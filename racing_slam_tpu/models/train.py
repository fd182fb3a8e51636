"""Self-supervised training for the learned frontend (no external data).

No pretrained weights can ship in this offline image, so both networks train
from scratch on synthesized supervision:

- SuperPoint: homography-warped pairs of procedural textures. The detector
  head distills the classical Shi-Tomasi response (ops/corners.py) — the
  same trick as SuperPoint's synthetic-shapes pretraining, using our
  classical detector as the corner oracle; the descriptor head trains with
  an InfoNCE loss over ground-truth correspondences given by the homography.
- LightGlue: given (possibly imperfect) descriptors for a warped pair with
  known GT assignment, minimize the negative log-likelihood of the GT
  matches under the partial assignment scores.

Run: python -m racing_slam_tpu.models.train --steps 500 --out weights/
Smoke-tested in CI with a couple of steps; longer runs produce usable
weights on the real chip.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial
from pathlib import Path

import jax

# --cpu must take effect BEFORE the model-module imports below: one of them
# creates device constants at import time, which locks in the default
# backend; jax.config.update in main() would then be too late.
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from ..ops.corners import shi_tomasi_response
from ..ops.image import bilinear_sample
from ..utils.synthetic import random_texture
from . import lightglue, superpoint


# ---------------------------------------------------------------------------
# Homography pair generation (host side)
# ---------------------------------------------------------------------------


def random_homography(rng: np.random.Generator, h: int, w: int, mag=0.15):
    """Random perspective warp mapping image 0 coords -> image 1 coords."""
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    jitter = rng.uniform(-mag, mag, (4, 2)).astype(np.float32) * [w, h]
    dst = src + jitter
    # DLT for the 3x3 homography.
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A, np.float64))
    H = Vt[-1].reshape(3, 3)
    return (H / H[2, 2]).astype(np.float32)


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-warp img through H (output pixel <- H^-1 @ pixel)."""
    h, w = img.shape
    Hi = np.linalg.inv(H)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], -1).reshape(-1, 3) @ Hi.T
    uv = pts[:, :2] / pts[:, 2:3]
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0, y0 = x.astype(np.int32), y.astype(np.int32)
    fx, fy = x - x0, y - y0
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )
    return out.reshape(h, w).astype(np.float32)


def apply_h(H: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = np.concatenate([xy, np.ones_like(xy[:, :1])], -1) @ H.T
    return p[:, :2] / p[:, 2:3]


# ---------------------------------------------------------------------------
# SuperPoint training
# ---------------------------------------------------------------------------


def _detector_labels(img: jnp.ndarray, nms: int = 4, quality: float = 0.01):
    """Cell-wise 65-way corner labels from the classical detector: per 8x8
    cell, the flat index of the strongest NMS'd Shi-Tomasi peak, or 64
    (dustbin) for cells with no peak. This is the original SuperPoint
    formulation (MagicPoint stage) with our classical detector as the
    corner oracle — a peaked CE target localizes, where the previous raw
    response-map MSE distillation produced blurry heatmaps (~2 px median
    epipolar error vs the classical frontend's 0.19 px)."""
    from ..ops.corners import max_pool_same

    score = shi_tomasi_response(img)
    is_peak = score >= max_pool_same(score, 2 * nms + 1)
    peak = jnp.where(
        is_peak & (score > quality * jnp.max(score)), score, 0.0
    )
    H, W = img.shape
    C = superpoint.CELL
    Hc, Wc = H // C, W // C
    cells = (
        peak[: Hc * C, : Wc * C]
        .reshape(Hc, C, Wc, C)
        .transpose(0, 2, 1, 3)
        .reshape(Hc, Wc, C * C)
    )
    best = jnp.argmax(cells, axis=-1)
    has = jnp.max(cells, axis=-1) > 0.0
    return jnp.where(has, best, C * C)  # 64 = dustbin


def superpoint_loss(params, img0, img1, xy0, xy1, corr_valid, xy_neg):
    """Detector cell-CE (both images) + descriptor InfoNCE across the
    homography correspondence (xy0[i] <-> xy1[i]).

    xy_neg [M, 2]: extra DISTRACTOR sites in image 1 (corners that are NOT
    the correspondence of any xy0). In-pair negatives alone leave the
    descriptor space coarse — every InfoNCE row must only beat N-1 mostly
    far-away sites; appending hard negatives from the same image forces
    local distinctiveness, which is what the pipeline's mutual-1NN and
    LightGlue scoring actually need."""
    f0 = superpoint.backbone(params, img0)
    f1 = superpoint.backbone(params, img1)
    lg0, dmap0 = superpoint.heads_logits(params, f0)
    lg1, dmap1 = superpoint.heads_logits(params, f1)

    def det_ce(logits, img):
        labels = _detector_labels(img)
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(
            jnp.take_along_axis(lp, labels[..., None], axis=-1)
        )

    det_loss = det_ce(lg0, img0) + det_ce(lg1, img1)

    d0 = superpoint.sample_descriptors(dmap0, xy0)  # [N, D]
    d1 = superpoint.sample_descriptors(dmap1, xy1)
    dn = superpoint.sample_descriptors(dmap1, xy_neg)  # [M, D] distractors
    sim = (d0 @ jnp.concatenate([d1, dn], axis=0).T) * 10.0  # [N, N+M]
    labels = jnp.arange(d0.shape[0])
    ce = -jax.nn.log_softmax(sim, axis=1)[labels, labels]
    ce_t = -jax.nn.log_softmax(sim[:, : d0.shape[0]], axis=0)[labels, labels]
    desc_loss = jnp.sum(jnp.where(corr_valid, ce + ce_t, 0.0)) / (
        jnp.sum(corr_valid) + 1e-6
    )
    return det_loss + desc_loss


def _corner_correspondences(img0, rng, n_corr, h, w, jit_response):
    """Correspondence sample sites AT classical-detector corners of img0
    (uniform-random sites land mostly on featureless background in the
    sprite-world half of the training distribution, which starves the
    descriptor InfoNCE of matchable structure — measured precision 0.42 on
    held-out pairs vs 0.87 for the same matcher on classical descriptors).
    Falls back to uniform sites to fill when an image has few corners."""
    score = np.array(jit_response(jnp.asarray(img0)))
    score[:8, :] = score[-8:, :] = 0.0
    score[:, :8] = score[:, -8:] = 0.0
    flat = np.argpartition(score.ravel(), -4 * n_corr)[-4 * n_corr:]
    flat = flat[score.ravel()[flat] > 0.0]
    rng.shuffle(flat)
    ys, xs = np.unravel_index(flat[:n_corr], score.shape)
    xy = np.stack([xs, ys], -1).astype(np.float32)
    if len(xy) < n_corr:
        pad = rng.uniform(
            [8, 8], [w - 8, h - 8], (n_corr - len(xy), 2)
        ).astype(np.float32)
        xy = np.concatenate([xy, pad], axis=0)
    # Sub-pixel jitter so descriptors learn bilinear-sampled localization.
    return xy + rng.uniform(-0.5, 0.5, xy.shape).astype(np.float32)


def _photometric(img, rng):
    """Gain/bias/noise jitter: the pipeline matches across exposure drift
    and sensor noise that clean warps never exhibit."""
    g = rng.uniform(0.7, 1.3)
    b = rng.uniform(-0.1, 0.1)
    n = rng.normal(0.0, rng.uniform(0.0, 0.03), img.shape)
    return np.clip(img * g + b + n, 0.0, 1.0).astype(np.float32)


def train_superpoint(
    steps: int = 200,
    img_size: tuple = (120, 160),
    n_corr: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 20,
    resume: str | None = None,
) -> superpoint.SuperPointParams:
    import optax

    rng = np.random.default_rng(seed)
    params = (
        superpoint.load_params(resume)
        if resume
        else superpoint.init_params(jax.random.PRNGKey(seed))
    )
    # Cosine decay to ~0: from-scratch InfoNCE plateaus noisily at a fixed
    # step size; the tail of the schedule is where match precision converges.
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))
    opt_state = opt.init(params)
    h, w = img_size
    jit_response = jax.jit(shi_tomasi_response)
    pool = _ImagePool(rng, h, w)

    @jax.jit
    def step_fn(params, opt_state, img0, img1, xy0, xy1, cv, xyn):
        loss, grads = jax.value_and_grad(superpoint_loss)(
            params, img0, img1, xy0, xy1, cv, xyn
        )
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(steps):
        img0 = pool.sample()
        H = random_homography(rng, h, w)
        img1 = warp_image(img0, H)
        xy0 = _corner_correspondences(img0, rng, n_corr, h, w, jit_response)
        xy1 = apply_h(H, xy0)
        cv = (
            (xy1[:, 0] >= 8) & (xy1[:, 0] < w - 8)
            & (xy1[:, 1] >= 8) & (xy1[:, 1] < h - 8)
        )
        img1 = _photometric(img1, rng)
        # Hard negatives: corner sites of the WARPED image (nudged off the
        # true correspondences by the >=3 px jitter below).
        xyn = _corner_correspondences(img1, rng, n_corr // 2, h, w,
                                      jit_response)
        xyn = xyn + rng.uniform(3.0, 6.0, xyn.shape) * rng.choice(
            [-1.0, 1.0], xyn.shape
        )
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(img0), jnp.asarray(img1),
            jnp.asarray(xy0), jnp.asarray(np.clip(xy1, 0, [w - 1, h - 1])),
            jnp.asarray(cv),
            jnp.asarray(np.clip(xyn, 0, [w - 1, h - 1]).astype(np.float32)),
        )
        if log_every and i % log_every == 0:
            print(f"superpoint step {i}: loss {float(loss):.4f}", flush=True)
    return params


# ---------------------------------------------------------------------------
# LightGlue training
# ---------------------------------------------------------------------------


def lightglue_loss(params, d0, xy0, d1, xy1, gt_idx, gt_valid, image_size):
    """NLL of ground-truth assignment under the partial-assignment scores."""
    K = d0.shape[0]
    scores, m0, m1 = lightglue.assignment_scores(
        params, d0, xy0, jnp.ones(K, bool), d1, xy1, jnp.ones(K, bool), image_size
    )
    picked = scores[jnp.arange(K), jnp.clip(gt_idx, 0)]
    nll = -jnp.log(picked + 1e-9)
    # Unmatched tokens should have low matchability.
    unmatched_pen = -jnp.log(1.0 - m0 + 1e-9)
    loss = jnp.sum(jnp.where(gt_valid, nll, unmatched_pen)) / K
    return loss


def train_lightglue(
    steps: int = 200,
    K: int = 96,
    dim: int = 64,
    n_layers: int = 2,
    lr: float = 1e-3,
    noise: float = 0.25,
    seed: int = 0,
    log_every: int = 20,
) -> lightglue.LightGlueParams:
    """Train on synthetic descriptor clouds: image-1 tokens are noisy copies
    of a permuted subset of image-0 tokens; the matcher must recover the
    permutation from descriptors + geometry."""
    import optax

    rng = np.random.default_rng(seed)
    params = lightglue.init_params(jax.random.PRNGKey(seed), dim, dim, n_layers)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    size = (128.0, 128.0)

    @jax.jit
    def step_fn(params, opt_state, d0, xy0, d1, xy1, gt_idx, gt_valid):
        loss, grads = jax.value_and_grad(lightglue_loss)(
            params, d0, xy0, d1, xy1, gt_idx, gt_valid, size
        )
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(steps):
        d0 = rng.standard_normal((K, dim)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        xy0 = rng.uniform(0, 128, (K, 2)).astype(np.float32)
        perm = rng.permutation(K)
        drop = rng.random(K) < 0.25  # 25% unmatched
        d1 = d0[perm] + noise * rng.standard_normal((K, dim)).astype(np.float32)
        d1[drop[perm]] = rng.standard_normal((drop[perm].sum(), dim))
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        shift = rng.uniform(-10, 10, (1, 2)).astype(np.float32)
        xy1 = np.clip(xy0[perm] + shift, 0, 127).astype(np.float32)
        inv = np.argsort(perm)
        gt_idx = inv  # token i of image0 -> position inv[i] in image1
        gt_valid = ~drop
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(d0), jnp.asarray(xy0),
            jnp.asarray(d1), jnp.asarray(xy1),
            jnp.asarray(gt_idx), jnp.asarray(gt_valid),
        )
        if log_every and i % log_every == 0:
            print(f"lightglue step {i}: loss {float(loss):.4f}")
    return params


def lightglue_frontend_loss(
    params, d0, xy0, v0, d1, xy1, v1, gt_idx, gt_valid, image_size
):
    """Masked NLL of the homography ground-truth assignment: matched tokens
    maximize their GT score; unmatched-but-valid tokens minimize
    matchability."""
    K = d0.shape[0]
    scores, m0, _ = lightglue.assignment_scores(
        params, d0, xy0, v0, d1, xy1, v1, image_size
    )
    picked = scores[jnp.arange(K), jnp.clip(gt_idx, 0)]
    nll = -jnp.log(picked + 1e-9)
    unmatched_pen = -jnp.log(1.0 - m0 + 1e-9)
    matched = gt_valid & v0
    unmatched = v0 & ~gt_valid
    n = jnp.sum(v0) + 1e-6
    return (
        jnp.sum(jnp.where(matched, nll, 0.0))
        + 0.3 * jnp.sum(jnp.where(unmatched, unmatched_pen, 0.0))
    ) / n


def _train_image(rng, h, w):
    """Training image sampler: half multi-octave noise textures, half
    sprite-world renders (textured quads on black background) — the actual
    content distribution the SLAM pipeline matches on. Trained only on dense
    textures, the matcher's double-softmax scores collapse on sparse scenes
    (most keypoints sit on background); mixing closes that gap."""
    if rng.random() < 0.5:
        return random_texture(h, w, rng)
    from ..ops.camera import Camera
    from ..utils.synthetic import SpriteWorld

    cam = Camera(fx=float(w) * 0.75, fy=float(w) * 0.75,
                 cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    world = SpriteWorld.generate(rng, n_sprites=60, tex_size=32)
    pose = np.eye(4, dtype=np.float32)
    return world.render(cam, pose)


class _ImagePool:
    """Pre-rendered training-image pool. A SpriteWorld render costs ~1 s of
    host time at 240x320 — per-step generation makes training host-bound
    with the device idle. The homography, photometric jitter, and
    correspondence sites stay fresh per step; reusing base images across
    steps is the standard synthetic-pretraining trade (epochs)."""

    def __init__(self, rng, h, w, size: int = 300):
        self.images = [_train_image(rng, h, w) for _ in range(size)]
        self.rng = rng

    def sample(self):
        return self.images[self.rng.integers(len(self.images))]


def _homography_pair(rng, frontend, extract, h, w, mag=0.12, pool=None):
    """One training example: classical-frontend features of a texture and its
    homography warp, plus the GT assignment (nearest warped keypoint < 3 px)."""
    img0 = pool.sample() if pool is not None else _train_image(rng, h, w)
    H = random_homography(rng, h, w, mag=mag)
    img1 = warp_image(img0, H)
    f0 = extract(jnp.asarray(img0))
    f1 = extract(jnp.asarray(img1))
    xy0 = np.asarray(f0.xy)
    xy1 = np.asarray(f1.xy)
    v0 = np.asarray(f0.valid)
    v1 = np.asarray(f1.valid)
    warped = apply_h(H, xy0)  # where image-0 keypoints land in image 1
    d2 = np.sum((warped[:, None, :] - xy1[None, :, :]) ** 2, axis=-1)
    d2[:, ~v1] = np.inf
    gt_idx = np.argmin(d2, axis=1).astype(np.int32)
    gt_valid = (
        v0
        & (d2[np.arange(len(xy0)), gt_idx] < 9.0)
        & (warped[:, 0] >= 0) & (warped[:, 0] < w)
        & (warped[:, 1] >= 0) & (warped[:, 1] < h)
    )
    return f0, f1, gt_idx, gt_valid


def train_lightglue_on_frontend(
    frontend,
    steps: int = 400,
    img_size: tuple = (160, 224),
    dim: int = 128,
    n_layers: int = 2,
    lr: float = 2e-4,
    seed: int = 0,
    log_every: int = 25,
) -> lightglue.LightGlueParams:
    """Train LightGlue on REAL frontend descriptors of homography-warped
    texture pairs — the weights the SLAM pipeline's `matcher: lightglue`
    path loads. Works for any frontend exposing extract()/descriptor_dim
    (classical 128-d or SuperPoint 256-d). GT correspondence comes from the
    known homography, so no labels are needed (same recipe as LightGlue's
    homography pretraining stage, Lindenberger et al. 2023)."""
    import optax

    rng = np.random.default_rng(seed)
    h, w = img_size
    extract = jax.jit(frontend.extract)
    params = lightglue.init_params(
        jax.random.PRNGKey(seed), frontend.descriptor_dim, dim, n_layers
    )
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    size = (float(w), float(h))

    @jax.jit
    def step_fn(params, opt_state, d0, xy0, v0, d1, xy1, v1, gt_idx, gt_valid):
        loss, grads = jax.value_and_grad(lightglue_frontend_loss)(
            params, d0, xy0, v0, d1, xy1, v1, gt_idx, gt_valid, size
        )
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    pool = _ImagePool(rng, h, w)
    for i in range(steps):
        f0, f1, gt_idx, gt_valid = _homography_pair(
            rng, frontend, extract, h, w, pool=pool)
        params, opt_state, loss = step_fn(
            params, opt_state, f0.desc, f0.xy, f0.valid,
            f1.desc, f1.xy, f1.valid,
            jnp.asarray(gt_idx), jnp.asarray(gt_valid),
        )
        if log_every and i % log_every == 0:
            print(f"lightglue-frontend step {i}: loss {float(loss):.4f}", flush=True)
    return params


def train_lightglue_frontend(steps: int = 400, **kw) -> lightglue.LightGlueParams:
    """LightGlue on the classical frontend's 128-d descriptors (the packaged
    weights/lightglue.npz recipe)."""
    from ..slam.frontend import ClassicalFrontend

    return train_lightglue_on_frontend(
        ClassicalFrontend(), steps=steps, **kw
    )


def _superpoint_frontend(superpoint_weights=None):
    from .superpoint import SuperPointFrontend, load_params as load_sp

    params = load_sp(superpoint_weights) if superpoint_weights else None
    return SuperPointFrontend(params=params)


def train_lightglue_superpoint(
    steps: int = 400, superpoint_weights=None, **kw
) -> lightglue.LightGlueParams:
    """LightGlue on the learned SuperPoint frontend's 256-d descriptors —
    joins the reference's deep path (learned extractor + learned matcher,
    src/features/DeepFeatureExtractor.cpp:8 + the lightglue submodule).
    Saved as weights/lightglue_superpoint.npz; the pipeline loads it when
    `--frontend learned --matcher lightglue`."""
    return train_lightglue_on_frontend(
        _superpoint_frontend(superpoint_weights), steps=steps, **kw
    )


def eval_lightglue_on_frontend(
    params, frontend, n_pairs: int = 8, img_size: tuple = (160, 224),
    seed: int = 1, threshold: float = 0.1,
):
    """Precision/recall of mutual-argmax matches vs homography GT on held-out
    pairs (and the frontend's mutual-1NN matcher on the same pairs)."""
    from ..ops.matching import match_frames

    rng = np.random.default_rng(seed)
    h, w = img_size
    extract = jax.jit(frontend.extract)
    stats = {"lg": [0, 0, 0], "classical": [0, 0, 0]}  # correct, proposed, gt
    for _ in range(n_pairs):
        f0, f1, gt_idx, gt_valid = _homography_pair(rng, frontend, extract, h, w)
        # GT indexed by image-1 keypoints (both matchers return that way).
        gt1 = -np.ones(len(gt_idx), np.int64)
        for i0 in np.nonzero(gt_valid)[0]:
            gt1[gt_idx[i0]] = i0
        lg = lightglue.match(
            params, f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid,
            (float(w), float(h)), threshold,
        )
        cl = match_frames(
            f0.desc, f0.valid, f1.desc, f1.valid, frontend.max_distance
        )
        for name, fm in (("lg", lg), ("classical", cl)):
            v = np.asarray(fm.valid)
            ti = np.asarray(fm.train_idx)
            stats[name][0] += int(np.sum(v & (ti == gt1)))
            stats[name][1] += int(np.sum(v))
            stats[name][2] += int(np.sum(gt1 >= 0))
    out = {}
    for name, (c, p, g) in stats.items():
        out[name] = {
            "precision": c / max(p, 1),
            "recall": c / max(g, 1),
            "proposed": p,
            "gt": g,
        }
    return out


def eval_lightglue_frontend(params, **kw):
    from ..slam.frontend import ClassicalFrontend

    return eval_lightglue_on_frontend(params, ClassicalFrontend(), **kw)


def eval_lightglue_superpoint(params, superpoint_weights=None, **kw):
    return eval_lightglue_on_frontend(
        params, _superpoint_frontend(superpoint_weights), **kw
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--sp-steps", type=int, default=None,
                   help="SuperPoint step count override (default: --steps)")
    p.add_argument("--sp-resume", type=str, default="",
                   help="resume SuperPoint training from this .npz")
    p.add_argument("--sp-lr", type=float, default=1e-3)
    p.add_argument("--sp-size", type=str, default="120x160",
                   help="SuperPoint training image size HxW; larger sizes "
                        "give more detector cells per example and transfer "
                        "better to the 480x640 pipeline resolution")
    p.add_argument("--lg-size", type=str, default="160x224",
                   help="LightGlue-on-frontend training image size HxW")
    p.add_argument("--out", type=Path, default=Path("weights"))
    p.add_argument(
        "--which",
        # "lightglue" (and "both") trains the PIPELINE-compatible recipe:
        # LightGlue on real classical-frontend 128-d descriptors
        # (train_lightglue_frontend) — the weights `--matcher lightglue`
        # loads. "lightglue-toy" is the synthetic descriptor-cloud exercise
        # (dim=64, incompatible with the pipeline) and saves under a distinct
        # filename so it can never shadow the real weights.
        # "lightglue-superpoint" trains a 256-d-input LightGlue on SuperPoint
        # descriptors (needs weights/superpoint.npz or --steps for both).
        choices=[
            "superpoint",
            "lightglue",
            "lightglue-frontend",  # alias for "lightglue" (historical name)
            "lightglue-superpoint",
            "lightglue-toy",
            "both",
        ],
        default="both",
    )
    p.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (the env var is too late once jax is "
             "imported)",
    )
    args = p.parse_args(argv)
    if args.cpu and jax.default_backend() != "cpu":
        jax.config.update("jax_platforms", "cpu")  # no-op if backend is live
    args.out.mkdir(parents=True, exist_ok=True)
    sp_hw = tuple(int(v) for v in args.sp_size.split("x"))
    lg_hw = tuple(int(v) for v in args.lg_size.split("x"))
    if args.which in ("superpoint", "both"):
        sp = train_superpoint(args.sp_steps or args.steps, img_size=sp_hw,
                              lr=args.sp_lr,
                              resume=args.sp_resume or None)
        superpoint.save_params(args.out / "superpoint.npz", sp)
        print(f"saved {args.out}/superpoint.npz")
    if args.which in ("lightglue", "lightglue-frontend", "both"):
        lg = train_lightglue_frontend(args.steps, img_size=lg_hw)
        print(eval_lightglue_frontend(lg))
        lightglue.save_params(args.out / "lightglue.npz", lg)
        print(f"saved {args.out}/lightglue.npz")
    if args.which in ("lightglue-superpoint", "both"):
        sp_path = args.out / "superpoint.npz"
        lg = train_lightglue_superpoint(
            args.steps, img_size=lg_hw,
            superpoint_weights=sp_path if sp_path.exists() else None
        )
        print(eval_lightglue_superpoint(
            lg, superpoint_weights=sp_path if sp_path.exists() else None
        ))
        lightglue.save_params(args.out / "lightglue_superpoint.npz", lg)
        print(f"saved {args.out}/lightglue_superpoint.npz")
    if args.which == "lightglue-toy":
        lg = train_lightglue(args.steps)
        lightglue.save_params(args.out / "lightglue_toy.npz", lg)
        print(f"saved {args.out}/lightglue_toy.npz (synthetic descriptor-"
              "cloud exercise; NOT loadable by the pipeline)")


if __name__ == "__main__":
    main()
