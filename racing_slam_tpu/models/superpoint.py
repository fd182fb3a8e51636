"""SuperPoint-style keypoint detector + descriptor network in pure JAX.

Parity slot for the reference's DeepFeatureExtractor, which calls the
(absent) lightglue-cpp submodule's SuperPoint-style extractor
(src/features/DeepFeatureExtractor.cpp:8: lightglue::FeatureExtractor(1000,
0.0005).extract_features(image)) and post-filters keypoints by a static mask
(DeepFeatureExtractor.cpp:11-18). Architecture follows the public SuperPoint
design (DeTone et al. 2018): a shared VGG-style encoder at 1/8 resolution, a
detection head predicting a 65-way (8x8 cell + dustbin) distribution, and a
descriptor head with bilinear sampling at keypoints.

Weights: randomly initialized by default — no pretrained weights ship in this
offline image (the reference snapshot is missing its submodule weights too).
`load_params` accepts an .npz of the same pytree for drop-in trained weights,
and models/train.py can self-train on synthetic homography pairs.

Everything is statically shaped; keypoint selection reuses the grid-cell
argmax strategy (ops/corners.py) so K is fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.image import bilinear_sample
from ..slam.state import Features

ENCODER_CHANNELS = (64, 64, 128, 128)
DESC_DIM = 256
CELL = 8  # detection cell (fixed by the 65-way head)


class SuperPointParams(NamedTuple):
    conv_w: tuple  # encoder conv kernels [k, k, cin, cout]
    conv_b: tuple
    det_w: tuple  # detector head
    det_b: tuple
    desc_w: tuple  # descriptor head
    desc_b: tuple


def init_params(key: jax.Array, desc_dim: int = DESC_DIM) -> SuperPointParams:
    keys = jax.random.split(key, 16)
    ki = iter(range(16))

    def conv(k, cin, cout, ksize=3):
        w = jax.random.normal(k, (ksize, ksize, cin, cout)) * jnp.sqrt(
            2.0 / (ksize * ksize * cin)
        )
        return w.astype(jnp.float32), jnp.zeros((cout,), jnp.float32)

    conv_w, conv_b = [], []
    cin = 1
    # Two convs per encoder stage, pool between stages (stages at 1, 1/2,
    # 1/4, 1/8 resolution).
    for cout in ENCODER_CHANNELS:
        for _ in range(2):
            w, b = conv(keys[next(ki)], cin, cout)
            conv_w.append(w)
            conv_b.append(b)
            cin = cout

    dw1, db1 = conv(keys[next(ki)], cin, 256)
    dw2, db2 = conv(keys[next(ki)], 256, 65, ksize=1)
    ew1, eb1 = conv(keys[next(ki)], cin, 256)
    ew2, eb2 = conv(keys[next(ki)], 256, desc_dim, ksize=1)
    return SuperPointParams(
        conv_w=tuple(conv_w),
        conv_b=tuple(conv_b),
        det_w=(dw1, dw2),
        det_b=(db1, db2),
        desc_w=(ew1, ew2),
        desc_b=(eb1, eb2),
    )


def _conv(x, w, b, stride=1, compute_dtype=None):
    """x: [H, W, C]; w: [k, k, cin, cout] (HWIO).

    compute_dtype=bfloat16 runs the conv with bf16 operands and f32
    accumulation — inference-only (extract): the backbone is ~40 GFLOP/frame
    at 640x480 and was the learned path's dominant per-frame cost in f32.
    Training keeps f32 (gradients through bf16 convs quantize noisily)."""
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    y = jax.lax.conv_general_dilated(
        x[None],
        w,
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )[0]
    return y + b


def _pool2(x):
    """Non-overlapping 2x2 max pool as reshape+max. Identical forward to
    reduce_window max, but its GRADIENT lowers to ordinary equality/select
    ops instead of reduce_window's select-and-scatter backward."""
    H, W, C = x.shape
    Hp, Wp = H - (H % 2), W - (W % 2)
    x = x[:Hp, :Wp]
    return x.reshape(Hp // 2, 2, Wp // 2, 2, C).max(axis=(1, 3))


def backbone(
    params: SuperPointParams, img: jnp.ndarray, compute_dtype=None
) -> jnp.ndarray:
    """[H, W] grayscale -> [H/8, W/8, C] features."""
    x = img[..., None]
    i = 0
    for stage in range(len(ENCODER_CHANNELS)):
        for _ in range(2):
            x = jax.nn.relu(
                _conv(x, params.conv_w[i], params.conv_b[i],
                      compute_dtype=compute_dtype)
            )
            i += 1
        if stage < len(ENCODER_CHANNELS) - 1:
            x = _pool2(x)
    return x


def heads_logits(params: SuperPointParams, feat: jnp.ndarray,
                 compute_dtype=None):
    """-> (detector logits [Hc, Wc, 65], dense descriptors [Hc, Wc, D]).
    The raw 65-way logits are the training surface (cell-wise CE against
    corner labels, the original SuperPoint formulation)."""
    d = jax.nn.relu(_conv(feat, params.det_w[0], params.det_b[0],
                          compute_dtype=compute_dtype))
    logits = _conv(d, params.det_w[1], params.det_b[1],
                   compute_dtype=compute_dtype)  # [Hc, Wc, 65]
    e = jax.nn.relu(_conv(feat, params.desc_w[0], params.desc_b[0],
                          compute_dtype=compute_dtype))
    desc = _conv(e, params.desc_w[1], params.desc_b[1],
                 compute_dtype=compute_dtype)  # [Hc, Wc, D]
    desc = desc.astype(jnp.float32)
    desc = desc / (jnp.linalg.norm(desc, axis=-1, keepdims=True) + 1e-8)
    return logits, desc


def heads(params: SuperPointParams, feat: jnp.ndarray, compute_dtype=None):
    """-> (heatmap [H, W], dense descriptors [H/8, W/8, D])."""
    Hc, Wc, _ = feat.shape
    logits, desc = heads_logits(params, feat, compute_dtype=compute_dtype)
    logits = logits.astype(jnp.float32)
    prob = jax.nn.softmax(logits, axis=-1)[..., :64]  # drop dustbin
    heat = prob.reshape(Hc, Wc, CELL, CELL).transpose(0, 2, 1, 3).reshape(
        Hc * CELL, Wc * CELL
    )
    return heat, desc


def select_keypoints(
    heat: jnp.ndarray,
    mask: jnp.ndarray | None,
    cell: int,
    n_per_cell: int,
    threshold: float,
    border: int = 4,
):
    """Grid-cell argmax selection on the heatmap (static K; same strategy as
    ops/corners.detect_corners). Returns (xy [K, 2], score [K], valid [K])."""
    H, W = heat.shape
    score = heat
    if mask is not None:
        score = jnp.where(mask > 0, score, 0.0)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = jnp.where(inb, score, 0.0)

    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    padded = jnp.zeros((Hp, Wp)).at[:H, :W].set(score)
    gh, gw = Hp // cell, Wp // cell
    cells = padded.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
        gh * gw, cell * cell
    )
    bests, scores = [], []
    for _ in range(n_per_cell):
        b = jnp.argmax(cells, axis=-1)
        sc = jnp.take_along_axis(cells, b[:, None], axis=-1)[:, 0]
        bests.append(b)
        scores.append(sc)
        cells = cells.at[jnp.arange(gh * gw), b].set(0.0)
    best = jnp.concatenate(bests)
    sc = jnp.concatenate(scores)
    cell_ids = jnp.tile(jnp.arange(gh * gw), n_per_cell)
    cy = (cell_ids // gw) * cell + best // cell
    cx = (cell_ids % gw) * cell + best % cell

    # Sub-pixel parabola fit on the heatmap (same refinement as the
    # classical detector, ops/corners.select_corners_from_maps): integer
    # cell-argmax keypoints alone put a ~0.3 px quantization floor under
    # every reprojection residual the whole geometry stack minimizes.
    cyc = jnp.clip(cy, 1, H - 2)
    cxc = jnp.clip(cx, 1, W - 2)
    s = lambda dy, dx: heat[cyc + dy, cxc + dx]
    denom_x = s(0, -1) - 2.0 * s(0, 0) + s(0, 1)
    denom_y = s(-1, 0) - 2.0 * s(0, 0) + s(1, 0)
    dx = jnp.where(
        jnp.abs(denom_x) > 1e-12, 0.5 * (s(0, -1) - s(0, 1)) / denom_x, 0.0
    )
    dy = jnp.where(
        jnp.abs(denom_y) > 1e-12, 0.5 * (s(-1, 0) - s(1, 0)) / denom_y, 0.0
    )
    dx = jnp.clip(dx, -0.5, 0.5)
    dy = jnp.clip(dy, -0.5, 0.5)
    xy = jnp.stack(
        [cxc.astype(jnp.float32) + dx, cyc.astype(jnp.float32) + dy], axis=-1
    )
    return xy, sc, sc > threshold


def sample_descriptors(desc_map: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear descriptor sampling at pixel coords: [Hc, Wc, D], [K, 2]."""
    coords = xy / CELL - 0.5  # pixel -> descriptor-map coords
    D = desc_map.shape[-1]
    out = jax.vmap(lambda ch: bilinear_sample(ch, coords), in_axes=-1, out_axes=-1)(
        desc_map
    )
    return out / (jnp.linalg.norm(out, axis=-1, keepdims=True) + 1e-8)


class SuperPointFrontend:
    """Learned frontend behind the same interface as ClassicalFrontend.

    max_distance mirrors the reference deep path's L2 gate (0.7,
    src/features/DeepFeatureExtractor.h:12-19).
    """

    def __init__(
        self,
        params: SuperPointParams | None = None,
        cell: int = 16,
        n_per_cell: int = 2,
        threshold: float = 0.0005,  # DeepFeatureExtractor.cpp:8 (0.0005)
        max_distance: float = 0.7,
        seed: int = 0,
    ):
        self.params = params if params is not None else init_params(
            jax.random.PRNGKey(seed)
        )
        self.descriptor_dim = self.params.desc_w[1].shape[-1]
        self.cell = cell
        self.n_per_cell = n_per_cell
        self.threshold = threshold
        self.max_distance = max_distance
        from ..slam.frontend import ClassicalMatcher

        # Frame<->frame matcher slot (same contract as ClassicalFrontend);
        # Slam swaps in a LightGlueMatcher when cfg.matcher="lightglue".
        self.matcher = ClassicalMatcher(max_distance)

    def num_keypoints(self, height: int, width: int) -> int:
        return self.n_per_cell * (-(-height // self.cell)) * (-(-width // self.cell))

    def extract(self, img: jnp.ndarray, mask: jnp.ndarray | None = None) -> Features:
        # Inference runs the conv stack in bf16 with f32 accumulation (the
        # tensor cores' native mode; half the memory traffic of f32). Keypoint selection / subpixel refinement / descriptor
        # normalization stay f32: the heatmap parabola fit and unit-norm
        # descriptors are where rounding would actually surface.
        feat = backbone(self.params, img, compute_dtype=jnp.bfloat16)
        heat, desc_map = heads(self.params, feat, compute_dtype=jnp.bfloat16)
        xy, score, valid = select_keypoints(
            heat, mask, self.cell, self.n_per_cell, self.threshold
        )
        desc = sample_descriptors(desc_map.astype(jnp.float32), xy)
        return Features(xy=xy, desc=desc, valid=valid, score=score)


def save_params(path, params: SuperPointParams) -> None:
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(path, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})


def load_params(path) -> SuperPointParams:
    template = init_params(jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(template)
    with np.load(path) as data:
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(data.files))]
    return jax.tree_util.tree_unflatten(treedef, leaves)
