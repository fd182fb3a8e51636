"""LightGlue-style attention matcher in pure JAX.

The BASELINE-mandated replacement for the reference's lightglue-cpp matcher
(absent submodule; visible call at src/features/DeepFeatureExtractor.cpp:8).
Architecture follows the public LightGlue design (Lindenberger et al. 2023):

- tokens = projected descriptors for both images;
- L transformer layers, each = self-attention within an image (with 2-D
  rotary positional encoding on normalized keypoint coords) followed by
  cross-attention between images;
- a partial assignment head: pairwise similarity + per-token matchability,
  combined into a double-softmax score matrix;
- mutual-argmax extraction with a score threshold.

Attention is [K, K] einsum (dense, or tiled online-softmax) with validity masking for
padded keypoints. n_layers=0 degrades to dual-softmax matching on the raw
descriptors, which is exact and testable without trained weights (no
pretrained weights exist in this offline image; load_params can restore a
trained .npz and models/train.py can self-train).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.matching import FrameMatches

HEADS = 4


class LayerParams(NamedTuple):
    # self-attention (per image, shared weights for both images)
    self_qkv_w: jnp.ndarray  # [D, 3D]
    self_out_w: jnp.ndarray  # [2D, D] (concat[token, message] -> token) MLP in
    self_mlp_w: jnp.ndarray  # [2D, D]
    self_mlp_b: jnp.ndarray
    # cross-attention
    cross_qk_w: jnp.ndarray  # [D, D]
    cross_v_w: jnp.ndarray  # [D, D]
    cross_mlp_w: jnp.ndarray  # [2D, D]
    cross_mlp_b: jnp.ndarray


class LightGlueParams(NamedTuple):
    in_proj_w: jnp.ndarray  # [Din, D]
    layers: tuple  # of LayerParams
    match_proj_w: jnp.ndarray  # [D, D] final similarity projection
    matchability_w: jnp.ndarray  # [D, 1]
    matchability_b: jnp.ndarray  # [1]


def init_params(
    key: jax.Array, in_dim: int = 256, dim: int = 256, n_layers: int = 4
) -> LightGlueParams:
    k = jax.random.split(key, 4 + 8 * max(n_layers, 1))
    ki = iter(range(len(k)))

    def lin(kk, a, b):
        return (jax.random.normal(kk, (a, b)) / jnp.sqrt(a)).astype(jnp.float32)

    layers = []
    for _ in range(n_layers):
        layers.append(
            LayerParams(
                self_qkv_w=lin(k[next(ki)], dim, 3 * dim),
                self_out_w=lin(k[next(ki)], dim, dim),
                self_mlp_w=lin(k[next(ki)], 2 * dim, dim),
                self_mlp_b=jnp.zeros((dim,), jnp.float32),
                cross_qk_w=lin(k[next(ki)], dim, dim),
                cross_v_w=lin(k[next(ki)], dim, dim),
                cross_mlp_w=lin(k[next(ki)], 2 * dim, dim),
                cross_mlp_b=jnp.zeros((dim,), jnp.float32),
            )
        )
    return LightGlueParams(
        in_proj_w=lin(k[next(ki)], in_dim, dim),
        layers=tuple(layers),
        match_proj_w=lin(k[next(ki)], dim, dim),
        matchability_w=lin(k[next(ki)], dim, 1),
        matchability_b=jnp.zeros((1,), jnp.float32),
    )


def _rotary_2d(xy: jnp.ndarray, dim: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2-D rotary embedding angles for normalized coords [K, 2] -> cos/sin
    [K, dim/2] (half the frequencies on x, half on y)."""
    q = dim // 4
    freqs = jnp.exp(jnp.linspace(0.0, 4.0, q)) * jnp.pi
    ax = xy[:, 0:1] * freqs[None, :]
    ay = xy[:, 1:2] * freqs[None, :]
    ang = jnp.concatenate([ax, ay], axis=-1)  # [K, dim/2]
    return jnp.cos(ang), jnp.sin(ang)


def _apply_rope(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray) -> jnp.ndarray:
    """Rotate feature pairs: x [K, H, dh] with dh even; cos/sin [K, dh/2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[:, None, :]
    s = sin[:, None, :]
    out = jnp.stack([x1 * c - x2 * s, x1 * s + x2 * c], axis=-1)
    return out.reshape(x.shape)


def _ln(x):
    """Parameter-free LayerNorm (pre-norm stabilizes the residual stack)."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-6)


def _flash_mha_xla(q, k, v, mask_k, tile: int = 512):
    """Online-softmax (flash) attention in plain XLA: lax.scan over key
    tiles carrying running (max, denominator, accumulator). No [H, K, K]
    logits ever exist in device memory: each step materializes one
    [Kq, H, tile] slab that XLA fuses into its matmul producers/consumers.

    Masking parity with the dense path: invalid keys logit -1e9 (uniform
    softmax if ALL keys are masked), tile-padding keys -2e9 (excluded even
    from that degenerate case — the dense path never saw those rows)."""
    Kq, H, dh = q.shape
    Kk = k.shape[0]
    scale = 1.0 / jnp.sqrt(dh).astype(jnp.float32)
    nk = -(-Kk // tile)
    pad = nk * tile - Kk
    mk = mask_k.astype(jnp.float32)
    if pad:
        zf = jnp.zeros((pad, H, dh), k.dtype)
        k = jnp.concatenate([k, zf], axis=0)
        v = jnp.concatenate([v, zf], axis=0)
        mk = jnp.concatenate([mk, jnp.full((pad,), -1.0, jnp.float32)])
    kt = k.reshape(nk, tile, H, dh)
    vt = v.reshape(nk, tile, H, dh)
    mt = mk.reshape(nk, tile)

    def body(carry, xs):
        m, l, acc = carry
        k_t, v_t, m_t = xs
        s = jnp.einsum("qhd,chd->qhc", q, k_t) * scale
        m_t = m_t[None, None, :]
        s = jnp.where(m_t > 0.0, s, jnp.where(m_t < 0.0, -2e9, -1e9))
        m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
        p = jnp.exp(s - m_new)
        alpha = jnp.exp(m - m_new)
        l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc = acc * alpha + jnp.einsum("qhc,chd->qhd", p, v_t)
        return (m_new, l, acc), None

    m0 = jnp.full((Kq, H, 1), -3e9, jnp.float32)
    l0 = jnp.zeros((Kq, H, 1), jnp.float32)
    a0 = jnp.zeros((Kq, H, dh), jnp.float32)
    (m, l, acc), _ = jax.lax.scan(body, (m0, l0, a0), (kt, vt, mt))
    return acc / l


def _mha(q, k, v, mask_q, mask_k, backend: str = "xla"):
    """Multi-head attention: q [Kq, H, dh], k/v [Kk, H, dh].

    backends:
      "xla_flash" (the "auto" default): _flash_mha_xla — online-softmax
        scan, no [H, K, K] logits in device memory;
      "xla": the naive dense einsum path (parity oracle; ~92 MB of logits
        per attention site at K=2400, 16 sites per matcher call)."""
    if backend == "xla_flash":
        msg = _flash_mha_xla(q, k, v, mask_k)
    else:
        dh = q.shape[-1]
        logits = jnp.einsum("qhd,khd->hqk", q, k) / jnp.sqrt(dh)
        logits = jnp.where(mask_k[None, None, :], logits, -1e9)
        attn = jax.nn.softmax(logits, axis=-1)
        msg = jnp.einsum("hqk,khd->qhd", attn, v)
    return jnp.where(mask_q[:, None, None], msg, 0.0)


def _split_heads(x, heads=HEADS):
    K, D = x.shape
    return x.reshape(K, heads, D // heads)


def _merge_heads(x):
    K, H, dh = x.shape
    return x.reshape(K, H * dh)


def _layer(
    p: LayerParams, t0, t1, rope0, rope1, m0, m1, backend: str = "xla"
):
    """One LightGlue layer: rotary self-attention then cross-attention, each
    followed by a gated-MLP token update (token <- token + MLP([token|msg])).
    rope0/rope1 are the precomputed (cos, sin) pairs — identical for every
    layer, so the caller hoists them out of the layer loop."""
    cos0, sin0 = rope0
    cos1, sin1 = rope1

    def self_attn(t, cos, sin, m):
        tn = _ln(t)
        qkv = tn @ p.self_qkv_w
        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = _apply_rope(_split_heads(q), cos, sin)
        k = _apply_rope(_split_heads(k), cos, sin)
        msg = _merge_heads(
            _mha(q, k, _split_heads(v), m, m, backend)
        ) @ p.self_out_w
        upd = jax.nn.gelu(
            jnp.concatenate([tn, _ln(msg)], -1) @ p.self_mlp_w + p.self_mlp_b
        )
        return t + upd

    t0 = self_attn(t0, cos0, sin0, m0)
    t1 = self_attn(t1, cos1, sin1, m1)

    def cross(ta, tb, ma, mb):
        tan, tbn = _ln(ta), _ln(tb)
        qa = _split_heads(tan @ p.cross_qk_w)
        kb = _split_heads(tbn @ p.cross_qk_w)
        vb = _split_heads(tbn @ p.cross_v_w)
        msg = _merge_heads(_mha(qa, kb, vb, ma, mb, backend))
        upd = jax.nn.gelu(
            jnp.concatenate([tan, _ln(msg)], -1) @ p.cross_mlp_w + p.cross_mlp_b
        )
        return ta + upd

    t0n = cross(t0, t1, m0, m1)
    t1n = cross(t1, t0, m1, m0)
    return t0n, t1n


def assignment_scores(
    params: LightGlueParams,
    desc0: jnp.ndarray,
    xy0: jnp.ndarray,
    valid0: jnp.ndarray,
    desc1: jnp.ndarray,
    xy1: jnp.ndarray,
    valid1: jnp.ndarray,
    image_size: tuple[float, float],
    attn_backend: str = "auto",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full forward pass -> (scores [K0, K1], matchability0, matchability1).

    scores combine double-softmax similarity with matchability sigmoids
    (LightGlue eq. 8-style partial assignment).

    attn_backend: "auto" resolves to "xla_flash" — the lax.scan
    online-softmax path (_flash_mha_xla), which keeps the [H, K, K] logits
    out of device memory. "xla" = naive dense einsum (parity oracle).
    """
    if attn_backend == "auto":
        attn_backend = "xla_flash"
    if attn_backend not in ("xla_flash", "xla"):
        raise ValueError(f"unknown attn_backend {attn_backend!r}")
    w, h = image_size
    n0 = (xy0 - jnp.array([w / 2, h / 2])) / max(w, h)
    n1 = (xy1 - jnp.array([w / 2, h / 2])) / max(w, h)

    t0 = desc0 @ params.in_proj_w
    t1 = desc1 @ params.in_proj_w
    if params.layers:
        D = t0.shape[-1]
        rope0 = _rotary_2d(n0, D // HEADS)
        rope1 = _rotary_2d(n1, D // HEADS)
    for p in params.layers:
        t0, t1 = _layer(p, t0, t1, rope0, rope1, valid0, valid1, attn_backend)

    t0 = _ln(t0) if len(params.layers) else t0
    t1 = _ln(t1) if len(params.layers) else t1
    z0 = t0 @ params.match_proj_w
    z1 = t1 @ params.match_proj_w
    sim = jnp.einsum("id,jd->ij", z0, z1) / jnp.sqrt(z0.shape[-1])
    sim = jnp.where(valid0[:, None] & valid1[None, :], sim, -1e9)

    s01 = jax.nn.log_softmax(sim, axis=1)
    s10 = jax.nn.log_softmax(sim, axis=0)
    m0 = jax.nn.sigmoid(t0 @ params.matchability_w + params.matchability_b)[:, 0]
    m1 = jax.nn.sigmoid(t1 @ params.matchability_w + params.matchability_b)[:, 0]
    scores = jnp.exp(s01 + s10) * m0[:, None] * m1[None, :]
    return scores, m0, m1


def match(
    params: LightGlueParams,
    desc0: jnp.ndarray,
    xy0: jnp.ndarray,
    valid0: jnp.ndarray,
    desc1: jnp.ndarray,
    xy1: jnp.ndarray,
    valid1: jnp.ndarray,
    image_size: tuple[float, float],
    threshold: float = 0.1,
    attn_backend: str = "auto",
) -> FrameMatches:
    """Mutual-argmax matches from the assignment scores; output indexed by
    image-1 keypoints (train_idx -> image 0), like ops.matching.match_frames."""
    scores, _, _ = assignment_scores(
        params, desc0, xy0, valid0, desc1, xy1, valid1, image_size,
        attn_backend=attn_backend,
    )
    best0_for_1 = jnp.argmax(scores, axis=0)  # [K1]
    best1_for_0 = jnp.argmax(scores, axis=1)  # [K0]
    mutual = best1_for_0[best0_for_1] == jnp.arange(scores.shape[1])
    sc = jnp.take_along_axis(scores, best0_for_1[None, :], axis=0)[0]
    ok = mutual & (sc > threshold) & valid1
    return FrameMatches(
        train_idx=best0_for_1.astype(jnp.int32),
        distance=1.0 - sc,  # present as a distance for API uniformity
        valid=ok,
    )


def save_params(path, params: LightGlueParams) -> None:
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(
        path,
        n_leaves=len(leaves),
        in_dim=params.in_proj_w.shape[0],
        dim=params.in_proj_w.shape[1],
        n_layers=len(params.layers),
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
    )


def load_params(path) -> LightGlueParams:
    """Restore trained weights; hyperparameters are stored in the file."""
    with np.load(path) as data:
        template = init_params(
            jax.random.PRNGKey(0),
            int(data["in_dim"]), int(data["dim"]), int(data["n_layers"]),
        )
        treedef = jax.tree_util.tree_structure(template)
        n = int(data["n_leaves"])
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
