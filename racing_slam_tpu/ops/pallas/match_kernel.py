"""Fused guided-matching stage 1 (map points -> frame keypoints), Pallas/Triton.

The reference's hottest inner loop (src/features/FeatureExtractor.cpp:26-92,
SURVEY.md §3.5): for each map point, the best keypoint within a pixel radius
of its projection, scored by the minimum descriptor distance over the point's
stored observations.

The XLA path (ops/matching.py) writes a [chunk*O, K] f32 distance block per
point chunk to device memory and reads it back for the min/argmin: at
P=4096, O=8, K=2400 that is ~0.6 GB of traffic per call against ~20 GFLOP of
bf16 matrix work, so the XLA path is bound by memory. This kernel keeps the
distances in registers:

- one program per tile of `tile_p` points (grid over point tiles only);
- a `fori_loop` over keypoint tiles inside the program; per tile, O bf16
  matrix products [tile_p, D] x [D, tile_k] with f32 accumulation, min over
  the observation axis, the pixel/validity gates, and a running
  (best_d, best_k) merge in which earlier keypoint tiles win ties — the same
  lowest-index tie rule as the XLA path's argmin.

Squared norms are computed once in the wrapper from the bf16-rounded
descriptors (`rounded_sq_norms`, shared with the XLA path); invalid observation
slots carry a norm of _BIG, which saturates their distance to exactly _BIG in
f32 and so drops them from the min without a separate mask.

The wrapper pads P and K to the tiles; padded points are ungated and padded
keypoints are invalid. The second reduction (best point per keypoint) is a
small scatter-min left to XLA (ops.matching._stage2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..matching import rounded_sq_norms

_BIG = 1e9


def _kernel(
    pu_ref,  # [TP] f32 projected point u
    pv_ref,  # [TP] f32 projected point v
    pg_ref,  # [TP] f32 point gate 0/1
    obs_ref,  # [TP, O, D] bf16 observation descriptors
    on2_ref,  # [TP, O] f32 observation norms (_BIG on invalid slots)
    ku_ref,  # [Kp] f32 keypoint u
    kv_ref,  # [Kp] f32 keypoint v
    kok_ref,  # [Kp] f32 keypoint gate 0/1
    kd_ref,  # [Kp, D] bf16 keypoint descriptors
    kn2_ref,  # [Kp] f32 keypoint norms
    bk_ref,  # [TP] i32 out: best keypoint
    bd_ref,  # [TP] f32 out: best squared distance (_BIG = none)
    *,
    n_obs: int,
    tile_k: int,
    n_k: int,
    radius_sq: float,
):
    tile_p = pu_ref.shape[0]
    pu = pu_ref[...]
    pv = pv_ref[...]
    pg = pg_ref[...] > 0.0

    def k_tile(kt, carry):
        run_d, run_k = carry
        ks = pl.ds(pl.multiple_of(kt * tile_k, tile_k), tile_k)
        kd = kd_ref[ks, :]  # [TK, D]
        kn2 = kn2_ref[ks]
        acc = jnp.full((tile_p, tile_k), _BIG, jnp.float32)
        for o in range(n_obs):
            cross = pl.dot(
                obs_ref[:, o, :], kd, trans_b=True,
                precision=(jax.lax.Precision.DEFAULT,) * 2,
            )  # [TP, TK] f32: bf16 x bf16 products, f32 accumulation
            on2 = on2_ref[:, o]
            dd = jnp.maximum(on2[:, None] + kn2[None, :] - 2.0 * cross, 0.0)
            acc = jnp.minimum(acc, dd)
        du = pu[:, None] - ku_ref[ks][None, :]
        dv = pv[:, None] - kv_ref[ks][None, :]
        ok = (
            (du * du + dv * dv <= radius_sq)
            & pg[:, None]
            & (kok_ref[ks] > 0.0)[None, :]
        )
        acc = jnp.where(ok, acc, _BIG)
        loc_d = jnp.min(acc, axis=1)
        loc_k = jnp.argmin(acc, axis=1).astype(jnp.int32) + kt * tile_k
        better = loc_d < run_d
        return jnp.where(better, loc_d, run_d), jnp.where(better, loc_k, run_k)

    run_d, run_k = jax.lax.fori_loop(
        0,
        n_k,
        k_tile,
        (jnp.full((tile_p,), _BIG, jnp.float32), jnp.zeros((tile_p,), jnp.int32)),
    )
    bd_ref[...] = run_d
    bk_ref[...] = run_k


def _pad_rows(x: jnp.ndarray, n: int, fill) -> jnp.ndarray:
    if n == 0:
        return x
    return jnp.concatenate([x, jnp.full((n,) + x.shape[1:], fill, x.dtype)])


@partial(
    jax.jit,
    static_argnames=("radius_px", "tile_p", "tile_k", "num_warps"),
)
def guided_match_stage1(
    uv_p: jnp.ndarray,  # [P, 2]
    gate_p: jnp.ndarray,  # [P] bool
    obs_desc: jnp.ndarray,  # [P, O, D]
    obs_valid: jnp.ndarray,  # [P, O] bool
    kp_uv: jnp.ndarray,  # [K, 2]
    kp_desc: jnp.ndarray,  # [K, D]
    kp_ok: jnp.ndarray,  # [K] bool
    radius_px: float = 20.0,
    tile_p: int = 16,
    tile_k: int = 128,
    num_warps: int = 4,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-point best keypoint and squared descriptor distance.

    Returns (best_k [P] i32, best_d_sq [P] f32; _BIG and index 0 where no
    keypoint passes the gates), the stage-1 semantics of the XLA path.
    D must be a power of two of at least 16; P and K are padded here.
    """
    P, O, D = obs_desc.shape
    K = kp_uv.shape[0]
    pad_p = (-P) % tile_p
    pad_k = (-K) % tile_k
    Pp, Kp = P + pad_p, K + pad_k

    ob = obs_desc.astype(jnp.bfloat16)
    kb = kp_desc.astype(jnp.bfloat16)
    on2 = jnp.where(obs_valid, rounded_sq_norms(obs_desc), _BIG)
    kn2 = rounded_sq_norms(kp_desc)

    f32 = jnp.float32
    args = (
        _pad_rows(uv_p[:, 0].astype(f32), pad_p, 0),
        _pad_rows(uv_p[:, 1].astype(f32), pad_p, 0),
        _pad_rows(gate_p.astype(f32), pad_p, 0),
        _pad_rows(ob, pad_p, 0),
        _pad_rows(on2, pad_p, _BIG),
        _pad_rows(kp_uv[:, 0].astype(f32), pad_k, 1e7),
        _pad_rows(kp_uv[:, 1].astype(f32), pad_k, 1e7),
        _pad_rows(kp_ok.astype(f32), pad_k, 0),
        _pad_rows(kb, pad_k, 0),
        _pad_rows(kn2, pad_k, 0),
    )
    row = pl.BlockSpec((tile_p,), lambda i: (i,))
    whole_k = pl.BlockSpec((Kp,), lambda i: (0,))
    bk, bd = pl.pallas_call(
        partial(
            _kernel, n_obs=O, tile_k=tile_k, n_k=Kp // tile_k,
            radius_sq=radius_px * radius_px,
        ),
        grid=(Pp // tile_p,),
        in_specs=[
            row, row, row,
            pl.BlockSpec((tile_p, O, D), lambda i: (i, 0, 0)),
            pl.BlockSpec((tile_p, O), lambda i: (i, 0)),
            whole_k, whole_k, whole_k,
            pl.BlockSpec((Kp, D), lambda i: (0, 0)),
            whole_k,
        ],
        out_specs=[row, row],
        out_shape=[
            jax.ShapeDtypeStruct((Pp,), jnp.int32),
            jax.ShapeDtypeStruct((Pp,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        name="guided_match_stage1",
    )(*args)
    return bk[:P], bd[:P]
