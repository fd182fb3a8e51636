"""Dense masked feature matching: frame-to-frame and map-to-frame.

Static-shape replacement for the reference matchers:

- frame<->frame: cv::BFMatcher 1-NN with cross-check + distance gate
  (src/features/FeatureExtractor.cpp:9-24) becomes one dense [K1, K2]
  distance matrix (a single matmul for L2-normalized descriptors) with
  argmin reductions both ways and a mutuality test.

- map->frame: the reference's per-point loop (project -> KD-tree 20 px radius
  query -> compare against ALL observations of the point -> best keypoint per
  point -> best point per keypoint with de-dup,
  src/features/FeatureExtractor.cpp:26-92) becomes a masked [P, K] min
  reduction: the KD-tree is replaced by a projected-distance mask (<= 20 px,
  src/features/FeatureExtractor.cpp:55), the observation comparison by a min
  over the point's O stored descriptors, and the two greedy reductions by
  argmin over K then scatter-min over P. The XLA path chunks over P to bound
  the [chunk*O, K] intermediates; on a GPU the fused Pallas kernel
  (ops/pallas/match_kernel.py) keeps them in registers instead.

Outputs are static-shape index arrays with validity masks (no compaction).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .camera import Camera, is_in_image, project_with_depth
from .pallas import resolve_backend
from .precision import f32_precision

SEARCH_RADIUS_PX = 20.0  # FeatureExtractor.cpp:55
_BIG = jnp.float32(1e9)


class FrameMatches(NamedTuple):
    """Per-query-keypoint match into the train (previous) frame."""

    train_idx: jnp.ndarray  # [K2] i32 index into frame-1 keypoints
    distance: jnp.ndarray  # [K2] f32
    valid: jnp.ndarray  # [K2] bool


class MapMatches(NamedTuple):
    """Per-keypoint match into the map."""

    point_idx: jnp.ndarray  # [K] i32 map-point slot (undefined where ~valid)
    distance: jnp.ndarray  # [K] f32
    valid: jnp.ndarray  # [K] bool


def rounded_sq_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 norms over the last axis of x rounded to bf16.

    The distance cross term multiplies bf16-rounded vectors, so the norms
    must be of the same rounded vectors for the squared distance to be
    exact. `reduce_precision` does the rounding: XLA's GPU compiler may drop
    an f32->bf16->f32 convert pair as excess precision, but it keeps this.
    """
    r = jax.lax.reduce_precision(x.astype(jnp.float32), exponent_bits=8,
                                 mantissa_bits=7)
    return jnp.sum(r * r, axis=-1)


def _pairwise_sq_dists(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """[N1, D], [N2, D] -> [N1, N2] squared L2 distances via one matmul.

    The cross term is a bf16 matmul with f32 accumulation: descriptors are
    unit vectors, so the ~0.4% bf16 input rounding moves squared distances
    by <~1e-2 — far below the match gate (0.64) and the separation between
    true and distractor matches. Norms stay f32. The products of bf16
    operands are exact in f32, so the explicit DEFAULT precision loses
    nothing against the callers' `highest` context; it keeps the product on
    the tensor cores instead of an f32 upcast.
    """
    b1 = d1.astype(jnp.bfloat16)
    b2 = d2.astype(jnp.bfloat16)
    n1 = rounded_sq_norms(d1)  # norms of the ROUNDED vectors: exact distances,
    n2 = rounded_sq_norms(d2)  # and the XLA and Pallas backends agree
    cross = jax.lax.dot_general(
        b1,
        b2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    return jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * cross, 0.0)


@f32_precision
def match_frames(
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid2: jnp.ndarray,
    max_distance: float,
) -> FrameMatches:
    """Mutual 1-NN descriptor matching with a distance gate.

    Mirrors BaseFeatureExtractor::match_features(prev, cur)
    (src/features/FeatureExtractor.cpp:9-24): queries are frame-2 keypoints,
    trains are frame-1; a match survives iff it is the nearest neighbour in
    BOTH directions (BFMatcher crossCheck) and dist < max_distance.
    """
    d2 = _pairwise_sq_dists(desc1, desc2)  # [K1, K2]
    d2 = jnp.where(valid1[:, None] & valid2[None, :], d2, _BIG)

    best1_for_2 = jnp.argmin(d2, axis=0)  # [K2] train index per query
    best2_for_1 = jnp.argmin(d2, axis=1)  # [K1] query index per train
    mutual = best2_for_1[best1_for_2] == jnp.arange(d2.shape[1])
    dist = jnp.sqrt(jnp.take_along_axis(d2, best1_for_2[None, :], axis=0)[0])
    ok = mutual & (dist < max_distance) & valid2
    return FrameMatches(train_idx=best1_for_2, distance=dist, valid=ok)


@partial(
    jax.jit,
    static_argnames=("chunk", "max_distance", "radius_px", "backend"),
)
@f32_precision
def match_map_to_frame(
    cam: Camera,
    pose: jnp.ndarray,
    point_xyz: jnp.ndarray,
    point_mask: jnp.ndarray,
    obs_desc: jnp.ndarray,
    obs_valid: jnp.ndarray,
    kp_uv: jnp.ndarray,
    kp_desc: jnp.ndarray,
    kp_valid: jnp.ndarray,
    kp_already_matched: jnp.ndarray,
    point_already_matched: jnp.ndarray,
    max_distance: float,
    radius_px: float = SEARCH_RADIUS_PX,
    chunk: int = 1024,
    backend: str = "auto",
) -> MapMatches:
    """Match map points into a frame by guided projection search.

    Equivalent of the reference map->frame matcher
    (src/features/FeatureExtractor.cpp:26-92) with the KD-tree replaced by a
    dense projected-distance gate.

    Args:
      pose: [4, 4] current frame pose (world->camera).
      point_xyz: [P, 3]; point_mask: [P] bool (valid & caller filter, e.g.
        observed-by-last-keyframe — src/Slam.cpp:138-150).
      obs_desc: [P, O, D] stored descriptors of each point's observations.
      obs_valid: [P, O] bool.
      kp_uv/kp_desc/kp_valid: [K, 2], [K, D], [K] current frame features.
      kp_already_matched: [K] bool — keypoints with existing map matches
        (final de-dup, FeatureExtractor.cpp:83-91).
      point_already_matched: [P] bool — points already matched in this frame.
      backend: "auto" = the fused Pallas kernel on a GPU, the chunked XLA
        path elsewhere; "pallas" / "xla" force one (see
        ops.pallas.resolve_backend).
    Returns per-keypoint MapMatches.
    """
    P = point_xyz.shape[0]
    K = kp_uv.shape[0]

    uv_p, depth = project_with_depth(cam, pose, point_xyz)  # [P, 2], [P]
    gate_p = (
        point_mask
        & ~point_already_matched
        & is_in_image(cam, uv_p)
        & (depth > 0.0)
    )

    kp_ok = kp_valid & ~kp_already_matched  # [K]
    args = (uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok)
    if resolve_backend(backend) == "pallas":
        from .pallas.match_kernel import guided_match_stage1

        best_k, best_d = guided_match_stage1(*args, radius_px=radius_px)
    else:
        best_k, best_d = guided_match_stage1_xla(
            *args, radius_px=radius_px, chunk=chunk
        )
    best_d = jnp.sqrt(jnp.minimum(best_d, _BIG))
    best_d = jnp.where(best_d < max_distance, best_d, _BIG)
    return _stage2(best_k, best_d, P, K)


def guided_match_stage1_xla(
    uv_p: jnp.ndarray,
    gate_p: jnp.ndarray,
    obs_desc: jnp.ndarray,
    obs_valid: jnp.ndarray,
    kp_uv: jnp.ndarray,
    kp_desc: jnp.ndarray,
    kp_ok: jnp.ndarray,
    radius_px: float = SEARCH_RADIUS_PX,
    chunk: int = 1024,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stage 1 (reference :58-75) in plain XLA: best keypoint per point.

    uv_p [P, 2] projected points, gate_p [P], obs_desc [P, O, D],
    obs_valid [P, O], kp_uv [K, 2], kp_desc [K, D], kp_ok [K]. Returns
    (best_k [P] i32, best squared distance [P] f32, _BIG where no keypoint
    passes the gates). Chunked over P to bound the [chunk*O, K] distance
    block; ops/pallas/match_kernel.py is the fused equivalent.
    """
    P, O, _ = obs_desc.shape
    K = kp_uv.shape[0]
    r2 = radius_px * radius_px
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P

    def pad0(x, fill=0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        ) if pad else x

    uv_pc = pad0(uv_p).reshape(n_chunks, chunk, 2)
    gate_pc = pad0(gate_p, False).reshape(n_chunks, chunk)
    obs_desc_c = pad0(obs_desc).reshape(n_chunks, chunk, O, -1)
    obs_valid_c = pad0(obs_valid, False).reshape(n_chunks, chunk, O)

    def per_chunk(args):
        uv_c, g_c, od_c, ov_c = args
        # Pixel gating [chunk, K].
        duv = uv_c[:, None, :] - kp_uv[None, :, :]
        px_ok = jnp.sum(duv * duv, axis=-1) <= r2
        # Descriptor distances: min over the point's observations.
        dd = _pairwise_sq_dists(od_c.reshape(chunk * O, -1), kp_desc)
        dd = dd.reshape(chunk, O, K)
        dd = jnp.where(ov_c[:, :, None], dd, _BIG)
        dd = jnp.min(dd, axis=1)  # [chunk, K]
        dd = jnp.where(px_ok & g_c[:, None] & kp_ok[None, :], dd, _BIG)
        best_k = jnp.argmin(dd, axis=-1)  # [chunk]
        best_d = jnp.min(dd, axis=-1)
        return best_k.astype(jnp.int32), best_d

    best_k, best_d = jax.lax.map(
        per_chunk, (uv_pc, gate_pc, obs_desc_c, obs_valid_c)
    )
    return best_k.reshape(-1)[:P], best_d.reshape(-1)[:P]


def _stage2(best_k: jnp.ndarray, best_d: jnp.ndarray, P: int, K: int) -> MapMatches:
    """Stage 2 (reference :76-80): best point per keypoint via scatter-min,
    winner id = lowest point index among the distance minimizers."""
    kp_best_d = jnp.full((K,), _BIG).at[best_k].min(best_d)
    pid = jnp.arange(P, dtype=jnp.int32)
    is_winner = best_d <= kp_best_d[best_k]
    kp_point = (
        jnp.full((K,), jnp.int32(P))
        .at[best_k]
        .min(jnp.where(is_winner & (best_d < _BIG), pid, jnp.int32(P)))
    )
    valid = (kp_best_d < _BIG) & (kp_point < P)
    return MapMatches(
        point_idx=jnp.where(valid, kp_point, -1),
        distance=kp_best_d,
        valid=valid,
    )


def unmatched_mask(
    matches: FrameMatches,
    kp1_matched: jnp.ndarray,
    kp2_matched: jnp.ndarray,
) -> jnp.ndarray:
    """Filter frame-matches whose endpoints already have map associations.

    Equivalent of features::unmatched_features
    (src/features/FeatureExtractor.cpp:94-105): keeps matches where neither
    the train keypoint (frame 1) nor the query keypoint (frame 2) is matched
    to a map point.
    """
    t = matches.train_idx
    return matches.valid & ~kp1_matched[t] & ~kp2_matched[jnp.arange(t.shape[0])]
