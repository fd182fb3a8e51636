"""Vmapped hypothesis-batch RANSAC for relative pose from 2D-2D matches.

Static-shape replacement for cv::findEssentialMat(RANSAC) + the reference's
cheirality disambiguation (src/PoseEstimation.cpp:22-59, 61-93). Instead of a
sequential adaptive RANSAC loop, a fixed batch of H hypotheses is estimated
and scored in parallel (one vmapped 8-point solve + Sampson scoring per
hypothesis), the winner refit on its inliers, and the four (R, t)
decompositions disambiguated by batched triangulation cheirality counts —
the same accept criteria the reference uses (all three triangulation filters,
src/Triangulation.cpp:60-95).

Reference RANSAC parameters: confidence 0.999, threshold 0.4 px
(src/PoseEstimation.cpp:73-79). Matching that confidence with 8-point minimal
samples (vs the reference's 5-point) takes a bigger batch: at 50% inliers
1-(1-0.5^8)^H is ≈0.87 for H=512 but ≈0.9997 for H=2048, and the whole batch
is one fused launch either way. The pipeline uses H=2048 for the
once-per-bootstrap solve (SlamConfig.init_ransac_hypotheses, the
accuracy-critical path, tested at 50% outliers over 100 seeds in
tests/test_essential_ransac.py) and H=512 for the optional per-frame pose
seed that motion BA immediately refines.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import se3
from .camera import Camera, normalize_pixels
from .essential import decompose, eight_point, sampson_error_sq
from .triangulation import triangulate_points

DEFAULT_NUM_HYPOTHESES = 512
DEFAULT_THRESHOLD_PX = 0.4  # PoseEstimation.cpp:78
MIN_SAMPLE = 8


class PoseEstimate(NamedTuple):
    """Relative pose estimate: X2 = R X1 + t (unit baseline)."""

    pose: jnp.ndarray  # [4, 4] relative transform cam1 -> cam2
    essential: jnp.ndarray  # [3, 3]
    inliers: jnp.ndarray  # [N] bool
    num_inliers: jnp.ndarray  # i32 scalar


def _sample_minimal_weights(
    key: jax.Array, mask: jnp.ndarray, num_hypotheses: int
) -> jnp.ndarray:
    """[H, N] one-hot-8 weight rows selecting uniform random valid 8-subsets.

    Uses the Gumbel-top-k trick: top-8 of iid uniforms restricted to valid
    entries is a uniform random 8-subset — fully parallel, no rejection loop.
    """
    n = mask.shape[0]
    u = jax.random.uniform(key, (num_hypotheses, n))
    u = jnp.where(mask[None, :], u, -jnp.inf)

    # Select the top-8 by 8 rounds of argmax + mask-out: identical subset
    # distribution to lax.top_k, built from plain reductions instead of a
    # sort over the large trailing dim.
    def body(_, carry):
        u, w = carry
        idx = jnp.argmax(u, axis=-1)  # [H]
        onehot = jax.nn.one_hot(idx, n, dtype=u.dtype)  # [H, N]
        return jnp.where(onehot > 0.0, -jnp.inf, u), w + onehot

    _, weights = jax.lax.fori_loop(
        0, MIN_SAMPLE, body, (u, jnp.zeros_like(u))
    )
    return weights


@partial(jax.jit, static_argnames=("num_hypotheses", "threshold_px"))
def estimate_relative_pose(
    cam: Camera,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    num_hypotheses: int = DEFAULT_NUM_HYPOTHESES,
    threshold_px: float = DEFAULT_THRESHOLD_PX,
) -> PoseEstimate:
    """Estimate the relative pose between two views from pixel matches.

    Equivalent of pose::estimate_pose (src/PoseEstimation.cpp:61-93):
    RANSAC essential matrix + 4-way cheirality disambiguation. The returned
    pose composes like the reference: pose_frame2 = pose @ pose_frame1.

    Args:
      uv1, uv2: [N, 2] matched pixel coordinates (padded rows arbitrary).
      mask: [N] bool validity of each match row.
      key: PRNG key for hypothesis sampling.
    """
    x1 = normalize_pixels(cam, uv1)
    x2 = normalize_pixels(cam, uv2)
    # Pixel threshold -> normalized plane (OpenCV divides by mean focal).
    thresh = threshold_px / (0.5 * (cam.fx + cam.fy))
    thresh_sq = thresh * thresh

    # --- Hypothesis batch ----------------------------------------------------
    weights = _sample_minimal_weights(key, mask, num_hypotheses)  # [H, N]
    Es = jax.vmap(lambda w: eight_point(x1, x2, w))(weights)  # [H, 3, 3]
    errs = jax.vmap(lambda E: sampson_error_sq(E, x1, x2))(Es)  # [H, N]
    inl = (errs < thresh_sq) & mask[None, :]
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)

    # --- Local optimization: IRLS refit from the winning hypothesis ---------
    # A single least-squares refit on the winner's inlier set is fragile: a
    # few gross outliers that slip under the threshold dominate the normal
    # equations. Instead run a few iteratively-reweighted refits with Cauchy
    # weights sigma^2 / (sigma^2 + err^2) seeded from the best minimal-sample
    # E (LO-RANSAC style), which downweights gross outliers smoothly.
    def irls_step(_, E):
        err = sampson_error_sq(E, x1, x2)
        w = jnp.where(mask, thresh_sq / (thresh_sq + err), 0.0)
        return eight_point(x1, x2, w)

    E = jax.lax.fori_loop(0, 4, irls_step, Es[best])
    final_err = sampson_error_sq(E, x1, x2)
    inliers = (final_err < thresh_sq) & mask
    num_inliers = jnp.sum(inliers)

    # --- Cheirality: pick the (R, t) with the most valid triangulations -----
    Rs, ts = decompose(E)  # [4, 3, 3], [4, 3]
    eye = jnp.eye(4, dtype=jnp.float32)

    def count_valid(R, t):
        rel = eye.at[:3, :3].set(R).at[:3, 3].set(t)
        tri = triangulate_points(cam, eye, rel, uv1, uv2, mask=inliers)
        return jnp.sum(tri.valid), rel

    counts, rels = jax.vmap(count_valid)(Rs, ts)
    pose = rels[jnp.argmax(counts)]
    return PoseEstimate(pose=pose, essential=E, inliers=inliers, num_inliers=num_inliers)


def compose_with_previous(rel_pose: jnp.ndarray, prev_pose: jnp.ndarray) -> jnp.ndarray:
    """frame.pose = rel * prev.pose (reference: src/Slam.cpp:131)."""
    return se3.compose(rel_pose, prev_pose)
