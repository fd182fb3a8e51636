"""Batched two-view DLT triangulation with validity filtering.

Batched replacement for the reference triangulation path
(src/Triangulation.cpp:37-98, which wraps cv::triangulatePoints): instead of
per-point SVD on dynamically-sized vectors, we triangulate ALL matches at once
as a batched 4x4 symmetric eigenproblem and return a static-shape validity
mask instead of a compacted list.

Filters reproduce the reference exactly:
  - behind-either-camera:     z < 0 in either view   (Triangulation.cpp:67-73)
  - low parallax:             cos(angle) > 0.9999    (Triangulation.cpp:76-81)
  - reprojection error:       > 2 px in either view  (Triangulation.cpp:84-92)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .precision import f32_precision

from . import se3
from .ba import inv3x3
from .camera import Camera, project_camera_points, projection_matrix

MAX_PARALLAX_COS = 0.9999  # Triangulation.cpp:80
MAX_REPROJ_ERR_PX = 2.0  # Triangulation.cpp:90


class Triangulated(NamedTuple):
    """Static-shape result: one slot per input match."""

    points: jnp.ndarray  # [N, 3] world positions (garbage where ~valid)
    valid: jnp.ndarray  # [N] bool — passed all filters (and input mask)


def _dlt_inhomogeneous(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """Linear triangulation for a batch of correspondences.

    P1, P2: [3, 4] projection matrices; uv1, uv2: [N, 2] pixels.
    Returns Euclidean points [N, 3].

    A is the standard DLT stack (u * P[2] - P[0]; v * P[2] - P[1]) per view.
    Instead of the homogeneous null-space (cv::triangulatePoints solves it by
    per-point SVD; a batched jnp.linalg.eigh over [N, 4, 4] is an iterative
    solver per point), fix w = 1 and solve the 3-unknown least squares
    A[:, :3] X = -A[:, 3] via closed-form 3x3 normal equations (adjugate
    inverse) — elementwise arithmetic, no batched eigensolver. The
    inhomogeneous form only degrades for points at infinity, which the
    parallax and reprojection filters below reject anyway
    (src/Triangulation.cpp:76-92).
    """
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        rows.append(u * P[2] - P[0])  # [N, 4]
        rows.append(v * P[2] - P[1])
    A = jnp.stack(rows, axis=-2)  # [N, 4, 4]
    # Row-normalize for conditioning before forming normal equations.
    A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    B = A[..., :, :3]  # [N, 4, 3]
    b = -A[..., :, 3]  # [N, 4]
    BtB = jnp.einsum("...ki,...kj->...ij", B, B)  # [N, 3, 3]
    Btb = jnp.einsum("...ki,...k->...i", B, b)  # [N, 3]
    return jnp.einsum("...ij,...j->...i", inv3x3(BtB), Btb)


@f32_precision
def triangulate_points(
    cam: Camera,
    pose1: jnp.ndarray,
    pose2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    max_reproj_px: float = MAX_REPROJ_ERR_PX,
) -> Triangulated:
    """Triangulate N pixel correspondences between two posed views.

    Equivalent of triangulation::triangulate_points
    (src/Triangulation.cpp:37-98) with mask-style outputs.

    Args:
      cam: pinhole camera shared by both views.
      pose1, pose2: [4, 4] world->camera transforms.
      uv1, uv2: [N, 2] pixel coordinates.
      mask: optional [N] bool of which correspondences are real (padding -> False).
      max_reproj_px: acceptance gate of filter 3 (reference hard-codes 2 px
        at ITS native resolution, src/Triangulation.cpp:90; a fixed pixel
        gate is angularly 1.5x stricter at 720p than at 480p, so
        resolution-scaled configs pass a scaled value).
    """
    P1 = projection_matrix(cam, pose1)
    P2 = projection_matrix(cam, pose2)
    X = _dlt_inhomogeneous(P1, P2, uv1, uv2)

    Xc1 = se3.transform_points(pose1, X)
    Xc2 = se3.transform_points(pose2, X)

    # Filter 1: behind either camera (Triangulation.cpp:67-73).
    in_front = (Xc1[..., 2] > 0.0) & (Xc2[..., 2] > 0.0)

    # Filter 2: parallax (Triangulation.cpp:76-81).
    c1 = se3.camera_center(pose1)
    c2 = se3.camera_center(pose2)
    d1 = c1 - X
    d2 = c2 - X
    d1n = d1 / (jnp.linalg.norm(d1, axis=-1, keepdims=True) + 1e-12)
    d2n = d2 / (jnp.linalg.norm(d2, axis=-1, keepdims=True) + 1e-12)
    cos_parallax = jnp.sum(d1n * d2n, axis=-1)
    has_parallax = cos_parallax <= MAX_PARALLAX_COS

    # Filter 3: reprojection error in both views (Triangulation.cpp:84-92).
    r1 = jnp.linalg.norm(project_camera_points(cam, Xc1) - uv1, axis=-1)
    r2 = jnp.linalg.norm(project_camera_points(cam, Xc2) - uv2, axis=-1)
    reproj_ok = (r1 <= max_reproj_px) & (r2 <= max_reproj_px)

    valid = in_front & has_parallax & reproj_ok
    if mask is not None:
        valid = valid & mask
    return Triangulated(points=X, valid=valid)
