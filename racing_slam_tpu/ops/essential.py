"""Essential-matrix estimation and decomposition, fully batched in JAX.

Batched replacement for cv::findEssentialMat / cv::decomposeEssentialMat
(reference: src/PoseEstimation.cpp:22-59, 73-79). We use the weighted
normalized 8-point algorithm expressed as a 9x9 symmetric eigenproblem so it
vmaps cleanly over RANSAC hypothesis batches, and SVD-based decomposition into
the four (R, t) candidates.

Coordinate convention: inputs are *normalized image-plane* coordinates
x = ((u-cx)/fx, (v-cy)/fy). E satisfies x2^T E x1 = 0 with E = [t]_x R where
X2 = R X1 + t maps camera-1-space points into camera-2 space — i.e. the
relative pose is pose2 @ pose1^{-1} when both are world->camera transforms.
"""

from __future__ import annotations

import jax.numpy as jnp

from .precision import f32_precision


def _homogeneous(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


@f32_precision
def eight_point(
    x1: jnp.ndarray, x2: jnp.ndarray, weights: jnp.ndarray
) -> jnp.ndarray:
    """Weighted 8-point estimate of E from normalized correspondences.

    Args:
      x1, x2: [N, 2] normalized image-plane coords in view 1 / view 2.
      weights: [N] nonneg weights (0 = ignore). Use a one-hot-8 vector for a
        minimal sample, or an inlier mask for refit.
    Returns: [3, 3] essential matrix with the (1,1,0) singular structure
      enforced.
    """
    # Weighted isotropic (Hartley-style) conditioning.
    wsum = jnp.sum(weights) + 1e-12
    m1 = jnp.sum(weights[:, None] * x1, axis=0) / wsum
    m2 = jnp.sum(weights[:, None] * x2, axis=0) / wsum
    d1 = jnp.sum(weights * jnp.linalg.norm(x1 - m1, axis=-1)) / wsum
    d2 = jnp.sum(weights * jnp.linalg.norm(x2 - m2, axis=-1)) / wsum
    s1 = jnp.sqrt(2.0) / (d1 + 1e-12)
    s2 = jnp.sqrt(2.0) / (d2 + 1e-12)
    n1 = (x1 - m1) * s1
    n2 = (x2 - m2) * s2

    h1 = _homogeneous(n1)  # [N, 3]
    h2 = _homogeneous(n2)
    # Constraint rows: kron(h2, h1) so that A @ vec(E') = 0 with h2^T E' h1 = 0.
    A = (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9)  # [N, 9]
    AtA = jnp.einsum("ni,nj->ij", A * weights[:, None], A)
    _, vecs = jnp.linalg.eigh(AtA)
    En = vecs[:, 0].reshape(3, 3)

    # Undo conditioning: h2^T En h1 = (T2 x2)^T En (T1 x1) => E = T2^T En T1.
    T1 = jnp.array([[s1, 0.0, -s1 * m1[0]], [0.0, s1, -s1 * m1[1]], [0.0, 0.0, 1.0]])
    T2 = jnp.array([[s2, 0.0, -s2 * m2[0]], [0.0, s2, -s2 * m2[1]], [0.0, 0.0, 1.0]])
    E = T2.T @ En @ T1

    # Project onto the essential manifold: singular values -> (1, 1, 0).
    U, _, Vt = jnp.linalg.svd(E)
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype=E.dtype)) @ Vt


@f32_precision
def sampson_error_sq(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Squared Sampson distance [N] in normalized-plane units.

    Matches OpenCV's RANSAC scoring model for findEssentialMat.
    """
    h1 = _homogeneous(x1)  # [N, 3]
    h2 = _homogeneous(x2)
    Ex1 = h1 @ E.T  # [N, 3] = (E @ h1^T)^T
    Etx2 = h2 @ E  # [N, 3] = (E^T @ h2^T)^T
    num = jnp.sum(h2 * Ex1, axis=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-18)


@f32_precision
def decompose(E: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """E -> four (R, t) candidates.

    Returns (R[4, 3, 3], t[4, 3]): {R1, R1, R2, R2} x {t, -t}, the same
    candidate set the reference enumerates from cv::decomposeEssentialMat
    (src/PoseEstimation.cpp:28-36). t is unit-norm.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Keep rotations proper.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts
