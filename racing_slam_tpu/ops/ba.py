"""Levenberg-Marquardt bundle adjustment with explicit Schur complement.

Static-shape replacement for the reference's Ceres solve
(src/Optimization.cpp:83-186, SPARSE_SCHUR, <=10 iterations). Design:

- Residual IDENTICAL to the reference (src/Optimization.cpp:24-43):
  normalized-plane error  p[:2]/p[2] - (obs - principal_point)/focal,
  with p = exp(rvec) X + t, focal = fx ONLY (the reference passes K(0,0)
  and ignores fy in the residual — src/Optimization.cpp:129-134), and
  Huber loss with delta = sqrt(5.991) (src/Optimization.cpp:136) applied
  via IRLS weights.
- Same parametrization Ceres autodiffs: global angle-axis rvec + t per
  camera, xyz per point; Jacobians by forward-mode autodiff (jacfwd) on the
  packed 9-vector, vmapped over the observation table — exact, not a local
  perturbation approximation.
- Freeze semantics reproduce FrameConfig / optimize_points
  (src/Optimization.cpp:103-146): frozen cameras/points contribute residuals
  as anchors but receive no update; points enter the problem only if
  observed by a free camera; residuals are included only for in-problem
  cameras observing in-problem points.
- Structure exploitation: per-point 3x3 Hessian blocks are eliminated in
  closed form (batched adjugate inverse), camera-camera coupling is
  scatter-added into a dense [F*6, F*6] reduced system (cameras are few),
  solved replicated. The reduced-system builder (`build_reduced_system`) is
  a pure function of a landmark shard so the distributed path can psum its
  outputs across shards (parallel/dist_ba.py).

Observation storage is point-major [P, O] (O = max observations per point),
mirroring MapPoint::m_observations (src/MapPoint.h:28) as a padded SoA table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import se3
from .camera import Camera
from .pallas import resolve_backend
from .precision import f32_precision

HUBER_DELTA = float(jnp.sqrt(5.991))  # Optimization.cpp:136
MAX_ITERS = 10  # Optimization.cpp:153
# Ceres Solver::Options::function_tolerance default — LM stops once an
# accepted step improves the cost by less than this fraction. The reference
# relies on it implicitly (it never overrides the default); it turns the
# fixed 10-iteration loop into a while_loop that typically exits in 3-5.
FUNCTION_TOLERANCE = 1e-6

# NOTE on robust scale: the reference applies HuberLoss(sqrt(5.991)) to a
# residual expressed in NORMALIZED-plane units (pixels / fx), so the loss
# only engages beyond ~2.45 rad — i.e. effectively never. We reproduce that
# default for parity, but every solver below takes a `huber_delta` so the
# pipeline can pass a pixel-meaningful scale (e.g. sqrt(5.991)/fx).


# ---------------------------------------------------------------------------
# Residual + robust weights
# ---------------------------------------------------------------------------


def _residual(rvec, t, X, uv, fx, cx, cy):
    """2-vector normalized-plane reprojection residual (Optimization.cpp:24-43)."""
    p = se3.exp_so3(rvec) @ X + t
    z = p[2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    nx = (uv[0] - cx) / fx
    ny = (uv[1] - cy) / fx  # fx only, like the reference caller
    return jnp.stack([p[0] / z_safe - nx, p[1] / z_safe - ny])


def _residual_packed(params9, uv, fx, cx, cy):
    return _residual(params9[:3], params9[3:6], params9[6:9], uv, fx, cx, cy)


def huber_weight(sq_norm: jnp.ndarray, delta: float = HUBER_DELTA) -> jnp.ndarray:
    """IRLS weight rho'(s) for Ceres HuberLoss: 1 inside, delta/|r| outside."""
    norm = jnp.sqrt(sq_norm + 1e-18)
    return jnp.where(sq_norm <= delta * delta, 1.0, delta / norm)


def huber_cost(sq_norm: jnp.ndarray, delta: float = HUBER_DELTA) -> jnp.ndarray:
    """Ceres HuberLoss rho(s): s inside, 2 delta sqrt(s) - delta^2 outside."""
    b = delta * delta
    return jnp.where(
        sq_norm <= b, sq_norm, 2.0 * delta * jnp.sqrt(sq_norm + 1e-18) - b
    )


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form (adjugate) 3x3 inverse; [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def solve6_spd(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Solve the (damped, SPD) 6x6 system H x = g in closed form.

    jnp.linalg.solve lowers a 6x6 LU with pivoting to a long serial scalar
    chain (on a GPU, a pivoting LU library call per LM iteration). Block
    elimination with two closed-form 3x3 inverses is a short straight-line
    program instead:
        H = [[A, B], [B^T, C]],  S = C - B^T A^-1 B
        x2 = S^-1 (g2 - B^T A^-1 g1),  x1 = A^-1 (g1 - B x2).
    Valid because LM damping keeps H (and hence A and S) positive definite.
    Batched over leading dims.
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    g1 = g[..., :3]
    g2 = g[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B  # [..., 3, 3]
    S = C - jnp.swapaxes(B, -1, -2) @ AinvB
    Sinv = inv3x3(S)
    rhs2 = g2 - jnp.einsum("...ij,...i->...j", AinvB, g1)
    x2 = jnp.einsum("...ij,...j->...i", Sinv, rhs2)
    x1 = jnp.einsum("...ij,...j->...i", Ainv, g1) - jnp.einsum(
        "...ij,...j->...i", AinvB, x2
    )
    return jnp.concatenate([x1, x2], axis=-1)


# ---------------------------------------------------------------------------
# Motion-only BA: one free pose, all points constant
# ---------------------------------------------------------------------------


class MotionBAResult(NamedTuple):
    rvec: jnp.ndarray  # [3]
    t: jnp.ndarray  # [3]
    cost: jnp.ndarray  # final robust cost (scalar)
    num_residuals: jnp.ndarray  # i32


@f32_precision
def motion_ba(
    cam: Camera,
    rvec: jnp.ndarray,
    t: jnp.ndarray,
    kp_uv: jnp.ndarray,
    point_xyz: jnp.ndarray,
    valid: jnp.ndarray,
    max_iters: int = MAX_ITERS,
    huber_delta: float = HUBER_DELTA,
    backend: str = "auto",
) -> MotionBAResult:
    """Optimize a single pose against fixed 3D points.

    Equivalent of the reference optimize_pose path (src/Slam.cpp:165-175 with
    OptimizationConfig{optimize_points=false, frames={current}}): the only
    residuals are the current frame's map matches, point positions constant.

    Args:
      kp_uv: [K, 2] matched keypoint pixels.
      point_xyz: [K, 3] matched map point positions (already gathered).
      valid: [K] bool — row participates.
      backend: "auto" = the fused single-program Pallas LM loop
        (ops/pallas/motion_ba_kernel.py) on a GPU, this function's
        while_loop elsewhere; "pallas" / "xla" force one (see
        ops.pallas.resolve_backend).
    """
    if resolve_backend(backend) == "pallas":
        from .pallas.motion_ba_kernel import motion_ba_fused

        out = motion_ba_fused(
            cam, rvec, t, kp_uv, point_xyz, valid, max_iters,
            float(huber_delta), FUNCTION_TOLERANCE,
        )
        return MotionBAResult(
            rvec=out[:3], t=out[3:6], cost=out[6], num_residuals=jnp.sum(valid)
        )
    fx, cx, cy = cam.fx, cam.cx, cam.cy
    K = kp_uv.shape[0]
    n_res = jnp.sum(valid)

    def terms(rv, tt):
        rvb = jnp.broadcast_to(rv, (K, 3))
        ttb = jnp.broadcast_to(tt, (K, 3))
        return residual_and_jacobians(rvb, ttb, point_xyz, kp_uv, fx, cx, cy)

    def robust_cost(rv, tt):
        r, _, _ = terms(rv, tt)
        s = jnp.sum(r * r, axis=-1)
        return jnp.sum(jnp.where(valid, huber_cost(s, huber_delta), 0.0))

    def cond_fn(state):
        _, _, _, _, it, done = state
        return (it < max_iters) & ~done

    def body(state):
        rv, tt, lam, cost, it, _ = state
        r, J, _ = terms(rv, tt)  # [K, 2], [K, 2, 6]
        s = jnp.sum(r * r, axis=-1)
        w = jnp.where(valid, huber_weight(s, huber_delta), 0.0)  # [K]
        Jw = J * w[:, None, None]
        H = jnp.einsum("kri,krj->ij", Jw, J)  # [6, 6]
        g = jnp.einsum("kri,kr->i", Jw, r)  # [6]
        D = jnp.diag(jnp.diagonal(H)) + 1e-9 * jnp.eye(6)
        delta = -solve6_spd(H + lam * D, g)
        rv_new = rv + delta[:3]
        tt_new = tt + delta[3:]
        new_cost = robust_cost(rv_new, tt_new)
        accept = new_cost < cost
        # Ceres function_tolerance: an accepted step that barely improves
        # means converged; a damping blow-up means stuck.
        done = (accept & (cost - new_cost <= FUNCTION_TOLERANCE * cost)) | (
            lam > 1e8
        )
        rv = jnp.where(accept, rv_new, rv)
        tt = jnp.where(accept, tt_new, tt)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), lam * 2.0)
        cost = jnp.where(accept, new_cost, cost)
        return (rv, tt, lam, cost, it + 1, done)

    cost0 = robust_cost(rvec, t)
    rv, tt, _, cost, _, _ = jax.lax.while_loop(
        cond_fn,
        body,
        (rvec, t, jnp.float32(1e-4), cost0, jnp.int32(0), jnp.bool_(False)),
    )
    return MotionBAResult(rvec=rv, t=tt, cost=cost, num_residuals=n_res)


# ---------------------------------------------------------------------------
# Full BA: Schur-complement LM over keyframes + points
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem.

    F cameras, P points, O max observations per point.
    """

    cam_rvec: jnp.ndarray  # [F, 3]
    cam_t: jnp.ndarray  # [F, 3]
    points: jnp.ndarray  # [P, 3]
    obs_cam: jnp.ndarray  # [P, O] i32 camera index per observation
    obs_uv: jnp.ndarray  # [P, O, 2] observed pixels
    obs_valid: jnp.ndarray  # [P, O] bool
    cam_free: jnp.ndarray  # [F] bool — pose receives updates
    cam_in_problem: jnp.ndarray  # [F] bool — camera's residuals included
    point_free: jnp.ndarray  # [P] bool — position receives updates
    point_in_problem: jnp.ndarray  # [P] bool — point's residuals included


class BAResult(NamedTuple):
    cam_rvec: jnp.ndarray
    cam_t: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray
    num_residuals: jnp.ndarray


class ReducedSystem(NamedTuple):
    """Output of landmark elimination — psum-able across landmark shards."""

    S: jnp.ndarray  # [F, F, 6, 6] reduced camera Hessian
    g_red: jnp.ndarray  # [F, 6] reduced gradient
    # Per-point data needed for back-substitution (stays shard-local):
    Hpp_inv: jnp.ndarray  # [P, 3, 3] damped inverse (zero for frozen points)
    g_p: jnp.ndarray  # [P, 3]
    W: jnp.ndarray  # [P, O, 6, 3] camera-point coupling blocks


def right_jacobian_so3(v: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian J_r of SO(3) at v [..., 3] -> [..., 3, 3].

    J_r(v) = I - (1-cos t)/t^2 [v]x + (t - sin t)/t^3 [v]x^2, Taylor-safe.
    Used for the exact derivative of the angle-axis rotation action:
    d(exp(v) X)/dv = -exp(v) [X]x J_r(v).
    """
    theta2 = jnp.sum(v * v, axis=-1)
    theta = jnp.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    A = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + 1e-24))
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta + 1e-24)
    )
    V = se3.hat(v)
    VV = V @ V
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), V.shape)
    return eye - A[..., None, None] * V + B[..., None, None] * VV


def residual_and_jacobians(rv, tt, X, uv, fx, cx, cy):
    """Analytic residual + Jacobians, batched over leading dims.

    rv, tt, X: [..., 3]; uv: [..., 2].
    Returns r [..., 2], J_c [..., 2, 6] (d r / d[rvec, t]), J_p [..., 2, 3].
    Exactly matches jacfwd of _residual_packed (verified in tests) at ~1/6
    the FLOPs — this is the hot inner loop of every LM iteration.

    Everything is hand-expanded to scalar arithmetic on [...] component
    vectors. The mathematically identical matrix formulation (R @ hat(X) @
    J_r chains over [..., 3, 3]) lowers to batched 3x3 dot_generals with
    tiny contraction dims and stacked intermediates in device memory; the
    scalar form fuses into elementwise kernels.
    """
    wx, wy, wz = rv[..., 0], rv[..., 1], rv[..., 2]
    Xx, Xy, Xz = X[..., 0], X[..., 1], X[..., 2]
    theta2 = wx * wx + wy * wy + wz * wz
    theta = jnp.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    safe1 = jnp.where(small, 1.0, theta)
    safe2 = jnp.where(small, 1.0, theta2)
    # Rodrigues coefficients: R = I + a W + b W^2.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / safe1)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    # Right-Jacobian coefficients: J_r = I - A W + B W^2 (see
    # right_jacobian_so3; d(exp(v) X)/dv = -exp(v) [X]x J_r(v)).
    A = b
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (safe2 * safe1)
    )

    R00 = 1.0 - b * (wy * wy + wz * wz)
    R01 = b * wx * wy - a * wz
    R02 = b * wx * wz + a * wy
    R10 = b * wx * wy + a * wz
    R11 = 1.0 - b * (wx * wx + wz * wz)
    R12 = b * wy * wz - a * wx
    R20 = b * wx * wz - a * wy
    R21 = b * wy * wz + a * wx
    R22 = 1.0 - b * (wx * wx + wy * wy)

    px = R00 * Xx + R01 * Xy + R02 * Xz + tt[..., 0]
    py = R10 * Xx + R11 * Xy + R12 * Xz + tt[..., 1]
    pz = R20 * Xx + R21 * Xy + R22 * Xz + tt[..., 2]
    z_safe = jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
    inv_z = 1.0 / z_safe
    gx = px * inv_z
    gy = py * inv_z
    nx = (uv[..., 0] - cx) / fx
    ny = (uv[..., 1] - cy) / fx
    r = jnp.stack([gx - nx, gy - ny], axis=-1)

    # M = R [X]x  (hat(X) columns expanded).
    M00 = R01 * Xz - R02 * Xy
    M01 = R02 * Xx - R00 * Xz
    M02 = R00 * Xy - R01 * Xx
    M10 = R11 * Xz - R12 * Xy
    M11 = R12 * Xx - R10 * Xz
    M12 = R10 * Xy - R11 * Xx
    M20 = R21 * Xz - R22 * Xy
    M21 = R22 * Xx - R20 * Xz
    M22 = R20 * Xy - R21 * Xx

    Jr00 = 1.0 - B * (wy * wy + wz * wz)
    Jr01 = A * wz + B * wx * wy
    Jr02 = -A * wy + B * wx * wz
    Jr10 = -A * wz + B * wx * wy
    Jr11 = 1.0 - B * (wx * wx + wz * wz)
    Jr12 = A * wx + B * wy * wz
    Jr20 = A * wy + B * wx * wz
    Jr21 = -A * wx + B * wy * wz
    Jr22 = 1.0 - B * (wx * wx + wy * wy)

    # dpdv = -M J_r  (d p_cam / d rvec).
    D00 = -(M00 * Jr00 + M01 * Jr10 + M02 * Jr20)
    D01 = -(M00 * Jr01 + M01 * Jr11 + M02 * Jr21)
    D02 = -(M00 * Jr02 + M01 * Jr12 + M02 * Jr22)
    D10 = -(M10 * Jr00 + M11 * Jr10 + M12 * Jr20)
    D11 = -(M10 * Jr01 + M11 * Jr11 + M12 * Jr21)
    D12 = -(M10 * Jr02 + M11 * Jr12 + M12 * Jr22)
    D20 = -(M20 * Jr00 + M21 * Jr10 + M22 * Jr20)
    D21 = -(M20 * Jr01 + M21 * Jr11 + M22 * Jr21)
    D22 = -(M20 * Jr02 + M21 * Jr12 + M22 * Jr22)

    # Rows of d r / d p_cam are [1, 0, -gx]/z and [0, 1, -gy]/z, so every
    # J block row j is inv_z * (row0_j - g * row2_j).
    zero = jnp.zeros_like(inv_z)
    J_c = jnp.stack(
        [
            jnp.stack(
                [
                    inv_z * (D00 - gx * D20),
                    inv_z * (D01 - gx * D21),
                    inv_z * (D02 - gx * D22),
                    inv_z,
                    zero,
                    -gx * inv_z,
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    inv_z * (D10 - gy * D20),
                    inv_z * (D11 - gy * D21),
                    inv_z * (D12 - gy * D22),
                    zero,
                    inv_z,
                    -gy * inv_z,
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )  # [..., 2, 6]
    J_p = jnp.stack(
        [
            jnp.stack(
                [
                    inv_z * (R00 - gx * R20),
                    inv_z * (R01 - gx * R21),
                    inv_z * (R02 - gx * R22),
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    inv_z * (R10 - gy * R20),
                    inv_z * (R11 - gy * R21),
                    inv_z * (R12 - gy * R22),
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )  # [..., 2, 3]
    return r, J_c, J_p


def _obs_terms(cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA):
    """Per-observation residuals, weights, Jacobians. Shapes [P, O, ...]."""
    fx, cx, cy = cam.fx, cam.cx, cam.cy
    P, O = prob.obs_cam.shape
    safe_cam = jnp.clip(prob.obs_cam, 0, prob.cam_rvec.shape[0] - 1)
    rv = prob.cam_rvec[safe_cam]  # [P, O, 3]
    tt = prob.cam_t[safe_cam]
    X = jnp.broadcast_to(prob.points[:, None, :], (P, O, 3))
    r, Jc, Jp = residual_and_jacobians(rv, tt, X, prob.obs_uv, fx, cx, cy)

    include = (
        prob.obs_valid
        & prob.cam_in_problem[safe_cam]
        & prob.point_in_problem[:, None]
    )
    s = jnp.sum(r * r, axis=-1)
    w = jnp.where(include, huber_weight(s, huber_delta), 0.0)
    return r, s, w, Jc, Jp, include, safe_cam


@f32_precision
def build_reduced_system(
    cam: Camera, prob: BAProblem, lam: jnp.ndarray,
    huber_delta: float = HUBER_DELTA,
) -> tuple[ReducedSystem, jnp.ndarray]:
    """Eliminate landmarks: build the reduced camera system for one shard.

    Returns (ReducedSystem, robust_cost_of_current_params). S and g_red are
    *contributions* — sum (psum) them over landmark shards before solving.
    The diagonal damping follows Ceres' scaled-diagonal LM: H + lam*diag(H).
    """
    F = prob.cam_rvec.shape[0]
    P, O = prob.obs_cam.shape
    r, s, w, Jc, Jp, include, safe_cam = _obs_terms(cam, prob, huber_delta)
    cost = jnp.sum(jnp.where(include, huber_cost(s, huber_delta), 0.0))

    Jc_w = Jc * w[..., None, None]  # [P, O, 2, 6]
    # One-hot camera assignment turns every scatter below into an einsum —
    # the whole Schur assembly becomes matmuls instead of serialized
    # scatter-adds (invalid observations have w = 0, so their one-hot target
    # contributes nothing).
    onehot = (safe_cam[..., None] == jnp.arange(F)).astype(jnp.float32)  # [P,O,F]

    # Camera blocks, STAGED as (per-observation outer products) @ one-hot:
    # the single 3-operand einsum ("pof,porj,pork->fjk") lets XLA pick a
    # contraction order that materializes a [P, O, F, 2, 6] intermediate —
    # ~50 MB per LM iteration at bench shapes, the dominant device-memory
    # traffic of the whole solver. Two explicit matmuls keep every
    # intermediate at [N, 36] (N = P*O).
    N = P * O
    oh_n = onehot.reshape(N, F)
    G = jnp.einsum("nri,nrj->nij", Jc_w.reshape(N, 2, 6), Jc.reshape(N, 2, 6))
    Hcc = (oh_n.T @ G.reshape(N, 36)).reshape(F, 6, 6)  # [F, 6, 6]
    g_cn = jnp.einsum("nri,nr->ni", Jc_w.reshape(N, 2, 6), r.reshape(N, 2))
    g_c = oh_n.T @ g_cn  # [F, 6]

    # Point blocks.
    Jp_w = Jp * w[..., None, None]  # [P, O, 2, 3]
    Hpp = jnp.einsum("pori,porj->pij", Jp_w, Jp)  # [P, 3, 3]
    g_p = jnp.einsum("pori,por->pi", Jp_w, r)  # [P, 3]
    W = jnp.einsum("pori,porj->poij", Jc_w, Jp)  # [P, O, 6, 3]

    # Damp: Ceres-style scaled diagonal (+ floor to keep invertible).
    # diag-matrix construction: d[..., k] placed on the diagonal via d * I.
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_d = Hpp + lam * dpp[..., :, None] * eye3 + 1e-9 * eye3
    dcc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    Hcc_d = Hcc + lam * dcc[..., :, None] * eye6 + 1e-9 * eye6

    # Landmark elimination (only free points are eliminated/updated; frozen
    # points keep Hpp_inv = 0 so they contribute pure anchors via Hcc).
    Hpp_inv = inv3x3(Hpp_d) * prob.point_free[:, None, None]

    # S = blockdiag(Hcc_d) - sum_p Y_a Hpp_inv Y_b^T with per-point per-camera
    # aggregated coupling blocks Y[p, f] = sum_{o: cam=f} W[p, o].
    Y = jnp.einsum("pof,poik->pfik", onehot, W)  # [P, F, 6, 3]
    Z = jnp.einsum("pfik,pkl->pfil", Y, Hpp_inv)  # [P, F, 6, 3]
    S_coup = jnp.einsum("pail,pbjl->abij", Z, Y)  # [F, F, 6, 6]
    S = -S_coup
    S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)

    # Reduced gradient: g_c - sum_p Y Hpp_inv g_p.
    g_red = g_c - jnp.einsum("pfik,pk->fi", Z, g_p)

    return (
        ReducedSystem(S=S, g_red=g_red, Hpp_inv=Hpp_inv, g_p=g_p, W=W),
        cost,
    )


@f32_precision
def solve_camera_system(
    S: jnp.ndarray, g_red: jnp.ndarray, cam_free: jnp.ndarray
) -> jnp.ndarray:
    """Solve the dense reduced camera system with freeze masking.

    Frozen cameras get zeroed rows/cols and an identity diagonal, so their
    delta is exactly zero (Ceres SetParameterBlockConstant semantics,
    src/Optimization.cpp:140-146).
    """
    F = S.shape[0]
    m = cam_free.astype(S.dtype)
    S = S * (m[:, None, None, None] * m[None, :, None, None])
    # Identity on frozen diagonal blocks to keep the system nonsingular.
    frozen_eye = (1.0 - m)[:, None, None] * jnp.eye(6)
    S = S.at[jnp.arange(F), jnp.arange(F)].add(frozen_eye)
    g = g_red * m[:, None]

    S_dense = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
    delta = -jnp.linalg.solve(S_dense, g.reshape(F * 6))
    return delta.reshape(F, 6)


@f32_precision
def back_substitute_points(
    rs: ReducedSystem, delta_c: jnp.ndarray, safe_cam: jnp.ndarray
) -> jnp.ndarray:
    """delta_p = -Hpp_inv (g_p + sum_o W_o^T delta_c[cam_o]); [P, 3]."""
    dc = delta_c[safe_cam]  # [P, O, 6]
    Wt_dc = jnp.einsum("poij,poi->pj", rs.W, dc)  # [P, 3]
    return -jnp.einsum("pij,pj->pi", rs.Hpp_inv, rs.g_p + Wt_dc)


def _problem_cost(
    cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA
) -> jnp.ndarray:
    r, s, w, _, _, include, _ = _obs_terms(cam, prob, huber_delta)
    return jnp.sum(jnp.where(include, huber_cost(s, huber_delta), 0.0))


@f32_precision
def structure_ba(
    cam: Camera,
    prob: BAProblem,
    free_slot: jnp.ndarray,
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur LM specialized to ONE free camera + free points.

    This is the exact shape of the reference's per-keyframe global BA
    (src/Slam.cpp:202-213: every previous keyframe frozen, the newest free,
    optimize_points=true) and of the bootstrap BA (src/Slam.cpp:63-68). With
    a single free camera the reduced camera system is just 6x6 and none of
    the [P, F, ...] coupling tensors of the generic solver exist: frozen
    cameras enter only through the per-point Hessians/gradients (anchors),
    and the camera-point coupling is a single [P, 6, 3] block. ~F x less
    work per LM iteration than `full_ba` with identical semantics
    (`prob.cam_free` is ignored; the free camera is `free_slot`).
    """
    fx, cx, cy = cam.fx, cam.cx, cam.cy
    F = prob.cam_rvec.shape[0]
    eye3 = jnp.eye(3)
    n_res = jnp.sum(
        prob.obs_valid
        & prob.cam_in_problem[jnp.clip(prob.obs_cam, 0, F - 1)]
        & prob.point_in_problem[:, None]
    )

    def cond_fn(state):
        return (state[5] < max_iters) & ~state[6]

    def body(state):
        cam_rvec, cam_t, points, lam, cost, it, _ = state
        cur = prob._replace(cam_rvec=cam_rvec, cam_t=cam_t, points=points)
        r, s, w, Jc, Jp, include, safe_cam = _obs_terms(cam, cur, huber_delta)
        free_obs = (safe_cam == free_slot).astype(w.dtype) * w  # [P, O]

        # Camera block (free camera only).
        Jc_f = Jc * free_obs[..., None, None]
        Hcc = jnp.einsum("porj,pork->jk", Jc_f, Jc)  # [6, 6]
        g_c = jnp.einsum("porj,por->j", Jc_f, r)  # [6]

        # Point blocks over ALL included observations (frozen cams anchor).
        Jp_w = Jp * w[..., None, None]
        Hpp = jnp.einsum("pori,porj->pij", Jp_w, Jp)  # [P, 3, 3]
        g_p = jnp.einsum("pori,por->pi", Jp_w, r)  # [P, 3]
        # Coupling with the free camera: Y[p] = sum_{o: cam=free} W[p, o].
        Y = jnp.einsum("porj,pori->pji", Jc_f, Jp)  # [P, 6, 3]

        dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
        Hpp_d = Hpp + lam * dpp[..., :, None] * eye3 + 1e-9 * eye3
        Hpp_inv = inv3x3(Hpp_d) * prob.point_free[:, None, None]

        Z = jnp.einsum("pik,pkl->pil", Y, Hpp_inv)  # [P, 6, 3]
        S = (
            Hcc
            + lam * jnp.diag(jnp.diagonal(Hcc))
            + 1e-9 * jnp.eye(6)
            - jnp.einsum("pil,pjl->ij", Z, Y)
        )
        g_red = g_c - jnp.einsum("pik,pk->i", Z, g_p)
        delta_c = -solve6_spd(S, g_red)  # [6]

        # Back-substitution: frozen cameras have zero delta, so only the
        # free-camera coupling term appears.
        delta_p = -jnp.einsum(
            "pij,pj->pi", Hpp_inv, g_p + jnp.einsum("pji,j->pi", Y, delta_c)
        )

        cam_rvec_new = cam_rvec.at[free_slot].add(delta_c[:3])
        cam_t_new = cam_t.at[free_slot].add(delta_c[3:])
        points_new = points + delta_p * prob.point_free[:, None]

        new_cost = _problem_cost(
            cam,
            prob._replace(
                cam_rvec=cam_rvec_new, cam_t=cam_t_new, points=points_new
            ),
            huber_delta,
        )
        accept = new_cost < cost
        done = (accept & (cost - new_cost <= FUNCTION_TOLERANCE * cost)) | (
            lam > 1e8
        )
        cam_rvec = jnp.where(accept, cam_rvec_new, cam_rvec)
        cam_t = jnp.where(accept, cam_t_new, cam_t)
        points = jnp.where(accept, points_new, points)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), lam * 2.5)
        cost = jnp.where(accept, new_cost, cost)
        return (cam_rvec, cam_t, points, lam, cost, it + 1, done)

    cost0 = _problem_cost(cam, prob, huber_delta)
    init = (
        prob.cam_rvec,
        prob.cam_t,
        prob.points,
        jnp.float32(init_lambda),
        cost0,
        jnp.int32(0),
        jnp.bool_(False),
    )
    cam_rvec, cam_t, points, _, cost, _, _ = jax.lax.while_loop(
        cond_fn, body, init
    )
    return BAResult(
        cam_rvec=cam_rvec, cam_t=cam_t, points=points, cost=cost, num_residuals=n_res
    )


@f32_precision
def window_ba(
    cam: Camera,
    prob: BAProblem,
    free_slots: jnp.ndarray,  # [W] i32 camera slots to optimize (-1 = unused)
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur LM with a SMALL static window of free cameras (local BA).

    Generalizes structure_ba (W=1, the reference's exact per-commit shape,
    src/Slam.cpp:202-213) to the W newest keyframes free at once: the drift
    the reference locks into frozen history gets re-solved while it is still
    cheap. Unlike full_ba, every coupling tensor is [P, W, ...] instead of
    [P, F, ...] — W is 4-8 so the per-iteration memory traffic stays close to
    the single-camera solver's. `prob.cam_free` is ignored; the free set is
    exactly the valid entries of `free_slots` (invalid = -1). Frozen cameras
    anchor through the point blocks as usual.
    """
    F = prob.cam_rvec.shape[0]
    P, O = prob.obs_cam.shape
    W = free_slots.shape[0]
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    slot_ok = free_slots >= 0  # [W]
    n_res = jnp.sum(
        prob.obs_valid
        & prob.cam_in_problem[jnp.clip(prob.obs_cam, 0, F - 1)]
        & prob.point_in_problem[:, None]
    )
    # Per-observation window one-hot: obs_cam == free_slots[w] (invalid
    # slots are -1 and never match a clipped cam id).
    onehot = (
        prob.obs_cam[..., None] == jnp.where(slot_ok, free_slots, -2)
    ).astype(jnp.float32)  # [P, O, W]
    oh_n = onehot.reshape(P * O, W)

    def cond_fn(state):
        return (state[5] < max_iters) & ~state[6]

    def body(state):
        cam_rvec, cam_t, points, lam, cost, it, _ = state
        cur = prob._replace(cam_rvec=cam_rvec, cam_t=cam_t, points=points)
        r, s, w, Jc, Jp, include, safe_cam = _obs_terms(cam, cur, huber_delta)
        N = P * O
        Jc_w = (Jc * w[..., None, None]).reshape(N, 2, 6)
        Jc_n = Jc.reshape(N, 2, 6)

        # Window camera blocks (staged matmuls; see build_reduced_system).
        G = jnp.einsum("nri,nrj->nij", Jc_w, Jc_n).reshape(N, 36)
        Hcc = (oh_n.T @ G).reshape(W, 6, 6)
        g_cn = jnp.einsum("nri,nr->ni", Jc_w, r.reshape(N, 2))
        g_c = oh_n.T @ g_cn  # [W, 6]

        # Point blocks over ALL included observations (frozen cams anchor).
        Jp_w = Jp * w[..., None, None]
        Hpp = jnp.einsum("pori,porj->pij", Jp_w, Jp)
        g_p = jnp.einsum("pori,por->pi", Jp_w, r)
        Wblk = jnp.einsum("pori,porj->poij", Jc_w.reshape(P, O, 2, 6), Jp)

        dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
        Hpp_d = Hpp + lam * dpp[..., :, None] * eye3 + 1e-9 * eye3
        Hpp_inv = inv3x3(Hpp_d) * prob.point_free[:, None, None]

        Y = jnp.einsum("pow,poik->pwik", onehot, Wblk)  # [P, W, 6, 3]
        Z = jnp.einsum("pwik,pkl->pwil", Y, Hpp_inv)
        S_coup = jnp.einsum("pail,pbjl->abij", Z, Y)  # [W, W, 6, 6]
        dcc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
        Hcc_d = Hcc + lam * dcc[..., :, None] * eye6 + 1e-9 * eye6
        S = -S_coup
        S = S.at[jnp.arange(W), jnp.arange(W)].add(Hcc_d)
        g_red = g_c - jnp.einsum("pwik,pk->wi", Z, g_p)

        delta_c = solve_camera_system(S, g_red, slot_ok)  # [W, 6]

        # Back-substitute: per-observation camera delta via the one-hot.
        dc = jnp.einsum("pow,wj->poj", onehot, delta_c)  # [P, O, 6]
        Wt_dc = jnp.einsum("poij,poi->pj", Wblk, dc)
        delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, g_p + Wt_dc)

        tgt = jnp.where(slot_ok, free_slots, F).astype(jnp.int32)
        cam_rvec_new = cam_rvec.at[tgt].add(delta_c[:, :3], mode="drop")
        cam_t_new = cam_t.at[tgt].add(delta_c[:, 3:], mode="drop")
        points_new = points + delta_p * prob.point_free[:, None]

        new_cost = _problem_cost(
            cam,
            prob._replace(
                cam_rvec=cam_rvec_new, cam_t=cam_t_new, points=points_new
            ),
            huber_delta,
        )
        accept = new_cost < cost
        done = (accept & (cost - new_cost <= FUNCTION_TOLERANCE * cost)) | (
            lam > 1e8
        )
        cam_rvec = jnp.where(accept, cam_rvec_new, cam_rvec)
        cam_t = jnp.where(accept, cam_t_new, cam_t)
        points = jnp.where(accept, points_new, points)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), lam * 2.5)
        cost = jnp.where(accept, new_cost, cost)
        return (cam_rvec, cam_t, points, lam, cost, it + 1, done)

    cost0 = _problem_cost(cam, prob, huber_delta)
    init = (
        prob.cam_rvec,
        prob.cam_t,
        prob.points,
        jnp.float32(init_lambda),
        cost0,
        jnp.int32(0),
        jnp.bool_(False),
    )
    cam_rvec, cam_t, points, _, cost, _, _ = jax.lax.while_loop(
        cond_fn, body, init
    )
    return BAResult(
        cam_rvec=cam_rvec, cam_t=cam_t, points=points, cost=cost,
        num_residuals=n_res,
    )


@f32_precision
def full_ba(
    cam: Camera,
    prob: BAProblem,
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur-complement LM over keyframes and points (single shard).

    Equivalent of optimization::optimize (src/Optimization.cpp:83-186):
    builds the robustified normal equations, eliminates landmarks, solves the
    reduced camera system, back-substitutes point updates, and runs an
    accept/reject LM loop for max_iters (reference budget: 10).
    """
    n_res = jnp.sum(
        prob.obs_valid
        & prob.cam_in_problem[jnp.clip(prob.obs_cam, 0, prob.cam_rvec.shape[0] - 1)]
        & prob.point_in_problem[:, None]
    )

    def cond_fn(state):
        return (state[5] < max_iters) & ~state[6]

    def body(state):
        cam_rvec, cam_t, points, lam, cost, it, _ = state
        cur = prob._replace(cam_rvec=cam_rvec, cam_t=cam_t, points=points)
        rs, _ = build_reduced_system(cam, cur, lam, huber_delta)
        delta_c = solve_camera_system(rs.S, rs.g_red, prob.cam_free)
        safe_cam = jnp.clip(prob.obs_cam, 0, prob.cam_rvec.shape[0] - 1)
        delta_p = back_substitute_points(rs, delta_c, safe_cam)

        cam_rvec_new = cam_rvec + delta_c[:, :3] * prob.cam_free[:, None]
        cam_t_new = cam_t + delta_c[:, 3:] * prob.cam_free[:, None]
        points_new = points + delta_p * prob.point_free[:, None]

        new_cost = _problem_cost(
            cam,
            prob._replace(
                cam_rvec=cam_rvec_new, cam_t=cam_t_new, points=points_new
            ),
            huber_delta,
        )
        accept = new_cost < cost
        done = (accept & (cost - new_cost <= FUNCTION_TOLERANCE * cost)) | (
            lam > 1e8
        )
        cam_rvec = jnp.where(accept, cam_rvec_new, cam_rvec)
        cam_t = jnp.where(accept, cam_t_new, cam_t)
        points = jnp.where(accept, points_new, points)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), lam * 2.5)
        cost = jnp.where(accept, new_cost, cost)
        return (cam_rvec, cam_t, points, lam, cost, it + 1, done)

    cost0 = _problem_cost(cam, prob, huber_delta)
    init = (
        prob.cam_rvec,
        prob.cam_t,
        prob.points,
        jnp.float32(init_lambda),
        cost0,
        jnp.int32(0),
        jnp.bool_(False),
    )
    cam_rvec, cam_t, points, _, cost, _, _ = jax.lax.while_loop(
        cond_fn, body, init
    )
    return BAResult(
        cam_rvec=cam_rvec, cam_t=cam_t, points=points, cost=cost, num_residuals=n_res
    )
