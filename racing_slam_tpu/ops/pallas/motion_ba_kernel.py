"""Fused motion-only bundle adjustment (one free pose, fixed points), Pallas/Triton.

motion_ba runs twice per tracking frame (src/Slam.cpp:165-175) on ~60 KB of
operands. As an XLA `while_loop` every LM iteration is a handful of small
kernels plus a device->host read of the loop predicate, so its cost is
launches and latency, not arithmetic. This kernel runs the whole
Levenberg-Marquardt loop in ONE program (`grid=(1,)`): the normal-equation
assembly at the current pose, the robust cost at the candidate pose, the
closed-form 6x6 solve, the lambda schedule and the Ceres-style
function-tolerance exit, all as a `lax.while_loop` inside the kernel.

Per-observation data are six 1-D rows (X, Y, Z, normalized u, v, valid) of
length Kp, a multiple of the chunk `32 * num_warps` (one element per thread).
Each pass walks the chunks with a `fori_loop` and accumulates the 21 unique
Hessian entries, the 6 gradient entries and the cost element-wise; the
block reductions to scalars happen once per pass.

Semantics match ops.ba.motion_ba (same residual, analytic Jacobian, Huber
IRLS weights, damping H + lam (diag(H) + 1e-9), lambda schedule and stopping
rule); tests/test_ba_kernels.py checks parity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _rodrigues(wx, wy, wz):
    """Rotation entries and right-Jacobian coefficients of the angle-axis w.

    R = I + a[w]x + b[w]x^2 and J_r = I - b[w]x + B[w]x^2 (the A coefficient
    of ops.ba.residual_and_jacobians equals b). Scalars in, scalars out.
    """
    theta2 = wx * wx + wy * wy + wz * wz
    theta = jnp.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    safe1 = jnp.where(small, 1.0, theta)
    safe2 = jnp.where(small, 1.0, theta2)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / safe1)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (safe2 * safe1)
    )
    R = (
        (1.0 - b * (wy * wy + wz * wz), b * wx * wy - a * wz, b * wx * wz + a * wy),
        (b * wx * wy + a * wz, 1.0 - b * (wx * wx + wz * wz), b * wy * wz - a * wx),
        (b * wx * wz - a * wy, b * wy * wz + a * wx, 1.0 - b * (wx * wx + wy * wy)),
    )
    Jr = (
        (1.0 - B * (wy * wy + wz * wz), b * wz + B * wx * wy, -b * wy + B * wx * wz),
        (-b * wz + B * wx * wy, 1.0 - B * (wx * wx + wz * wz), b * wx + B * wy * wz),
        (b * wy + B * wx * wz, -b * wx + B * wy * wz, 1.0 - B * (wx * wx + wy * wy)),
    )
    return R, Jr


def _huber_cost(s, delta):
    b = delta * delta
    return jnp.where(s <= b, s, 2.0 * delta * jnp.sqrt(s + 1e-18) - b)


def _huber_weight(s, delta):
    return jnp.where(s <= delta * delta, 1.0, delta / jnp.sqrt(s + 1e-18))


def _inv3(m):
    """Closed-form 3x3 inverse of a nested tuple of scalars (ops.ba.inv3x3)."""
    (a, b, c), (d, e, f), (g, h, i) = m
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    return (
        (A * inv_det, -(b * i - c * h) * inv_det, (b * f - c * e) * inv_det),
        (B * inv_det, (a * i - c * g) * inv_det, -(a * f - c * d) * inv_det),
        (C * inv_det, -(a * h - b * g) * inv_det, (a * e - b * d) * inv_det),
    )


def _solve6(H, g):
    """ops.ba.solve6_spd on scalars: block elimination with two 3x3 inverses."""
    A = [[H[i][j] for j in range(3)] for i in range(3)]
    B = [[H[i][j + 3] for j in range(3)] for i in range(3)]
    C = [[H[i + 3][j + 3] for j in range(3)] for i in range(3)]
    g1, g2 = g[:3], g[3:]
    Ainv = _inv3(A)
    AinvB = [[sum(Ainv[i][k] * B[k][j] for k in range(3)) for j in range(3)]
             for i in range(3)]
    S = [[C[i][j] - sum(B[k][i] * AinvB[k][j] for k in range(3))
          for j in range(3)] for i in range(3)]
    Sinv = _inv3(S)
    rhs2 = [g2[j] - sum(AinvB[i][j] * g1[i] for i in range(3)) for j in range(3)]
    x2 = [sum(Sinv[i][j] * rhs2[j] for j in range(3)) for i in range(3)]
    x1 = [sum(Ainv[i][j] * g1[j] for j in range(3))
          - sum(AinvB[i][j] * x2[j] for j in range(3)) for i in range(3)]
    return x1 + x2


def _kernel(pose_ref, x_ref, y_ref, z_ref, nx_ref, ny_ref, v_ref, out_ref, *,
            chunk, n_chunks, max_iters, huber_delta, ftol):
    """pose_ref: [8] (rvec, t, lam0, unused); out_ref: [8] (rvec, t, cost, iters)."""

    def rows(c):
        s = pl.ds(pl.multiple_of(c * chunk, chunk), chunk)
        return (x_ref[s], y_ref[s], z_ref[s], nx_ref[s], ny_ref[s],
                v_ref[s] > 0.0)

    def project(R, t, X, Y, Z):
        px = R[0][0] * X + R[0][1] * Y + R[0][2] * Z + t[0]
        py = R[1][0] * X + R[1][1] * Y + R[1][2] * Z + t[1]
        pz = R[2][0] * X + R[2][1] * Y + R[2][2] * Z + t[2]
        inv_z = 1.0 / jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
        return px * inv_z, py * inv_z, inv_z

    def cost_at(w, t):
        R, _ = _rodrigues(*w)

        def body(c, acc):
            X, Y, Z, nx, ny, ok = rows(c)
            gx, gy, _ = project(R, t, X, Y, Z)
            s = (gx - nx) ** 2 + (gy - ny) ** 2
            return acc + jnp.where(ok, _huber_cost(s, huber_delta), 0.0)

        acc = jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((chunk,), jnp.float32))
        return jnp.sum(acc)

    def normal_equations(w, t):
        R, Jr = _rodrigues(*w)

        def body(c, accs):
            X, Y, Z, nx, ny, ok = rows(c)
            gx, gy, inv_z = project(R, t, X, Y, Z)
            r0, r1 = gx - nx, gy - ny
            wt = jnp.where(ok, _huber_weight(r0 * r0 + r1 * r1, huber_delta), 0.0)
            # M = R [X]x ; D = -M J_r = d p_cam / d rvec.
            Xv = (X, Y, Z)
            M = [[R[i][(k + 1) % 3] * Xv[(k + 2) % 3]
                  - R[i][(k + 2) % 3] * Xv[(k + 1) % 3] for k in range(3)]
                 for i in range(3)]
            D = [[-(M[i][0] * Jr[0][j] + M[i][1] * Jr[1][j] + M[i][2] * Jr[2][j])
                  for j in range(3)] for i in range(3)]
            zero = jnp.zeros_like(inv_z)
            J0 = [inv_z * (D[0][j] - gx * D[2][j]) for j in range(3)] + [
                inv_z, zero, -gx * inv_z]
            J1 = [inv_z * (D[1][j] - gy * D[2][j]) for j in range(3)] + [
                zero, inv_z, -gy * inv_z]
            terms = [wt * (J0[i] * J0[j] + J1[i] * J1[j])
                     for i in range(6) for j in range(i, 6)]
            terms += [wt * (J0[i] * r0 + J1[i] * r1) for i in range(6)]
            return tuple(a + b for a, b in zip(accs, terms))

        zeros = tuple(jnp.zeros((chunk,), jnp.float32) for _ in range(27))
        sums = [jnp.sum(a) for a in jax.lax.fori_loop(0, n_chunks, body, zeros)]
        H = [[None] * 6 for _ in range(6)]
        n = 0
        for i in range(6):
            for j in range(i, 6):
                H[i][j] = H[j][i] = sums[n]
                n += 1
        return H, sums[21:]

    def cond_fn(st):
        return (st[4] < max_iters) & ~st[5]

    def body(st):
        w, t, lam, cost, it, _ = st
        H, g = normal_equations(w, t)
        Hd = [[H[i][j] + (lam * (H[i][j] + 1e-9) if i == j else 0.0)
               for j in range(6)] for i in range(6)]
        delta = _solve6(Hd, g)
        w_n = tuple(w[i] - delta[i] for i in range(3))
        t_n = tuple(t[i] - delta[3 + i] for i in range(3))
        new_cost = cost_at(w_n, t_n)
        accept = new_cost < cost
        done = (accept & (cost - new_cost <= ftol * cost)) | (lam > 1e8)
        w = tuple(jnp.where(accept, a, b) for a, b in zip(w_n, w))
        t = tuple(jnp.where(accept, a, b) for a, b in zip(t_n, t))
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), lam * 2.0)
        cost = jnp.where(accept, new_cost, cost)
        return w, t, lam, cost, it + 1, done

    w0 = (pose_ref[0], pose_ref[1], pose_ref[2])
    t0 = (pose_ref[3], pose_ref[4], pose_ref[5])
    w, t, _, cost, it, _ = jax.lax.while_loop(
        cond_fn, body,
        (w0, t0, pose_ref[6], cost_at(w0, t0), jnp.int32(0), jnp.bool_(False)),
    )
    idx = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
    vals = (*w, *t, cost, it.astype(jnp.float32))
    out = jnp.zeros((8,), jnp.float32)
    for i, v in enumerate(vals):
        out = jnp.where(idx == i, v, out)
    out_ref[...] = out


@partial(
    jax.jit,
    static_argnames=("max_iters", "huber_delta", "ftol", "num_warps"),
)
def motion_ba_fused(
    cam,
    rvec: jnp.ndarray,  # [3]
    t: jnp.ndarray,  # [3]
    kp_uv: jnp.ndarray,  # [K, 2]
    point_xyz: jnp.ndarray,  # [K, 3]
    valid: jnp.ndarray,  # [K] bool
    max_iters: int,
    huber_delta: float,
    ftol: float,
    num_warps: int = 16,
) -> jnp.ndarray:
    """Run the fused LM loop; returns [8] f32 (rvec, t, final cost, iters)."""
    K = kp_uv.shape[0]
    chunk = 32 * num_warps
    Kp = -(-K // chunk) * chunk
    f32 = jnp.float32

    def row(x):
        return jnp.pad(x.astype(f32), (0, Kp - K))

    pose0 = jnp.concatenate(
        [rvec.astype(f32), t.astype(f32), jnp.asarray([1e-4, 0.0], f32)]
    )
    rows = (
        row(point_xyz[:, 0]), row(point_xyz[:, 1]), row(point_xyz[:, 2]),
        row((kp_uv[:, 0] - cam.cx) / cam.fx),
        row((kp_uv[:, 1] - cam.cy) / cam.fx),  # fx only, like the reference
        row(valid),
    )
    return pl.pallas_call(
        partial(
            _kernel, chunk=chunk, n_chunks=Kp // chunk, max_iters=max_iters,
            huber_delta=huber_delta, ftol=ftol,
        ),
        out_shape=jax.ShapeDtypeStruct((8,), f32),
        grid=(1,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        name="motion_ba_fused",
    )(pose0, *rows)
