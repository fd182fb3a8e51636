"""Parity of the fused motion-BA Pallas kernel vs the XLA solver.

The kernel must be a drop-in replacement: same residual, same Huber IRLS,
same lambda schedule and stopping rule as ops.ba.motion_ba. These tests run
the kernel through Pallas' interpreter on CPU (the `pallas_interpret`
fixture) and compare against the XLA
while_loop on identical problems; the wrapper's padding and the backend
choice are checked here too. The single-camera structure solver has no
kernel; its XLA path is checked on the same rig at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from racing_slam_tpu.ops.ba import FUNCTION_TOLERANCE, BAProblem, motion_ba, structure_ba
from racing_slam_tpu.ops.pallas.motion_ba_kernel import motion_ba_fused
from tests.geometry_fixtures import default_camera, project_np, synthetic_scene
from tests.test_ba import _make_rig, _problem_from_rig


def _run_pallas_motion(cam, rv0, t0, uv, X, valid, max_iters=10,
                       huber_delta=float(jnp.sqrt(5.991)), num_warps=4):
    return motion_ba_fused(
        cam, jnp.asarray(rv0, jnp.float32), jnp.asarray(t0, jnp.float32),
        jnp.asarray(uv), jnp.asarray(X), jnp.asarray(valid),
        max_iters, huber_delta, FUNCTION_TOLERANCE, num_warps=num_warps,
    )


def _problem(rng, n=150, outliers=0):
    cam = default_camera()
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = Rotation.from_rotvec([0.03, -0.1, 0.02]).as_matrix()
    T_gt[:3, 3] = [0.3, -0.1, 0.2]
    X = synthetic_scene(rng, n)
    uv = project_np(cam, T_gt, X)
    if outliers:
        uv[:outliers] += rng.uniform(80, 200, (outliers, 2)).astype(np.float32)
    rv0 = Rotation.from_matrix(T_gt[:3, :3]).as_rotvec().astype(np.float32)
    rv0 += np.float32([0.02, -0.015, 0.01])
    t0 = T_gt[:3, 3] + np.float32([0.05, -0.04, 0.06])
    return cam, T_gt, X, uv, rv0, t0


def test_motion_kernel_matches_xla(rng, pallas_interpret):
    cam, T_gt, X, uv, rv0, t0 = _problem(rng)
    valid = np.ones(len(X), bool)
    ref = motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(uv),
                    jnp.asarray(X), jnp.asarray(valid), backend="xla")
    out = _run_pallas_motion(cam, rv0, t0, uv, X, valid)
    # Both converge to the same optimum (exact float equality is not expected:
    # reduction orders differ).
    np.testing.assert_allclose(np.asarray(out[:3]), np.asarray(ref.rvec),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out[3:6]), np.asarray(ref.t),
                               atol=1e-4)
    assert float(out[6]) <= float(ref.cost) * 1.01 + 1e-10


def test_motion_kernel_recovers_pose(rng, pallas_interpret):
    cam, T_gt, X, uv, rv0, t0 = _problem(rng)
    out = _run_pallas_motion(cam, rv0, t0, uv, X, np.ones(len(X), bool))
    rv_gt = Rotation.from_matrix(T_gt[:3, :3]).as_rotvec()
    np.testing.assert_allclose(np.asarray(out[:3]), rv_gt, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out[3:6]), T_gt[:3, 3], atol=1e-3)
    assert float(out[6]) < 1e-8


def test_motion_kernel_huber_and_mask(rng, pallas_interpret):
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=150, outliers=15)
    valid = np.ones(len(X), bool)
    out = _run_pallas_motion(cam, rv0, t0, uv, X, valid,
                             huber_delta=2.45 / cam.fx)
    np.testing.assert_allclose(np.asarray(out[3:6]), T_gt[:3, 3], atol=5e-3)
    # Masking the outliers entirely gives an exact fit.
    valid[:15] = False
    out2 = _run_pallas_motion(cam, rv0, t0, uv, X, valid)
    assert float(out2[6]) < 1e-8


def test_motion_kernel_all_invalid_is_identity(rng, pallas_interpret):
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=64)
    out = _run_pallas_motion(cam, rv0, t0, uv, X, np.zeros(len(X), bool))
    np.testing.assert_allclose(np.asarray(out[:3]), rv0, atol=0)
    np.testing.assert_allclose(np.asarray(out[3:6]), t0, atol=0)


@pytest.mark.parametrize("n,num_warps", [(1, 1), (31, 1), (200, 2), (300, 4)])
def test_motion_kernel_padding_edges(rng, n, num_warps, pallas_interpret):
    """K not a multiple of the chunk (32 * num_warps), including a single
    chunk and several: padded rows carry valid = 0 and change nothing."""
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=n)
    valid = rng.random(n) < 0.9
    valid[0] = True
    ref = motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(uv),
                    jnp.asarray(X), jnp.asarray(valid), backend="xla")
    out = _run_pallas_motion(cam, rv0, t0, uv, X, valid, num_warps=num_warps)
    np.testing.assert_allclose(np.asarray(out[:3]), np.asarray(ref.rvec),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out[3:6]), np.asarray(ref.t),
                               atol=2e-3)
    assert 1 <= int(out[7]) <= 10


@pytest.mark.parametrize("backend", ["pallas", "interpret", "cuda"])
def test_motion_forced_or_unknown_backend_raises(rng, backend):
    """Without a GPU a forced kernel raises instead of interpreting."""
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=16)
    with pytest.raises(ValueError):
        motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(uv),
                  jnp.asarray(X), jnp.ones(16, bool), backend=backend)


def test_motion_auto_backend_is_xla_off_gpu(rng):
    """"auto" resolves to the XLA while_loop where there is no GPU: the
    traced program holds no pallas_call."""
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=16)
    jaxpr = jax.make_jaxpr(
        lambda u: motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), u,
                            jnp.asarray(X), jnp.ones(16, bool))
    )(jnp.asarray(uv))
    assert "pallas_call" not in str(jaxpr)
    assert "while" in str(jaxpr)


# ---------------------------------------------------------------------------
# structure_ba (single free camera + free points Schur LM, XLA only)
# ---------------------------------------------------------------------------


def _perturbed_rig(rng) -> tuple:
    cam, poses, X, obs_cam, obs_uv, obs_valid = _make_rig(rng, n_cams=3)
    poses_pert = [p.copy() for p in poses]
    poses_pert[2][:3, 3] += np.float32([0.06, -0.04, 0.05])
    R_p = (Rotation.from_rotvec([0.01, 0.02, -0.01]).as_matrix()
           @ poses_pert[2][:3, :3])
    poses_pert[2][:3, :3] = R_p.astype(np.float32)
    X_noisy = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    prob: BAProblem = _problem_from_rig(
        cam, poses_pert, X_noisy, obs_cam, obs_uv, obs_valid,
        cam_free=np.array([False, False, True]),
        point_free=np.ones(len(X), bool),
    )
    return cam, poses, X, prob


def test_structure_ba_recovers_truth(rng):
    cam, poses, X, prob = _perturbed_rig(rng)
    res = structure_ba(cam, prob, jnp.int32(2))
    np.testing.assert_allclose(np.asarray(res.cam_t)[2], poses[2][:3, 3],
                               atol=2e-3)
    err = np.linalg.norm(np.asarray(res.points) - X, axis=-1)
    assert np.median(err) < 5e-3


def test_structure_ba_respects_freeze_masks(rng):
    cam, poses, X, prob = _perturbed_rig(rng)
    frozen = np.zeros(len(X), bool)
    frozen[:20] = True  # freeze the first 20 points
    prob = prob._replace(point_free=jnp.asarray(~frozen))
    res = structure_ba(cam, prob, jnp.int32(2))
    out_X = np.asarray(res.points)
    np.testing.assert_array_equal(out_X[:20], np.asarray(prob.points)[:20])
    # The rest still move (non-zero update on noisy points).
    assert np.linalg.norm(out_X[20:] - np.asarray(prob.points)[20:]) > 1e-4
    # Only the free slot's pose moves; the result keeps the input shapes.
    assert res.cam_rvec.shape == prob.cam_rvec.shape
    np.testing.assert_array_equal(np.asarray(res.cam_t)[:2],
                                  np.asarray(prob.cam_t)[:2])
