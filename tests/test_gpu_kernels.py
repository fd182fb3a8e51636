"""The Pallas kernels as compiled for the GPU (no interpreter), against the
XLA paths at the real widths. They skip without a GPU; see tests/conftest.py
for how to run them on one."""

import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("P", [4096, 16384])
def test_match_kernel_on_gpu(gpu, P):
    res = cs.check_match(P, reps=0)
    assert res["ok"], res


def test_motion_kernel_on_gpu(gpu):
    res = cs.check_motion(reps=0)
    assert res["ok"], res


def test_auto_backend_takes_the_kernels_on_gpu(gpu):
    import jax.numpy as jnp

    from racing_slam_tpu.ops.ba import motion_ba

    cam, args = cs.motion_inputs(64)
    jaxpr = jax.make_jaxpr(lambda *a: motion_ba(cam, *a))(*args)
    assert "pallas_call" in str(jaxpr)
    m_args = cs.match_inputs(64, 128, 8, 128)
    from racing_slam_tpu.ops.matching import match_map_to_frame
    from racing_slam_tpu.ops.se3 import pose_matrix

    X = jnp.concatenate([m_args[0], jnp.full((64, 1), 5.0)], axis=1)
    jaxpr = jax.make_jaxpr(lambda: match_map_to_frame(
        cam, pose_matrix(jnp.zeros(3), jnp.zeros(3)), X, m_args[1], m_args[2],
        m_args[3], m_args[4], m_args[5], m_args[6], jnp.zeros(128, bool),
        jnp.zeros(64, bool), max_distance=0.8))()
    assert "pallas_call" in str(jaxpr)
