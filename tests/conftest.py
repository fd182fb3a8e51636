"""Test configuration: run on CPU with 8 virtual devices.

The XLA host platform is forced to expose 8 devices so multi-device sharding
logic (shard_map, the seq x lm mesh) compiles and executes without a
multi-GPU machine. XLA_FLAGS is read when the CPU client is created, and
jax.config.update("jax_platforms", "cpu") takes effect as long as no backend
has been used yet.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere (the decision is
made inside the `gpu` fixture, never at import time). To run them on a GPU
machine, keep JAX on its default devices:

    RSLAM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
ON_GPU = os.environ.get("RSLAM_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# Geometry tests need f32 matmuls, not bf16 passes.
jax.config.update("jax_default_matmul_precision", "highest")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas kernels through Pallas' interpreter: the CPU tests of
    kernels that otherwise compile only for a GPU. The kernels' jit caches
    are cleared around the test so no interpreted trace outlives it."""
    from functools import partial

    from jax.experimental import pallas as pl

    from racing_slam_tpu.ops.pallas import match_kernel, motion_ba_kernel

    kernels = (match_kernel.guided_match_stage1, motion_ba_kernel.motion_ba_fused)
    for k in kernels:
        k.clear_cache()
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    yield
    for k in kernels:
        k.clear_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (RSLAM_TESTS_ON_GPU=1 on a GPU machine)")
