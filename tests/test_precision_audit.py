"""Every f32 matmul in the tracking step's geometry runs at HIGHEST precision.

On a GPU an f32 matmul without an explicit precision may run in TF32 (about
three decimal digits), which is enough to move a reprojection by a pixel at
the pipeline's depths. ops.precision.f32_precision wraps every geometry
entry point; this audit traces slam_step with the process default set to
DEFAULT and walks every sub-jaxpr (cond branches, loops, scans) for f32
dot_generals that did not get HIGHEST.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _below_highest(fn, *args):
    """Source lines of f32 matmuls in fn's trace that are not HIGHEST."""
    from jax._src import source_info_util

    with jax.default_matmul_precision("default"):
        jaxpr = jax.make_jaxpr(fn)(*args)
    dots = _f32_dots(jaxpr.jaxpr, [])
    assert dots, "the audit found no f32 matmuls to check"
    return sorted({
        source_info_util.summarize(e.source_info)
        for e in dots
        if tuple(e.params["precision"] or ()) != HIGHEST
    })


def _f32_dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            out.append(eqn)
        for p in eqn.params.values():
            for j in p if isinstance(p, (list, tuple)) else [p]:
                if isinstance(j, jcore.ClosedJaxpr):
                    _f32_dots(j.jaxpr, out)
                elif isinstance(j, jcore.Jaxpr):
                    _f32_dots(j, out)
    return out


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"pose_prediction": "constant_velocity"},
        {"pose_prediction": "adaptive"},
        {"essential_matrix_estimation": True},
    ],
    ids=["constant_position", "constant_velocity", "adaptive", "essential"],
)
def test_slam_step_geometry_is_highest_precision(overrides):
    import __graft_entry__ as ge
    from racing_slam_tpu.slam.pipeline import slam_step

    _, (state, img, key, mask) = ge.entry()
    cam, cfg, frontend, _ = ge._tiny_setup()
    cfg = dataclasses.replace(cfg, **overrides)

    def step(state, img, key):
        return slam_step(state, img, key, mask, cam=cam, cfg=cfg,
                         frontend=frontend)

    bad = _below_highest(step, state, img, key)
    assert not bad, f"f32 matmuls below HIGHEST precision: {bad}"


@pytest.mark.parametrize("stage", ["bootstrap", "commit_initialization",
                                   "refinement"])
def test_bootstrap_and_refinement_geometry_is_highest_precision(stage):
    from functools import partial

    import numpy as np

    import __graft_entry__ as ge
    from racing_slam_tpu.slam.pipeline import (
        Slam,
        commit_initialization,
        try_initialize,
    )
    from racing_slam_tpu.utils.video import ArraySource

    cam, cfg, _, _ = ge._tiny_setup()
    cfg = dataclasses.replace(cfg, refine_every_frames=4)
    img = np.random.default_rng(0).uniform(0, 1, (cam.height, cam.width))
    img = img.astype(np.float32)
    slam = Slam(cam, ArraySource([img, img]), cfg)
    feat = slam._extract(jnp.asarray(img), None)
    K = feat.valid.shape[0]
    if stage == "bootstrap":
        fn = partial(try_initialize, cam=cam, cfg=cfg,
                     matcher=slam.frontend.matcher)
        args = (feat, feat, jax.random.PRNGKey(0))
    elif stage == "commit_initialization":
        fn = partial(commit_initialization, cam=cam, cfg=cfg)
        args = (slam.state, feat, feat, jnp.asarray(img), jnp.eye(4),
                jnp.arange(K, dtype=jnp.int32), jnp.ones(K, bool),
                jnp.int32(0), jnp.int32(1))
    else:
        fn, args = slam._refine_one, (slam.state,)
    bad = _below_highest(fn, *args)
    assert not bad, f"f32 matmuls below HIGHEST precision: {bad}"
