"""Global map refinement on the live engine state, landmark-sharded.

The reference's only whole-map optimization is the per-keyframe-commit BA with
every previous keyframe FROZEN (src/Slam.cpp:202-213) — older poses are never
revisited, so early drift is locked in. This module adds the stage the
reference's single-process Ceres could not afford (src/Optimization.cpp:151-153
is one-process SPARSE_SCHUR): a periodic FULL bundle adjustment over the live
SlamState — every keyframe pose (minus the gauge anchors) and every map point
free — with landmarks sharded over the mesh 'lm' axis so per-iteration wire
traffic is one psum of the reduced camera system (parallel/dist_ba.py).

Gauge handling: a monocular map has a 7-dof gauge freedom (similarity). The
two OLDEST valid keyframes are frozen, pinning global pose AND scale exactly
the way the reference's bootstrap does (ref frame fixed + unit baseline,
src/Slam.cpp:63-80).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..ops.ba import HUBER_DELTA, BAProblem, BAResult
from ..ops.camera import Camera
from ..slam.state import SlamState


def gauge_anchor_mask(kfs_valid: jnp.ndarray, frame_index: jnp.ndarray) -> jnp.ndarray:
    """[F] bool — True for the two oldest valid keyframes (frozen anchors)."""
    order = jnp.where(kfs_valid, frame_index, jnp.iinfo(jnp.int32).max)
    F = kfs_valid.shape[0]
    oldest = jnp.argmin(order)
    order2 = order.at[oldest].set(jnp.iinfo(jnp.int32).max)
    second = jnp.argmin(order2)
    idx = jnp.arange(F)
    return ((idx == oldest) | (idx == second)) & kfs_valid


def build_global_problem(state: SlamState) -> BAProblem:
    """BAProblem over the FULL live map: all valid keyframes except the two
    gauge anchors free, all valid points free. Pure gathers — vmap-able over
    stacked multi-sequence states."""
    kfs, m = state.kfs, state.map
    anchors = gauge_anchor_mask(kfs.valid, kfs.frame_index)
    obs_uv = kfs.kp_xy[m.obs_kf, m.obs_kp]  # [P, O, 2]
    return BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos,
        obs_cam=m.obs_kf,
        obs_uv=obs_uv,
        obs_valid=m.obs_valid & m.valid[:, None],
        cam_free=kfs.valid & ~anchors,
        cam_in_problem=kfs.valid,
        point_free=m.valid,
        point_in_problem=m.valid,
    )


def build_global_problem_compact(
    state: SlamState, budget: int
) -> tuple[BAProblem, jnp.ndarray, jnp.ndarray]:
    """Like build_global_problem, but compacted to <= budget live points
    (most-observed first, MapState.ba_point_selection_mask) so the LM loop
    iterates [budget, O] tensors instead of the full map capacity — live
    points are typically a quarter of capacity, and refine cost scales with
    the point axis. Overflowing points (rare: live > budget) keep their
    positions and are re-checked by the post-refine cull.
    Returns (problem, sel [budget] map slots, sel_ok [budget])."""
    kfs, m = state.kfs, state.map
    anchors = gauge_anchor_mask(kfs.valid, kfs.frame_index)
    sel, sel_ok = m.ba_point_selection_mask(m.valid, budget)
    obs_kf = m.obs_kf[sel]
    obs_kp = m.obs_kp[sel]
    prob = BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos[sel],
        obs_cam=obs_kf,
        obs_uv=kfs.kp_xy[obs_kf, obs_kp],
        obs_valid=m.obs_valid[sel] & sel_ok[:, None],
        cam_free=kfs.valid & ~anchors,
        cam_in_problem=kfs.valid,
        point_free=sel_ok,
        point_in_problem=sel_ok,
    )
    return prob, sel, sel_ok


def apply_refinement(state: SlamState, res: BAResult) -> SlamState:
    """Write refined poses/points back into the live state.

    The solver masks updates to free cams/points, so the write-back is
    unconditional. The in-flight tracking pose (last_rvec/t) is re-anchored
    by shifting it with the last keyframe's pose correction, so the next
    frame's constant-position prediction starts consistent with the refined
    map (the per-frame motion BA then absorbs the residual).
    """
    kfs = state.kfs
    slot = state.last_kf_slot
    # Preserve the relative pose last-frame <- last-keyframe across the
    # refinement: with world->camera poses, rel = T_last @ inv(T_kf), so
    # T_last_new = T_last @ inv(T_kf_old) @ T_kf_new (RIGHT-composition —
    # the correction acts in the keyframe's world parametrization, not the
    # last frame's camera frame).
    from ..ops import se3

    T_old = se3.pose_matrix(kfs.rvec[slot], kfs.t[slot])
    T_new = se3.pose_matrix(res.cam_rvec[slot], res.cam_t[slot])
    # se3.compose is f32_precision-wrapped; bare `@` here could run the 4x4
    # chain in TF32 and perturb the tracking seed.
    corr = se3.compose(se3.inverse(T_old), T_new)
    T_last = se3.compose(se3.pose_matrix(state.last_rvec, state.last_t), corr)
    last_rvec, last_t = se3.rt_from_matrix(T_last)
    # Correct the t-2 pose the same way so the constant-velocity predictor
    # sees an unchanged relative motion across the refinement.
    T_prev = se3.compose(se3.pose_matrix(state.prev_rvec, state.prev_t), corr)
    prev_rvec, prev_t = se3.rt_from_matrix(T_prev)

    return state._replace(
        kfs=kfs._replace(rvec=res.cam_rvec, t=res.cam_t),
        map=state.map._replace(pos=res.points),
        last_rvec=last_rvec,
        last_t=last_t,
        prev_rvec=prev_rvec,
        prev_t=prev_t,
    )


def apply_refinement_compact(
    state: SlamState, res: BAResult, sel: jnp.ndarray, sel_ok: jnp.ndarray
) -> SlamState:
    """apply_refinement for the compacted problem: scatter the refined
    point positions back into their map slots (poses are full-size)."""
    P = state.map.pos.shape[0]
    tgt = jnp.where(sel_ok, sel, P)
    pos = state.map.pos.at[tgt].set(res.points, mode="drop")
    full = res._replace(points=pos)
    return apply_refinement(state, full)


def make_refine_step(
    cam: Camera,
    mesh: Mesh,
    seq_axis: str = "seq",
    lm_axis: str = "lm",
    max_iters: int = 10,
    huber_delta: float = HUBER_DELTA,
):
    """Jitted stacked-state refinement: states [S, ...] -> states [S, ...].

    Problem construction, the landmark-sharded LM loop (psum of the reduced
    camera system over `lm_axis` per iteration; parallel/dist_ba.py), and the
    write-back all run in ONE device program over the (seq x lm) mesh.
    """
    from functools import partial as _partial

    from .dist_ba import batched_distributed_full_ba

    ba = _partial(
        batched_distributed_full_ba,
        cam,
        mesh=mesh,
        seq_axis=seq_axis,
        lm_axis=lm_axis,
        max_iters=max_iters,
        huber_delta=huber_delta,
    )

    def refine(states: SlamState) -> tuple[SlamState, jnp.ndarray]:
        probs = jax.vmap(build_global_problem)(states)
        res = ba(prob_batch=probs)
        new_states = jax.vmap(apply_refinement)(states, res)
        return new_states, res.cost

    from jax.sharding import NamedSharding, PartitionSpec as P

    # Hand states back in the tracking step's layout (leading axis on the seq
    # mesh axis, replicated over lm) — the BA internals shard points over
    # ('seq', 'lm') and would otherwise leak that layout to the caller.
    seq_sh = NamedSharding(mesh, P(seq_axis))
    repl_sh = NamedSharding(mesh, P())
    return jax.jit(refine, out_shardings=(seq_sh, repl_sh))
