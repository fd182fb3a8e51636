"""The SLAM pipeline: two-view bootstrap + per-frame tracking on the device.

Re-design of the reference orchestrator (src/Slam.cpp) around one principle:
each video frame is processed by a SINGLE jit-compiled device step —
extraction, initial pose, both matching passes, both motion-BA solves, the
keyframe decision, and (under lax.cond, so it only executes when taken) the
entire keyframe path including triangulation, global BA and culling. The host
loop only decodes frames and reads back a small StepInfo for logging; there is
no per-stage host<->device ping-pong.

Stage-by-stage parity with the reference step (src/Slam.cpp:89-122):
  initial pose      -> constant-position or essential-matrix RANSAC
                       (src/Slam.cpp:124-136)
  match last KF     -> map->frame matcher filtered to points observed by the
                       last keyframe (src/Slam.cpp:138-150)
  optimize pose     -> motion-only BA, points frozen (src/Slam.cpp:165-175)
  match map         -> same matcher, no filter, de-dup vs existing matches
                       (src/Slam.cpp:152-163)
  optimize pose     -> again
  keyframe decision -> matches < 0.9 x last keyframe's (src/Slam.cpp:113-118)
  keyframe path     -> add associations, triangulate unmatched (flag), global
                       BA with all previous KFs frozen + points free (flag),
                       cull mean-reproj > 3 px (flag) (src/Slam.cpp:177-243)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import se3
from ..ops.ba import HUBER_DELTA, BAProblem, motion_ba, structure_ba
from ..ops.camera import Camera
from ..ops.image import bilinear_sample
from ..ops.matching import match_map_to_frame, unmatched_mask
from ..ops.ransac import estimate_relative_pose
from ..ops.triangulation import triangulate_points
from .config import SlamConfig
from .frontend import ClassicalFrontend, LightGlueMatcher
from .state import (
    Features,
    SlamState,
    add_associations,
    create_points,
    keyframe_reprojection_error,
    point_reprojection_errors,
    point_reprojection_errors_sel,
    remove_points,
    write_keyframe,
)


class StepInfo(NamedTuple):
    """Per-frame diagnostics (small; cheap to pull to host for logging)."""

    rvec: jnp.ndarray
    t: jnp.ndarray
    n_matches_kf: jnp.ndarray  # after match-with-last-keyframe
    n_matches_total: jnp.ndarray  # after match-with-map
    n_last_kf_matches: jnp.ndarray
    is_keyframe: jnp.ndarray
    n_points: jnp.ndarray
    n_keyframes: jnp.ndarray
    reproj_error_px: jnp.ndarray
    # Matches that survive the pose solve: residual < 3 px after the final
    # motion BA. Raw match counts can stay high on a STALE map (dense
    # keypoint grids give every projection ~15 candidates within the gate,
    # so spurious descriptor matches persist after tracking dies); inliers
    # collapse, making this the loss-detection signal.
    n_inliers: jnp.ndarray


def _huber(cfg: SlamConfig, cam: Camera) -> float:
    return HUBER_DELTA / cam.fx if cfg.huber_mode == "pixel" else HUBER_DELTA


def _point_matched_mask(P: int, matches: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """[P] bool — map slots referenced by the frame's match array."""
    tgt = jnp.where(valid & (matches >= 0), matches, P)
    return jnp.zeros((P,), bool).at[tgt].set(True, mode="drop")


def _commit_keyframe(
    state: SlamState,
    img: jnp.ndarray,
    feat: Features,
    rvec: jnp.ndarray,
    t: jnp.ndarray,
    matches: jnp.ndarray,
    *,
    cam: Camera,
    cfg: SlamConfig,
    matcher,
) -> SlamState:
    """The keyframe path (src/Slam.cpp:177-219 + cull 221-243), jit-safe."""
    F = cfg.max_keyframes
    kfs, m = state.kfs, state.map
    last_slot = state.last_kf_slot

    # Slot policy: fill free slots first; at capacity, evict the OLDEST
    # keyframe (sliding local map). The reference grows its keyframe vector
    # unboundedly (src/Slam.h:44); a fixed-capacity device store must evict, and
    # oldest-first keeps the recent window that tracking actually matches
    # against.
    oldest = jnp.argmin(
        jnp.where(kfs.valid, kfs.frame_index, jnp.iinfo(jnp.int32).max)
    ).astype(jnp.int32)
    slot = jnp.where(state.num_kf < F, state.num_kf, oldest)

    # Archive the evicted keyframe's pose (at its last refined value) so the
    # full trajectory from frame 0 stays evaluable — the reference never
    # forgets a keyframe (src/Slam.h:42-47). OOB index + mode='drop' makes
    # the append a no-op when no eviction happens (or the archive is full;
    # arch_count keeps the true eviction total so the host can detect
    # overflow).
    A = state.arch_frame_index.shape[0]
    evict = state.num_kf >= F
    aidx = jnp.where(evict, state.arch_count, A).astype(jnp.int32)
    arch_rvec = state.arch_rvec.at[aidx].set(kfs.rvec[oldest], mode="drop")
    arch_t = state.arch_t.at[aidx].set(kfs.t[oldest], mode="drop")
    arch_fi = state.arch_frame_index.at[aidx].set(
        kfs.frame_index[oldest], mode="drop"
    )
    arch_count = state.arch_count + evict.astype(jnp.int32)

    # Scrub observations referencing the evicted slot, then drop map points
    # that lost their last observation (they can never be matched or culled
    # again — zombie slots would otherwise exhaust map capacity).
    # Points losing an observation here are cull candidates (their MEAN
    # error changes); capture the mask before the scrub erases it.
    evicted_obs = m.observed_by(slot) & m.valid
    m = m._replace(obs_valid=m.obs_valid & (m.obs_kf != slot))
    orphan = m.valid & ~jnp.any(m.obs_valid, axis=-1)
    m, kfs = remove_points(m, kfs, orphan)

    match_ok = (matches >= 0) & feat.valid
    kfs = write_keyframe(
        kfs, slot, rvec, t, feat, jnp.where(match_ok, matches, -1), state.frame_count
    )
    # Map associations for tracked matches (src/Slam.cpp:180-183).
    m = add_associations(
        m, slot, matches, match_ok, kfs.frame_index, policy=cfg.obs_policy
    )

    # Triangulate unmatched features vs the last keyframe (src/Slam.cpp:186-199).
    if cfg.triangulate_points:
        fm = matcher(
            kfs.desc[last_slot],
            kfs.kp_xy[last_slot],
            kfs.kp_valid[last_slot],
            feat.desc,
            feat.xy,
            feat.valid,
        )
        kp1_matched = kfs.matches[last_slot] >= 0
        kp2_matched = kfs.matches[slot] >= 0
        un = unmatched_mask(fm, kp1_matched, kp2_matched)
        uv1 = kfs.kp_xy[last_slot][fm.train_idx]
        pose1 = se3.pose_matrix(kfs.rvec[last_slot], kfs.t[last_slot])
        pose2 = se3.pose_matrix(rvec, t)
        tri = triangulate_points(cam, pose1, pose2, uv1, feat.xy, mask=un,
                                 max_reproj_px=cfg.triangulation_reproj_px)
        colors = bilinear_sample(img, feat.xy)
        K = feat.xy.shape[0]
        m, kfs, new_slots, new_created = create_points(
            m,
            tri.points,
            tri.valid,
            last_slot,
            slot,
            fm.train_idx,
            jnp.arange(K, dtype=jnp.int32),
            colors,
            kfs,
        )
    else:
        new_slots = new_created = None

    # Global BA: all previous keyframes frozen, the new one free, points free
    # (src/Slam.cpp:202-213 — only points observed by the free frame enter).
    # The problem is COMPACTED to the <= K slots observed by the new keyframe
    # (see MapState.ba_point_selection) so LM iterates over [Pc, O] tensors
    # instead of the full map capacity.
    if cfg.bundle_adjust:
        K = feat.xy.shape[0]
        P = m.valid.shape[0]
        huber = _huber(cfg, cam)

        def solve_single(kfs, m):
            """Reference shape: only the NEW keyframe free, points it
            observes free (src/Slam.cpp:202-213)."""
            Pc = min(P, cfg.ba_commit_budget or -(-K // 128) * 128)
            sel, sel_ok = m.ba_point_selection(slot, Pc)
            obs_kf = m.obs_kf[sel]
            obs_kp = m.obs_kp[sel]
            prob = BAProblem(
                cam_rvec=kfs.rvec,
                cam_t=kfs.t,
                points=m.pos[sel],
                obs_cam=obs_kf,
                obs_uv=kfs.kp_xy[obs_kf, obs_kp],
                obs_valid=m.obs_valid[sel] & sel_ok[:, None],
                cam_free=jnp.arange(F) == slot,
                cam_in_problem=kfs.valid,
                point_free=sel_ok,
                point_in_problem=sel_ok,
            )
            res = structure_ba(
                cam, prob, slot, max_iters=cfg.ba_iters, huber_delta=huber,
            )
            pos = m.pos.at[jnp.where(sel_ok, sel, P)].set(
                res.points, mode="drop"
            )
            return res.cam_rvec, res.cam_t, pos

        def solve_window(kfs, m):
            """Windowed local BA: the W newest keyframes free (two stay
            frozen as gauge anchors), over the points they observe — the
            drift the reference locks into frozen history gets re-solved
            while it is still cheap. The covering point set is SMALL (the
            window shares its tracked points; measured ~355 live at W=4),
            so the budget is window_ba_budget, not W x K."""
            from ..ops.ba import window_ba

            Wn = cfg.local_ba_window
            newest_first = jnp.argsort(
                jnp.where(kfs.valid, -kfs.frame_index, jnp.int32(1 << 30))
            ).astype(jnp.int32)
            n_free = jnp.clip(jnp.sum(kfs.valid) - 2, 1, Wn)
            free_slots = jnp.where(
                jnp.arange(Wn) < n_free, newest_first[:Wn], -1
            ).astype(jnp.int32)
            Pc = min(P, cfg.window_ba_budget)
            sel, sel_ok = m.ba_point_selection_mask(
                m.observed_by_any(free_slots) & m.valid, Pc
            )
            obs_kf = m.obs_kf[sel]
            obs_kp = m.obs_kp[sel]
            prob = BAProblem(
                cam_rvec=kfs.rvec,
                cam_t=kfs.t,
                points=m.pos[sel],
                obs_cam=obs_kf,
                obs_uv=kfs.kp_xy[obs_kf, obs_kp],
                obs_valid=m.obs_valid[sel] & sel_ok[:, None],
                cam_free=jnp.arange(F) == slot,
                cam_in_problem=kfs.valid,
                point_free=sel_ok,
                point_in_problem=sel_ok,
            )
            res = window_ba(
                cam, prob, free_slots, max_iters=cfg.ba_iters,
                huber_delta=huber,
            )
            pos = m.pos.at[jnp.where(sel_ok, sel, P)].set(
                res.points, mode="drop"
            )
            return res.cam_rvec, res.cam_t, pos

        if cfg.local_ba_window <= 1:
            new_rvec, new_t, new_pos = solve_single(kfs, m)
        elif cfg.window_ba_every <= 1:
            new_rvec, new_t, new_pos = solve_window(kfs, m)
        else:
            # Hybrid cadence: the windowed drift-corrector every Nth commit,
            # the ~2x-cheaper fused single-camera solver otherwise. Both
            # branches compile; only the taken one executes (lax.cond).
            commit_no = state.arch_count + state.num_kf  # total commits
            new_rvec, new_t, new_pos = jax.lax.cond(
                commit_no % cfg.window_ba_every == 0,
                lambda args: solve_window(*args),
                lambda args: solve_single(*args),
                (kfs, m),
            )
        kfs = kfs._replace(rvec=new_rvec, t=new_t)
        m = m._replace(pos=new_pos)
        rvec = new_rvec[slot]
        t = new_t[slot]

    # Cull points with mean reprojection error > 3 px (src/Slam.cpp:221-243).
    # Incremental-exact: a point whose position, observing-keyframe poses,
    # and observation set are all unchanged since its last check has an
    # unchanged mean error — it survived then, so it survives now. The only
    # points whose inputs changed this commit are (a) those observed by the
    # newest W keyframes (covers every pose the single/window BA freed and
    # every point position either solver moved — both selections are subsets
    # of these observation masks), (b) those that gained an observation or
    # were created (subset of observed_by(slot), slot ∈ newest W), and
    # (c) those that lost an observation to the eviction scrub. Periodic
    # refinement moves everything, but its program runs its own FULL sweep
    # (see _refine_fn), so the invariant holds between commits. The sweep
    # compacts to <= cull_budget candidate rows ([C, O] work instead of
    # [P, O] — one of the P-proportional passes behind the large-map
    # throughput gap); if candidates ever overflow the budget, lax.cond
    # falls back to the exact full sweep rather than skipping checks.
    if cfg.cull_points:
        P = m.valid.shape[0]
        Wc = max(cfg.local_ba_window, 1)
        # Invalid slots sort last; if one lands in the window (num_kf < Wc)
        # it has no valid observations, so observed_by_any ignores it.
        newest = jnp.argsort(
            jnp.where(kfs.valid, -kfs.frame_index, jnp.int32(1 << 30))
        )[:Wc].astype(jnp.int32)
        cand = (evicted_obs | m.observed_by_any(newest)) & m.valid
        Cb = min(P, cfg.cull_budget)
        csel, csel_ok = m.ba_point_selection_mask(cand, Cb)

        def cull_compact(args):
            m_, kfs_ = args
            err, has_obs = point_reprojection_errors_sel(
                cam, m_, kfs_, csel, csel_ok
            )
            bad = csel_ok & has_obs & (err > cfg.cull_reproj_px)
            return (
                jnp.zeros((P,), bool)
                .at[jnp.where(bad, csel, P)]
                .set(True, mode="drop")
            )

        def cull_full(args):
            m_, kfs_ = args
            err, has_obs = point_reprojection_errors(cam, m_, kfs_)
            return m_.valid & has_obs & (err > cfg.cull_reproj_px)

        remove = jax.lax.cond(
            jnp.sum(cand) <= Cb, cull_compact, cull_full, (m, kfs)
        )
        m, kfs = remove_points(m, kfs, remove)

    # Incremental obs-descriptor cache refresh: the only rows whose
    # observation TABLE changed this commit are tracked associations
    # (add_associations targets `matches`) and created points — at most
    # K + C of the P capacity slots. Re-gather just those [T, O, D] rows
    # instead of the full [P, O, D] sweep; removals/evictions only flip
    # validity, which every consumer re-derives from obs_valid & valid.
    # (At P=16384 the full re-gather per commit was one of the
    # P-proportional passes behind the 37% large-map throughput loss.)
    Pm = m.valid.shape[0]
    touched = jnp.where(match_ok, matches, Pm).astype(jnp.int32)
    if new_slots is not None:
        t2 = jnp.where(new_created, new_slots, Pm).astype(jnp.int32)
        touched = jnp.concatenate([touched, t2])
    safe = jnp.minimum(touched, Pm - 1)
    drows = kfs.desc[m.obs_kf[safe], m.obs_kp[safe]].astype(jnp.bfloat16)
    obs_desc = state.obs_desc.at[touched].set(drows, mode="drop")

    return state._replace(
        kfs=kfs,
        map=m,
        num_kf=jnp.minimum(state.num_kf + 1, F),
        last_kf_slot=slot,
        last_rvec=rvec,
        last_t=t,
        obs_desc=obs_desc,
        arch_rvec=arch_rvec,
        arch_t=arch_t,
        arch_frame_index=arch_fi,
        arch_count=arch_count,
    )


def slam_step(
    state: SlamState,
    img: jnp.ndarray,
    key: jax.Array,
    mask: jnp.ndarray | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend: ClassicalFrontend,
) -> tuple[SlamState, StepInfo]:
    """One fully-fused tracking step (device-side equivalent of
    Slam::step, src/Slam.cpp:89-122)."""
    P = cfg.map_capacity
    # Accept uint8 images (4x cheaper host->device transfer) and normalize
    # on device.
    if img.dtype == jnp.uint8:
        img = img.astype(jnp.float32) * (1.0 / 255.0)
    feat = frontend.extract(img, mask)
    last_slot = state.last_kf_slot

    # ---- Initial pose estimate (src/Slam.cpp:124-136) ----------------------
    if cfg.essential_matrix_estimation:
        fm = frontend.matcher(
            state.last_feat.desc,
            state.last_feat.xy,
            state.last_feat.valid,
            feat.desc,
            feat.xy,
            feat.valid,
        )
        uv1 = state.last_feat.xy[fm.train_idx]
        est = estimate_relative_pose(
            cam,
            uv1,
            feat.xy,
            fm.valid,
            key,
            num_hypotheses=cfg.ransac_hypotheses,
            threshold_px=cfg.ransac_threshold_px,
        )
        pose = se3.compose(
            est.pose, se3.pose_matrix(state.last_rvec, state.last_t)
        )
        rvec, t = se3.rt_from_matrix(pose)
    elif cfg.pose_prediction == "adaptive":
        # Healthy tracking: constant position (free). Starved tracking
        # (previous frame's inliers below the threshold): essential-matrix
        # frame-to-frame prediction — the stale-map position model is
        # exactly what drags the pose off during sparse stretches, while
        # frame-to-frame geometry stays sound. lax.cond executes only the
        # taken branch, so the matcher+RANSAC cost only exists in the rare
        # starved frames.
        def _essential_pred(_):
            fm = frontend.matcher(
                state.last_feat.desc,
                state.last_feat.xy,
                state.last_feat.valid,
                feat.desc,
                feat.xy,
                feat.valid,
            )
            uv1 = state.last_feat.xy[fm.train_idx]
            est = estimate_relative_pose(
                cam,
                uv1,
                feat.xy,
                fm.valid,
                key,
                num_hypotheses=cfg.ransac_hypotheses,
                threshold_px=cfg.ransac_threshold_px,
            )
            # Constant-speed prior: the essential decomposition's
            # translation is unit-norm (monocular scale is unobservable) —
            # composing it raw would add ~unit-length jumps per starved
            # frame, and the motion BA has too few good map matches there
            # to rescale it (measured: 12-18% full-trajectory ATE).
            # Rescale the relative translation to the previous inter-frame
            # camera-center displacement: direction from 2-view geometry,
            # magnitude from the motion prior.
            T_last = se3.pose_matrix(state.last_rvec, state.last_t)
            T_prev = se3.pose_matrix(state.prev_rvec, state.prev_t)
            speed = jnp.linalg.norm(
                se3.camera_center(T_last) - se3.camera_center(T_prev)
            )
            rel_t = est.pose[:3, 3]
            rel_t = rel_t / (jnp.linalg.norm(rel_t) + 1e-9) * speed
            rel = est.pose.at[:3, 3].set(rel_t)
            pose = se3.compose(rel, T_last)
            return se3.rt_from_matrix(pose)

        rvec, t = jax.lax.cond(
            state.last_inliers < cfg.adaptive_pred_inliers,
            _essential_pred,
            lambda _: (state.last_rvec, state.last_t),
            None,
        )
    elif cfg.pose_prediction == "constant_velocity":
        # Constant-velocity model: extrapolate the last relative motion,
        # T_pred = (T_last inv(T_prev)) T_last. Keeps the 20 px projected
        # match gate centered under racing-like motion where the reference's
        # constant-position model (src/Slam.cpp:134) mispredicts by several
        # px and starves matching exactly in the hard stretches.
        T_last = se3.pose_matrix(state.last_rvec, state.last_t)
        T_prev = se3.pose_matrix(state.prev_rvec, state.prev_t)
        T_pred = se3.compose(se3.compose(T_last, se3.inverse(T_prev)), T_last)
        rvec, t = se3.rt_from_matrix(T_pred)
    else:
        # Constant-position model (src/Slam.cpp:134).
        rvec, t = state.last_rvec, state.last_t

    huber = _huber(cfg, cam)
    obs_desc = state.obs_desc  # cached gather (see SlamState.obs_desc)
    obs_dvalid = state.map.obs_valid & state.map.valid[:, None]
    no_kp_matched = jnp.zeros(feat.valid.shape, bool)
    no_pt_matched = jnp.zeros((P,), bool)

    # ---- Match with last keyframe's points (src/Slam.cpp:138-150) ----------
    filt = state.map.observed_by(last_slot) & state.map.valid
    mm1 = match_map_to_frame(
        cam,
        se3.pose_matrix(rvec, t),
        state.map.pos,
        filt,
        obs_desc,
        obs_dvalid,
        feat.xy,
        feat.desc,
        feat.valid,
        no_kp_matched,
        no_pt_matched,
        max_distance=frontend.max_distance,
        radius_px=cfg.match_radius_px,
        backend=cfg.matching_backend,
    )
    matches = jnp.where(mm1.valid, mm1.point_idx, -1)
    n_kf_matches = jnp.sum(matches >= 0)

    # ---- Optimize pose (src/Slam.cpp:165-175) ------------------------------
    if cfg.optimize_pose:
        res = motion_ba(
            cam,
            rvec,
            t,
            feat.xy,
            state.map.pos[jnp.clip(matches, 0)],
            matches >= 0,
            max_iters=cfg.motion_ba_iters,
            huber_delta=huber,
            backend=cfg.ba_backend,
        )
        rvec, t = res.rvec, res.t

    # ---- Match with the whole map (src/Slam.cpp:152-163) -------------------
    mm2 = match_map_to_frame(
        cam,
        se3.pose_matrix(rvec, t),
        state.map.pos,
        state.map.valid,
        obs_desc,
        obs_dvalid,
        feat.xy,
        feat.desc,
        feat.valid,
        matches >= 0,
        _point_matched_mask(P, matches, feat.valid),
        max_distance=frontend.max_distance,
        radius_px=cfg.match_radius_px,
        backend=cfg.matching_backend,
    )
    matches = jnp.where(mm2.valid & (matches < 0), mm2.point_idx, matches)

    if cfg.optimize_pose:
        res = motion_ba(
            cam,
            rvec,
            t,
            feat.xy,
            state.map.pos[jnp.clip(matches, 0)],
            matches >= 0,
            max_iters=cfg.motion_ba_iters,
            huber_delta=huber,
            backend=cfg.ba_backend,
        )
        rvec, t = res.rvec, res.t

    # ---- Keyframe decision (src/Slam.cpp:113-118) --------------------------
    n_total = jnp.sum((matches >= 0) & feat.valid)
    n_last = state.kfs.num_matches(last_slot)
    is_kf = n_total < cfg.keyframe_match_ratio * n_last

    # Post-solve inlier count (see StepInfo.n_inliers): one [K] projection.
    from ..ops.camera import project_with_depth

    uv_m, depth_m = project_with_depth(
        cam, se3.pose_matrix(rvec, t), state.map.pos[jnp.clip(matches, 0)]
    )
    reproj_m = jnp.linalg.norm(uv_m - feat.xy, axis=-1)
    n_inliers = jnp.sum(
        (matches >= 0) & feat.valid & (depth_m > 0.0)
        & (reproj_m < cfg.inlier_px)
    )
    if cfg.min_commit_inliers:
        # Absolute commit floor (see SlamConfig.min_commit_inliers): keep
        # triangulating fresh geometry through starved stretches instead of
        # letting the relative rule's bar chase the starvation down.
        is_kf = is_kf | (n_inliers < cfg.min_commit_inliers)

    state = state._replace(
        last_rvec=rvec,
        last_t=t,
        prev_rvec=state.last_rvec,
        prev_t=state.last_t,
        last_feat=feat,
        last_matches=matches,
        last_inliers=n_inliers.astype(jnp.int32),
    )
    state = jax.lax.cond(
        is_kf,
        lambda s: _commit_keyframe(
            s, img, feat, rvec, t, matches, cam=cam, cfg=cfg,
            matcher=frontend.matcher,
        ),
        lambda s: s,
        state,
    )
    state = state._replace(frame_count=state.frame_count + 1)

    # Monitoring metric (reference prints it every frame, src/main.cpp:106).
    # The [F, K] projection pass is pure diagnostics taxing the fused hot
    # loop, so recompute only every reproj_monitor_every frames (0 = only at
    # keyframe commits, where the map changed anyway).
    every = cfg.reproj_monitor_every
    if every == 1:
        state = state._replace(
            reproj_px=keyframe_reprojection_error(cam, state.map, state.kfs)
        )
    elif every > 1:
        state = state._replace(
            reproj_px=jax.lax.cond(
                (state.frame_count % every == 0) | is_kf,
                lambda s: keyframe_reprojection_error(cam, s.map, s.kfs),
                lambda s: s.reproj_px,
                state,
            )
        )
    else:
        state = state._replace(
            reproj_px=jax.lax.cond(
                is_kf,
                lambda s: keyframe_reprojection_error(cam, s.map, s.kfs),
                lambda s: s.reproj_px,
                state,
            )
        )

    info = StepInfo(
        rvec=state.last_rvec,
        t=state.last_t,
        n_matches_kf=n_kf_matches,
        n_matches_total=n_total,
        n_last_kf_matches=n_last,
        is_keyframe=is_kf,
        n_points=state.map.num_points(),
        n_keyframes=state.num_kf,
        reproj_error_px=state.reproj_px,
        n_inliers=n_inliers,
    )
    return state, info


def _null_info(state: SlamState) -> StepInfo:
    """StepInfo for a padded (inactive) scan slot; dtypes match slam_step's."""
    z = jnp.int32(0)
    return StepInfo(
        rvec=state.last_rvec,
        t=state.last_t,
        n_matches_kf=z,
        n_matches_total=z,
        n_last_kf_matches=z,
        is_keyframe=jnp.bool_(False),
        n_points=z,
        n_keyframes=state.num_kf,
        reproj_error_px=state.reproj_px.astype(jnp.float32),
        n_inliers=z,
    )


def slam_step_batch(
    state: SlamState,
    imgs: jnp.ndarray,  # [N, H, W] uint8 (or float32)
    keys: jax.Array,  # [N] PRNG keys
    active: jnp.ndarray,  # [N] bool — False for EOF padding slots
    mask: jnp.ndarray | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend: ClassicalFrontend,
) -> tuple[SlamState, StepInfo]:
    """N tracking steps in ONE device program (lax.scan over frames).

    The reference steps strictly one frame per host iteration
    (src/main.cpp:72-111); here each dispatch costs a host->device round
    trip, so the host loop feeds the device a whole decoded frame batch and
    the sequential recurrence runs on-device. Padding slots (active=False) leave the state untouched, so a
    final partial batch reuses the same compiled program.
    """

    def body(st, xs):
        img, key, act = xs
        return jax.lax.cond(
            act,
            lambda s: slam_step(s, img, key, mask, cam=cam, cfg=cfg, frontend=frontend),
            lambda s: (s, _null_info(s)),
            st,
        )

    return jax.lax.scan(body, state, (imgs, keys, active))


# ---------------------------------------------------------------------------
# Two-view bootstrap (src/Slam.cpp:32-87, src/Init.cpp:8-63)
# ---------------------------------------------------------------------------


class InitAttempt(NamedTuple):
    pose: jnp.ndarray  # [4, 4] relative pose ref->query
    n_triangulated: jnp.ndarray
    match_train: jnp.ndarray  # [K] i32
    match_valid: jnp.ndarray  # [K] bool


def try_initialize(
    ref_feat: Features,
    query_feat: Features,
    key: jax.Array,
    *,
    cam: Camera,
    cfg: SlamConfig,
    matcher,
) -> InitAttempt:
    """One pairing attempt of the initializer (src/Init.cpp:38-57): match,
    estimate pose, count clean triangulations."""
    fm = matcher(
        ref_feat.desc, ref_feat.xy, ref_feat.valid,
        query_feat.desc, query_feat.xy, query_feat.valid,
    )
    uv1 = ref_feat.xy[fm.train_idx]
    est = estimate_relative_pose(
        cam,
        uv1,
        query_feat.xy,
        fm.valid,
        key,
        num_hypotheses=cfg.init_ransac_hypotheses,
        threshold_px=cfg.ransac_threshold_px,
    )
    eye = jnp.eye(4)
    tri = triangulate_points(cam, eye, est.pose, uv1, query_feat.xy,
                             mask=fm.valid,
                             max_reproj_px=cfg.triangulation_reproj_px)
    return InitAttempt(
        pose=est.pose,
        n_triangulated=jnp.sum(tri.valid),
        match_train=fm.train_idx,
        match_valid=fm.valid,
    )


def commit_initialization(
    state: SlamState,
    ref_feat: Features,
    query_feat: Features,
    ref_img: jnp.ndarray,
    query_pose: jnp.ndarray,
    match_train: jnp.ndarray,
    match_valid: jnp.ndarray,
    ref_index: jnp.ndarray,
    query_index: jnp.ndarray,
    *,
    cam: Camera,
    cfg: SlamConfig,
) -> SlamState:
    """Accept an initialization (src/Slam.cpp:42-86): triangulate, create map
    points, BA {ref frozen, query free, points free}, rescale to unit
    baseline, install both keyframes."""
    F = cfg.max_keyframes
    kfs, m = state.kfs, state.map
    eye = jnp.eye(4)
    K = query_feat.xy.shape[0]

    if ref_img.dtype == jnp.uint8:
        ref_img = ref_img.astype(jnp.float32) * (1.0 / 255.0)
    rvec_q, t_q = se3.rt_from_matrix(query_pose)
    uv1 = ref_feat.xy[match_train]
    tri = triangulate_points(cam, eye, query_pose, uv1, query_feat.xy,
                             mask=match_valid,
                             max_reproj_px=cfg.triangulation_reproj_px)

    kfs = write_keyframe(
        kfs, 0, jnp.zeros(3), jnp.zeros(3), ref_feat, jnp.full((K,), -1), ref_index
    )
    kfs = write_keyframe(
        kfs, 1, rvec_q, t_q, query_feat, jnp.full((K,), -1), query_index
    )
    colors = bilinear_sample(ref_img, uv1)
    m, kfs, _, created = create_points(
        m,
        tri.points,
        tri.valid,
        jnp.int32(0),
        jnp.int32(1),
        match_train,
        jnp.arange(K, dtype=jnp.int32),
        colors,
        kfs,
    )

    # BA: ref fixed, query free, points free (src/Slam.cpp:63-68), compacted
    # to the <= K slots the bootstrap just created.
    P = m.valid.shape[0]
    Pc = min(P, -(-K // 128) * 128)
    sel, sel_ok = m.ba_point_selection(jnp.int32(1), Pc)
    obs_kf = m.obs_kf[sel]
    obs_kp = m.obs_kp[sel]
    prob = BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos[sel],
        obs_cam=obs_kf,
        obs_uv=kfs.kp_xy[obs_kf, obs_kp],
        obs_valid=m.obs_valid[sel] & sel_ok[:, None],
        cam_free=jnp.arange(F) == 1,
        cam_in_problem=kfs.valid,
        point_free=sel_ok,
        point_in_problem=sel_ok,
    )
    res = structure_ba(
        cam, prob, jnp.int32(1), max_iters=cfg.ba_iters,
        huber_delta=_huber(cfg, cam),
    )
    kfs = kfs._replace(rvec=res.cam_rvec, t=res.cam_t)
    tgt = jnp.where(sel_ok, sel, P)
    m = m._replace(pos=m.pos.at[tgt].set(res.points, mode="drop"))

    # Rescale to unit baseline (src/Slam.cpp:70-80).
    scale = 1.0 / (jnp.linalg.norm(kfs.t[1] - kfs.t[0]) + 1e-12)
    kfs = kfs._replace(t=kfs.t.at[1].set(kfs.t[1] * scale))
    m = m._replace(pos=jnp.where(m.valid[:, None], m.pos * scale, m.pos))

    return state._replace(
        kfs=kfs,
        map=m,
        num_kf=jnp.int32(2),
        last_kf_slot=jnp.int32(1),
        last_rvec=kfs.rvec[1],
        last_t=kfs.t[1],
        # Zero initial velocity: the bootstrap pair may be several frames
        # apart, so its relative motion over-predicts the per-frame step.
        prev_rvec=kfs.rvec[1],
        prev_t=kfs.t[1],
        last_feat=query_feat,
        last_matches=kfs.matches[1],
        frame_count=query_index.astype(jnp.int32) + 1,
        obs_desc=m.observation_descriptors(kfs)[0].astype(jnp.bfloat16),
        # Fresh bootstrap = healthy tracking: seed the adaptive-prediction
        # signal with the accepted match count so the first post-init frame
        # uses the constant-position model.
        last_inliers=jnp.sum(match_valid).astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


class Slam:
    """Host orchestrator: owns the device state, decodes frames, drives jitted
    steps. Mirrors the public surface of the reference Slam class
    (src/Slam.h:20-33): initialize(), step(), map/poses/reprojection_error."""

    def __init__(
        self,
        cam: Camera,
        video,  # iterable yielding [H, W] float32 grayscale frames
        config: SlamConfig = SlamConfig(),
        static_mask: np.ndarray | None = None,
        seed: int = 0,
        frontend=None,
    ):
        self.cam = cam
        self.cfg = config
        self.video = iter(video)
        self.frontend = frontend if frontend is not None else ClassicalFrontend(
            cell=config.cell,
            n_per_cell=config.n_per_cell,
            max_distance=config.max_match_distance,
        )
        if config.matcher == "lightglue":
            from pathlib import Path

            from ..models import lightglue

            # Default weight file per frontend descriptor space: classical
            # 128-d -> lightglue.npz; SuperPoint 256-d -> the jointly-trained
            # lightglue_superpoint.npz (the reference's deep path: learned
            # extractor feeding the learned matcher,
            # src/features/DeepFeatureExtractor.cpp:8).
            wdir = Path(__file__).resolve().parent.parent / "weights"
            default = (
                wdir / "lightglue_superpoint.npz"
                if self.frontend.descriptor_dim != 128
                and (wdir / "lightglue_superpoint.npz").exists()
                else wdir / "lightglue.npz"
            )
            wpath = config.lightglue_weights or str(default)
            params = lightglue.load_params(wpath)
            in_dim = params.in_proj_w.shape[0]
            if in_dim != self.frontend.descriptor_dim:
                raise ValueError(
                    f"LightGlue weights at {wpath} take {in_dim}-d descriptors "
                    f"but the {type(self.frontend).__name__} produces "
                    f"{self.frontend.descriptor_dim}-d ones; pass matching "
                    "weights via lightglue_weights (train with "
                    "models.train --which lightglue for the classical "
                    "frontend, --which lightglue-superpoint for the learned "
                    "one)"
                )
            self.frontend.matcher = LightGlueMatcher(
                params,
                image_size=(float(cam.width), float(cam.height)),
                threshold=config.lightglue_threshold,
            )
        K = self.frontend.num_keypoints(cam.height, cam.width)
        self.state = SlamState.create(
            F=config.max_keyframes,
            P=config.map_capacity,
            O=config.max_observations,
            K=K,
            D=self.frontend.descriptor_dim,
            A=config.archive_capacity,
        )
        self._mask = None if static_mask is None else jnp.asarray(static_mask)
        self._key = jax.random.PRNGKey(seed)
        # Host-side PRNG key source for the batched driver: a jax PRNG key is
        # raw uint32[2] data, so drawing key material from a host RNG avoids
        # two device round trips per batch (each jax.random.split is its own
        # dispatch). Deterministic per
        # (seed, batch index); step()/initialize() keep the split chain.
        self._seed = seed
        self._host_rng = np.random.default_rng(seed ^ 0xA5A5_5A5A)
        self._frame_idx = 0
        self._prefetched = None

        def _extract_u8(img, mask):
            if img.dtype == jnp.uint8:
                img = img.astype(jnp.float32) * (1.0 / 255.0)
            return self.frontend.extract(img, mask)

        self._extract = jax.jit(_extract_u8)
        self._step = jax.jit(
            partial(slam_step, cam=cam, cfg=config, frontend=self.frontend)
        )
        self._step_batch = jax.jit(
            partial(slam_step_batch, cam=cam, cfg=config, frontend=self.frontend)
        )
        self._try_init = jax.jit(
            partial(
                try_initialize,
                cam=cam,
                cfg=config,
                matcher=self.frontend.matcher,
            )
        )
        self._commit_init = jax.jit(
            partial(commit_initialization, cam=cam, cfg=config)
        )
        # Periodic global refinement (cfg.refine_every_frames): FULL bundle
        # adjustment over all live keyframes + points with the two oldest
        # keyframes as gauge anchors — the stage the reference's per-commit
        # frozen-history BA (src/Slam.cpp:202-213) never had. Runs unsharded
        # on this chip; MultiSlam has the landmark-sharded version
        # (parallel/refine.py).
        self._frames_since_refine = 0
        self._refine_one = None
        self.refine_costs: list = []
        if config.refine_every_frames:
            from ..ops.ba import full_ba
            from ..parallel.refine import (
                apply_refinement,
                apply_refinement_compact,
                build_global_problem,
                build_global_problem_compact,
            )

            def _refine_fn(state: SlamState):
                if config.refine_budget:
                    Rc = min(config.map_capacity, config.refine_budget)
                    prob, sel, sel_ok = build_global_problem_compact(state, Rc)
                else:
                    prob = build_global_problem(state)
                res = full_ba(
                    cam,
                    prob,
                    max_iters=config.refine_iters,
                    huber_delta=_huber(config, cam),
                )
                if config.refine_budget:
                    state = apply_refinement_compact(state, res, sel, sel_ok)
                else:
                    state = apply_refinement(state, res)
                # Post-refine outlier rejection (same 3 px rule as the
                # commit path, src/Slam.cpp:221-243): a full-window BA has
                # no other defense against bad associations — without this
                # cull they drag every pose they touch.
                if config.cull_points:
                    err, has_obs = point_reprojection_errors(
                        cam, state.map, state.kfs
                    )
                    remove = (
                        state.map.valid & has_obs & (err > config.cull_reproj_px)
                    )
                    m2, kfs2 = remove_points(state.map, state.kfs, remove)
                    state = state._replace(map=m2, kfs=kfs2)
                return state, res.cost

            self._refine_one = jax.jit(_refine_fn)

        self.infos: list = []
        # Per-frame image retention for debug overlays (run.py --overlay-every;
        # reference equivalent: the main-loop image view, src/main.cpp:85-104).
        # Off by default — it adds a device->host frame readback per step.
        self.keep_last_image = False
        self.last_image: np.ndarray | None = None
        # Failure detection / recovery bookkeeping (SlamConfig.reinit_on_lost).
        self._lost_streak = 0
        self._frames_since_check = 0
        self._pending_info: StepInfo | None = None
        self.segments: list[dict] = []  # archived trajectory segments
        self.n_reinits = 0
        self.eof_on_reinit = False  # loss declared but stream ended mid-bootstrap

    # -- frame source -------------------------------------------------------
    def _decode_next(self):
        """Pull one frame from the source and start its async device upload
        as uint8 (the host->device link is the per-frame bottleneck)."""
        pb = getattr(self, "_pushback", None)
        if pb:
            img = pb.pop(0)
            self._frame_idx += 1
            return jax.device_put(img)
        try:
            img = next(self.video)
        except StopIteration:
            return None
        self._frame_idx += 1
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return jax.device_put(img)  # async

    def _next_frame(self):
        if self._prefetched is not None:
            img, self._prefetched = self._prefetched, None
            return img
        return self._decode_next()

    def _subkey(self):
        self._key, k = jax.random.split(self._key)
        return k

    def reset_state(self) -> None:
        """Fresh world state with this engine's compiled shapes (used by the
        lost-tracking re-bootstrap and by benchmark replays)."""
        K = self.frontend.num_keypoints(self.cam.height, self.cam.width)
        self.state = SlamState.create(
            F=self.cfg.max_keyframes,
            P=self.cfg.map_capacity,
            O=self.cfg.max_observations,
            K=K,
            D=self.frontend.descriptor_dim,
            A=self.cfg.archive_capacity,
        )

    def reset_run(self, video) -> None:
        """Reset world state AND driver bookkeeping for a fresh run over
        `video` (benchmark replays reuse every compiled program)."""
        self.reset_state()
        self.video = iter(video)
        self._frame_idx = 0
        self._prefetched = None
        self._host_rng = np.random.default_rng(self._seed ^ 0xA5A5_5A5A)
        self._pushback = []
        # Reset the device PRNG chain too: the bootstrap draws RANSAC keys
        # from it, so an un-reset chain makes every benchmark replay a
        # DIFFERENT program (measured: marginal seeds bootstrap differently
        # on later replays and spiral into re-init churn).
        self._key = jax.random.PRNGKey(self._seed)
        self._frames_since_refine = 0
        self._lost_streak = 0
        self._frames_since_check = 0
        self._pending_info = None
        self.infos = []
        self.refine_costs = []
        self.segments = []
        self.n_reinits = 0
        self.eof_on_reinit = False
        self._arch_overflow_warned = False

    # -- public API ---------------------------------------------------------
    def initialize(self) -> bool:
        """Two-view bootstrap (src/Slam.cpp:32-87 + src/Init.cpp:8-63)."""
        img = self._next_frame()
        if img is None:
            return False
        ref_img = img
        ref_feat = self._extract(img, self._mask)
        ref_index = self._frame_idx - 1
        chances = 0
        while True:
            img = self._next_frame()
            if img is None:
                return False
            chances += 1
            if chances > self.cfg.max_ref_chances:
                ref_img, ref_feat, ref_index = (
                    img,
                    self._extract(img, self._mask),
                    self._frame_idx - 1,
                )
                chances = 0
                continue
            query_feat = self._extract(img, self._mask)
            att = self._try_init(ref_feat, query_feat, self._subkey())
            if int(att.n_triangulated) < self.cfg.min_init_points:
                continue
            self.state = self._commit_init(
                self.state,
                ref_feat,
                query_feat,
                ref_img,
                att.pose,
                att.match_train,
                att.match_valid,
                jnp.int32(ref_index),
                jnp.int32(self._frame_idx - 1),
            )
            return True

    def step(self) -> StepInfo | None:
        """Process one frame (src/Slam.cpp:89-122). Returns None at EOF."""
        while True:
            img = self._next_frame()
            if img is None:
                return None
            self.state, info = self._step(
                self.state, img, self._subkey(), self._mask
            )
            if self.keep_last_image:
                self.last_image = np.asarray(img)
            # Overlap the next frame's decode+upload with this step's compute
            # (both the step dispatch and device_put are async).
            self._prefetched = self._decode_next()
            self.infos.append(info)
            self._maybe_refine(1)
            if not self.cfg.reinit_on_lost:
                return info
            # Sample the loss signal every lost_check_interval frames, and
            # read the PREVIOUS sampled frame's info: its scalars are ready
            # (it finished while later steps were dispatched), so the
            # readback does not stall the async pipeline.
            self._frames_since_check += 1
            if self._frames_since_check < self.cfg.lost_check_interval:
                return info
            self._frames_since_check = 0
            prev, self._pending_info = self._pending_info, info
            if prev is None or self._check_tracking(prev):
                return info
            # Tracking was lost and a re-bootstrap ran: continue with the
            # next frame on the fresh map.

    def _maybe_refine(self, n_frames: int) -> None:
        """Run the periodic global refinement once `refine_every_frames`
        frames have accumulated (async dispatch; the cost scalar is read
        later, never mid-pipeline)."""
        if self._refine_one is None:
            return
        self._frames_since_refine += n_frames
        if self._frames_since_refine < self.cfg.refine_every_frames:
            return
        self._frames_since_refine = 0
        self.state, cost = self._refine_one(self.state)
        self.refine_costs.append(cost)

    # -- failure detection / recovery (new capability; see SlamConfig) ------
    def _check_tracking(self, info: StepInfo) -> bool:
        """Declare tracking lost after `lost_patience` consecutive
        low-match frames; archive the segment and re-bootstrap. Returns
        False when a re-initialization was attempted (the caller then moves
        on to the next frame, or hits EOF if the bootstrap exhausted it)."""
        if int(info.n_inliers) >= self.cfg.min_track_matches:
            self._lost_streak = 0
            return True
        self._lost_streak += 1
        if self._lost_streak < self.cfg.lost_patience:
            return True
        self._lost_streak = 0
        self._pending_info = None  # drop the in-flight info from the old map
        self._recover_lost()
        return False

    def run(self, max_frames: int | None = None) -> list:
        n = 0
        while max_frames is None or n < max_frames:
            if self.step() is None:
                break
            n += 1
        return self.infos

    # -- batched stepping (dispatch amortization) -----------------------------
    def _decode_batch(self, n: int) -> list[np.ndarray]:
        frames = []
        # Drain pushed-back frames first (a prefetched batch returned by a
        # loss-recovery or an early exit; see run_batched).
        pb = getattr(self, "_pushback", None)
        while pb and len(frames) < n:
            frames.append(pb.pop(0))
            self._frame_idx += 1
        while len(frames) < n:
            try:
                img = next(self.video)
            except StopIteration:
                break
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            frames.append(img)
            self._frame_idx += 1
        return frames

    def run_batched(self, max_frames: int | None = None, batch: int = 16) -> int:
        """Process the stream in N-frame device dispatches (slam_step_batch).

        Each dispatch costs one host->device round trip regardless of N, so
        this is the high-throughput driver. Host work is PIPELINED: a
        single worker thread decodes, stacks, and uploads batch i+1 (one
        combined device_put — images + host-drawn PRNG keys + active mask)
        while the device computes batch i, hiding the host decode + transfer
        time that otherwise serializes with compute. Dispatches never cross a refine boundary, so
        `refine_every_frames` is honest at any batch size (short sub-batches
        are padded with inactive slots and reuse the same program).

        Per-frame StepInfos accumulate as stacked device arrays in
        self.batch_infos (read them after the run). Loss detection checks
        every batch, reading the PREVIOUS batch's inlier counts (already
        computed — no stall); on recovery, any prefetched frames are pushed
        back so the re-bootstrap continues the stream in order. Returns the
        number of frames processed.
        """
        assert self._prefetched is None, "do not mix step() and run_batched()"
        from concurrent.futures import ThreadPoolExecutor

        self.batch_infos: list[StepInfo] = []
        if not hasattr(self, "_pushback"):
            self._pushback: list[np.ndarray] = []
        total = 0
        prev_infos: StepInfo | None = None
        prev_n = 0

        def calc_want(total_sim: int, since_sim: int) -> int:
            want = (
                batch if max_frames is None
                else min(batch, max_frames - total_sim)
            )
            if self._refine_one is not None:
                want = min(
                    want,
                    max(1, self.cfg.refine_every_frames - since_sim),
                )
            return want

        def prep(want: int):
            frames = self._decode_batch(want)
            if not frames:
                return None
            n = len(frames)
            padded = (
                frames + [frames[-1]] * (batch - n) if n < batch else frames
            )
            dev = jax.device_put((
                np.stack(padded),
                self._host_rng.integers(
                    0, 1 << 32, size=(batch, 2), dtype=np.uint32
                ),
                np.arange(batch) < n,
            ))
            return dev, n, frames

        def push_back(fut):
            """Return an un-processed prefetched batch to the stream."""
            if fut is None:
                return
            res = fut.result()
            if res is not None:
                self._pushback = res[2] + self._pushback
                self._frame_idx -= len(res[2])

        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(prep, calc_want(total, self._frames_since_refine))
        try:
            while max_frames is None or total < max_frames:
                res = fut.result()
                fut = None
                if res is None:
                    break
                (imgs, keys, active), n, _raw = res
                # Predict the NEXT batch's shape (refine cadence and frame
                # budget are deterministic) and start preparing it before
                # dispatching this one, so upload overlaps compute.
                total_sim = total + n
                since_sim = self._frames_since_refine + n
                if (
                    self._refine_one is not None
                    and since_sim >= self.cfg.refine_every_frames
                ):
                    since_sim = 0
                if max_frames is None or total_sim < max_frames:
                    fut = ex.submit(prep, calc_want(total_sim, since_sim))
                self.state, infos = self._step_batch(
                    self.state, imgs, keys, active, self._mask
                )
                self.batch_infos.append(infos)
                total += n
                self._maybe_refine(n)
                if not self.cfg.reinit_on_lost:
                    continue
                # Check EVERY batch, reading the PREVIOUS batch's counts
                # (already computed — no stall). If the previous batch
                # showed starvation, also check the CURRENT batch now
                # (blocking; rare) to halve the zombie window.
                lost = prev_infos is not None and self._batch_lost(
                    prev_infos, prev_n
                )
                speculated = False
                if not lost and prev_infos is not None and (
                    np.asarray(prev_infos.n_inliers)[:prev_n][-1:]
                    < self.cfg.min_track_matches
                ).any():
                    # Speculative early check ONLY when the previous batch
                    # ENDS with an open low-inlier streak (a real loss stays
                    # low into the current batch). Reading the current
                    # batch's counts BLOCKS on its dispatch — doing so for
                    # transient mid-batch dips serialized host and device
                    # and cost the learned frontend ~40% of its wall
                    # throughput (its inlier counts dip routinely while
                    # tracking stays healthy).
                    lost = self._batch_lost(infos, n)
                    speculated = True
                if lost:
                    # The prefetched batch precedes the re-bootstrap's
                    # frames: hand it back so initialize() consumes the
                    # stream in order.
                    push_back(fut)
                    fut = None
                    self._recover_lost()
                    prev_infos, prev_n = None, 0
                    fut = ex.submit(
                        prep, calc_want(total, self._frames_since_refine)
                    )
                    continue
                # A speculative check already folded THIS batch into the
                # persistent streak; re-processing it next iteration as
                # prev_infos would double-count its low-inlier runs and can
                # fire a spurious recovery below lost_patience. The streak
                # alone carries the batch's trailing run forward.
                prev_infos, prev_n = (None, 0) if speculated else (infos, n)
        finally:
            # An early exit (max_frames, EOF mid-prep) may leave decoded
            # frames in flight; hand them back to the stream.
            push_back(fut)
            ex.shutdown()
        # Close the run with a final refinement if frames accumulated since
        # the last one: callers read the state right after run_batched, and
        # a window refined N frames ago is measurably worse than one refined
        # now (the whole point of the periodic full BA).
        if self._refine_one is not None and self._frames_since_refine > 0:
            self._frames_since_refine = 0
            self.state, cost = self._refine_one(self.state)
            self.refine_costs.append(cost)
        return total

    def _check_batch(self, infos: StepInfo, n: int) -> bool:
        """Loss detection + recovery in one call (per-frame driver parity).
        Returns False when tracking was declared lost and a re-bootstrap
        ran."""
        if not self._batch_lost(infos, n):
            return True
        self._recover_lost()
        return False

    def _batch_lost(self, infos: StepInfo, n: int) -> bool:
        """PURE detection over a completed batch's stacked infos (updates
        only the streak counter) — recovery is separate so run_batched can
        hand prefetched frames back to the stream first. True = lost.

        Semantics: only the streak still OPEN at the batch end counts. A
        mid-batch dip that self-recovers within the same batch does not
        trigger (measured on the bench world, seed 7: inliers fall to
        single digits for ~6 frames near frame 250 and recover unaided —
        re-initing there would discard a live map that tracking was about
        to re-acquire, which is exactly the bad trade)."""
        counts = np.asarray(infos.n_inliers)[:n]
        lost_run = self._lost_streak  # streak persists across batches
        for c in counts:
            lost_run = lost_run + 1 if c < self.cfg.min_track_matches else 0
        if lost_run < self.cfg.lost_patience:
            self._lost_streak = lost_run
            return False
        self._lost_streak = 0
        return True

    def _recover_lost(self) -> None:
        """Archive the finished trajectory segment and re-bootstrap from the
        current stream position. If the re-bootstrap cannot complete (EOF
        before two initializing frames are found — a loss declared near the
        end of the stream), restore the archived world state instead of
        finishing with an empty map: the old map was live moments ago and
        every accessor (poses/points/reprojection_error) should keep
        reflecting it."""
        backup = self.state
        self.segments.append(
            dict(
                poses=self.poses(include_archived=True),
                frame_indices=self.keyframe_indices(include_archived=True),
                points=self.points(),
            )
        )
        self.reset_state()
        self.n_reinits += 1
        if not self.initialize():
            self.state = backup
            self.segments.pop()
            self.n_reinits -= 1
            self.eof_on_reinit = True
        self._prefetched = None

    # -- accessors (reference: Slam::map/poses/reprojection_error) ----------
    def _kf_slots(self) -> np.ndarray:
        """Valid keyframe slots ordered by source frame index (the store is
        unordered once eviction starts reusing slots)."""
        v = np.asarray(self.state.kfs.valid)
        fi = np.asarray(self.state.kfs.frame_index)
        slots = np.nonzero(v)[0]
        return slots[np.argsort(fi[slots], kind="stable")]

    def archived(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evicted-keyframe archive: (frame_indices [N], rvec [N,3], t [N,3])
        in eviction order == temporal order (eviction always takes the oldest
        live keyframe). Warns once if evictions overflowed the archive."""
        A = self.state.arch_frame_index.shape[0]
        total = int(self.state.arch_count)
        if total > A and not getattr(self, "_arch_overflow_warned", False):
            self._arch_overflow_warned = True
            import warnings

            warnings.warn(
                f"keyframe archive overflow: {total} evictions > capacity "
                f"{A}; full-trajectory output is truncated — raise "
                "SlamConfig.archive_capacity"
            )
        n = min(total, A)
        return (
            np.asarray(self.state.arch_frame_index)[:n],
            np.asarray(self.state.arch_rvec)[:n],
            np.asarray(self.state.arch_t)[:n],
        )

    def poses(self, include_archived: bool = False) -> np.ndarray:
        """[N, 4, 4] keyframe poses in temporal order. With
        include_archived, evicted keyframes (slam/state.py archive) are
        prepended so the trajectory covers frame 0 onward — the reference
        keeps every keyframe (src/Slam.h:42-47), so full-trajectory output
        is the parity surface."""
        s = self._kf_slots()
        T = np.asarray(
            se3.pose_matrix(self.state.kfs.rvec[s], self.state.kfs.t[s])
        )
        if not include_archived:
            return T
        _, arv, at = self.archived()
        if len(arv) == 0:
            return T
        Ta = np.asarray(se3.pose_matrix(jnp.asarray(arv), jnp.asarray(at)))
        return np.concatenate([Ta, T], axis=0)

    def keyframe_indices(self, include_archived: bool = False) -> np.ndarray:
        live = np.asarray(self.state.kfs.frame_index)[self._kf_slots()]
        if not include_archived:
            return live
        afi, _, _ = self.archived()
        return np.concatenate([afi, live], axis=0)

    def points(self) -> np.ndarray:
        m = self.state.map
        v = np.asarray(m.valid)
        return np.asarray(m.pos)[v]

    def reprojection_error(self) -> float:
        return float(
            keyframe_reprojection_error(self.cam, self.state.map, self.state.kfs)
        )

    def overlay_data(self) -> dict:
        """Current-frame overlay ingredients (keypoints, matched map-point
        projections, match mask) for viz.save_overlay — the headless
        equivalent of the reference's per-frame image view
        (src/main.cpp:87-104)."""
        st = self.state
        kp = np.asarray(st.last_feat.xy)
        valid = np.asarray(st.last_feat.valid)
        matches = np.asarray(st.last_matches)
        matched = valid & (matches >= 0)
        pose = se3.pose_matrix(st.last_rvec, st.last_t)
        from ..ops.camera import project

        pos = st.map.pos[jnp.clip(jnp.asarray(matches), 0)]
        proj = np.asarray(project(self.cam, pose, pos))
        return dict(
            image=None if self.last_image is None
            else self.last_image.astype(np.float32) / 255.0,
            keypoints=np.where(valid[:, None], kp, np.nan),
            projections=proj,
            matches_mask=matched,
        )
