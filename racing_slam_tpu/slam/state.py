"""Fixed-capacity SoA world state: keyframes, map points, observations.

The reference keeps an object graph: Frame objects with per-keypoint match
slots (src/Frame.h:56-59), a Map holding unordered_set<unique_ptr<MapPoint>>
(src/Map.h:57), and MapPoint observation dicts {Frame* -> keypoint index}
(src/MapPoint.h:26-28). On the device that becomes a pytree of padded arrays with
validity masks:

- KeyframeStore[F]: poses as (rvec, t), keypoints, descriptors, per-keypoint
  match slots (i32 map-point id, -1 = none — mirroring Frame::m_map_matches).
- MapState[P]: positions, colors, valid mask, and a point-major observation
  table obs_kf/obs_kp/obs_valid[P, O] (mirroring MapPoint::m_observations).

Pointer identity becomes integer slot ids; deletion (Map::remove_point,
src/Map.cpp:40-51) becomes mask clearing plus match-slot scrubbing; slot
allocation reuses invalid slots via argsort(valid) (invalid-first ordering).
Every mutation below is a pure jit-safe function with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import se3
from ..ops.camera import Camera, project_with_depth
from ..ops.precision import f32_precision

NO_MATCH = jnp.int32(-1)


class Features(NamedTuple):
    """Extracted per-frame features (static K slots)."""

    xy: jnp.ndarray  # [K, 2]
    desc: jnp.ndarray  # [K, D]
    valid: jnp.ndarray  # [K] bool
    score: jnp.ndarray  # [K]


class KeyframeStore(NamedTuple):
    rvec: jnp.ndarray  # [F, 3]
    t: jnp.ndarray  # [F, 3]
    kp_xy: jnp.ndarray  # [F, K, 2]
    desc: jnp.ndarray  # [F, K, D]
    kp_valid: jnp.ndarray  # [F, K] bool
    matches: jnp.ndarray  # [F, K] i32 map-point slot or -1
    valid: jnp.ndarray  # [F] bool
    frame_index: jnp.ndarray  # [F] i32 source video frame id

    @staticmethod
    def create(F: int, K: int, D: int) -> "KeyframeStore":
        return KeyframeStore(
            rvec=jnp.zeros((F, 3)),
            t=jnp.zeros((F, 3)),
            kp_xy=jnp.zeros((F, K, 2)),
            desc=jnp.zeros((F, K, D)),
            kp_valid=jnp.zeros((F, K), bool),
            matches=jnp.full((F, K), NO_MATCH),
            valid=jnp.zeros((F,), bool),
            frame_index=jnp.full((F,), -1, jnp.int32),
        )

    def pose(self, f) -> jnp.ndarray:
        return se3.pose_matrix(self.rvec[f], self.t[f])

    def num_matches(self, f) -> jnp.ndarray:
        return jnp.sum((self.matches[f] >= 0) & self.kp_valid[f])


class MapState(NamedTuple):
    pos: jnp.ndarray  # [P, 3]
    color: jnp.ndarray  # [P] intensity (grayscale pipeline; viewer tint)
    valid: jnp.ndarray  # [P] bool
    obs_kf: jnp.ndarray  # [P, O] i32 keyframe slot
    obs_kp: jnp.ndarray  # [P, O] i32 keypoint index in that keyframe
    obs_valid: jnp.ndarray  # [P, O] bool

    @staticmethod
    def create(P: int, O: int) -> "MapState":
        return MapState(
            pos=jnp.zeros((P, 3)),
            color=jnp.zeros((P,)),
            valid=jnp.zeros((P,), bool),
            obs_kf=jnp.zeros((P, O), jnp.int32),
            obs_kp=jnp.zeros((P, O), jnp.int32),
            obs_valid=jnp.zeros((P, O), bool),
        )

    def num_points(self) -> jnp.ndarray:
        return jnp.sum(self.valid)

    def observed_by(self, kf_slot) -> jnp.ndarray:
        """[P] bool — point has an observation in keyframe `kf_slot`
        (MapPoint::is_observed_by, src/MapPoint.cpp:32-35)."""
        return jnp.any((self.obs_kf == kf_slot) & self.obs_valid, axis=-1)

    def observation_descriptors(self, kfs: KeyframeStore) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Gather stored descriptors of all observations: [P, O, D], [P, O]."""
        d = kfs.desc[self.obs_kf, self.obs_kp]  # [P, O, D]
        return d, self.obs_valid & self.valid[:, None]

    def ba_point_selection(self, kf_slot, budget: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Compact the BA point set: slots observed by `kf_slot` first.

        The per-keyframe global BA only optimizes points observed by the free
        frame (src/Optimization.cpp:105-120) — at most K of the P capacity
        slots (each keypoint matches or seeds at most one point). Gathering
        them into a [budget] problem shrinks every [P, O, ...] tensor of the
        LM loop.
        Returns (sel [budget] i32 map slots, sel_ok [budget] bool).
        """
        return self.ba_point_selection_mask(
            self.observed_by(kf_slot) & self.valid, budget
        )

    def ba_point_selection_mask(
        self, point_in: jnp.ndarray, budget: int
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Compact an arbitrary in-problem point mask into [budget] slots.

        Under budget overflow, keep the points with the most observations
        (the best-anchored ones benefit most from a refit; fresh 2-view
        points keep their triangulated positions).
        """
        O = self.obs_valid.shape[1]
        n_obs = jnp.sum(self.obs_valid, axis=-1)
        rank = jnp.where(point_in, O - n_obs, 2 * O)
        order = jnp.argsort(rank)  # stable
        sel = order[:budget].astype(jnp.int32)
        return sel, point_in[sel]

    def observed_by_any(self, kf_slots: jnp.ndarray) -> jnp.ndarray:
        """[P] bool — point has an observation in ANY of `kf_slots` [W]
        (entries < 0 ignored)."""
        eq = (self.obs_kf[..., None] == jnp.where(kf_slots >= 0, kf_slots, -2))
        return jnp.any(eq & self.obs_valid[..., None], axis=(-2, -1))


class SlamState(NamedTuple):
    kfs: KeyframeStore
    map: MapState
    num_kf: jnp.ndarray  # i32 — keyframe slots in use
    last_kf_slot: jnp.ndarray  # i32 — slot of the most recent keyframe
    # Last processed frame (reference m_last_frame, src/Slam.h:46):
    last_rvec: jnp.ndarray  # [3]
    last_t: jnp.ndarray  # [3]
    # Frame before last — carries the constant-velocity motion model
    # (SlamConfig.pose_prediction): T_pred = (T_last inv(T_prev)) T_last.
    prev_rvec: jnp.ndarray  # [3]
    prev_t: jnp.ndarray  # [3]
    last_feat: Features
    last_matches: jnp.ndarray  # [K] i32 map slot per keypoint of last frame
    frame_count: jnp.ndarray  # i32 — frames processed so far
    # Cached gather of kfs.desc[map.obs_kf, map.obs_kp] ([P, O, D]). The
    # matcher needs it EVERY frame, but its inputs only change at keyframe
    # commits — caching turns a per-frame multi-MB gather into a per-commit
    # one. Refreshed at the end of _commit_keyframe / commit_initialization;
    # validity is always derived fresh from obs_valid & valid. Stored bf16:
    # the matchers round descriptors to bf16 anyway (ops/matching.py), and
    # halving this largest state array halves the matcher's device-memory
    # reads.
    obs_desc: jnp.ndarray  # [P, O, D] bf16
    # Cached monitoring metric (keyframe_reprojection_error): the full [F, K]
    # projection pass is pure diagnostics, so SlamConfig.reproj_monitor_every
    # controls how often it is recomputed; frames in between report this
    # cached value (-1 before the first computation).
    reproj_px: jnp.ndarray  # f32 scalar
    # Evicted-keyframe pose archive. The reference keeps EVERY keyframe alive
    # forever (src/Slam.h:42-47); the fixed-F sliding window must evict, but
    # evicted poses are appended here (at their last refined value) so the
    # full trajectory from frame 0 stays evaluable — trajectory output and
    # ATE are computed over archive + live window, never just the window.
    # Archived poses stay consistent with the live gauge because periodic
    # refinement freezes the two OLDEST live keyframes (parallel/refine.py
    # gauge_anchor_mask), so the world frame never moves under the archive.
    arch_rvec: jnp.ndarray  # [A, 3]
    arch_t: jnp.ndarray  # [A, 3]
    arch_frame_index: jnp.ndarray  # [A] i32 (-1 = empty)
    arch_count: jnp.ndarray  # i32 — total evictions (may exceed A; overflow drops)
    # Previous frame's post-solve inlier count (StepInfo.n_inliers): drives
    # the adaptive initial-pose fallback (SlamConfig.pose_prediction
    # "adaptive" switches to essential-matrix prediction while this is low).
    last_inliers: jnp.ndarray  # i32

    @staticmethod
    def create(F: int, P: int, O: int, K: int, D: int, A: int = 512) -> "SlamState":
        return SlamState(
            kfs=KeyframeStore.create(F, K, D),
            map=MapState.create(P, O),
            num_kf=jnp.int32(0),
            last_kf_slot=jnp.int32(0),
            last_rvec=jnp.zeros(3),
            last_t=jnp.zeros(3),
            prev_rvec=jnp.zeros(3),
            prev_t=jnp.zeros(3),
            last_feat=Features(
                xy=jnp.zeros((K, 2)),
                desc=jnp.zeros((K, D)),
                valid=jnp.zeros((K,), bool),
                score=jnp.zeros((K,)),
            ),
            last_matches=jnp.full((K,), NO_MATCH),
            frame_count=jnp.int32(0),
            obs_desc=jnp.zeros((P, O, D), jnp.bfloat16),
            reproj_px=jnp.float32(-1.0),
            arch_rvec=jnp.zeros((A, 3)),
            arch_t=jnp.zeros((A, 3)),
            arch_frame_index=jnp.full((A,), -1, jnp.int32),
            arch_count=jnp.int32(0),
            last_inliers=jnp.int32(0),
        )


# ---------------------------------------------------------------------------
# Mutations (pure, jit-safe)
# ---------------------------------------------------------------------------


def write_keyframe(
    kfs: KeyframeStore,
    slot: jnp.ndarray,
    rvec: jnp.ndarray,
    t: jnp.ndarray,
    feat: Features,
    matches: jnp.ndarray,
    frame_index: jnp.ndarray,
) -> KeyframeStore:
    """Write a frame into keyframe slot `slot` (dynamic index)."""
    return kfs._replace(
        rvec=kfs.rvec.at[slot].set(rvec),
        t=kfs.t.at[slot].set(t),
        kp_xy=kfs.kp_xy.at[slot].set(feat.xy),
        desc=kfs.desc.at[slot].set(feat.desc),
        kp_valid=kfs.kp_valid.at[slot].set(feat.valid),
        matches=kfs.matches.at[slot].set(matches),
        valid=kfs.valid.at[slot].set(True),
        frame_index=kfs.frame_index.at[slot].set(frame_index.astype(jnp.int32)),
    )


def allocate_point_slots(map_valid: jnp.ndarray, n_cand: int) -> jnp.ndarray:
    """[n_cand] free slot ids (invalid slots first). If fewer free slots than
    candidates exist, trailing entries point at already-valid slots — callers
    must AND with `slot_is_free` (see create_points) to drop overflow."""
    order = jnp.argsort(map_valid.astype(jnp.int32))  # invalid (0) first
    return order[:n_cand].astype(jnp.int32)


def create_points(
    m: MapState,
    positions: jnp.ndarray,  # [C, 3]
    cand_valid: jnp.ndarray,  # [C]
    kf_a: jnp.ndarray,  # scalar i32 keyframe slot of first observation
    kf_b: jnp.ndarray,  # scalar i32 keyframe slot of second observation
    kp_a: jnp.ndarray,  # [C] keypoint index in kf_a
    kp_b: jnp.ndarray,  # [C] keypoint index in kf_b
    colors: jnp.ndarray,  # [C]
    kfs: KeyframeStore,
) -> tuple[MapState, KeyframeStore, jnp.ndarray, jnp.ndarray]:
    """Batch equivalent of Map::create_point (src/Map.cpp:21-38): allocate a
    slot per valid candidate, write position/color, register the two
    observations, and set both frames' match slots.

    Returns (map, kfs, slots[C], created[C]).
    """
    C = positions.shape[0]
    P = m.valid.shape[0]
    O = m.obs_kf.shape[1]
    K = kfs.matches.shape[1]
    # Compact candidates to the front so the first n_valid free slots are used.
    order = jnp.argsort(~cand_valid)  # valid candidates first
    inv_order = jnp.argsort(order)
    slots_sorted = allocate_point_slots(m.valid, C)
    slots = slots_sorted[inv_order]  # slot for candidate i (distinct)
    created = cand_valid & ~m.valid[slots]

    # Masked scatter via out-of-bounds sentinel + mode='drop': rejected
    # candidates target index P, which XLA drops deterministically.
    target = jnp.where(created, slots, P).astype(jnp.int32)

    zeros_i = jnp.zeros((C, O - 2), jnp.int32)
    obs_kf_new = jnp.concatenate(
        [jnp.full((C, 1), kf_a), jnp.full((C, 1), kf_b), zeros_i], axis=-1
    ).astype(jnp.int32)
    obs_kp_new = jnp.concatenate(
        [kp_a[:, None], kp_b[:, None], zeros_i], axis=-1
    ).astype(jnp.int32)
    obs_valid_new = jnp.concatenate(
        [jnp.ones((C, 2), bool), jnp.zeros((C, O - 2), bool)], axis=-1
    )
    m = m._replace(
        pos=m.pos.at[target].set(positions, mode="drop"),
        color=m.color.at[target].set(colors, mode="drop"),
        valid=m.valid.at[target].set(True, mode="drop"),
        obs_kf=m.obs_kf.at[target].set(obs_kf_new, mode="drop"),
        obs_kp=m.obs_kp.at[target].set(obs_kp_new, mode="drop"),
        obs_valid=m.obs_valid.at[target].set(obs_valid_new, mode="drop"),
    )
    # Wire both frames' match slots (Map.cpp:33-34); same drop trick on the
    # keypoint axis.
    kp_a_t = jnp.where(created, kp_a.astype(jnp.int32), K)
    kp_b_t = jnp.where(created, kp_b.astype(jnp.int32), K)
    kfs = kfs._replace(
        matches=kfs.matches.at[kf_a, kp_a_t]
        .set(slots, mode="drop")
        .at[kf_b, kp_b_t]
        .set(slots, mode="drop")
    )
    return m, kfs, slots, created


def add_associations(
    m: MapState,
    kf_slot: jnp.ndarray,
    point_idx: jnp.ndarray,  # [K] i32 map slot per keypoint (or -1)
    assoc_valid: jnp.ndarray,  # [K] bool
    kf_frame_index: jnp.ndarray | None = None,  # [F] i32 (KeyframeStore.frame_index)
    policy: str = "replace_oldest",
) -> MapState:
    """Batch Map::add_association (src/Map.cpp:53-57): register an observation
    (kf_slot, keypoint k) on each matched point.

    The reference's observation dict grows unboundedly; the fixed-O table
    needs a policy once a point is full:
    - "replace_oldest" (default): overwrite the observation from the OLDEST
      keyframe (by frame_index). Long-lived points keep accumulating fresh
      anchors — the most recent views are also the ones the matcher and BA
      weight the most — instead of freezing at their first O views.
    - "drop_newest": the reference-adjacent conservative cap — new
      associations are discarded when the table is full.

    Either way, the target slot is the first INVALID slot when one exists
    (eviction scrubbing leaves holes; a count-based cursor would land on a
    live slot and silently destroy an observation).
    """
    K = point_idx.shape[0]
    P, O = m.obs_valid.shape
    pid = jnp.clip(point_idx, 0, P - 1)
    if kf_frame_index is None:
        # No age info: order by observation slot (creation order approximates
        # age because slots fill left to right).
        age = jnp.where(
            m.obs_valid, jnp.arange(O, dtype=jnp.int32)[None, :], jnp.int32(-1)
        )
    else:
        age = jnp.where(
            m.obs_valid, kf_frame_index[jnp.clip(m.obs_kf, 0)], jnp.int32(-1)
        )  # [P, O]; invalid slots sort first (age -1)
    slot_of = jnp.argmin(age, axis=-1).astype(jnp.int32)  # [P]
    cursor = slot_of[pid]  # [K]
    ok = assoc_valid & (point_idx >= 0)
    if policy == "drop_newest":
        ok = ok & jnp.any(~m.obs_valid, axis=-1)[pid]
    # OOB sentinel + drop for rejected rows. Duplicate (pid, cursor) targets
    # cannot occur: the matcher yields at most one keypoint per point.
    pid_t = jnp.where(ok, pid, P).astype(jnp.int32)
    cur_t = jnp.where(ok, cursor, O).astype(jnp.int32)
    kp_ids = jnp.arange(K, dtype=jnp.int32)
    return m._replace(
        obs_kf=m.obs_kf.at[pid_t, cur_t].set(
            jnp.full((K,), kf_slot, jnp.int32), mode="drop"
        ),
        obs_kp=m.obs_kp.at[pid_t, cur_t].set(kp_ids, mode="drop"),
        obs_valid=m.obs_valid.at[pid_t, cur_t].set(True, mode="drop"),
    )


def remove_points(
    m: MapState, kfs: KeyframeStore, remove: jnp.ndarray
) -> tuple[MapState, KeyframeStore]:
    """Batch Map::remove_point (src/Map.cpp:40-51): invalidate points and
    scrub every keyframe match slot referencing them."""
    m = m._replace(
        valid=m.valid & ~remove,
        obs_valid=m.obs_valid & ~remove[:, None],
    )
    ref = kfs.matches  # [F, K]
    stale = (ref >= 0) & remove[jnp.clip(ref, 0)]
    kfs = kfs._replace(matches=jnp.where(stale, NO_MATCH, ref))
    return m, kfs


@f32_precision
def _obs_mean_errors(
    cam: Camera,
    pos: jnp.ndarray,  # [N, 3]
    obs_kf: jnp.ndarray,  # [N, O]
    obs_kp: jnp.ndarray,  # [N, O]
    obs_w: jnp.ndarray,  # [N, O] bool — observations to count
    kfs: KeyframeStore,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean reprojection error (px) per row over its observations.

    The F keyframe rotations are Rodrigues-expanded ONCE ([F, 3, 3]) and
    gathered per observation — the naive per-observation pose_matrix build
    materialized [N*O, 4, 4] transforms with transcendentals per entry, one
    of the P-proportional commit costs at large map capacity."""
    from ..ops.camera import project_camera_points

    R = se3.exp_so3(kfs.rvec)  # [F, 3, 3]
    Xc = (
        jnp.einsum("noij,nj->noi", R[obs_kf], pos) + kfs.t[obs_kf]
    )  # [N, O, 3]
    uv = project_camera_points(cam, Xc)
    obs_uv = kfs.kp_xy[obs_kf, obs_kp]  # [N, O, 2]
    err = jnp.linalg.norm(uv - obs_uv, axis=-1)
    n = jnp.sum(obs_w, axis=-1)
    mean_err = jnp.sum(jnp.where(obs_w, err, 0.0), axis=-1) / jnp.maximum(n, 1)
    return mean_err, n > 0


def point_reprojection_errors(
    cam: Camera, m: MapState, kfs: KeyframeStore
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean reprojection error (px) per point over its observations.

    Mirrors Slam::cull_points' accumulation (src/Slam.cpp:221-243).
    Returns (mean_err[P], has_obs[P])."""
    return _obs_mean_errors(
        cam, m.pos, m.obs_kf, m.obs_kp, m.obs_valid & m.valid[:, None], kfs
    )


def point_reprojection_errors_sel(
    cam: Camera,
    m: MapState,
    kfs: KeyframeStore,
    sel: jnp.ndarray,  # [C] i32 map slots
    sel_ok: jnp.ndarray,  # [C] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """point_reprojection_errors over a COMPACTED candidate set: [C, O]
    work instead of [P, O]. Used by the commit-time incremental cull (see
    pipeline._commit_keyframe): only points whose error inputs changed this
    commit need re-checking, so the sweep compacts to those."""
    return _obs_mean_errors(
        cam,
        m.pos[sel],
        m.obs_kf[sel],
        m.obs_kp[sel],
        m.obs_valid[sel] & (m.valid[sel] & sel_ok)[:, None],
        kfs,
    )


def keyframe_reprojection_error(
    cam: Camera, m: MapState, kfs: KeyframeStore
) -> jnp.ndarray:
    """Mean px error over all keyframe match slots — the reference's
    monitoring metric Slam::reprojection_error (src/Slam.cpp:245-260)."""
    F, K = kfs.matches.shape
    pid = jnp.clip(kfs.matches, 0)
    ok = (kfs.matches >= 0) & kfs.kp_valid & kfs.valid[:, None] & m.valid[pid]
    poses = se3.pose_matrix(kfs.rvec, kfs.t)  # [F, 4, 4]
    pts = m.pos[pid]  # [F, K, 3]
    uv, _ = project_with_depth(cam, poses[:, None], pts[:, :, None])
    uv = uv.reshape(F, K, 2)
    err = jnp.linalg.norm(uv - kfs.kp_xy, axis=-1)
    n = jnp.sum(ok)
    return jnp.sum(jnp.where(ok, err, 0.0)) / jnp.maximum(n, 1)
