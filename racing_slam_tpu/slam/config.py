"""Configuration: sequence YAML (camera + assets) and engine flags.

Mirrors the reference's two config layers in one place:
- per-sequence YAML (video path, optional mask, fx/fy, optional cx/cy
  defaulting to the image center) — src/main.cpp:11-40, assets/*.yaml;
- SlamConfig feature flags, which the reference hard-codes in main
  (src/main.cpp:53-59) and we expose as runtime switches, plus the
  capacity/threshold knobs a static-shape device engine needs.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Engine flags + static capacities. Hashable: safe as a jit static arg."""

    # The reference's five feature flags with its hard-coded defaults
    # (src/main.cpp:53-59; field meanings in src/Slam.h:11-17).
    triangulate_points: bool = False
    bundle_adjust: bool = True
    optimize_pose: bool = True
    cull_points: bool = False
    essential_matrix_estimation: bool = False

    # Static capacities (shape-defining; changing them recompiles).
    max_keyframes: int = 32  # F
    map_capacity: int = 4096  # P
    max_observations: int = 8  # O per point
    # Evicted-keyframe pose archive capacity (A). The reference keeps every
    # keyframe forever (src/Slam.h:42-47); the sliding-F window archives
    # evicted poses so trajectory output/ATE cover frame 0 onward. 7 floats
    # + an i32 per entry — raising it is free; the driver warns on overflow.
    archive_capacity: int = 512
    # Frontend: K = n_per_cell * ceil(H/cell) * ceil(W/cell) keypoints.
    cell: int = 16
    n_per_cell: int = 2
    max_match_distance: float = 0.8

    # Thresholds (reference values cited per field).
    keyframe_match_ratio: float = 0.9  # src/Slam.cpp:114
    # Absolute keyframe-commit floor: ALSO commit when post-solve inliers
    # fall below this (0 = reference parity: relative rule only). The
    # reference's purely relative 0.9 rule has a death trap measured on
    # long sequences: one starved commit (say 22 matches) lowers the bar to
    # ~20, which spurious matches on a stale map exceed forever — commits
    # stop, triangulation stops, the map never refills, tracking zombifies.
    # An absolute floor keeps committing (and therefore triangulating fresh
    # geometry) through sparse stretches; the 3 px cull and periodic
    # refinement absorb the extra noise.
    min_commit_inliers: int = 0
    cull_reproj_px: float = 3.0  # src/Slam.cpp:234
    # Triangulation acceptance gate (filter 3, src/Triangulation.cpp:90).
    # All four pixel gates (this, cull_reproj_px, inlier_px,
    # ransac_threshold_px) are tuned in REFERENCE pixels; at other
    # resolutions a fixed pixel gate changes its angular meaning — 1.5x
    # stricter at 720p — which starves triangulation/culls aggressively
    # (measured: 720p ATE 3.3% vs 1.25% at 480p on the same world).
    # bench.py --px-scale auto scales them with resolution.
    triangulation_reproj_px: float = 2.0
    # Commit-time cull candidate budget. The cull sweep is incremental-exact
    # (pipeline._commit_keyframe: only points whose error inputs changed
    # this commit are re-checked, compacted to [cull_budget, O] rows); when
    # candidates overflow the budget — more changed points than this — the
    # commit falls back to the exact full [P, O] sweep under lax.cond. The
    # window's covering set measures a few hundred live points, so 2048
    # leaves wide headroom. 0 forces the full sweep on every commit
    # (equivalence-testing / A-B knob).
    cull_budget: int = 2048
    min_init_points: int = 50  # src/Init.h:19
    max_ref_chances: int = 5  # src/Init.h:18
    ba_iters: int = 10  # src/Optimization.cpp:153
    motion_ba_iters: int = 10
    # Commit-BA point budget (0 = one slot per keypoint, the exact worst
    # case, so nothing is ever dropped). Smaller budgets shrink every
    # [budget, O] tensor of the commit LM loop but overflow leaves freshly
    # triangulated points unrefined — measured on the bench this doubles ATE
    # and adds keyframe commits (worse map -> more commits via the 0.9 rule),
    # so the default stays exact; the knob exists for memory-constrained
    # configs (overflow keeps the best-anchored points, see
    # MapState.ba_point_selection).
    ba_commit_budget: int = 0
    # Local-BA window at keyframe commit: 1 = the reference's exact shape
    # (only the NEW keyframe free, src/Slam.cpp:202-213); W > 1 frees the W
    # newest keyframes (ops.ba.window_ba) so recent drift is re-solved while
    # it is still cheap instead of frozen into history. At least two
    # keyframes always stay frozen as gauge anchors.
    local_ba_window: int = 1
    # With local_ba_window > 1, run the windowed solve only on every Nth
    # keyframe commit (other commits use the cheaper single-camera solver,
    # ops.ba.structure_ba). The window re-solve is a drift corrector, not a
    # tracking necessity — every 2nd commit retains the accuracy win
    # (measured on the 304-frame bench).
    window_ba_every: int = 1
    # Window-BA point budget. The W newest keyframes SHARE their tracked
    # points, so the covering set is small (measured ~355 live points at
    # W=4 on the bench world — less than one frame's K); 1024 leaves 3x
    # headroom, and overflow keeps the most-observed points (ranked
    # selection) with the post-solve cull as the safety net.
    window_ba_budget: int = 1024
    # Huber scale: "reference" keeps Ceres' sqrt(5.991) on the normalized
    # residual (effectively quadratic); "pixel" rescales it by 1/fx so the
    # robust loss engages at the intended ~2.45 px. A/B on the synthetic
    # benchmark world (tools/ab_huber.py, 3 seeds x 40 frames): pixel wins
    # every seed — mean ATE 1.05% of trajectory length vs 1.57% for the
    # reference semantics — so pixel stays the default.
    huber_mode: str = "pixel"
    # Full-observation-table policy (the reference's dict grows unboundedly,
    # src/MapPoint.h:28): "replace_oldest" keeps the O most recent anchors,
    # "drop_newest" discards new associations once full. See
    # state.add_associations.
    obs_policy: str = "replace_oldest"

    # Tracking-time RANSAC batch (essential_matrix_estimation path): its
    # output is only a pre-BA pose seed, immediately refined by motion BA on
    # map matches, so a smaller batch is fine.
    ransac_hypotheses: int = 512
    # Bootstrap RANSAC batch. The reference runs adaptive RANSAC at
    # confidence 0.999 (src/PoseEstimation.cpp:73-79) with 5-point minimal
    # samples; our batched 8-point solver needs more hypotheses for the same
    # guarantee: 1-(1-0.5^8)^2048 ≈ 0.9997 at 50% inliers. The bootstrap runs
    # once per (re)initialization, so the 4x batch is effectively free.
    init_ransac_hypotheses: int = 2048
    ransac_threshold_px: float = 0.4  # src/PoseEstimation.cpp:78

    # Frame<->frame matcher: "classical" = mutual-1NN descriptor distance
    # (the reference's BFMatcher, src/features/FeatureExtractor.cpp:9-24);
    # "lightglue" = the trained attention matcher (models/lightglue.py,
    # reference's lightglue-cpp role, src/features/DeepFeatureExtractor.cpp:8).
    matcher: str = "classical"
    # Path to trained LightGlue weights; "" = the packaged
    # racing_slam_tpu/weights/lightglue.npz.
    lightglue_weights: str = ""
    # Mutual-argmax acceptance threshold for the LightGlue matcher. 0.35 is
    # the precision/recall sweet spot for the classical-descriptor weights;
    # the from-scratch SuperPoint pairing needs a looser 0.2 to keep enough
    # matches for the two-view bootstrap (>= 50 triangulations, Init.h:19).
    lightglue_threshold: float = 0.35
    # Guided-matcher and motion-BA backends: "auto" = the fused Pallas
    # kernels (ops/pallas/) on a GPU, the XLA paths elsewhere; "pallas" /
    # "xla" force one ("pallas" raises without a GPU).
    matching_backend: str = "auto"
    ba_backend: str = "auto"
    # Initial-pose model when essential_matrix_estimation is off:
    # "constant_position" = the reference's model (pose := last frame's,
    # src/Slam.cpp:134); "constant_velocity" = extrapolate the last relative
    # motion, T_pred = (T_last inv(T_prev)) T_last. At racing-like motion the
    # position model mispredicts by several px per frame, which starves the
    # 20 px projected match gate exactly in low-texture stretches; the
    # velocity model keeps the gate centered for free (no RANSAC cost).
    # "adaptive" = constant position while tracking is healthy, switching to
    # essential-matrix frame-to-frame prediction (the reference's
    # essential_matrix_estimation path, src/Slam.cpp:127-132, under
    # lax.cond so it costs NOTHING when not taken) whenever the previous
    # frame's inlier count drops below adaptive_pred_inliers — measured to
    # carry tracking through map-starved stretches where the position model
    # spirals (pose dragged by spurious matches onto the stale map).
    pose_prediction: str = "constant_position"
    adaptive_pred_inliers: int = 40
    # Guided-match gate radius (reference: 20 px KD-tree query,
    # src/features/FeatureExtractor.cpp:55). In the dense masked-distance
    # design the radius is just a mask threshold — a wider gate costs ZERO
    # extra compute (the [P, K] matrix is computed either way), unlike the
    # reference's KD-tree whose cost grows with radius. A wider gate keeps
    # lock when the initial-pose prediction is off by a few px (fast motion,
    # sparse stretches). Default stays at the reference's 20 px for parity;
    # bench.py and deployment configs raise it to 28.
    match_radius_px: float = 20.0

    # Failure detection / recovery (new capability; the reference only prints
    # "Initialization failed" and keeps going — src/Slam.cpp:38-41). Tracking
    # is declared lost after `lost_patience` consecutive frames with fewer
    # than `min_track_matches` post-solve INLIERS (matches with < inlier_px
    # residual after the final motion BA; StepInfo.n_inliers). Raw match
    # counts are NOT a loss signal: a stale map over a dense keypoint grid
    # keeps producing spurious descriptor matches forever (measured: seeds
    # stalled for 250 frames at healthy-looking match counts), while inliers
    # collapse. If `reinit_on_lost`, the engine archives the finished
    # trajectory segment and re-runs the two-view bootstrap from the current
    # stream position.
    min_track_matches: int = 30
    inlier_px: float = 3.0
    lost_patience: int = 2
    reinit_on_lost: bool = True
    # Loss checks read one scalar back from the device, a host round trip,
    # so sample only every N-th frame (patience counts failing CHECKS, so
    # detection lag is at most interval * patience frames).
    lost_check_interval: int = 4

    # Periodic global refinement (new capability): every N processed frames,
    # run a FULL bundle adjustment over ALL live keyframes and map points
    # (gauge-anchored on the two oldest keyframes) in the single-sequence
    # driver. The reference's only whole-map solve freezes every previous
    # keyframe (src/Slam.cpp:202-213), so its early drift is locked in
    # forever; periodic all-free refinement keeps the live window globally
    # consistent and stops ATE growing with sequence length. 0 = off.
    refine_every_frames: int = 0
    refine_iters: int = 10
    # Refinement point budget: the global problem is compacted to this many
    # live points (most-observed first) so refine cost scales with live map
    # size, not capacity (live points run ~25% of capacity on the bench
    # world). 0 = solve over full capacity. Overflow points keep their
    # positions and face the post-refine cull.
    refine_budget: int = 2048

    # Per-frame monitoring: the keyframe reprojection error in StepInfo is a
    # full [F, K] projection pass over every keyframe's matches
    # (state.keyframe_reprojection_error) — pure diagnostics the reference
    # also recomputes every frame (src/main.cpp:106) but which taxes the
    # fused hot loop. Compute it only every N-th frame (other frames carry
    # the last computed value); 0 = never (reproj_error_px reads -1).
    reproj_monitor_every: int = 1


@dataclasses.dataclass
class SequenceConfig:
    """Per-sequence YAML (src/main.cpp:11-40)."""

    video: str
    fx: float
    fy: float
    mask: str | None = None
    cx: float | None = None  # defaults to image center (main.cpp:21-26)
    cy: float | None = None


def load_sequence_yaml(path: str | Path) -> SequenceConfig:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    base = Path(path).parent

    def _resolve(p):
        if p is None:
            return None
        p = Path(p)
        return str(p if p.is_absolute() else base / p)

    return SequenceConfig(
        video=_resolve(d["video"]),
        mask=_resolve(d.get("mask")),
        fx=float(d["fx"]),
        fy=float(d["fy"]),
        cx=float(d["cx"]) if "cx" in d else None,
        cy=float(d["cy"]) if "cy" in d else None,
    )
