"""CLI app: run the SLAM engine on a sequence (reference: src/main.cpp).

Usage:
    python -m racing_slam_tpu <sequence.yaml> [options]
    python -m racing_slam_tpu --synthetic [options]

Mirrors the reference app loop (src/main.cpp:42-114): loads the sequence
YAML (video/mask/fx/fy, cx/cy defaulting to image center — main.cpp:21-26),
runs initialization + per-frame stepping, prints the per-frame reprojection
error (main.cpp:106) and match/keyframe counters, then writes trajectory and
map artifacts (the headless equivalents of the Pangolin view).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="racing_slam_tpu", description=__doc__)
    p.add_argument("sequence", nargs="?", help="sequence YAML (video/mask/fx/fy/cx/cy)")
    p.add_argument("--synthetic", action="store_true", help="run on a generated sprite-world sequence")
    p.add_argument("--synthetic-frames", type=int, default=48)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--out", type=Path, default=None, help="output dir for artifacts")
    p.add_argument("--checkpoint-every", type=int, default=0, help="save state every N keyframes (0=off)")
    p.add_argument("--overlay-every", type=int, default=0,
                   help="save a keypoint/match overlay image every N frames "
                        "(0=off; needs --out)")
    p.add_argument("--resume", type=Path, default=None, help="resume from a state checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    # The reference's five feature flags (hard-coded in main.cpp:53-59).
    for flag, default in [
        ("triangulate-points", True),
        ("bundle-adjust", True),
        ("optimize-pose", True),
        ("cull-points", True),
        ("essential-matrix-estimation", False),
    ]:
        p.add_argument(f"--{flag}", dest=flag.replace("-", "_"),
                       action=argparse.BooleanOptionalAction, default=default)
    p.add_argument("--max-keyframes", type=int, default=32)
    p.add_argument("--map-capacity", type=int, default=4096)
    p.add_argument("--frontend", choices=["classical", "learned"], default="classical",
                   help="classical = Shi-Tomasi + patch descriptors (default); "
                        "learned = SuperPoint-style network (reference deep path)")
    p.add_argument("--weights", type=Path, default=None,
                   help="superpoint .npz weights for --frontend learned")
    p.add_argument("--matcher", choices=["classical", "lightglue"],
                   default="classical",
                   help="frame<->frame matcher: classical mutual-1NN or the "
                        "trained LightGlue attention matcher "
                        "(reference deep path, DeepFeatureExtractor.cpp:8)")
    p.add_argument("--lightglue-weights", type=Path, default=None,
                   help="lightglue .npz (default: packaged weights)")
    p.add_argument("--prediction", default="constant_position",
                   choices=("constant_position", "constant_velocity",
                            "adaptive"),
                   help="initial-pose model (src/Slam.cpp:124-136); "
                        "'adaptive' switches to essential-matrix prediction "
                        "with a constant-speed scale prior while tracking "
                        "is starved (free when healthy: lax.cond)")
    p.add_argument("--min-commit-inliers", type=int, default=0,
                   help="absolute keyframe-commit floor (0 = the "
                        "reference's purely relative 0.9 rule)")
    p.add_argument("--match-backend", default="auto",
                   choices=("auto", "pallas", "xla"),
                   help="guided-matcher backend (ops.pallas.resolve_backend)")
    p.add_argument("--local-ba-window", type=int, default=1,
                   help="keyframes freed by the commit-time local BA: 1 = "
                        "the reference's newest-only shape "
                        "(src/Slam.cpp:202-213); W>1 re-solves the W newest "
                        "poses at each commit (ops.ba.window_ba)")
    p.add_argument("--refine-every", type=int, default=0,
                   help="run a FULL bundle adjustment over all live "
                        "keyframes+points every N frames (0=off) — stops "
                        "drift growing with sequence length (the reference's "
                        "per-commit BA freezes all previous keyframes, "
                        "src/Slam.cpp:202-213)")
    p.add_argument("--monitor-every", type=int, default=1,
                   help="recompute the per-frame reprojection-error monitor "
                        "every N frames (1=reference parity, 0=only at "
                        "keyframe commits; the [F,K] pass is pure "
                        "diagnostics)")
    p.add_argument("--interactive", action="store_true",
                   help="step manually: wait for Enter between frames "
                        "(q+Enter quits) — the reference's TAB-keypress "
                        "stepping loop (src/main.cpp:109, "
                        "src/Visualization.cpp:40-44); combine with "
                        "--overlay-every 1 --out DIR for a per-frame view")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import numpy as np

    from .ops.camera import Camera
    from .slam.config import SlamConfig, load_sequence_yaml
    from .slam.pipeline import Slam
    from .utils import viz
    from .utils.checkpoint import save_state
    from .utils.timing import MetricsSink, StageTimer
    from .utils.video import ArraySource, load_mask, open_video

    cfg = SlamConfig(
        triangulate_points=args.triangulate_points,
        bundle_adjust=args.bundle_adjust,
        optimize_pose=args.optimize_pose,
        cull_points=args.cull_points,
        essential_matrix_estimation=args.essential_matrix_estimation,
        max_keyframes=args.max_keyframes,
        map_capacity=args.map_capacity,
        matcher=args.matcher,
        lightglue_weights=str(args.lightglue_weights or ""),
        refine_every_frames=args.refine_every,
        reproj_monitor_every=args.monitor_every,
        local_ba_window=args.local_ba_window,
        pose_prediction=args.prediction,
        min_commit_inliers=args.min_commit_inliers,
        matching_backend=args.match_backend,
    )

    gt_poses = None
    if args.synthetic:
        from .utils.synthetic import make_sequence

        rng = np.random.default_rng(args.seed)
        cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
        seq = make_sequence(
            rng, n_frames=args.synthetic_frames, cam=cam, n_sprites=260,
            step_t=np.array([0.05, 0.005, 0.10], np.float32),
        )
        source = ArraySource(seq.frames)
        gt_poses = seq.poses
        mask = None
    elif args.sequence:
        sc = load_sequence_yaml(args.sequence)
        loader = open_video(sc.video)
        cx = sc.cx if sc.cx is not None else loader.width / 2  # main.cpp:21-26
        cy = sc.cy if sc.cy is not None else loader.height / 2
        cam = Camera(fx=sc.fx, fy=sc.fy, cx=cx, cy=cy,
                     width=loader.width, height=loader.height)
        source = loader
        mask = load_mask(sc.mask) if sc.mask else None
    else:
        print("error: provide a sequence YAML or --synthetic", file=sys.stderr)
        return 2

    frontend = None
    if args.frontend == "learned":
        from .models.superpoint import SuperPointFrontend, load_params

        wpath = args.weights
        if wpath is None:
            packaged = Path(__file__).resolve().parent / "weights" / "superpoint.npz"
            wpath = packaged if packaged.exists() else None
        params = load_params(wpath) if wpath else None
        if params is None:
            print("note: --frontend learned with RANDOM weights "
                  "(train via python -m racing_slam_tpu.models.train)")
        frontend = SuperPointFrontend(params=params, cell=cfg.cell,
                                      n_per_cell=cfg.n_per_cell)
    slam = Slam(cam, source, cfg, static_mask=mask, seed=args.seed,
                frontend=frontend)
    if args.resume:
        from .utils.checkpoint import load_state

        slam.state = load_state(args.resume)
        print(f"resumed from {args.resume} (kf={int(slam.state.num_kf)})")

    timer = StageTimer()
    out = args.out
    if out:
        out.mkdir(parents=True, exist_ok=True)
    sink = MetricsSink(out / "metrics.jsonl") if out else None
    if args.overlay_every and out:
        slam.keep_last_image = True

    if int(slam.state.num_kf) < 2:
        with timer.stage("initialize"):
            if not slam.initialize():
                print("Initialization failed")  # src/Slam.cpp:39
                return 1
        print(
            f"Initialized with keyframes {slam.keyframe_indices().tolist()}, "
            f"{int(slam.state.map.num_points())} points"
        )

    n = 0
    last_kf_count = int(slam.state.num_kf)
    t_start = time.time()
    while args.max_frames is None or n < args.max_frames:
        if args.interactive and n > 0:
            try:
                if input("[Enter]=step  q=quit > ").strip().lower() == "q":
                    break
            except EOFError:
                break
        with timer.stage("step", block_on=None):
            info = slam.step()
        if info is None:
            break
        n += 1
        if not args.quiet:
            # Per-frame print mirroring main.cpp:106 + Slam.cpp counters.
            print(
                f"frame {n}: reprojection error: {float(info.reproj_error_px):.3f} | "
                f"matches {int(info.n_matches_total)} | "
                f"keyframes {int(info.n_keyframes)} | "
                f"points {int(info.n_points)}"
                + ("  [new keyframe]" if bool(info.is_keyframe) else "")
            )
        if sink:
            sink.write(
                dict(
                    frame=n,
                    reproj_px=float(info.reproj_error_px),
                    n_matches=int(info.n_matches_total),
                    n_keyframes=int(info.n_keyframes),
                    n_points=int(info.n_points),
                    is_keyframe=bool(info.is_keyframe),
                )
            )
        if args.overlay_every and out and n % args.overlay_every == 0:
            od = slam.overlay_data()
            viz.save_overlay(out / f"overlay_{n:05d}.png", **od)
        if (
            args.checkpoint_every
            and out
            and int(slam.state.num_kf) >= last_kf_count + args.checkpoint_every
        ):
            save_state(out / "state.npz", slam.state)
            last_kf_count = int(slam.state.num_kf)

    dt = time.time() - t_start
    print(f"\nprocessed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    print(f"final reprojection error: {slam.reprojection_error():.3f} px")
    print(timer.report())

    if gt_poses is not None and int(slam.state.num_kf) >= 2:
        from .utils.metrics import ate_rmse

        kf_idx = slam.keyframe_indices(include_archived=True)
        ate = ate_rmse(slam.poses(include_archived=True), gt_poses[kf_idx])
        print(f"ATE vs ground truth: {ate:.4f}")

    if out:
        # Full trajectory: archived (evicted) keyframes + the live window,
        # matching the reference's keep-everything semantics (src/Slam.h:42-47).
        poses = slam.poses(include_archived=True)
        pts = slam.points()
        colors = np.asarray(slam.state.map.color)[np.asarray(slam.state.map.valid)]
        viz.save_trajectory_plot(out / "trajectory.png", poses, pts, colors)
        viz.export_ply(out / "map.ply", pts, colors, poses)
        viz.save_trajectory_tum(
            out / "trajectory.tum", poses,
            stamps=slam.keyframe_indices(include_archived=True).astype(float),
        )
        save_state(out / "state.npz", slam.state)
        print(f"artifacts written to {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
