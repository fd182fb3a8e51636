"""Round-3 experiment: ATE growth vs sequence length, refinement on/off.

Runs the bench-identical pipeline over a long synthetic sequence, pausing at
checkpoints to record ATE-over-live-keyframes as a fraction of trajectory
length. Asks: does periodic global refinement
(SlamConfig.refine_every_frames) stop drift growing with sequence length?

Usage:
  python tools/exp_drift.py --frames 300 --refine-every 0
  python tools/exp_drift.py --frames 300 --refine-every 32 --monitor-every 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--refine-every", type=int, default=0)
    p.add_argument("--refine-iters", type=int, default=10)
    p.add_argument("--monitor-every", type=int, default=1)
    p.add_argument("--local-ba-window", type=int, default=1)
    p.add_argument("--backends", default="auto",
                   choices=("auto", "pallas", "xla"),
                   help="matching and motion-BA backends "
                        "(ops.pallas.resolve_backend)")
    p.add_argument("--essential", action="store_true",
                   help="essential-matrix initial pose instead of constant-position")
    p.add_argument("--radius", type=float, default=28.0,
                   help="guided-match gate radius in px (bench default 28)")
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--checkpoints", type=str, default="100,200,300")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from racing_slam_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.slam.config import SlamConfig
    from racing_slam_tpu.slam.pipeline import Slam
    from racing_slam_tpu.utils.metrics import ate_rmse, camera_centers
    from racing_slam_tpu.utils.synthetic import make_sequence
    from racing_slam_tpu.utils.video import ArraySource

    print("devices:", jax.devices(), file=sys.stderr)
    rng = np.random.default_rng(args.seed)
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    t0 = time.time()
    seq = make_sequence(
        rng,
        n_frames=args.frames,
        cam=cam,
        n_sprites=260,
        step_t=np.array([0.05, 0.005, 0.10], np.float32),
        yaw_per_frame=0.002,
    )
    print(f"rendered {len(seq.frames)} frames in {time.time()-t0:.1f}s",
          file=sys.stderr)

    cfg = SlamConfig(
        match_radius_px=args.radius,
        essential_matrix_estimation=args.essential,
        triangulate_points=True,
        bundle_adjust=True,
        optimize_pose=True,
        cull_points=True,
        max_keyframes=32,
        map_capacity=4096,
        max_observations=8,
        refine_every_frames=args.refine_every,
        refine_iters=args.refine_iters,
        reproj_monitor_every=args.monitor_every,
        local_ba_window=args.local_ba_window,
        matching_backend=args.backends,
        ba_backend=args.backends,
    )
    slam = Slam(cam, ArraySource(seq.frames), cfg)
    assert slam.initialize()

    checkpoints = [int(c) for c in args.checkpoints.split(",") if c]
    done = 0
    t_start = time.time()
    for cp in checkpoints:
        want = cp - done
        if want <= 0:
            continue
        n = slam.run_batched(max_frames=want, batch=args.batch)
        done += n
        jax.block_until_ready(slam.state)
        kf_idx = slam.keyframe_indices()
        est = slam.poses()
        gt = seq.poses[kf_idx]
        ate = ate_rmse(est, gt)
        length = float(
            np.linalg.norm(camera_centers(gt)[-1] - camera_centers(seq.poses)[0])
        )
        total_len = float(np.linalg.norm(
            camera_centers(seq.poses[: done + 2])[-1]
            - camera_centers(seq.poses)[0]
        ))
        print(
            f"frame {done:4d}: ATE {ate:.4f} over window-len {length:.2f} "
            f"({100*ate/max(length,1e-9):.2f}%), total-len {total_len:.2f} "
            f"({100*ate/max(total_len,1e-9):.2f}%), kf={int(slam.state.num_kf)} "
            f"pts={int(slam.state.map.num_points())} "
            f"reproj={slam.reprojection_error():.2f}px",
            flush=True,
        )
        if n < want:
            break
    dt = time.time() - t_start
    print(f"{done} frames in {dt:.1f}s = {done/dt:.1f} fps (incl. readbacks; "
          f"refines={len(slam.refine_costs)})")
    if slam.refine_costs:
        print("refine costs:", [float(c) for c in slam.refine_costs[:8]], "...")


if __name__ == "__main__":
    main()
