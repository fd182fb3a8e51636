"""A/B the Huber-loss semantics against the reference's (VERDICT r1 #9).

The reference applies Ceres HuberLoss(sqrt(5.991)) to the NORMALIZED-PLANE
residual (src/Optimization.cpp:130-136): at fx~500 a 2.45-px error is a
~0.005 normalized residual, so the robust loss never engages — effectively a
quadratic loss. Our default huber_mode="pixel" rescales delta by 1/fx so the
loss turns robust at the intended ~2.45 px. This script measures both on the
synthetic benchmark world (same generator as bench.py, smaller for CPU) and
prints ATE + keyframe counts; the winner is documented in slam/config.py.

Run: python tools/ab_huber.py [--frames N] [--big]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Accuracy-only A/B: runs on CPU so the card stays free; --device keeps
# JAX's default device instead.
import jax  # noqa: E402

if "--device" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")


def run(huber_mode: str, seq, cam, cfg_kw):
    from racing_slam_tpu.slam.config import SlamConfig
    from racing_slam_tpu.slam.pipeline import Slam
    from racing_slam_tpu.utils.metrics import ate_rmse, camera_centers
    from racing_slam_tpu.utils.video import ArraySource

    cfg = SlamConfig(huber_mode=huber_mode, **cfg_kw)
    slam = Slam(cam, ArraySource(seq.frames), cfg)
    t0 = time.time()
    assert slam.initialize(), "init failed"
    slam.run_batched(batch=16)
    dt = time.time() - t0
    kf_idx = slam.keyframe_indices()
    gt = seq.poses[kf_idx]
    ate = ate_rmse(slam.poses(), gt)
    length = float(np.linalg.norm(camera_centers(gt)[-1] - camera_centers(gt)[0]))
    return dict(
        huber_mode=huber_mode,
        ate=float(ate),
        pct_of_length=100.0 * float(ate) / max(length, 1e-9),
        n_kf=int(slam.state.num_kf),
        n_points=int(slam.state.map.num_points()),
        reproj_px=float(slam.reprojection_error()),
        seconds=dt,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--big", action="store_true", help="640x480 bench camera")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.utils.synthetic import make_sequence

    if args.big:
        cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
        cfg_kw = dict(
            triangulate_points=True, bundle_adjust=True, optimize_pose=True,
            cull_points=True, max_keyframes=32, map_capacity=4096,
        )
        sprites, step = 260, np.array([0.05, 0.005, 0.10], np.float32)
    else:
        cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
        cfg_kw = dict(
            triangulate_points=True, bundle_adjust=True, optimize_pose=True,
            cull_points=True, max_keyframes=16, map_capacity=2048,
            max_observations=6,
        )
        sprites, step = 160, np.array([0.08, 0.008, 0.13], np.float32)

    rows = []
    for seed in range(args.seeds):
        seq = make_sequence(
            np.random.default_rng(7 + seed), n_frames=args.frames, cam=cam,
            n_sprites=sprites, step_t=step,
        )
        for mode in ("pixel", "reference"):
            r = run(mode, seq, cam, cfg_kw)
            r["seed"] = seed
            rows.append(r)
            print(
                f"seed {seed} huber={mode:9s} ATE {r['ate']:.4f} "
                f"({r['pct_of_length']:.2f}% of length) kf={r['n_kf']} "
                f"pts={r['n_points']} reproj={r['reproj_px']:.2f}px "
                f"[{r['seconds']:.1f}s]",
                flush=True,
            )
    for mode in ("pixel", "reference"):
        ates = [r["pct_of_length"] for r in rows if r["huber_mode"] == mode]
        print(f"mean ATE% {mode}: {np.mean(ates):.3f} over {len(ates)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
