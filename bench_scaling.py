"""Scaling-efficiency harness: frames/s per sequence at N vs 1 sequences.

Measures whatever mesh exists:

- on N GPUs: N sequences across N cards (the real metric);
- on 1 GPU: N sequences on one card — the intra-card batching curve (an
  upper bound on the work the card has headroom for);
- on CPU (JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8): the
  full plumbing, so the day multi-chip hardware exists this one command
  produces the number.

Prints ONE JSON line:
  {"metric": "scaling_efficiency", "value": eff, "unit": "ratio",
   "n_seq": N, "fps_total_1": ..., "fps_total_n": ..., ...}

Usage: python bench_scaling.py [--n-seq N] [--frames F] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_fleet(cam, seq_frames: list, mesh, cfg, batch: int) -> float:
    """Track every sequence to completion; returns total frames/s (after a
    full warmup pass so compile time is excluded)."""
    import jax

    from racing_slam_tpu.parallel.multi_seq import MultiSlam
    from racing_slam_tpu.utils.video import ArraySource

    def fresh():
        return MultiSlam(
            cam, [ArraySource(f) for f in seq_frames], mesh, cfg
        )

    ms = fresh()
    assert ms.initialize(), "initialization failed"
    ms.run_batched(batch=batch)  # warmup: compiles init + full/partial batches
    jax.block_until_ready(ms.states)

    ms = fresh()
    assert ms.initialize()
    t0 = time.time()
    n = ms.run_batched(batch=batch)
    jax.block_until_ready(ms.states)
    dt = time.time() - t0
    total = n * len(seq_frames)
    log(f"  S={len(seq_frames)}: {total} frames in {dt:.2f}s "
        f"-> {total/dt:.1f} total fps ({n/dt:.1f} per seq)")
    return total / dt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n-seq", type=int, default=0,
                   help="sequence count for the N-point (default: #devices)")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from racing_slam_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from jax.sharding import Mesh

    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.slam.config import SlamConfig
    from racing_slam_tpu.utils.synthetic import make_sequence

    devices = jax.devices()
    n_dev = len(devices)
    N = args.n_seq or n_dev
    log(f"devices: {n_dev} x {devices[0].platform}; N={N}")

    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    t0 = time.time()
    seqs = [
        make_sequence(
            np.random.default_rng(7 + i),
            n_frames=args.frames,
            cam=cam,
            n_sprites=260,
            step_t=np.array([0.05, 0.005, 0.10], np.float32),
            yaw_per_frame=0.002,
        ).frames
        for i in range(N)
    ]
    log(f"rendered {N} x {args.frames} frames in {time.time()-t0:.1f}s")

    cfg = SlamConfig(
        triangulate_points=True,
        bundle_adjust=True,
        optimize_pose=True,
        cull_points=True,
        max_keyframes=32,
        map_capacity=4096,
        max_observations=8,
    )

    # 1-sequence point: mesh with seq=1 (every device on 'lm').
    mesh1 = Mesh(np.asarray(devices).reshape(1, n_dev), ("seq", "lm"))
    fps1 = run_fleet(cam, seqs[:1], mesh1, cfg, args.batch)

    # N-sequence point: seq axis as wide as the device count allows.
    seq_ax = int(np.gcd(N, n_dev))
    meshN = Mesh(
        np.asarray(devices).reshape(seq_ax, n_dev // seq_ax), ("seq", "lm")
    )
    fpsN = run_fleet(cam, seqs, meshN, cfg, args.batch)

    eff = fpsN / (N * fps1)
    log(f"scaling efficiency at N={N}: {eff:.3f}")
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(eff, 4),
        "unit": "ratio",
        "n_seq": N,
        "n_devices": n_dev,
        "seq_axis": seq_ax,
        "platform": devices[0].platform,
        "fps_total_1": round(fps1, 2),
        "fps_total_n": round(fpsN, 2),
        "fps_per_seq_n": round(fpsN / N, 2),
    }))


if __name__ == "__main__":
    main()
