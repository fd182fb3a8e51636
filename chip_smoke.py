"""Start-up proof on the GPU: the kernels against XLA, then the tracking path
end to end through the entry points a user calls (Slam.initialize +
Slam.run_batched, as bench.py drives them).

    python chip_smoke.py                     # one card, every phase below
    python chip_smoke.py --compare-backends  # + frames/s per kernel/XLA pairing
    python chip_smoke.py --four              # four cards: the MultiSlam fleet only

One card:
  1. the card's name and power limit (nvidia-smi);
  2. each Pallas kernel against its XLA path at the real widths (dense
     match at P=4096 and P=16384, K=2400, O=8, D=128; motion BA at K=2400,
     10 iterations): parity within the stated tolerances, then the median
     time per call of both;
  3. the classical path: bench.py's world (seed 3), 96 frames at 640x480,
     bench.py's SlamConfig, gated on full-trajectory ATE and coverage as
     bench.py gates them; frames/s, the step's compiled memory analysis and
     the peak device memory;
  4. the learned path (SuperPoint frontend + LightGlue matcher with the
     packaged weights) on the same world, same gate.

Four cards (--four): a {seq: 2, lm: 2} mesh at 640x480, P=4096, with
landmark-sharded refinement on; sequence 1 of a fleet replay is compared
with a single-device Slam replay of the same frames (pose tolerance 5e-2,
as __graft_entry__.dryrun_multichip checks).

Every phase that fails makes the script exit non-zero, and so does a
machine without a GPU. Diagnostics go to stderr; stdout carries the card
line, one line per phase, and as its last line one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import numpy as np

MATCH_TOL = 1e-3  # squared-distance agreement, and the tie margin for best_k
MOTION_REL_TOL = 1e-4  # pose agreement, relative to the pose's norm
POSE_TOL_FOUR = 5e-2  # fleet vs single-device replay
FRAMES = 96  # frames of each rendered world


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def say(line: str) -> None:
    print(line, flush=True)


def median_time(fn, *args, reps: int = 20) -> float:
    """Median seconds per call after one warm-up call (compile included)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 2: kernels against XLA
# ---------------------------------------------------------------------------


def match_inputs(P: int, K: int, O: int, D: int, seed: int = 0,
                 width: int = 640, height: int = 480):
    """Stage-1 matcher inputs shaped like a tracking frame: each map point
    projects near a keypoint and stores noisy copies of its descriptor."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    kp_uv = rng.uniform([0, 0], [width, height], (K, 2)).astype(np.float32)
    kp_desc = unit(rng.standard_normal((K, D))).astype(np.float32)
    src = rng.integers(0, K, P)
    uv_p = (kp_uv[src] + rng.normal(0, 6, (P, 2))).astype(np.float32)
    obs = unit(kp_desc[src][:, None] + 0.35 * rng.standard_normal((P, O, D)))
    return (
        jnp.asarray(uv_p), jnp.asarray(rng.random(P) < 0.6),
        jnp.asarray(obs.astype(np.float32)),
        jnp.asarray(rng.random((P, O)) < 0.7),
        jnp.asarray(kp_uv), jnp.asarray(kp_desc),
        jnp.asarray(rng.random(K) < 0.95),
    )


def _second_best(args, radius_px: float, chunk: int = 1024):
    """Plain XLA: the two smallest gated distances per point (tie margin)."""
    import jax
    import jax.numpy as jnp

    from racing_slam_tpu.ops.matching import _pairwise_sq_dists

    uv_p, gate_p, obs, ov, kp_uv, kp_desc, kp_ok = args
    P, O, D = obs.shape
    K = kp_uv.shape[0]
    n = -(-P // chunk)
    pad = n * chunk - P

    def padp(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    def per_chunk(xs):
        uv, g, od, v = xs
        dd = _pairwise_sq_dists(od.reshape(-1, D), kp_desc).reshape(-1, O, K)
        dd = jnp.where(v[:, :, None], dd, 1e9).min(axis=1)
        px = jnp.sum((uv[:, None] - kp_uv[None]) ** 2, -1) <= radius_px ** 2
        dd = jnp.where(px & g[:, None] & kp_ok[None], dd, 1e9)
        return -jax.lax.top_k(-dd, 2)[0]

    top2 = jax.lax.map(per_chunk, tuple(
        padp(x).reshape((n, chunk) + x.shape[1:]) for x in (uv_p, gate_p, obs, ov)
    ))
    return top2.reshape(-1, 2)[:P]


def check_match(P: int, K: int = 2400, O: int = 8, D: int = 128, *,
                radius_px: float = 28.0, reps: int = 20) -> dict:
    """Stage-1 kernel vs XLA: parity, then median time per call of each."""
    import jax

    from racing_slam_tpu.ops.matching import guided_match_stage1_xla
    from racing_slam_tpu.ops.pallas.match_kernel import guided_match_stage1

    args = match_inputs(P, K, O, D)
    xla = jax.jit(lambda *a: guided_match_stage1_xla(*a, radius_px=radius_px))
    ker = jax.jit(lambda *a: guided_match_stage1(*a, radius_px=radius_px))
    rk, rd = map(np.asarray, xla(*args))
    bk, bd = map(np.asarray, ker(*args))
    top2 = np.asarray(jax.jit(lambda *a: _second_best(a, radius_px))(*args))
    margin = top2[:, 1] - top2[:, 0]
    k_diff = bk != rk
    out = dict(
        P=P, K=K, O=O, D=D, matched=int((rd < 1e9).sum()),
        max_abs_d=float(np.max(np.abs(bd - rd))),
        k_mismatch=int(k_diff.sum()),
        k_mismatch_beyond_margin=int((k_diff & (margin > MATCH_TOL)).sum()),
    )
    out["ok"] = bool(out["max_abs_d"] <= MATCH_TOL
                     and out["k_mismatch_beyond_margin"] == 0
                     and out["matched"] > 0)
    if reps:
        out["kernel_s"] = median_time(ker, *args, reps=reps)
        out["xla_s"] = median_time(xla, *args, reps=reps)
    return out


def motion_inputs(K: int, seed: int = 0):
    """A tracking-frame motion-BA problem: K matches, 30% invalid slots, 5%
    outliers, the initial pose a few centimetres and degrees off."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from bench import make_cam

    cam = make_cam(480)
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, K), rng.uniform(-3, 3, K),
                  rng.uniform(4, 14, K)], -1).astype(np.float32)
    R = Rotation.from_rotvec([0.02, -0.05, 0.01]).as_matrix()
    t = np.array([0.2, -0.05, 0.3])
    pc = X @ R.T + t
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv += rng.normal(0, 0.7, uv.shape)
    n_out = K // 20
    uv[:n_out] += rng.uniform(-25, 25, (n_out, 2))
    rv0 = Rotation.from_matrix(R).as_rotvec() + [0.01, -0.008, 0.006]
    t0 = t + [0.04, -0.03, 0.05]
    return cam, (jnp.asarray(rv0, jnp.float32), jnp.asarray(t0, jnp.float32),
                 jnp.asarray(uv, jnp.float32), jnp.asarray(X),
                 jnp.asarray(rng.random(K) < 0.7))


def check_motion(K: int = 2400, *, iters: int = 10, reps: int = 20) -> dict:
    """Motion-BA kernel vs the XLA while_loop at `highest` precision."""
    import jax

    from racing_slam_tpu.ops.ba import FUNCTION_TOLERANCE, motion_ba
    from racing_slam_tpu.ops.pallas.motion_ba_kernel import motion_ba_fused

    cam, args = motion_inputs(K)
    huber = float(np.sqrt(5.991)) / cam.fx  # SlamConfig.huber_mode="pixel"
    xla = jax.jit(lambda *a: motion_ba(cam, *a, max_iters=iters,
                                       huber_delta=huber, backend="xla"))
    ker = jax.jit(lambda *a: motion_ba_fused(
        cam, *a, iters, huber, FUNCTION_TOLERANCE))
    ref = xla(*args)
    pose_x = np.concatenate([np.asarray(ref.rvec), np.asarray(ref.t)])
    out_k = np.asarray(ker(*args))
    rel = float(np.linalg.norm(out_k[:6] - pose_x) / np.linalg.norm(pose_x))
    out = dict(K=K, max_iters=iters, kernel_iters=int(out_k[7]), rel_pose=rel,
               cost_kernel=float(out_k[6]), cost_xla=float(ref.cost))
    out["ok"] = bool(rel <= MOTION_REL_TOL and np.isfinite(out_k).all())
    if reps:
        out["kernel_s"] = median_time(ker, *args, reps=reps)
        out["xla_s"] = median_time(xla, *args, reps=reps)
    return out


# ---------------------------------------------------------------------------
# Phases 3-4: the tracking path end to end
# ---------------------------------------------------------------------------


def render_world(cam, n_frames: int, seed: int = 3):
    import bench

    seq = bench.render(seed, cam, n_frames)
    seq.frames = [np.clip(f * 255.0, 0, 255).astype(np.uint8) for f in seq.frames]
    return seq


def track(variant: str, cam, cfg, seq, *, batch: int = 48, replays: int = 3,
          memory: bool = True) -> dict:
    """Initialize + run_batched over the world: warm-up (compiles), then
    `replays` timed replays; ATE/coverage of the last one, gated."""
    import jax
    import jax.numpy as jnp

    import bench
    from racing_slam_tpu.utils.video import ArraySource

    slam = bench.build_slam(cam, seq.frames, cfg, variant, None)
    t0 = time.perf_counter()
    if not slam.initialize():
        raise RuntimeError(f"{variant}: initialization failed")
    slam.run_batched(batch=batch)
    jax.block_until_ready(slam.state)
    out = dict(variant=variant, frames=len(seq.frames),
               warmup_s=time.perf_counter() - t0)
    if memory:
        H, W = cam.height, cam.width
        ma = slam._step_batch.lower(
            slam.state, jnp.zeros((batch, H, W), np.uint8),
            jax.random.split(jax.random.PRNGKey(0), batch),
            jnp.ones((batch,), bool), slam._mask,
        ).compile().memory_analysis()
        out["step_memory"] = {
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)
        }
    fps = []
    for _ in range(replays):
        slam.reset_run(ArraySource(seq.frames))
        if not slam.initialize():
            raise RuntimeError(f"{variant}: re-initialization failed")
        t0 = time.perf_counter()
        n = slam.run_batched(batch=batch)
        jax.block_until_ready(slam.state)
        fps.append(n / (time.perf_counter() - t0))
    acc = bench.full_trajectory_ate(slam, seq)
    out.update(
        fps=fps, fps_median=float(np.median(fps)),
        ate_pct=100.0 * acc["ate"] / max(acc["length"], 1e-9),
        coverage=acc["coverage"], reinits=slam.n_reinits,
    )
    out["device_fps"] = bench.device_replay_fps(slam, seq, batch)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    out["ok"] = bench.passes_accuracy_gate(out["ate_pct"], out["coverage"])
    return out


def bench_config(cam, variant: str = "classical", **overrides):
    import bench

    args = bench.parse_args(["--variant", variant])
    return dataclasses.replace(bench.make_config(args, cam), **overrides)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def check_fleet(cam, cfg, seqs, *, batch: int = 48) -> dict:
    """MultiSlam over a {seq, lm} mesh with refinement, then the no-refine
    fleet replay of sequence 1 against a single-device Slam replay."""
    import jax

    from racing_slam_tpu.parallel.mesh import make_mesh
    from racing_slam_tpu.parallel.multi_seq import MultiSlam
    from racing_slam_tpu.slam.pipeline import Slam
    from racing_slam_tpu.utils.video import ArraySource

    mesh = make_mesh({"seq": 2, "lm": 2})
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], mesh, cfg,
                   refine_every=1, refine_iters=cfg.refine_iters)
    if not ms.initialize():
        raise RuntimeError("fleet initialization failed")
    t0 = time.perf_counter()
    n = ms.run_batched(batch=batch)
    jax.block_until_ready(ms.states)
    dt = time.perf_counter() - t0
    costs = np.asarray(ms.refine_costs[-1]) if ms.refine_costs else np.array([])
    pos = ms.states.map.pos
    out = dict(
        mesh=dict(mesh.shape), frames_per_seq=n, run_s=dt,
        refines=len(ms.refine_costs), refine_costs=costs.tolist(),
        state_devices=len(pos.sharding.device_set),
        state_spec=str(pos.sharding.spec),
    )

    cfg_nr = dataclasses.replace(cfg, refine_every_frames=0)
    ms2 = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], mesh, cfg_nr)
    if not ms2.initialize():
        raise RuntimeError("fleet replay initialization failed")
    ms2.run_batched(batch=batch)
    jax.block_until_ready(ms2.states)
    single = Slam(cam, ArraySource(seqs[1].frames), cfg_nr, seed=1)
    if not single.initialize():
        raise RuntimeError("single-device replay initialization failed")
    single.run_batched(batch=batch)
    jax.block_until_ready(single.state)
    out["parity_dt"] = float(np.linalg.norm(
        np.asarray(ms2.states.last_t)[1] - np.asarray(single.state.last_t)))
    out["parity_drv"] = float(np.linalg.norm(
        np.asarray(ms2.states.last_rvec)[1] - np.asarray(single.state.last_rvec)))
    out["ok"] = bool(
        out["parity_dt"] < POSE_TOL_FOUR and out["parity_drv"] < POSE_TOL_FOUR
        and out["state_devices"] == mesh.size
        and np.isfinite(costs).all() and out["refines"] >= 1
    )
    return out


# ---------------------------------------------------------------------------


def _phase(name: str, fn, failures: list):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:  # reported, then the script exits non-zero
        log(f"{name}: FAILED\n{traceback.format_exc()}")
        failures.append(name)
        return None
    res["phase_s"] = time.perf_counter() - t0
    say(f"{name}: {'ok' if res['ok'] else 'FAILED'} {json.dumps(res)}")
    if not res["ok"]:
        failures.append(name)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card MultiSlam fleet phase")
    ap.add_argument("--compare-backends", action="store_true",
                    help="also time the classical step for each "
                         "(matching_backend, ba_backend) pairing")
    args = ap.parse_args(argv)

    from racing_slam_tpu.utils.runtime import (
        card_info,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    for line in card_info():
        say(f"card: {line}")
    import bench

    cam = bench.make_cam(480)
    failures: list[str] = []
    if args.four:
        if device["count"] != 4:
            raise SystemExit(f"--four needs 4 GPUs, JAX sees {device['count']}")
        seqs = [render_world(cam, FRAMES, seed) for seed in (3, 5)]
        _phase("fleet_4", lambda: check_fleet(cam, bench_config(cam), seqs),
               failures)
    else:
        for P in (4096, 16384):
            _phase(f"match_P{P}", lambda P=P: check_match(P), failures)
        _phase("motion_ba", check_motion, failures)
        seq = render_world(cam, FRAMES)
        _phase("classical", lambda: track("classical", cam, bench_config(cam),
                                          seq), failures)
        _phase("learned", lambda: track(
            "learned", cam, bench_config(cam, "learned"), seq), failures)
        if args.compare_backends:
            pairs = [("xla", "xla"), ("pallas", "xla"), ("xla", "pallas"),
                     ("pallas", "pallas")]
            for m, b in pairs + pairs[::-1]:
                _phase(f"classical_match-{m}_ba-{b}", lambda m=m, b=b: track(
                    "classical", cam,
                    bench_config(cam, matching_backend=m, ba_backend=b),
                    seq, replays=2, memory=False), failures)
    if failures:
        log("failed phases:", failures)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
