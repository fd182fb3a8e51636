"""Benchmark harness: tracking throughput of the full SLAM pipeline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, ...}

The default run measures the headline configuration (classical frontend +
matcher, 640x480, full flags) over FIVE seeds on a 304-frame sequence and
reports the median wall-clock fps / full-trajectory ATE with the per-seed
spread. Each seed takes the best of `--replays` (default 5) full measured
replays of the identical compiled program, and a `device_fps` figure is
measured from PRE-STAGED device batches (all frames uploaded before the
clock starts, no host decode/upload/readback on the timed path).

It needs a GPU and exits otherwise; the JSON names the device JAX ran on and
the card's name and power limit.

ATE is computed over the FULL trajectory from the first keyframe: evicted
keyframes' poses come from the SlamState archive (slam/state.py), matching
the reference, which keeps every keyframe (src/Slam.h:42-47) — not just the
surviving F-slot window.

Variants (each costs a fresh compile):
  python bench.py                      # headline, 5 seeds
  python bench.py --variant lightglue  # classical frontend + LightGlue matcher
  python bench.py --variant learned    # SuperPoint frontend + LightGlue matcher
  python bench.py --res 720            # 1280x720 fused-frontend datapoint
  python bench.py --masked             # static-mask sequence (okayama shape)

Baseline note: the reference publishes no numbers, and its
C++/OpenCV/Ceres/Pangolin stack cannot be built here. The
vs_baseline denominator is the documented 30 frames/s estimate for the
reference's single-threaded CPU loop — a reference-favorable upper bound
(the literally-measured stand-in re-run does 1.91 fps,
tools/reference_baseline.py). All diagnostics go to stderr; stdout carries
only the JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REFERENCE_FPS_ESTIMATE = 30.0
REFERENCE_RERUN_FPS = 1.91  # tools/reference_baseline.py, measured round 2
# Accuracy gate: full-trajectory ATE as % of trajectory length, and the
# fraction of source frames inside some tracked segment.
ATE_PCT_GATE = 10.0
COVERAGE_GATE = 0.85


def passes_accuracy_gate(ate_pct: float, coverage: float) -> bool:
    return bool(np.isfinite(ate_pct) and ate_pct <= ATE_PCT_GATE
                and coverage >= COVERAGE_GATE)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_cam(res: int):
    from racing_slam_tpu.ops.camera import Camera

    if res == 720:
        return Camera(fx=720.0, fy=720.0, cx=640.0, cy=360.0,
                      width=1280, height=720)
    return Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0,
                  width=640, height=480)


def render(seed: int, cam, n_frames: int):
    from racing_slam_tpu.utils.synthetic import make_sequence

    rng = np.random.default_rng(seed)
    return make_sequence(
        rng,
        n_frames=n_frames,
        cam=cam,
        n_sprites=260,
        step_t=np.array([0.05, 0.005, 0.10], np.float32),
        yaw_per_frame=0.002,
    )


def make_mask(cam) -> np.ndarray:
    """Static mask in the okayama shape: car hood / overlay regions blocked
    (bottom fifth + a top banner), the reference's masked-video use case
    (its assets/okayama-mask.png + okayama.yaml)."""
    m = np.ones((cam.height, cam.width), np.uint8)
    m[-cam.height // 5 :, :] = 0
    m[: cam.height // 12, :] = 0
    return m


def build_slam(cam, frames, cfg, variant: str, mask):
    from racing_slam_tpu.slam.pipeline import Slam
    from racing_slam_tpu.utils.video import ArraySource

    frontend = None
    if variant == "learned":
        from pathlib import Path

        from racing_slam_tpu.models import superpoint

        wdir = Path(__file__).resolve().parent / "racing_slam_tpu" / "weights"
        params = superpoint.load_params(wdir / "superpoint.npz")
        frontend = superpoint.SuperPointFrontend(params=params)
    return Slam(cam, ArraySource(frames), cfg, static_mask=mask,
                frontend=frontend)


def full_trajectory_ate(slam, seq) -> dict:
    """Sim(3) ATE over the FULL run: every trajectory segment (re-inits
    archive the previous segment), each segment covering archive + live
    keyframes from its first frame. Segments are aligned independently (a
    monocular re-bootstrap loses scale/frame continuity by construction);
    the reported percentage is length-weighted across segments, and
    `coverage` is the fraction of source frames inside some segment — a
    run that silently stalls scores low coverage instead of hiding it."""
    from racing_slam_tpu.utils.metrics import ate_rmse, camera_centers

    from racing_slam_tpu.utils.metrics import umeyama_sim3

    segs = list(slam.segments) + [
        dict(
            poses=slam.poses(include_archived=True),
            frame_indices=slam.keyframe_indices(include_archived=True),
        )
    ]
    n_live_final = len(slam.keyframe_indices())
    tot_ate, tot_len, covered, n_kf = 0.0, 0.0, 0, 0
    spans = []
    arch_rmse = live_rmse = float("nan")
    for si, s in enumerate(segs):
        idx = np.asarray(s["frame_indices"])
        est = np.asarray(s["poses"])
        if len(idx) < 3:
            continue
        gt = seq.poses[idx]
        tot_ate += float(ate_rmse(est, gt))
        tot_len += float(
            np.linalg.norm(camera_centers(gt)[-1] - camera_centers(gt)[0])
        )
        covered += int(idx[-1]) - int(idx[0]) + 1
        n_kf += len(idx)
        spans.append([int(idx[0]), int(idx[-1])])
        # Write-once-archive cost probe (final segment): one Sim(3) fit on
        # the WHOLE segment, then split the residual into the archived
        # prefix vs the live window. If the archived part is no worse, the
        # frozen-at-eviction poses cost ~nothing vs keeping them live.
        n_arch = len(idx) - n_live_final
        if si == len(segs) - 1 and n_arch >= 3 and n_live_final >= 3:
            c_est, c_gt = camera_centers(est), camera_centers(gt)
            sc, R, t = umeyama_sim3(c_est, c_gt)
            err = np.linalg.norm((sc * (R @ c_est.T)).T + t - c_gt, axis=-1)
            arch_rmse = float(np.sqrt((err[:n_arch] ** 2).mean()))
            live_rmse = float(np.sqrt((err[n_arch:] ** 2).mean()))
    return dict(
        ate=tot_ate,
        length=max(tot_len, 1e-9),
        coverage=covered / len(seq.frames),
        n_kf=n_kf,
        n_archived=len(slam.keyframe_indices(include_archived=True))
        - len(slam.keyframe_indices()),
        kf_span=spans,
        ate_split_archived=arch_rmse,
        ate_split_live=live_rmse,
    )


def device_replay_fps(slam, seq, batch: int) -> float:
    """Throughput with all batches PRE-STAGED on device: same compiled
    step/refine programs and cadence as run_batched, but zero host decode,
    upload, or readback inside the timed window. This is the engine's
    device+dispatch rate; a wall-clock fps far below it indicts the host
    decode/upload path, not the engine."""
    import jax
    import jax.numpy as jnp

    from racing_slam_tpu.utils.video import ArraySource

    cfg = slam.cfg
    slam.reset_run(ArraySource(seq.frames))
    assert slam.initialize(), "device-replay re-initialization failed"
    rest = []
    while True:
        try:
            rest.append(np.asarray(next(slam.video)))
        except StopIteration:
            break

    # Dispatch plan mirroring run_batched's refine chunking.
    plan: list[tuple[int, bool]] = []  # (n_frames, refine_after)
    since, i = 0, 0
    refine_on = slam._refine_one is not None
    while i < len(rest):
        want = min(batch, len(rest) - i)
        if refine_on:
            want = min(want, max(1, cfg.refine_every_frames - since))
        since += want
        i += want
        fire = refine_on and since >= cfg.refine_every_frames
        if fire:
            since = 0
        plan.append((want, fire))
    if refine_on and since > 0:
        plan[-1] = (plan[-1][0], True)

    # Pre-stage every padded batch + keys + active masks on device.
    staged = []
    i = 0
    for n, fire in plan:
        fr = rest[i : i + n]
        i += n
        fr = fr + [fr[-1]] * (batch - n)
        imgs = jax.device_put(np.stack(fr))
        keys = jax.random.split(slam._subkey(), batch)
        active = jnp.asarray(np.arange(batch) < n)
        staged.append((imgs, keys, active, fire))
    jax.block_until_ready([s[0] for s in staged])

    state = slam.state
    t0 = time.time()
    for imgs, keys, active, fire in staged:
        state, _ = slam._step_batch(state, imgs, keys, active, slam._mask)
        if fire:
            state, _ = slam._refine_one(state)
    jax.block_until_ready(state)
    dt = time.time() - t0
    slam.state = state
    return len(rest) / dt


def run_one(seed: int, cam, cfg, variant: str, n_frames: int, batch: int,
            masked: bool, replays: int):
    """Render + warmup + measured passes. Returns dict of results."""
    import jax

    from racing_slam_tpu.utils.video import ArraySource

    t0 = time.time()
    seq = render(seed, cam, n_frames)
    # Convert to uint8 ONCE at render time: a real deployment decodes uint8
    # video; per-batch float->uint8 conversion in the driver costs ~0.5
    # ms/frame of pure host time at 640x480.
    seq.frames = [
        np.clip(f * 255.0, 0, 255).astype(np.uint8) for f in seq.frames
    ]
    mask = make_mask(cam) if masked else None
    log(f"seed {seed}: rendered {len(seq.frames)} frames in {time.time()-t0:.1f}s")

    slam = build_slam(cam, seq.frames, cfg, variant, mask)
    t0 = time.time()
    assert slam.initialize(), "initialization failed"
    log(f"  initialized in {time.time() - t0:.1f}s")

    # Warmup pass: run the WHOLE sequence once so every program (full and
    # padded final batch, keyframe + tracking branches, refinement) compiles.
    t0 = time.time()
    warm = slam.run_batched(batch=batch)
    jax.block_until_ready(slam.state)
    log(f"  warmup: {warm} steps in {time.time() - t0:.1f}s")

    # Measured passes: reset world state and replay the SAME full sequence
    # with everything compiled — initialization + tracking, batched dispatch.
    # Best of `replays`; the median replay is reported beside it.
    fps_reps = []
    t_init = 0.0
    for rep in range(replays):
        slam.reset_run(ArraySource(seq.frames))
        t0 = time.time()
        assert slam.initialize(), "re-initialization failed"
        t_init = time.time() - t0
        t0 = time.time()
        n = slam.run_batched(batch=batch)
        jax.block_until_ready(slam.state)
        dt = time.time() - t0
        fps_reps.append(n / dt)
    fps = max(fps_reps)

    acc = full_trajectory_ate(slam, seq)
    ate, length = acc["ate"], acc["length"]
    # Capture run stats BEFORE device_replay_fps: it calls reset_run, which
    # zeroes n_reinits (the round-4 JSON reported dead zeros because of
    # exactly this ordering).
    n_reinits = slam.n_reinits
    log(
        f"  measured: {n} frames -> best {fps:.2f} fps of "
        f"{['%.1f' % f for f in fps_reps]} (+{t_init:.2f}s bootstrap); "
        f"kf={acc['n_kf']} ({acc['n_archived']} archived, "
        f"spans {acc['kf_span']}, coverage {acc['coverage']:.2f}) "
        f"pts={int(slam.state.map.num_points())} "
        f"reinits={n_reinits}"
        f"{' (EOF mid-rebootstrap, state restored)' if slam.eof_on_reinit else ''}"
        f" reproj={slam.reprojection_error():.2f}px | "
        f"full-traj ATE {ate:.4f} / len {length:.2f} "
        f"({100*ate/max(length,1e-9):.2f}%) | "
        f"split archived/live RMSE {acc['ate_split_archived']:.4f}/"
        f"{acc['ate_split_live']:.4f}"
    )

    dev_fps = device_replay_fps(slam, seq, batch)
    log(f"  device-staged replay: {dev_fps:.2f} fps")
    return dict(seed=seed, fps=fps, fps_reps=fps_reps, device_fps=dev_fps,
                fps_median_replay=float(np.median(fps_reps)),
                ate=ate, length=length, slam=slam, n=n,
                coverage=acc["coverage"],
                n_reinits=n_reinits, acc=acc)


def ba_throughput(slam, cfg, cam) -> float:
    """BA solver iterations/second at the real commit shapes (BASELINE.json's
    BA iters/s metric)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from racing_slam_tpu.ops.ba import BAProblem, structure_ba

    st = slam.state
    K = st.last_feat.xy.shape[0]
    Pc = min(cfg.map_capacity, -(-K // 128) * 128)
    slot = st.last_kf_slot
    sel, sel_ok = st.map.ba_point_selection(slot, Pc)
    obs_kf = st.map.obs_kf[sel]
    obs_kp = st.map.obs_kp[sel]
    prob = BAProblem(
        cam_rvec=st.kfs.rvec, cam_t=st.kfs.t, points=st.map.pos[sel],
        obs_cam=obs_kf, obs_uv=st.kfs.kp_xy[obs_kf, obs_kp],
        obs_valid=st.map.obs_valid[sel] & sel_ok[:, None],
        cam_free=jnp.arange(cfg.max_keyframes) == slot,
        cam_in_problem=st.kfs.valid,
        point_free=sel_ok, point_in_problem=sel_ok,
    )
    sba = jax.jit(partial(structure_ba, max_iters=cfg.ba_iters))
    jax.block_until_ready(sba(cam, prob, slot))  # compile
    reps = 20
    t0 = time.time()
    for _ in range(reps):
        out = sba(cam, prob, slot)
    jax.block_until_ready(out)
    rate = reps * cfg.ba_iters / (time.time() - t0)
    log(f"BA throughput: {rate:.0f} LM iters/s "
        f"({cfg.ba_iters} iters/solve, {Pc} points, {int(st.num_kf)} cams)")
    return rate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=str, default="3,5,7,8,9")
    ap.add_argument("--frames", type=int, default=304)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--replays", type=int, default=5)
    ap.add_argument("--res", type=int, default=480, choices=(480, 720))
    ap.add_argument("--variant", default="classical",
                    choices=("classical", "lightglue", "learned"))
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--radius", type=float, default=28.0)
    ap.add_argument("--px-scale", default="auto",
                    help="scale factor applied to the pixel-unit gates "
                         "(match radius, RANSAC threshold, cull, inlier, "
                         "triangulation acceptance). 'auto' = res/480: the "
                         "gates are tuned in 480p pixels, and a fixed pixel "
                         "gate is angularly 1.5x stricter at 720p — "
                         "measured to starve triangulation and over-cull "
                         "(720p ATE 3.3% vs 1.25%). Pass 1.0 for "
                         "reference-literal fixed-pixel thresholds.")
    ap.add_argument("--prediction", default="constant_velocity",
                    choices=("constant_position", "constant_velocity",
                             "adaptive"),
                    help="initial-pose model; 'adaptive' falls back to "
                         "essential-matrix prediction in starved stretches "
                         "(lax.cond: free when healthy)")
    ap.add_argument("--min-commit-inliers", type=int, default=0,
                    help="absolute keyframe-commit floor (0 = reference's "
                         "purely relative 0.9 rule, which zombie-locks on "
                         "long starved stretches; see SlamConfig)")
    ap.add_argument("--essential", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="essential-matrix initial pose (RANSAC) instead of "
                         "the constant-position model: the projected 20 px "
                         "match gate survives hard stretches where constant "
                         "position misses (reference flag, src/Slam.h:11-17)")
    ap.add_argument("--refine-every", type=int, default=None,
                    help="override refine_every_frames (default: 48 — the "
                         "cadence the round-3 headline actually ran at; "
                         "run_batched now honors the knob at any batch size)")
    ap.add_argument("--local-ba-window", type=int, default=4,
                    help="keyframes freed by the commit-time local BA "
                         "(1 = reference shape: newest only; the default 4 "
                         "re-solves recent drift while it is cheap — "
                         "measured worst-seed full-trajectory ATE 2.3% vs "
                         "3.3% at W=1 on the 304-frame benchmark)")
    ap.add_argument("--kf-ratio", type=float, default=0.8,
                    help="keyframe decision ratio (reference hard-codes 0.9, "
                         "src/Slam.cpp:114 — tuned for ITS matcher; with the "
                         "wider dense-gate matcher + CV prediction matches "
                         "persist longer, and 0.9 commits every ~1.9 frames. "
                         "0.8 halves the commit rate AND improves ATE: "
                         "fewer short-baseline keyframes)")
    ap.add_argument("--window-every", type=int, default=1,
                    help="run the windowed commit BA only on every Nth "
                         "commit (hybrid with the fused single-camera "
                         "solver; see SlamConfig.window_ba_every)")
    ap.add_argument("--map-capacity", type=int, default=4096,
                    help="map point capacity P (scale bench: 16384)")
    ap.add_argument("--max-keyframes", type=int, default=32,
                    help="live keyframe window F (scale bench: 64)")
    ap.add_argument("--match-backend", default="auto",
                    choices=("auto", "pallas", "xla"),
                    help="guided-matcher backend (ops.pallas.resolve_backend)")
    return ap.parse_args(argv)


def make_config(args: argparse.Namespace, cam):
    """The benchmark's SlamConfig for the parsed options."""
    from racing_slam_tpu.slam.config import SlamConfig

    ps = (cam.height / 480.0) if args.px_scale == "auto" else float(args.px_scale)
    return SlamConfig(
        match_radius_px=args.radius * ps,
        ransac_threshold_px=0.4 * ps,
        cull_reproj_px=3.0 * ps,
        inlier_px=3.0 * ps,
        triangulation_reproj_px=2.0 * ps,
        pose_prediction=args.prediction,
        min_commit_inliers=args.min_commit_inliers,
        essential_matrix_estimation=args.essential,
        triangulate_points=True,
        bundle_adjust=True,
        optimize_pose=True,
        cull_points=True,
        max_keyframes=args.max_keyframes,
        map_capacity=args.map_capacity,
        max_observations=8,
        archive_capacity=512,
        matching_backend=args.match_backend,
        matcher="lightglue" if args.variant in ("lightglue", "learned") else "classical",
        # Monitoring only at keyframe commits (the reference recomputes the
        # [F, K] reprojection pass every frame purely for its per-frame
        # print, src/main.cpp:106 — here it would tax the fused hot loop).
        reproj_monitor_every=0,
        # Periodic global refinement over the live keyframe window: kills
        # the length-proportional drift of the frozen-history commit BA.
        # 48 = the effective cadence of the round-3 headline (whose knob
        # said 16 but fired per-48-batch); run_batched now chunks
        # dispatches so the knob is honest at any batch size.
        refine_every_frames=(args.refine_every
                             if args.refine_every is not None else 48),
        refine_iters=10,
        local_ba_window=args.local_ba_window,
        window_ba_every=args.window_every,
        keyframe_match_ratio=args.kf_ratio,
    )


def main():
    args = parse_args()

    from racing_slam_tpu.utils.runtime import (
        card_info,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    cards = card_info()
    import jax

    log("devices:", jax.devices(), "cards:", cards)
    cam = make_cam(args.res)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cfg = make_config(args, cam)

    results = []
    for seed in seeds:
        results.append(
            run_one(seed, cam, cfg, args.variant, args.frames, args.batch,
                    args.masked, args.replays)
        )

    fps_list = sorted(r["fps"] for r in results)
    dev_list = sorted(r["device_fps"] for r in results)
    ate_pct = sorted(100 * r["ate"] / max(r["length"], 1e-9) for r in results)
    cov_list = sorted(r["coverage"] for r in results)
    fps_med = float(np.median(fps_list))
    dev_med = float(np.median(dev_list))
    ate_med = float(np.median([r["ate"] for r in results]))
    ate_pct_med = float(np.median(ate_pct))
    cov_med = float(np.median(cov_list))
    log(f"median over {len(seeds)} seeds: {fps_med:.1f} fps wall "
        f"(device-staged {dev_med:.1f}), full-trajectory ATE "
        f"{ate_pct_med:.2f}% of length (range {ate_pct[0]:.2f}-{ate_pct[-1]:.2f}), "
        f"coverage {cov_med:.2f} (worst {cov_list[0]:.2f})")

    # Accuracy gate: throughput with a broken trajectory is meaningless —
    # and so is accuracy over a trajectory that silently stopped covering
    # the sequence (the round-3 audit's window-local blind spot).
    if not np.isfinite(fps_med) or not passes_accuracy_gate(ate_pct_med, cov_med):
        log(f"FATAL: accuracy check failed (median ATE {ate_pct_med:.2f}% "
            f"> {ATE_PCT_GATE}% or median coverage {cov_med:.2f} < "
            f"{COVERAGE_GATE})")
        sys.exit(1)

    rate = ba_throughput(results[-1]["slam"], cfg, cam)

    name = f"tracking_fps_{cam.width}x{cam.height}_full_pipeline"
    if args.variant != "classical":
        name += f"_{args.variant}"
    if args.masked:
        name += "_masked"
    if args.map_capacity != 4096 or args.max_keyframes != 32:
        name += f"_P{args.map_capacity}_F{args.max_keyframes}"
    print(
        json.dumps(
            {
                "metric": name,
                "value": round(fps_med, 3),
                "unit": "frames/s",
                "vs_baseline": round(fps_med / REFERENCE_FPS_ESTIMATE, 3),
                "device_fps": round(dev_med, 3),
                "device_fps_range": [round(dev_list[0], 1), round(dev_list[-1], 1)],
                "ate": round(ate_med, 4),
                "ate_pct_of_length": round(ate_pct_med, 2),
                "ate_scope": "full_trajectory_incl_archived_keyframes",
                "n_frames": args.frames,
                "replays": args.replays,
                "seeds": seeds,
                "device": dict(device, cards=cards),
                "fps_range": [round(fps_list[0], 1), round(fps_list[-1], 1)],
                # Median replay per seed, then median over seeds: keeps the
                # gap between best and typical replays visible.
                "fps_median_replay": round(float(np.median(
                    [r["fps_median_replay"] for r in results])), 3),
                "ate_pct_range": [round(ate_pct[0], 2), round(ate_pct[-1], 2)],
                "coverage": round(cov_med, 3),
                "coverage_range": [round(cov_list[0], 3), round(cov_list[-1], 3)],
                "reinits": [r["n_reinits"] for r in results],
                # Write-once-archive cost probe: RMSE split of the final
                # segment under ONE Sim(3) fit — archived prefix vs live
                # window (see full_trajectory_ate).
                "ate_split_archived": round(float(np.nanmedian(
                    [r["acc"]["ate_split_archived"] for r in results])), 4),
                "ate_split_live": round(float(np.nanmedian(
                    [r["acc"]["ate_split_live"] for r in results])), 4),
                "ba_iters_per_s": round(rate, 1),
                "reference_rerun_fps": REFERENCE_RERUN_FPS,
            }
        )
    )


if __name__ == "__main__":
    main()
