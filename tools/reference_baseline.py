"""Faithful CPU re-run of the reference pipeline to MEASURE the baseline.

The reference (GregVS/Racing-SLAM) publishes no numbers and its C++ stack
(vcpkg: OpenCV+Ceres+Pangolin) cannot be built offline in this image. This
script re-implements the reference's per-frame loop in Python with the SAME
third-party native code paths the reference calls:

  stage                reference                      this script
  -----                ---------                      -----------
  corner detection     cv::GFTTDetector               cv2.goodFeaturesToTrack
                       (max 3000, q .005, dist 7,       (same params, same impl)
                        OrbFeatureExtractor.cpp:14-16)
  descriptors          cv::ORB::compute, size 31      cv2.ORB_create().compute
                       (OrbFeatureExtractor.cpp:18-22)
  frame<->frame match  cv::BFMatcher(HAMMING, xcheck) cv2.BFMatcher (same)
                       max dist 64
                       (FeatureExtractor.cpp:9-24)
  map->frame match     project + KDTree radius 20 px  project + cKDTree radius
                       + desc vs all observations       (scipy C impl)
                       (FeatureExtractor.cpp:26-92)
  essential + pose     cv::findEssentialMat RANSAC    cv2.findEssentialMat
                       conf .999 thr .4 px              (same impl)
                       (PoseEstimation.cpp:73-79)
  triangulation        cv::triangulatePoints + 3      cv2.triangulatePoints
                       filters (Triangulation.cpp)      (same impl + filters)
  bundle adjustment    Ceres LM SPARSE_SCHUR <=10 it  scipy least_squares TRF
                       Huber sqrt(5.991), normalized    w/ sparse Jacobian,
                       plane, fx only                   same residual/loss
                       (Optimization.cpp:24-43,151-153)

The only non-native substitution is Ceres -> scipy.optimize.least_squares
(sparse-Jacobian trust-region; the closest available LM). Per-stage timings
are reported so the OpenCV-backed stages (identical native code to the
reference) anchor the measurement; the BA stand-in's share is visible.

Run on the same synthetic sequence as bench.py with the same feature flags,
so frames/s and ATE are directly comparable. Prints one JSON line to stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import cv2
import numpy as np
from scipy.optimize import least_squares
from scipy.sparse import lil_matrix
from scipy.spatial import cKDTree

HUBER = np.sqrt(5.991)
MAX_HAMMING = 64.0  # OrbFeatureExtractor.h:12-20
RADIUS_PX = 20.0  # FeatureExtractor.cpp:55
KEYFRAME_RATIO = 0.9  # Slam.cpp:114
CULL_PX = 3.0  # Slam.cpp:234
MIN_INIT_POINTS = 50  # Init.h:18
MAX_REF_CHANCES = 5  # Init.h:19
BA_MAX_ITERS = 10  # Optimization.cpp:152


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Timers:
    def __init__(self):
        self.acc = defaultdict(float)

    def __call__(self, name):
        return _Span(self, name)


class _Span:
    def __init__(self, timers, name):
        self.timers, self.name = timers, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.timers.acc[self.name] += time.perf_counter() - self.t0


class Frame:
    __slots__ = ("pose", "kp", "desc", "tree", "matches", "index")

    def __init__(self, kp, desc, index=-1):
        self.pose = np.eye(4)
        self.kp = kp  # [K,2] f64 pixel coords
        self.desc = desc  # [K,32] u8 ORB
        self.tree = cKDTree(kp) if len(kp) else None
        self.matches = {}  # kp index -> point id
        self.index = index  # source frame index (for ATE correspondence)


class MapPoint:
    __slots__ = ("pos", "obs")

    def __init__(self, pos):
        self.pos = pos  # [3]
        self.obs = {}  # frame -> kp index


class RefSlam:
    """Reference Slam re-run (src/Slam.cpp semantics, OpenCV/scipy backends)."""

    def __init__(self, K, frames_u8, mask=None):
        self.K = K
        self.frames = frames_u8
        self.mask = mask
        self.idx = 0
        self.points = {}  # id -> MapPoint
        self.next_pid = 0
        self.keyframes = []
        self.last = None
        self.orb = cv2.ORB_create()
        self.bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        self.t = Timers()

    # ---- feature extraction (OrbFeatureExtractor.cpp:5-25) -----------------
    def extract(self, img, index):
        with self.t("extract"):
            pts = cv2.goodFeaturesToTrack(
                img, maxCorners=3000, qualityLevel=0.005, minDistance=7,
                mask=self.mask,
            )
            if pts is None:
                return Frame(np.zeros((0, 2)), np.zeros((0, 32), np.uint8), index)
            kps = [cv2.KeyPoint(float(x), float(y), 31) for x, y in pts[:, 0]]
            kps, desc = self.orb.compute(img, kps)
            if desc is None:
                return Frame(np.zeros((0, 2)), np.zeros((0, 32), np.uint8), index)
            xy = np.array([k.pt for k in kps])
            return Frame(xy, desc, index)

    def next_frame(self):
        if self.idx >= len(self.frames):
            return None
        img = self.frames[self.idx]
        self.idx += 1
        return self.extract(img, self.idx - 1)

    # ---- frame<->frame matching (FeatureExtractor.cpp:9-24) ----------------
    def match_frames(self, f1, f2):
        with self.t("match_frames"):
            if len(f1.kp) == 0 or len(f2.kp) == 0:
                return []
            raw = self.bf.match(f1.desc, f2.desc)
            return [(m.queryIdx, m.trainIdx) for m in raw
                    if m.distance <= MAX_HAMMING]

    # ---- map->frame matching (FeatureExtractor.cpp:26-92) ------------------
    def match_map(self, frame, point_filter=None):
        with self.t("match_map"):
            best_per_kp = {}
            for pid, pt in self.points.items():
                if point_filter is not None and not point_filter(pt):
                    continue
                uv = project(self.K, frame.pose, pt.pos)
                if uv is None:
                    continue
                cand = frame.tree.query_ball_point(uv, RADIUS_PX)
                if not cand:
                    continue
                best_d, best_i = MAX_HAMMING, -1
                for i in cand:
                    for ofr, oi in pt.obs.items():
                        d = cv2.norm(
                            frame.desc[i], ofr.desc[oi], cv2.NORM_HAMMING
                        )
                        if d < best_d:
                            best_d, best_i = d, i
                if best_i >= 0:
                    prev = best_per_kp.get(best_i)
                    if prev is None or best_d < prev[0]:
                        best_per_kp[best_i] = (best_d, pid)
            out = {}
            taken = set()
            for i, (d, pid) in best_per_kp.items():
                if i in frame.matches or pid in taken:
                    continue
                if any(m == pid for m in frame.matches.values()):
                    continue
                out[i] = pid
                taken.add(pid)
            return out

    # ---- bundle adjustment (Optimization.cpp, Ceres stand-in) --------------
    def optimize(self, free_frames, frozen_frames, optimize_points):
        with self.t("ba"):
            run_ba(self.K, free_frames, frozen_frames, self.points,
                   optimize_points)

    # ---- two-view init (Slam.cpp:32-87, Init.cpp:8-63) ---------------------
    def initialize(self):
        ref = self.next_frame()
        chances = 0
        while True:
            q = self.next_frame()
            if q is None:
                return False
            chances += 1
            if chances > MAX_REF_CHANCES:
                ref, chances = q, 0
                continue
            matches = self.match_frames(ref, q)
            est = estimate_pose(self.K, ref, q, matches, self.t)
            if est is None:
                continue
            pose, inliers = est
            tri = triangulate(self.K, np.eye(4), pose, ref.kp, q.kp, inliers,
                              self.t)
            if len(tri) < MIN_INIT_POINTS:
                continue
            q.pose = pose
            for pos, (i1, i2) in tri:
                pid = self.next_pid
                self.next_pid += 1
                mp = MapPoint(pos)
                mp.obs[ref] = i1
                mp.obs[q] = i2
                ref.matches[i1] = pid
                q.matches[i2] = pid
                self.points[pid] = mp
            self.optimize([q], [ref], True)
            scale = 1.0 / max(np.linalg.norm(q.pose[:3, 3]), 1e-12)
            q.pose[:3, 3] *= scale
            for mp in self.points.values():
                mp.pos = mp.pos * scale
            self.keyframes = [ref, q]
            self.last = q
            return True

    # ---- per-frame tracking (Slam.cpp:89-122) ------------------------------
    def step(self):
        frame = self.next_frame()
        if frame is None:
            return False
        frame.pose = self.last.pose.copy()  # constant-position (Slam.cpp:134)
        last_kf = self.keyframes[-1]
        m1 = self.match_map(frame, lambda p: last_kf in p.obs)
        frame.matches.update(m1)
        self.optimize([frame], [], False)
        m2 = self.match_map(frame)
        frame.matches.update(m2)
        self.optimize([frame], [], False)
        n_kf = len([i for i in last_kf.matches])
        if len(frame.matches) < KEYFRAME_RATIO * n_kf:
            self.init_keyframe(frame)
        self.last = frame
        return True

    # ---- keyframe path (Slam.cpp:177-243) ----------------------------------
    def init_keyframe(self, frame):
        for i, pid in frame.matches.items():
            self.points[pid].obs[frame] = i
        last_kf = self.keyframes[-1]
        # triangulate unmatched (Slam.cpp:186-199)
        fm = self.match_frames(last_kf, frame)
        un = [(a, b) for a, b in fm
              if a not in last_kf.matches and b not in frame.matches]
        tri = triangulate(self.K, last_kf.pose, frame.pose, last_kf.kp,
                          frame.kp, un, self.t)
        for pos, (i1, i2) in tri:
            pid = self.next_pid
            self.next_pid += 1
            mp = MapPoint(pos)
            mp.obs[last_kf] = i1
            mp.obs[frame] = i2
            last_kf.matches[i1] = pid
            frame.matches[i2] = pid
            self.points[pid] = mp
        self.keyframes.append(frame)
        # global BA: prev KFs frozen, new free, points free (Slam.cpp:202-213)
        self.optimize([frame], self.keyframes[:-1], True)
        # cull (Slam.cpp:221-243)
        dead = []
        for pid, mp in self.points.items():
            errs = []
            for fr, i in mp.obs.items():
                uv = project(self.K, fr.pose, mp.pos, clip=False)
                errs.append(np.linalg.norm(uv - fr.kp[i]))
            if errs and np.mean(errs) > CULL_PX:
                dead.append(pid)
        for pid in dead:
            mp = self.points.pop(pid)
            for fr, i in mp.obs.items():
                fr.matches.pop(i, None)


def project(K, pose, pos, clip=True):
    pc = pose[:3, :3] @ pos + pose[:3, 3]
    if clip and pc[2] <= 1e-9:
        return None
    uv = K @ (pc / pc[2])
    return uv[:2]


def estimate_pose(K, f1, f2, matches, timers):
    """PoseEstimation.cpp:61-93: findEssentialMat + cheirality recoverPose."""
    with timers("essential"):
        if len(matches) < 8:
            return None
        p1 = np.float64([f1.kp[a] for a, _ in matches])
        p2 = np.float64([f2.kp[b] for _, b in matches])
        E, inl = cv2.findEssentialMat(
            p1, p2, K, method=cv2.RANSAC, prob=0.999, threshold=0.4
        )
        if E is None or E.shape != (3, 3):
            return None
        _, R, t, inl2 = cv2.recoverPose(E, p1, p2, K, mask=inl)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = t[:, 0]
        inliers = [m for m, ok in zip(matches, inl2[:, 0]) if ok]
        return pose, inliers


def triangulate(K, pose1, pose2, kp1, kp2, matches, timers):
    """Triangulation.cpp:37-98: cv::triangulatePoints + the 3 filters."""
    with timers("triangulate"):
        if not matches:
            return []
        P1 = K @ pose1[:3]
        P2 = K @ pose2[:3]
        p1 = np.float64([kp1[a] for a, _ in matches]).T
        p2 = np.float64([kp2[b] for _, b in matches]).T
        X = cv2.triangulatePoints(P1, P2, p1, p2)
        X = (X[:3] / X[3]).T
        out = []
        c1 = -pose1[:3, :3].T @ pose1[:3, 3]
        c2 = -pose2[:3, :3].T @ pose2[:3, 3]
        for x, m in zip(X, matches):
            pc1 = pose1[:3, :3] @ x + pose1[:3, 3]
            pc2 = pose2[:3, :3] @ x + pose2[:3, 3]
            if pc1[2] <= 0 or pc2[2] <= 0:  # behind camera (:67-73)
                continue
            r1, r2 = x - c1, x - c2
            cosp = r1 @ r2 / max(np.linalg.norm(r1) * np.linalg.norm(r2), 1e-12)
            if cosp > 0.9999:  # parallax (:76-81)
                continue
            e1 = np.linalg.norm(K[:2, :2] @ (pc1[:2] / pc1[2]) + K[:2, 2]
                                - kp1[m[0]])
            e2 = np.linalg.norm(K[:2, :2] @ (pc2[:2] / pc2[2]) + K[:2, 2]
                                - kp2[m[1]])
            if e1 > 2.0 or e2 > 2.0:  # reproj (:84-92)
                continue
            out.append((x, m))
        return out


def run_ba(K, free_frames, frozen_frames, points, optimize_points):
    """Optimization.cpp:83-186 with scipy TRF as the Ceres stand-in.

    Residual = normalized-plane error with fx only (Optimization.cpp:24-43),
    Huber sqrt(5.991), params = 6-dof per free frame (+3 per point when
    optimize_points). Only points observed by a free frame enter; frozen-frame
    observations anchor them (Optimization.cpp:103-147).
    """
    f = K[0, 0]
    pp = K[:2, 2]
    pids = []
    if optimize_points:
        free_set = set(free_frames)
        for pid, mp in points.items():
            if any(fr in free_set for fr in mp.obs):
                pids.append(pid)
    pid_slot = {pid: i for i, pid in enumerate(pids)}
    frame_slot = {fr: i for i, fr in enumerate(free_frames)}

    obs = []  # (frame_or_None slot, point id, uv, frozen pose)
    in_problem = set(pids)
    for fi, fr in enumerate(free_frames + list(frozen_frames)):
        for i, pid in fr.matches.items():
            if optimize_points:
                if pid not in in_problem:
                    continue
            elif fr not in frame_slot:
                continue
            obs.append((frame_slot.get(fr, -1), pid, fr.kp[i], fr))
    if not obs:
        return

    nf = len(free_frames)
    x0 = np.zeros(6 * nf + 3 * len(pids))
    for fr, s in frame_slot.items():
        rvec, _ = cv2.Rodrigues(fr.pose[:3, :3])
        x0[6 * s:6 * s + 3] = rvec[:, 0]
        x0[6 * s + 3:6 * s + 6] = fr.pose[:3, 3]
    for pid, s in pid_slot.items():
        x0[6 * nf + 3 * s:6 * nf + 3 * s + 3] = points[pid].pos

    def unpack(x):
        poses = []
        for s in range(nf):
            R, _ = cv2.Rodrigues(x[6 * s:6 * s + 3])
            poses.append((R, x[6 * s + 3:6 * s + 6]))
        pts = x[6 * nf:].reshape(-1, 3)
        return poses, pts

    def residuals(x):
        poses, pts = unpack(x)
        out = np.zeros(2 * len(obs))
        for k, (fs, pid, uv, fr) in enumerate(obs):
            if fs >= 0:
                R, t = poses[fs]
            else:
                R, t = fr.pose[:3, :3], fr.pose[:3, 3]
            p = pts[pid_slot[pid]] if pid in pid_slot else points[pid].pos
            pc = R @ p + t
            z = max(pc[2], 1e-9)
            out[2 * k] = pc[0] / z - (uv[0] - pp[0]) / f
            out[2 * k + 1] = pc[1] / z - (uv[1] - pp[1]) / f
        return out

    spar = lil_matrix((2 * len(obs), len(x0)), dtype=int)
    for k, (fs, pid, uv, fr) in enumerate(obs):
        if fs >= 0:
            spar[2 * k:2 * k + 2, 6 * fs:6 * fs + 6] = 1
        if pid in pid_slot:
            s = 6 * nf + 3 * pid_slot[pid]
            spar[2 * k:2 * k + 2, s:s + 3] = 1

    res = least_squares(
        residuals, x0, jac_sparsity=spar, method="trf",
        loss="huber", f_scale=HUBER / f, max_nfev=BA_MAX_ITERS,
        x_scale="jac", verbose=0,
    )
    poses, pts = unpack(res.x)
    for fr, s in frame_slot.items():
        R, t = poses[s]
        fr.pose = np.eye(4)
        fr.pose[:3, :3] = R
        fr.pose[:3, 3] = t
    for pid, s in pid_slot.items():
        points[pid].pos = pts[s]


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    # The synthetic-world renderer imports jax-adjacent modules; keep this
    # measurement entirely on CPU (and off the card bench.py may be using).
    jax.config.update("jax_platforms", "cpu")
    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.utils.metrics import ate_rmse
    from racing_slam_tpu.utils.synthetic import make_sequence

    rng = np.random.default_rng(7)
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    seq = make_sequence(
        rng, n_frames=112, cam=cam, n_sprites=260,
        step_t=np.array([0.05, 0.005, 0.10], np.float32), yaw_per_frame=0.002,
    )
    frames = [np.clip(f * 255, 0, 255).astype(np.uint8) for f in seq.frames]
    K = np.array([[480.0, 0, 320.0], [0, 480.0, 240.0], [0, 0, 1]])

    slam = RefSlam(K, frames)
    t0 = time.perf_counter()
    assert slam.initialize(), "reference re-run failed to initialize"
    t_init = time.perf_counter() - t0
    log(f"initialized in {t_init:.2f}s at frame {slam.idx}")

    t0 = time.perf_counter()
    n = 0
    while slam.step():
        n += 1
    dt = time.perf_counter() - t0
    fps = n / dt
    log(f"tracked {n} frames in {dt:.2f}s -> {fps:.2f} fps; "
        f"kf={len(slam.keyframes)} pts={len(slam.points)}")
    for name, acc in sorted(slam.t.acc.items(), key=lambda kv: -kv[1]):
        log(f"  {name:14s} {acc / n * 1e3:8.2f} ms/frame")

    # ATE vs ground truth (Sim3-aligned, same evaluator as bench.py)
    kf_poses = np.stack([kf.pose for kf in slam.keyframes])
    kf_idx = np.array([kf.index for kf in slam.keyframes])
    gt = np.stack([np.asarray(p) for p in seq.poses])[kf_idx]
    ate = ate_rmse(kf_poses, gt)
    from racing_slam_tpu.utils.metrics import camera_centers
    length = float(np.linalg.norm(np.diff(camera_centers(gt), axis=0),
                                  axis=-1).sum())
    log(f"ATE {ate:.4f} over trajectory length {length:.2f}")

    print(json.dumps({
        "metric": "reference_rerun_fps_640x480_full_pipeline",
        "value": round(fps, 3),
        "unit": "frames/s",
        "ate": round(float(ate), 4),
        "n_frames": n,
        "trajectory_length": round(length, 3),
        "stage_ms_per_frame": {
            k: round(v / n * 1e3, 2) for k, v in slam.t.acc.items()
        },
    }))


if __name__ == "__main__":
    main()
