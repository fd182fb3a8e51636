"""A/B: our batched 8-point RANSAC + IRLS refit vs OpenCV's 5-point RANSAC.

The reference uses cv::findEssentialMat's 5-point minimal solver
(src/PoseEstimation.cpp:73-79). The engine trades it for a vmapped
8-point hypothesis batch + IRLS refit (ops/ransac.py): the 5-point solver
needs 10th-degree polynomial root-finding (eigendecomposition of a
non-symmetric companion matrix per hypothesis), which does not batch into
one static-shape device program. This tool measures what that trade costs ON THE BENCH
WORLD, at bootstrap-like frame gaps from low to moderate parallax:
identical features + matches are fed to both estimators and each relative
pose is scored against ground truth (rotation angle error; translation
DIRECTION angle error — monocular scale is unobservable).

Runs on CPU (leaves the card free):  python tools/ab_five_point.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import cv2  # noqa: E402
import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def pose_errors(R_est, t_est, T_gt_rel):
    """(rotation deg, translation-direction deg) vs ground-truth relative."""
    R_gt = T_gt_rel[:3, :3]
    t_gt = T_gt_rel[:3, 3]
    dR = R_est @ R_gt.T
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    rot_deg = float(np.degrees(np.arccos(c)))
    n_est = np.linalg.norm(t_est)
    n_gt = np.linalg.norm(t_gt)
    if n_est < 1e-12 or n_gt < 1e-12:
        return rot_deg, float("nan")
    ca = np.clip(abs(np.dot(t_est / n_est, t_gt / n_gt)), -1.0, 1.0)
    return rot_deg, float(np.degrees(np.arccos(ca)))


def main():
    from racing_slam_tpu.ops import se3
    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.ops.ransac import estimate_relative_pose
    from racing_slam_tpu.slam.frontend import ClassicalFrontend
    from racing_slam_tpu.utils.synthetic import make_sequence

    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0,
                 width=640, height=480)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    fe = ClassicalFrontend()
    extract = jax.jit(fe.extract)
    matcher = jax.jit(fe.matcher)

    rows = {}
    for seed in (3, 5, 8):
        rng = np.random.default_rng(seed)
        seq = make_sequence(
            rng, n_frames=64, cam=cam, n_sprites=260,
            step_t=np.array([0.05, 0.005, 0.10], np.float32),
            yaw_per_frame=0.002,
        )
        feats = [extract(jnp.asarray(f), None) for f in seq.frames]
        for gap in (1, 2, 3, 5, 8):
            for i0 in range(2, 50, 7):
                i1 = i0 + gap
                fa, fb = feats[i0], feats[i1]
                fm = matcher(fa.desc, fa.xy, fa.valid, fb.desc, fb.xy, fb.valid)
                valid = np.asarray(fm.valid)
                if valid.sum() < 30:
                    continue
                uv1 = np.asarray(fa.xy[fm.train_idx])[valid]
                uv2 = np.asarray(fb.xy)[valid]
                T_gt = np.asarray(
                    seq.poses[i1] @ np.linalg.inv(seq.poses[i0])
                )

                # (a) ours: batched 8-point RANSAC + IRLS refit
                est = estimate_relative_pose(
                    cam, jnp.asarray(fa.xy[fm.train_idx]), jnp.asarray(fb.xy),
                    jnp.asarray(fm.valid), jax.random.PRNGKey(seed * 100 + i0),
                    num_hypotheses=2048, threshold_px=0.4,
                )
                T8 = np.asarray(est.pose)
                r8, t8 = pose_errors(T8[:3, :3], T8[:3, 3], T_gt)

                # (b) reference path: cv 5-point RANSAC + cheirality
                E, inl = cv2.findEssentialMat(
                    uv1, uv2, K, method=cv2.RANSAC, prob=0.999, threshold=0.4
                )
                if E is None or E.shape != (3, 3):
                    continue
                _, R5, t5, _ = cv2.recoverPose(E, uv1, uv2, K, mask=inl)
                r5, t5e = pose_errors(R5, t5[:, 0], T_gt)

                # Parallax proxy: median flow magnitude of the matches (px).
                flow = float(np.median(np.linalg.norm(uv2 - uv1, axis=1)))
                rows.setdefault(gap, []).append((flow, r8, t8, r5, t5e))

    print(f"{'gap':>4} {'n':>4} {'med_flow_px':>11} "
          f"{'rot8':>7} {'dir8':>7} {'rot5':>7} {'dir5':>7}   (median deg)")
    for gap in sorted(rows):
        a = np.array(rows[gap])
        med = np.nanmedian(a, axis=0)
        print(f"{gap:>4} {len(a):>4} {med[0]:>11.1f} "
              f"{med[1]:>7.3f} {med[2]:>7.2f} {med[3]:>7.3f} {med[4]:>7.2f}")


if __name__ == "__main__":
    main()
