"""TRUE multi-process run: 2 jax.distributed CPU processes on localhost.

The multi-host code paths (initialize_distributed, put_sharded's
make_array_from_process_local_data branch, MultiSlam's addressable-shard
readbacks and allgathered control decisions) cannot be exercised by the
8-virtual-device single-process mesh — this test spawns two REAL processes
(4 virtual CPU devices each, gloo collectives) running tests/mp_worker.py in
lockstep over a {seq: 2, lm: 4} mesh, one sequence per process, and asserts
the resulting trajectories equal a single-process MultiSlam run of the same
two sequences.
"""

import os
import socket
import subprocess
import sys

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_run_matches_single(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_worker.py")
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            SLAM_COORDINATOR=f"localhost:{port}",
            SLAM_NUM_PROCESSES="2",
            SLAM_PROCESS_ID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, worker, str(tmp_path)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=840)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    # Single-process baseline over the SAME two sequences on this process's
    # 8-device mesh (same {seq: 2, lm: 4} topology, both rows local).
    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.parallel.mesh import make_mesh
    from racing_slam_tpu.parallel.multi_seq import MultiSlam
    from racing_slam_tpu.slam.config import SlamConfig
    from racing_slam_tpu.utils.synthetic import make_sequence
    from racing_slam_tpu.utils.video import ArraySource

    cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
    seqs = [
        make_sequence(
            np.random.default_rng(42 + i), n_frames=10, cam=cam, n_sprites=140,
            step_t=np.array([0.10, 0.01, 0.16], np.float32),
        )
        for i in range(2)
    ]
    cfg = SlamConfig(
        triangulate_points=True,
        bundle_adjust=True,
        optimize_pose=True,
        cull_points=True,
        max_keyframes=4,
        map_capacity=256,
        max_observations=4,
        ba_iters=2,
        motion_ba_iters=2,
        ransac_hypotheses=64,
        reinit_on_lost=False,
    )
    mesh = make_mesh({"seq": 2, "lm": 4})
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], mesh, cfg)
    assert ms.initialize()
    assert ms.run_batched(max_frames=6, batch=3) == 6
    want = ms.states_per_sequence()

    got = {}
    for pid in range(2):
        with np.load(tmp_path / f"proc{pid}.npz") as d:
            got.update({k: d[k] for k in d.files})
    for g in range(2):
        assert f"seq{g}_last_t" in got, sorted(got)
        np.testing.assert_array_equal(
            got[f"seq{g}_kf_valid"], np.asarray(want[g].kfs.valid)
        )
        assert int(got[f"seq{g}_num_kf"]) == int(want[g].num_kf)
        np.testing.assert_allclose(
            got[f"seq{g}_last_t"], np.asarray(want[g].last_t), atol=5e-2
        )
