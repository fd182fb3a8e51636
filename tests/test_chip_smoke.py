"""chip_smoke.py: refuses to run without a GPU, and its phase functions work
on the CPU at a tiny size (kernels through the Pallas interpreter)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from racing_slam_tpu.ops.camera import Camera

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four"], ["--compare-backends"]])
def test_exits_nonzero_without_gpu(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("P", [64, 100])
def test_match_phase_cpu(P, pallas_interpret):
    res = cs.check_match(P, K=128, O=4, D=32, reps=1)
    assert res["ok"], res
    assert res["max_abs_d"] == 0.0 and res["k_mismatch"] == 0


def test_motion_phase_cpu(pallas_interpret):
    res = cs.check_motion(300, reps=1)
    assert res["ok"], res
    assert 1 <= res["kernel_iters"] <= res["max_iters"]


def test_track_phase_cpu():
    cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
    seq = cs.render_world(cam, 24)
    cfg = cs.bench_config(cam, map_capacity=1024, max_keyframes=8,
                          refine_every_frames=12)
    res = cs.track("classical", cam, cfg, seq, batch=12, replays=1)
    assert res["ok"], res
    assert res["frames"] == 24 and len(res["fps"]) == 1
    assert res["step_memory"]["argument_size_in_bytes"] > 0


def test_failed_phase_is_recorded(capsys):
    failures = []

    def boom():
        raise RuntimeError("x")

    assert cs._phase("boom", boom, failures) is None
    cs._phase("bad", lambda: {"ok": False}, failures)
    cs._phase("good", lambda: {"ok": True}, failures)
    assert failures == ["boom", "bad"]
    assert "good: ok" in capsys.readouterr().out
