"""Measurement matrix: every bench.py variant row, one world.

Runs bench.py invocations one after another, each in its own process (one
JAX process per card; this parent never imports JAX), and collects each
stdout JSON line into matrix.json. All rows run on the SAME
304-frame world protocol (seeds subsets of the headline's 3,5,7,8,9) except
the large-map rows, which use 150 frames at 4x capacity.

Run:  python tools/run_matrix.py [--only headline,lightglue,...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = {
    "headline": ["--seeds", "3,5,7,8,9", "--replays", "5"],
    "lightglue": ["--variant", "lightglue", "--seeds", "3,8", "--replays", "4"],
    "learned": ["--variant", "learned", "--seeds", "3,8", "--replays", "4"],
    "masked": ["--masked", "--seeds", "3,8", "--replays", "4"],
    "720p": ["--res", "720", "--seeds", "3,8", "--replays", "4"],
    "p16384": ["--map-capacity", "16384", "--frames", "150",
               "--seeds", "3,8", "--replays", "4"],
    "p4096_150": ["--frames", "150", "--seeds", "3,8", "--replays", "4"],
    "p16384_f64": ["--map-capacity", "16384", "--max-keyframes", "64",
                   "--frames", "150", "--seeds", "3,8", "--replays", "4"],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--out", type=str,
                    default=os.path.join(ROOT, "chiprun_out", "bench_matrix"))
    args = ap.parse_args()
    names = [n for n in args.only.split(",") if n] or list(ROWS)
    os.makedirs(args.out, exist_ok=True)
    results = {}
    for name in names:
        extra = ROWS[name]
        log = os.path.join(args.out, f"{name}.log")
        outj = os.path.join(args.out, f"{name}.json")
        t0 = time.time()
        print(f"=== {name}: bench.py {' '.join(extra)}", flush=True)
        with open(log, "w") as lf, open(outj, "w") as of:
            rc = subprocess.call(
                [sys.executable, os.path.join(ROOT, "bench.py")] + extra,
                stdout=of, stderr=lf, cwd=ROOT, timeout=4000,
            )
        dt = time.time() - t0
        line = open(outj).read().strip()
        print(f"    rc={rc} in {dt/60:.1f} min: {line[:200]}", flush=True)
        if line:
            try:
                results[name] = json.loads(line)
            except json.JSONDecodeError:
                results[name] = {"error": line[:500]}
        with open(os.path.join(args.out, "matrix.json"), "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({k: {kk: v.get(kk) for kk in (
        "value", "device_fps", "ate_pct_of_length", "coverage",
        "fps_median_replay")} for k, v in results.items()}, indent=1))


if __name__ == "__main__":
    main()
