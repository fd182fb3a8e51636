"""Process set-up shared by the GPU entry points (bench.py, bench_scaling.py,
chip_smoke.py): the persistent compile cache, the GPU requirement, and the
card description every measurement is printed beside.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# Fixed, gitignored, inside the checkout: the cache key includes the path, so
# a directory that moves between runs would never hit.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set here. Otherwise the cache lives at DEFAULT_CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(DEFAULT_CACHE_DIR)


def require_gpu() -> dict:
    """Fail unless JAX's default devices are GPUs; describe them.

    Returns {"platform", "kind", "count"} as JAX reports them.
    """
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default devices are {devs[0].platform!r} "
            f"({devs[0].device_kind}); this entry point measures the GPU only"
        )
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> list[str]:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
