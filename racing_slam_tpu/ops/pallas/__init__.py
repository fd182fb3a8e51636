"""Pallas kernels (Triton route) for the tracking step's hot inner loops.

The kernels compile for NVIDIA GPUs only. Tests run them on the CPU through
Pallas' interpreter (the `pallas_interpret` fixture in tests/conftest.py);
the engine itself never interprets.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "pallas", "xla")


def resolve_backend(backend: str) -> str:
    """Map a backend option to the path that runs.

    "auto" takes the Pallas kernel on a GPU and the XLA path elsewhere;
    "pallas" demands the kernel and raises where there is no GPU; "xla"
    always takes the XLA path.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    on_gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        return "pallas" if on_gpu else "xla"
    if backend == "pallas" and not on_gpu:
        raise ValueError(
            "backend='pallas' needs a GPU (the kernels compile through "
            f"Triton); the default backend is {jax.default_backend()!r}"
        )
    return backend
