"""Matmul-precision control for geometry kernels.

On an NVIDIA GPU, an f32 matmul/einsum at the default precision may run in
TF32 on the tensor cores: 10 mantissa bits, about three decimal digits. That
is the right trade for neural nets, but geometry (8-point constraint
matrices, Sampson scores, DLT normal matrices, pose chains, reprojection
errors) loses the digits that sub-pixel thresholds depend on. Every geometry entry point is
wrapped with @f32_precision so its traced matmuls run at HIGHEST precision,
while model code elsewhere keeps the fast default.
"""

from __future__ import annotations

import functools

import jax


def f32_precision(fn):
    """Decorator: trace the function under highest matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
