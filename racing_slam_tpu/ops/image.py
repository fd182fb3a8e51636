"""Image-processing primitives: convolutions, gradients, bilinear sampling.

Everything operates on single-channel float32 images [H, W] (grayscale in
[0, 1]) with static shapes, expressed as XLA-friendly convs and gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .precision import f32_precision


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] uint8/float -> [H, W] float32 in [0, 1] (BT.601 luma, the
    same weighting cv::cvtColor BGR2GRAY uses in the reference extractor,
    src/features/OrbFeatureExtractor.cpp:8)."""
    img = img.astype(jnp.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    return gray / 255.0


def _conv2d(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """'same' conv of [H, W] with [kh, kw], f32.

    Single-channel spatial convolutions give a matrix unit no contraction
    dimension (C=1), so this routes through shift-and-add: one padded slice
    + FMA per tap, which XLA fuses into elementwise kernels. The kernels
    used here are small and separable (3-15 taps per axis).
    """
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    H, W = img.shape
    padded = jnp.pad(img, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    out = jnp.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            k = kernel[kh - 1 - dy, kw - 1 - dx]  # conv = correlate(flipped)
            out = out + k * jax.lax.dynamic_slice(padded, (dy, dx), (H, W))
    return out


def _sep_conv(img: jnp.ndarray, krow: jnp.ndarray, kcol: jnp.ndarray) -> jnp.ndarray:
    """Separable 'same' conv: 1-D kernel along W (krow) then along H (kcol)."""
    tmp = _conv2d(img, krow[None, :])
    return _conv2d(tmp, kcol[:, None])


@f32_precision
def sobel_gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ix, Iy via 3x3 Sobel (matches cv::Sobel used inside GFTT).

    Sobel is separable: smooth [1,2,1] x diff [-1,0,1]."""
    smooth = jnp.array([1.0, 2.0, 1.0])
    diff = jnp.array([-1.0, 0.0, 1.0])
    ix = _sep_conv(img, diff, smooth)
    iy = _sep_conv(img, smooth, diff)
    return ix, iy


def box_filter(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """size x size box sum (not mean) via separable conv."""
    k = jnp.ones((size,), jnp.float32)
    return _sep_conv(img, k, k)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = int(3.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    k = jnp.asarray(gaussian_kernel1d(sigma))
    return _sep_conv(img, k, k)


def max_pool_same(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """size x size max filter, 'same' padding (for NMS).

    Separable shift-max (size taps per axis) instead of lax.reduce_window:
    elementwise maxima that fuse with their neighbours."""
    H, W = img.shape
    p = size // 2

    def pool_axis(x, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (p, size - 1 - p)
        padded = jnp.pad(x, pad, constant_values=-jnp.inf)
        out = None
        for d in range(size):
            start = (d, 0) if axis == 0 else (0, d)
            sl = jax.lax.dynamic_slice(padded, start, (H, W))
            out = sl if out is None else jnp.maximum(out, sl)
        return out

    return pool_axis(pool_axis(img, 1), 0)


@f32_precision
def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Sample [H, W] image at continuous (x, y) locations [..., 2].

    Out-of-bounds coordinates are clamped (callers mask separately).
    """
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, W - 1)
    y1i = jnp.minimum(y0i + 1, H - 1)

    flat = img.reshape(-1)
    g = lambda yy, xx: flat[yy * W + xx]
    v00 = g(y0i, x0i)
    v01 = g(y0i, x1i)
    v10 = g(y1i, x0i)
    v11 = g(y1i, x1i)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
