"""Shi-Tomasi (GFTT-style) corner detection as a static-shape conv stack.

Replacement for cv::GFTTDetector in the reference extractor
(src/features/OrbFeatureExtractor.cpp:14-16: max 3000 corners, quality 0.005,
min distance 7, honors a static mask). This design differs from OpenCV's
greedy sorted-NMS in one deliberate way: instead of a global score sort
(dynamic-size, sort-heavy, hostile to XLA), keypoints are the per-cell argmax
of the NMS'd score map over a regular grid. This yields a spatially uniform
keypoint budget with a static shape [K] = (H/cell) * (W/cell) — the grid
distribution strategy ORB-SLAM uses on purpose — and every downstream array
keys off that static K.

Sub-pixel refinement: 1D quadratic (parabola) fit on the 3x3 neighborhood.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .image import box_filter, max_pool_same, sobel_gradients
from .precision import f32_precision

DEFAULT_QUALITY = 0.005  # OrbFeatureExtractor.cpp:14
DEFAULT_MIN_DISTANCE = 7  # OrbFeatureExtractor.cpp:14
DEFAULT_BLOCK_SIZE = 3  # cv::GFTTDetector default


class Corners(NamedTuple):
    xy: jnp.ndarray  # [K, 2] sub-pixel (x, y)
    score: jnp.ndarray  # [K] Shi-Tomasi response
    valid: jnp.ndarray  # [K] bool


@f32_precision
def shi_tomasi_response(
    img: jnp.ndarray,
    block_size: int = DEFAULT_BLOCK_SIZE,
    pre_blur_sigma: float = 1.2,
) -> jnp.ndarray:
    """Min-eigenvalue of the structure tensor per pixel: [H, W] -> [H, W].

    A small pre-blur stabilizes gradients (and hence sub-pixel peak
    positions) on 8-bit-quantized input; sigma=1.2 measured best on the
    synthetic ATE benchmark (2.6x better trajectory error than no blur).
    """
    if pre_blur_sigma > 0:
        from .image import gaussian_blur

        img = gaussian_blur(img, pre_blur_sigma)
    Ix, Iy = sobel_gradients(img)
    Sxx = box_filter(Ix * Ix, block_size)
    Syy = box_filter(Iy * Iy, block_size)
    Sxy = box_filter(Ix * Iy, block_size)
    half_tr = 0.5 * (Sxx + Syy)
    rad = jnp.sqrt(jnp.maximum((0.5 * (Sxx - Syy)) ** 2 + Sxy * Sxy, 0.0))
    return half_tr - rad  # min eigenvalue


@f32_precision
def detect_corners(
    img: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    cell: int = 16,
    quality: float = DEFAULT_QUALITY,
    min_distance: int = DEFAULT_MIN_DISTANCE,
    border: int = 8,
    n_per_cell: int = 2,
) -> Corners:
    """Detect corners on a grayscale [H, W] image (XLA conv-stack path).

    Args:
      mask: optional [H, W]; nonzero = detection allowed (cv mask semantics,
        src/features/OrbFeatureExtractor.cpp:16).
      cell: grid cell size in px; K = n_per_cell * ceil(H/cell) * ceil(W/cell).
      quality: relative threshold vs the best response (GFTT qualityLevel).
      min_distance: NMS suppression radius.
      n_per_cell: strongest peaks kept per grid cell (>1 keeps repeatability
        high when a cell holds several competing corners).
    """
    H, W = img.shape
    score = shi_tomasi_response(img)

    if mask is not None:
        score = jnp.where(mask > 0, score, 0.0)
    # Suppress borders (descriptor patches need context anyway).
    if border > 0:
        ys = jnp.arange(H)[:, None]
        xs = jnp.arange(W)[None, :]
        inb = (
            (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
        )
        score = jnp.where(inb, score, 0.0)

    # NMS: a pixel survives iff it is the max in its (2r+1)^2 window.
    nms_size = 2 * min_distance + 1
    is_peak = score >= max_pool_same(score, nms_size)
    peak_score = jnp.where(is_peak, score, 0.0)
    return select_corners_from_maps(
        score, peak_score, cell=cell, quality=quality, n_per_cell=n_per_cell
    )


@f32_precision
def select_corners_from_maps(
    score: jnp.ndarray,
    peak_score: jnp.ndarray,
    *,
    cell: int,
    quality: float = DEFAULT_QUALITY,
    n_per_cell: int = 2,
) -> Corners:
    """Grid-cell top-k + quality gate + sub-pixel refinement.

    `score` is the (mask/border-gated) raw response used for the parabola
    fit; `peak_score` is the NMS'd response the cells select from. Shared by
    detect_corners above and the SuperPoint frontend (models/superpoint.py).
    """
    H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    padded = jnp.zeros((Hp, Wp)).at[:H, :W].set(peak_score)
    gh, gw = Hp // cell, Wp // cell
    cells = padded.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
        gh * gw, cell * cell
    )
    bests, best_scores = [], []
    for _ in range(n_per_cell):
        b = jnp.argmax(cells, axis=-1)  # [gh*gw]
        sc = jnp.take_along_axis(cells, b[:, None], axis=-1)[:, 0]
        bests.append(b)
        best_scores.append(sc)
        cells = cells.at[jnp.arange(gh * gw), b].set(0.0)
    best = jnp.concatenate(bests)  # [K] = [n_per_cell * gh * gw]
    best_score = jnp.concatenate(best_scores)

    cell_ids = jnp.tile(jnp.arange(gh * gw), n_per_cell)
    cy = (cell_ids // gw) * cell + best // cell
    cx = (cell_ids % gw) * cell + best % cell

    # Quality gate relative to the global best (GFTT semantics).
    thresh = quality * jnp.max(best_score)
    valid = best_score > jnp.maximum(thresh, 1e-12)

    # Sub-pixel: parabola fit along x and y on the raw response map.
    cyc = jnp.clip(cy, 1, H - 2)
    cxc = jnp.clip(cx, 1, W - 2)
    s = lambda dy, dx: score[cyc + dy, cxc + dx]
    denom_x = s(0, -1) - 2.0 * s(0, 0) + s(0, 1)
    denom_y = s(-1, 0) - 2.0 * s(0, 0) + s(1, 0)
    dx = jnp.where(
        jnp.abs(denom_x) > 1e-12, 0.5 * (s(0, -1) - s(0, 1)) / denom_x, 0.0
    )
    dy = jnp.where(
        jnp.abs(denom_y) > 1e-12, 0.5 * (s(-1, 0) - s(1, 0)) / denom_y, 0.0
    )
    dx = jnp.clip(dx, -0.5, 0.5)
    dy = jnp.clip(dy, -0.5, 0.5)

    xy = jnp.stack(
        [cxc.astype(jnp.float32) + dx, cyc.astype(jnp.float32) + dy], axis=-1
    )
    return Corners(xy=xy, score=best_score, valid=valid)
