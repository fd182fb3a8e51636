"""Patch descriptors: normalized intensity patches projected to 128-d.

Replacement for the reference's ORB descriptors (upright BRIEF over a 31 px
patch — src/features/OrbFeatureExtractor.cpp:18-22; GFTT leaves keypoint
angle unset so ORB::compute produces *upright* descriptors). This design
uses a dense float descriptor instead of binary Hamming: a Gaussian-blurred
S x S intensity patch around each keypoint, mean/variance normalized
(photometric invariance), projected by a fixed random orthonormal matrix to
D = 128 and L2-normalized. Matching distance is then
Euclidean in [0, 2], analogous to the reference's deep-descriptor path
(L2 norm, max distance 0.7 — src/features/DeepFeatureExtractor.h:12-19).

All of it is gathers + one [K, S^2] x [S^2, D] matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .image import gaussian_blur
from .precision import f32_precision

PATCH_SIZE = 16  # samples per side
PATCH_SPACING = 1.5  # px between samples => ~24 px support (ORB patch is 31)
DESCRIPTOR_DIM = 128
BLUR_SIGMA = 2.0
# Default match gate for these descriptors (L2 on unit vectors, in [0, 2]);
# analogous role to max_distance() in the reference extractors.
MAX_DISTANCE = 0.8


def _projection_matrix() -> np.ndarray:
    """Fixed random orthonormal [S^2, D] projection (seeded, reproducible)."""
    rng = np.random.default_rng(1234)
    A = rng.standard_normal((PATCH_SIZE * PATCH_SIZE, PATCH_SIZE * PATCH_SIZE))
    Q, _ = np.linalg.qr(A)
    return Q[:, :DESCRIPTOR_DIM].astype(np.float32)


_PROJ = _projection_matrix()


def _patch_offsets() -> np.ndarray:
    """[S^2, 2] (dx, dy) sampling grid centered on the keypoint."""
    r = (PATCH_SIZE - 1) / 2.0
    lin = (np.arange(PATCH_SIZE) - r) * PATCH_SPACING
    dx, dy = np.meshgrid(lin, lin)
    return np.stack([dx.ravel(), dy.ravel()], axis=-1).astype(np.float32)


_OFFSETS = _patch_offsets()


# Side of the square window fetched around each keypoint. Must cover the
# sampling support (PATCH_SIZE * PATCH_SPACING = 24 px) + 1 px for bilinear;
# 32 keeps the minor dims tile-aligned.
PATCH_T = 32


@f32_precision
def extract_descriptors(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Compute descriptors for keypoints.

    Args:
      img: [H, W] grayscale float32 (unblurred; blurring happens here).
      xy: [K, 2] keypoint pixel coords.
    Returns: [K, D] L2-normalized float32 descriptors.

    Instead of 4 scalar gathers per sample (K * S^2 * 4 random loads — the
    dominant cost of the naive bilinear formulation), this
    fetches one contiguous [T, T] window per keypoint (a single XLA gather
    of K tiles via vmapped dynamic_slice) and expresses the fractional
    sampling grid as two small per-keypoint interpolation matmuls — the
    separable structure of bilinear interpolation. Everything downstream of
    the window fetch is matrix work.
    """
    H, W = img.shape
    K = xy.shape[0]
    S = PATCH_SIZE
    T = PATCH_T
    blurred = gaussian_blur(img, BLUR_SIGMA)

    r = (S - 1) / 2.0
    lin = jnp.asarray((np.arange(S) - r) * PATCH_SPACING, jnp.float32)  # [S]
    x = jnp.clip(xy[:, 0], 0.0, W - 1.001)
    y = jnp.clip(xy[:, 1], 0.0, H - 1.001)
    ox = jnp.clip(jnp.floor(x).astype(jnp.int32) - T // 2 + 1, 0, W - T)
    oy = jnp.clip(jnp.floor(y).astype(jnp.int32) - T // 2 + 1, 0, H - T)
    patches = jax.vmap(
        lambda oy_, ox_: jax.lax.dynamic_slice(blurred, (oy_, ox_), (T, T))
    )(oy, ox)  # [K, T, T]

    def interp_matrix(coord, origin):
        """Bilinear weights of the S sample positions over the T window
        columns: [K, S, T] with two nonzeros per row."""
        s = coord[:, None] + lin[None, :] - origin[:, None].astype(jnp.float32)
        s = jnp.clip(s, 0.0, T - 1.001)
        s0 = jnp.floor(s)
        f = (s - s0)[..., None]  # [K, S, 1]
        s0i = s0.astype(jnp.int32)[..., None]  # [K, S, 1]
        cols = jnp.arange(T, dtype=jnp.int32)
        return (cols == s0i) * (1.0 - f) + (cols == s0i + 1) * f

    Ry = interp_matrix(y, oy)  # [K, S, T]
    Cx = interp_matrix(x, ox)  # [K, S, T]
    rows = jnp.einsum("kiy,kyx->kix", Ry, patches)  # [K, S, T]
    sampled = jnp.einsum("kix,kjx->kij", rows, Cx)  # [K, S(y), S(x)]
    return _finalize(sampled.reshape(K, S * S))


def _finalize(patches_flat: jnp.ndarray) -> jnp.ndarray:
    """Normalize flat patches and project to D: [K, S^2] -> [K, D] unit."""
    mean = jnp.mean(patches_flat, axis=-1, keepdims=True)
    std = jnp.std(patches_flat, axis=-1, keepdims=True) + 1e-6
    normed = (patches_flat - mean) / std
    desc = normed @ jnp.asarray(_PROJ)  # [K, D]
    return desc / (jnp.linalg.norm(desc, axis=-1, keepdims=True) + 1e-8)


# Margin of the static per-cell window. A keypoint sits anywhere in its
# cell [0, cell) and its sampling grid spans +-(PATCH_SIZE-1)/2 * SPACING
# = +-11.25 px (+1 for bilinear), so window = [-MARGIN, cell + MARGIN).
CELL_MARGIN = 16


@f32_precision
def extract_descriptors_cells(
    img: jnp.ndarray,
    xy: jnp.ndarray,
    cell: int,
    n_per_cell: int,
) -> jnp.ndarray:
    """Descriptors for GRID-ORDERED keypoints without per-keypoint gathers.

    `xy` must follow detect_corners' layout: K = n_per_cell * gh * gw with
    keypoint i belonging to cell (i % (gh * gw)). Each cell's fixed
    (cell + 2*MARGIN)^2 window is assembled from 3x3 shifted STATIC slices of
    the padded image — pure dense copies — so the per-keypoint work reduces
    to the two separable interpolation matmuls. The vmapped dynamic_slice
    formulation (extract_descriptors) does a [K, T, T] random gather every
    frame instead.

    Requires cell >= 9 and CELL_MARGIN <= cell (margin = one neighbor tile).
    """
    H, W = img.shape
    S = PATCH_SIZE
    M = CELL_MARGIN
    assert M <= cell, "CELL_MARGIN must fit in one neighboring tile"
    T = cell + 2 * M
    blurred = gaussian_blur(img, BLUR_SIGMA)

    gh = -(-H // cell)
    gw = -(-W // cell)
    K = xy.shape[0]
    assert K == n_per_cell * gh * gw, "xy must be grid-ordered"

    # Pad to the tile grid plus one margin tile on every side (edge padding
    # approximates the clamped-window behavior of the gather path at image
    # borders; border keypoints are suppressed upstream anyway). The extra
    # trailing `cell` keeps every strided chunk view below in bounds.
    Hp = gh * cell
    Wp = gw * cell
    padded = jnp.pad(
        blurred, ((M, Hp - H + M + cell), (M, Wp - W + M + cell)), mode="edge"
    )

    # Window of cell (cy, cx) spans padded[cy*cell : cy*cell + T, ...].
    # Decompose the window's row range [0, T) into chunks [0, M), [M, M+cell),
    # [M+cell, T). For a fixed chunk (start, size), the rows of ALL windows
    # form one strided view of the padded image: padded[start : start +
    # gh*cell] reshaped to [gh, cell, ...] and cropped to size — a static
    # dense copy, no gather. Same along columns; concatenating the 3x3
    # chunk grid rebuilds every window.
    row_chunks = [(0, M), (M, cell), (M + cell, M)]
    col_chunks = [(0, M), (M, cell), (M + cell, M)]
    rows_built = []
    for rs, rn in row_chunks:
        cols_built = []
        for cs, cn in col_chunks:
            block = padded[rs : rs + gh * cell, cs : cs + gw * cell]
            # -> [gh, rn, gw, cn] by striding cell in both dims then cropping
            block = block.reshape(gh, cell, gw, cell)[:, :rn, :, :cn]
            cols_built.append(block)
        rows_built.append(jnp.concatenate(cols_built, axis=-1))  # [gh,rn,gw,T]
    windows = jnp.concatenate(rows_built, axis=1)  # [gh, T, gw, T]
    windows = windows.transpose(0, 2, 1, 3).reshape(gh * gw, T, T)

    r = (S - 1) / 2.0
    lin = jnp.asarray((np.arange(S) - r) * PATCH_SPACING, jnp.float32)  # [S]
    C = gh * gw
    # Cell origins (static, cell-major layout).
    ids = np.arange(C)
    origin_x = jnp.asarray((ids % gw) * cell - M, jnp.float32)  # [C]
    origin_y = jnp.asarray((ids // gw) * cell - M, jnp.float32)

    def interp(coord, origin):
        """[C] coord, [C] window origin -> [C, S, T] bilinear weights."""
        s = coord[:, None] + lin[None, :] - origin[:, None]
        s = jnp.clip(s, 0.0, T - 1.001)
        s0 = jnp.floor(s)
        f = (s - s0)[..., None]
        s0i = s0.astype(jnp.int32)[..., None]
        cols = jnp.arange(T, dtype=jnp.int32)
        return (cols == s0i) * (1.0 - f) + (cols == s0i + 1) * f

    outs = []
    for g in range(n_per_cell):
        gx = xy[g * C : (g + 1) * C, 0]
        gy = xy[g * C : (g + 1) * C, 1]
        Ry = interp(gy, origin_y)  # [C, S, T]
        Cx = interp(gx, origin_x)
        rows2 = jnp.einsum("kiy,kyx->kix", Ry, windows)  # [C, S, T]
        sampled = jnp.einsum("kix,kjx->kij", rows2, Cx)  # [C, S, S]
        outs.append(sampled.reshape(C, S * S))
    return _finalize(jnp.concatenate(outs, axis=0))
