"""Feature frontends: classical (corner + patch descriptor) and learned.

The reference has two interchangeable extractors behind
BaseFeatureExtractor (src/features/FeatureExtractor.h:43-59):
OrbFeatureExtractor (GFTT + ORB) and DeepFeatureExtractor (lightglue-cpp
SuperPoint-style). Here a frontend is a small object exposing

    extract(img, mask) -> Features      (jit-safe, static K)
    max_distance                        (match gate for its descriptor space)

The classical frontend corresponds to the ORB path; the learned frontend
(models/superpoint.py) plugs in behind the same interface.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.corners import detect_corners
from ..ops.descriptors import MAX_DISTANCE, extract_descriptors_cells
from ..ops.matching import match_frames
from .state import Features


class ClassicalMatcher:
    """Mutual-1NN descriptor matching with a distance gate — the reference's
    BFMatcher cross-check path (src/features/FeatureExtractor.cpp:9-24).
    Ignores keypoint geometry; kept behind the same call signature as the
    learned matcher so the pipeline is matcher-agnostic."""

    def __init__(self, max_distance: float = MAX_DISTANCE):
        self.max_distance = max_distance

    def __call__(self, desc0, xy0, valid0, desc1, xy1, valid1):
        return match_frames(desc0, valid0, desc1, valid1, self.max_distance)


class LightGlueMatcher:
    """LightGlue-style attention matcher (models/lightglue.py) behind the
    frame-matching interface — the reference's lightglue-cpp role
    (src/features/DeepFeatureExtractor.cpp:8). Takes keypoint coords for the
    rotary positional encoding; weights come from a trained .npz
    (models/train.py, committed at racing_slam_tpu/weights/lightglue.npz)."""

    # Threshold picked by precision/recall sweep on held-out homography
    # pairs (models/train.py eval). Round-5 weights at 0.35: on classical
    # descriptors the trained matcher reaches precision .87 / recall .98
    # (vs .93/.95 for mutual-1NN — it proposes more, recovering matches
    # the distance gate drops); in-pipeline both trained pairings track
    # the 304-frame bench at 1.2-1.4% full-trajectory ATE.
    def __init__(self, params, image_size: tuple[float, float],
                 threshold: float = 0.35, attn_backend: str = "auto"):
        self.params = params
        self.image_size = image_size
        self.threshold = threshold
        self.attn_backend = attn_backend  # see lightglue.forward

    def __call__(self, desc0, xy0, valid0, desc1, xy1, valid1):
        from ..models import lightglue

        return lightglue.match(
            self.params, desc0, xy0, valid0, desc1, xy1, valid1,
            self.image_size, self.threshold, attn_backend=self.attn_backend,
        )


class ClassicalFrontend:
    """Shi-Tomasi grid corners + normalized patch descriptors."""

    def __init__(
        self,
        cell: int = 16,
        n_per_cell: int = 2,
        max_distance: float = MAX_DISTANCE,
    ):
        self.cell = cell
        self.n_per_cell = n_per_cell
        self.max_distance = max_distance
        from ..ops.descriptors import DESCRIPTOR_DIM

        self.descriptor_dim = DESCRIPTOR_DIM
        # Frame<->frame matcher; replaceable with LightGlueMatcher (the
        # pipeline calls frontend.matcher at every frame-matching site).
        self.matcher = ClassicalMatcher(max_distance)

    def num_keypoints(self, height: int, width: int) -> int:
        return self.n_per_cell * (-(-height // self.cell)) * (-(-width // self.cell))

    def extract(self, img: jnp.ndarray, mask: jnp.ndarray | None = None) -> Features:
        c = detect_corners(
            img, mask=mask, cell=self.cell, n_per_cell=self.n_per_cell
        )
        # Cell-ordered keypoints -> gather-free descriptor extraction.
        d = extract_descriptors_cells(img, c.xy, self.cell, self.n_per_cell)
        return Features(xy=c.xy, desc=d, valid=c.valid, score=c.score)
