"""Anchor generation (numpy).

The port's own copy of `retinanet_tpu/data/anchors.py`: anchors in
`[cx, cy, w, h]` pixel units for levels `min_level..max_level` (stride
2^level); per cell `len(aspect_ratios) * len(scales)` anchors, ratio-major
then scale; each level flattened row-major over (y, x, anchor) and the
levels concatenated. That (h, w, a) order is the one the heads' NHWC
outputs flatten to in `ops/postprocess.fuse_predictions`.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


class AnchorGenerator:
    """Generates the anchor pyramid for a fixed image size.

    Attributes:
      boxes: (total_anchors, 4) float32 numpy array, [cx, cy, w, h] pixels.
      boundaries: per-level start offsets into `boxes`; len = num_levels + 1.
      num_anchors: anchors per feature-map cell.
      feature_shapes: list of (fh, fw) per level.
    """

    def __init__(self,
                 image_height: int,
                 image_width: int,
                 min_level: int,
                 max_level: int,
                 areas: Sequence[float],
                 aspect_ratios: Sequence[float],
                 scales: Sequence[float]):
        self.image_height = int(image_height)
        self.image_width = int(image_width)
        self.min_level = int(min_level)
        self.max_level = int(max_level)
        self.areas = [float(a) for a in areas]
        self.aspect_ratios = [float(r) for r in aspect_ratios]
        self.scales = [float(s) for s in scales]
        self.num_anchors = len(self.aspect_ratios) * len(self.scales)

        num_levels = max_level - min_level + 1
        if len(self.areas) < num_levels:
            raise ValueError(
                f"Need one area per level: {len(self.areas)} areas for "
                f"levels {min_level}..{max_level}")
        # Trailing extra areas are ignored, as the reference does (the
        # mobiledet-448 configs list 5 areas for levels 3..6).
        self.areas = self.areas[:num_levels]

        self.strides = [2 ** lvl for lvl in range(min_level, max_level + 1)]
        self.feature_shapes = [
            (math.ceil(image_height / s), math.ceil(image_width / s))
            for s in self.strides
        ]
        self.boundaries = self._compute_boundaries()
        self.boxes = self._generate()

    def _compute_boundaries(self):
        bounds = [0]
        for fh, fw in self.feature_shapes:
            bounds.append(bounds[-1] + fh * fw * self.num_anchors)
        return bounds

    def _level_dims(self, area: float) -> np.ndarray:
        """(num_anchors, 2) [w, h]; ratio-major, scale-minor ordering."""
        dims = []
        for ratio in self.aspect_ratios:
            h = math.sqrt(area / ratio)
            w = area / h
            for scale in self.scales:
                dims.append([scale * w, scale * h])
        return np.asarray(dims, dtype=np.float32)

    def _generate(self) -> np.ndarray:
        all_levels = []
        for i, (stride, (fh, fw)) in enumerate(
                zip(self.strides, self.feature_shapes)):
            cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
            cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
            # meshgrid(x, y) 'xy' indexing: centers[y, x] = (cx[x], cy[y])
            centers = np.stack(np.meshgrid(cx, cy), axis=-1)  # (fh, fw, 2)
            centers = np.broadcast_to(
                centers[:, :, None, :], (fh, fw, self.num_anchors, 2))
            dims = np.broadcast_to(
                self._level_dims(self.areas[i])[None, None],
                (fh, fw, self.num_anchors, 2))
            anchors = np.concatenate([centers, dims], axis=-1)
            all_levels.append(
                anchors.reshape(fh * fw * self.num_anchors, 4))
        return np.ascontiguousarray(
            np.concatenate(all_levels, axis=0), dtype=np.float32)

    @property
    def total_anchors(self) -> int:
        return self.boundaries[-1]


@lru_cache(maxsize=32)
def _cached(image_height, image_width, min_level, max_level, areas,
            aspect_ratios, scales) -> AnchorGenerator:
    return AnchorGenerator(image_height, image_width, min_level, max_level,
                           areas, aspect_ratios, scales)


def from_params(params) -> AnchorGenerator:
    """Build (cached) anchors from a full config tree."""
    h, w = params.input.input_shape
    ff = params.architecture.feature_fusion
    ap = params.anchor_params
    return _cached(int(h), int(w), int(ff.min_level), int(ff.max_level),
                   tuple(ap.areas), tuple(ap.aspect_ratios), tuple(ap.scales))


def level_splits(anchors: AnchorGenerator) -> Tuple[Tuple[str, int, int], ...]:
    """[(level_key, start, end), ...] for slicing flat anchor tensors."""
    out = []
    for i, lvl in enumerate(range(anchors.min_level, anchors.max_level + 1)):
        out.append((str(lvl), anchors.boundaries[i],
                    anchors.boundaries[i + 1]))
    return tuple(out)
