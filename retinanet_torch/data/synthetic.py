"""Synthetic train batches in memory (the port's own copy of
`synthetic_train_batch` in `retinanet_tpu/data/synthetic.py`): the same
seed gives the same batch in both packages, without a dataset on disk."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_train_batch(batch_size: int, input_shape: Tuple[int, int],
                          max_boxes: int = 100, num_classes: int = 80,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """One fixed-shape train batch: raw-pixel images and padded ground
    truth (1 to 11 centre-format boxes an image, valid ones first)."""
    h, w = input_shape
    rng = np.random.default_rng(seed)
    n_boxes = rng.integers(1, min(12, max_boxes), size=batch_size)
    boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    classes = np.zeros((batch_size, max_boxes), np.int32)
    valid = np.zeros((batch_size, max_boxes), bool)
    for i, n in enumerate(n_boxes):
        cx = rng.uniform(0.15 * w, 0.85 * w, n)
        cy = rng.uniform(0.15 * h, 0.85 * h, n)
        bw = rng.uniform(0.05 * w, 0.4 * w, n)
        bh = rng.uniform(0.05 * h, 0.4 * h, n)
        boxes[i, :n] = np.stack([cx, cy, bw, bh], -1)
        classes[i, :n] = rng.integers(0, num_classes, n)
        valid[i, :n] = True
    return {
        "image": rng.uniform(0, 255, (batch_size, h, w, 3)).astype(np.float32),
        "boxes": boxes,
        "classes": classes,
        "valid": valid,
    }
