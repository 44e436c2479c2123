"""Synthetic data: in-memory batches and on-disk tfrecord fixtures (the
port's own copy of `retinanet_tpu/data/synthetic.py`). The same seed gives
the same batch, and the same boxes, classes, image sizes and annotations
JSON, in both packages; the JPEG bytes differ, because the port encodes
through its own JPEG library (`host_codec`) and not through cv2."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from retinanet_torch.data import host_codec, tfrecord


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


def synthetic_train_iterator(batch_size: int, input_shape: Tuple[int, int],
                             max_boxes: int = 100, num_classes: int = 80,
                             seed: int = 0,
                             num_batches: Optional[int] = None,
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """`synthetic_train_batch` with seeds seed, seed + 1, ..."""
    i = 0
    while num_batches is None or i < num_batches:
        yield synthetic_train_batch(
            batch_size, input_shape, max_boxes, num_classes, seed + i)
        i += 1


def _class_color(class_id: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + class_id)
    return rng.integers(40, 255, 3).astype(np.uint8)


def _scene_jpeg(rng, h: int, w: int, boxes_norm: np.ndarray,
                classes: np.ndarray) -> bytes:
    """A learnable scene: a flat, slightly noisy background and
    class-coloured filled rectangles at the box locations."""
    img = np.full((h, w, 3), 30, dtype=np.uint8)
    img = img + rng.integers(0, 20, (h, w, 3), dtype=np.uint8)
    for b, c in zip(boxes_norm, classes):
        x1, y1 = int(b[0] * w), int(b[1] * h)
        x2, y2 = int(b[2] * w), int(b[3] * h)
        img[y1:y2, x1:x2] = _class_color(int(c))
    return host_codec.encode_jpeg(img)


def write_synthetic_tfrecords(directory: str, prefix: str = "train",
                              num_shards: int = 2,
                              samples_per_shard: int = 8,
                              num_classes: int = 80, seed: int = 0,
                              write_annotations: bool = False,
                              max_side: int = 640):
    """Writes COCO-schema tfrecords of scenes with sides from 240 px to
    below `max_side` and 1 to 7 boxes each; returns the glob pattern (and
    the COCO annotations JSON path when `write_annotations`). The default
    writes the JAX package's files byte for byte."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    image_id = 0
    ann_id = 0
    images, annotations = [], []
    for shard in range(num_shards):
        path = os.path.join(
            directory, f"{prefix}-{shard:04d}-of-{num_shards:04d}.tfrecord")
        with tfrecord.RecordWriter(path) as w:
            for _ in range(samples_per_shard):
                h = int(rng.integers(240, max_side))
                wdt = int(rng.integers(240, max_side))
                n = int(rng.integers(1, 8))
                x1 = rng.uniform(0, 0.7, n)
                y1 = rng.uniform(0, 0.7, n)
                boxes = np.stack([
                    x1, y1,
                    x1 + rng.uniform(0.05, 0.3, n),
                    y1 + rng.uniform(0.05, 0.3, n)], -1).clip(0, 1)
                classes = rng.integers(0, num_classes, n)
                w.write(tfrecord.make_detection_example(
                    _scene_jpeg(rng, h, wdt, boxes, classes),
                    image_id, boxes, classes))
                images.append({"id": image_id, "height": h, "width": wdt,
                               "file_name": f"{image_id}.jpg"})
                for b, c in zip(boxes, classes):
                    x, y = float(b[0] * wdt), float(b[1] * h)
                    bw = float((b[2] - b[0]) * wdt)
                    bh = float((b[3] - b[1]) * h)
                    annotations.append({
                        "id": ann_id, "image_id": image_id,
                        "category_id": int(c),
                        "bbox": [x, y, bw, bh], "area": bw * bh,
                        "iscrowd": 0})
                    ann_id += 1
                image_id += 1
    pattern = os.path.join(directory, f"{prefix}-*")
    if not write_annotations:
        return pattern
    ann_path = os.path.join(directory, f"annotations_{prefix}.json")
    with open(ann_path, "w") as f:
        json.dump({
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": i, "name": f"class_{i:03d}"}
                for i in range(num_classes)],
        }, f)
    return pattern, ann_path
