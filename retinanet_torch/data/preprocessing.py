"""Image preprocessing, split between the host and the card (counterpart of
`retinanet_tpu/data/preprocessing.py`).

  * HOST (`HostPreprocessor`, numpy + the native resampler of
    `host_codec`): random flip, scale-jitter resize, crop and mean-pad for
    training; aspect-preserving resize-with-pad for validation. The pad is
    the per-channel mean, so that after normalization on the card the pad
    region is exactly 0.0.
  * CARD (`make_device_normalizer`, fused into the train step):
    normalization.

Geometry: random_scale ~ U[min, max]; scale = min(rs*th/h, rs*tw/w);
resize to round(img*scale); random crop offset in [0, scaled-target]+; pad
top-left to the target. Labels: clip to the frame, convert to centre
format, drop degenerate boxes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from retinanet_torch.core.device import device_constant
from retinanet_torch.data import host_codec


def flip_boxes_horizontal(boxes: np.ndarray) -> np.ndarray:
    """Flip normalized corner boxes."""
    if boxes.size == 0:
        return boxes
    return np.stack(
        [1.0 - boxes[:, 2], boxes[:, 1], 1.0 - boxes[:, 0], boxes[:, 3]],
        axis=-1)


def _as_uint8(image) -> np.ndarray:
    image = np.asarray(image)
    return image if image.dtype == np.uint8 else image.astype(np.uint8)


class HostPreprocessor:
    """Host-side geometric preprocessing for one sample.

    Produces fixed-shape outputs ready for the card:
      image: (H, W, 3) uint8, raw-pixel domain, mean-padded (the mean
        rounded down to uint8)
      boxes: (max_boxes, 4) float32 center-format pixels (zero padded)
      classes: (max_boxes,) int32
      valid: (max_boxes,) bool
    """

    def __init__(self, params, max_boxes: int = 100):
        self.target_h, self.target_w = (
            int(params.input.input_shape[0]), int(params.input.input_shape[1]))
        dl = params.dataloader_params
        self.mean = np.asarray(dl.preprocessing.mean, dtype=np.float32)
        self.stddev = np.asarray(dl.preprocessing.stddev, dtype=np.float32)
        self.pixel_scale = float(dl.preprocessing.pixel_scale)
        aug = dl.augmentations
        self.use_augmentation = bool(aug.use_augmentation)
        self.horizontal_flip = bool(
            self.use_augmentation and aug.horizontal_flip)
        if self.use_augmentation:
            self.jitter = (float(aug.scale_jitter.min_scale),
                           float(aug.scale_jitter.max_scale))
        else:
            self.jitter = None
        self.max_boxes = int(max_boxes)

    # -- train path ---------------------------------------------------------

    def __call__(self,
                 image: np.ndarray,
                 boxes_norm: np.ndarray,
                 classes: np.ndarray,
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """image: (h, w, 3) raw pixels, cast to uint8 if they are not;
        boxes_norm: (n, 4) normalized [0,1] corners; classes: (n,) ints.
        `rng` draws, in this order: the flip, the jitter scale, the two
        crop offsets."""
        image = _as_uint8(image)
        boxes_norm = np.asarray(boxes_norm, dtype=np.float32).reshape(-1, 4)
        classes = np.asarray(classes, dtype=np.int32).reshape(-1)

        # the image flip is folded into the resampler's x coordinates
        flip = bool(self.horizontal_flip and rng.uniform() > 0.5)
        if flip:
            boxes_norm = flip_boxes_horizontal(boxes_norm)

        th, tw = self.target_h, self.target_w
        # All scalar geometry runs in float32, as the reference's float32
        # tensors do: the int truncation of `max_offset * uniform` sits on
        # float32 rounding boundaries, and float64 here would give
        # off-by-one crop offsets (320 * f32(0.7) is 224.0 in f32 but
        # 223.9999... in f64 -> 223).
        f32 = np.float32
        hw = np.array(image.shape[:2], dtype=f32)
        target = np.array([th, tw], dtype=f32)

        if self.jitter is not None:
            random_scale = f32(rng.uniform(self.jitter[0], self.jitter[1]))
            scaled_t = random_scale * target
        else:
            scaled_t = target

        scale = np.min((scaled_t / hw).astype(f32))
        scaled_shape = np.round(hw * scale)
        image_scale = (scaled_shape / hw).astype(f32)  # (sy, sx)

        offset = np.zeros(2, dtype=np.int64)
        if self.jitter is not None:
            max_offset = np.maximum(scaled_shape - target, f32(0.0))
            draw = rng.uniform(0, 1, size=2).astype(f32)
            offset = (max_offset * draw).astype(np.int64)

        sy, sx = float(image_scale[0]), float(image_scale[1])
        valid_h = min(th, int(scaled_shape[0]) - int(offset[0]))
        valid_w = min(tw, int(scaled_shape[1]) - int(offset[1]))
        # resize + crop + flip + mean-pad in one pass that only touches the
        # target-sized output
        out = host_codec.resample_bilinear(
            image, (th, tw), (valid_h, valid_w), (sy, sx),
            (float(offset[0]), float(offset[1])), flip, self.mean)

        # boxes: normalized corners -> pixels in the cropped frame, float32
        off_f = offset.astype(f32)
        boxes = np.stack([
            boxes_norm[:, 0] * hw[1] * image_scale[1] - off_f[1],
            boxes_norm[:, 1] * hw[0] * image_scale[0] - off_f[0],
            boxes_norm[:, 2] * hw[1] * image_scale[1] - off_f[1],
            boxes_norm[:, 3] * hw[0] * image_scale[0] - off_f[0],
        ], axis=-1) if boxes_norm.size else boxes_norm.reshape(0, 4)

        boxes, classes = self._prepare_labels(boxes, classes)
        return self._pad_labels(out, boxes, classes)

    def _prepare_labels(self, boxes: np.ndarray, classes: np.ndarray):
        """Clip each coordinate to its own axis, convert to centre format,
        drop degenerate boxes."""
        if boxes.size == 0:
            return boxes.reshape(0, 4), classes[:0]
        lim = np.array(
            [self.target_w, self.target_h, self.target_w, self.target_h],
            dtype=np.float32)
        boxes = np.clip(boxes, 0.0, lim)
        xywh = np.concatenate(
            [(boxes[:, :2] + boxes[:, 2:]) / 2.0, boxes[:, 2:] - boxes[:, :2]],
            axis=-1)
        keep = (xywh[:, 2] > 0.0) & (xywh[:, 3] > 0.0)
        return xywh[keep], classes[keep]

    def _pad_labels(self, image, boxes, classes):
        n = min(len(boxes), self.max_boxes)
        out_boxes = np.zeros((self.max_boxes, 4), dtype=np.float32)
        out_classes = np.zeros((self.max_boxes,), dtype=np.int32)
        out_valid = np.zeros((self.max_boxes,), dtype=bool)
        out_boxes[:n] = boxes[:n]
        out_classes[:n] = classes[:n]
        out_valid[:n] = True
        return {"image": image, "boxes": out_boxes, "classes": out_classes,
                "valid": out_valid}

    # -- val / serving path --------------------------------------------------

    def resize_with_pad(self, image: np.ndarray):
        """Aspect-preserving resize + top-left mean pad. Returns (image,
        resize_scale (sy, sx) float32)."""
        image = _as_uint8(image)
        th, tw = self.target_h, self.target_w
        # float32 scalar math, for the same rounding boundaries as the
        # train path
        hw = np.array(image.shape[:2], dtype=np.float32)
        scale = np.min((np.array([th, tw], np.float32) / hw)
                       .astype(np.float32))
        scaled = np.round(hw * scale)
        resize_scale = (scaled / hw).astype(np.float32)
        out = host_codec.resample_bilinear(
            image, (th, tw), (int(scaled[0]), int(scaled[1])),
            (float(resize_scale[0]), float(resize_scale[1])),
            (0.0, 0.0), False, self.mean)
        return out, resize_scale


def normalize_image(image: torch.Tensor, mean, stddev,
                    pixel_scale: float = 1.0) -> torch.Tensor:
    """(image / pixel_scale - mean) / stddev over the last (channel) axis."""
    mean = device_constant(tuple(mean), torch.float32, image.device)
    stddev = device_constant(tuple(stddev), torch.float32, image.device)
    image = image / pixel_scale
    return (image - mean) / stddev


def make_device_normalizer(params):
    dl = params.dataloader_params.preprocessing
    mean = tuple(float(m) for m in dl.mean)
    stddev = tuple(float(s) for s in dl.stddev)
    pixel_scale = float(dl.pixel_scale)

    def _norm(images: torch.Tensor) -> torch.Tensor:
        """images: (..., H, W, 3) raw pixels -> normalized float32."""
        m = device_constant(mean, torch.float32, images.device)
        s = device_constant(stddev, torch.float32, images.device)
        return (images.to(torch.float32) / pixel_scale - m) / s

    return _norm
