"""Device-side image normalization (counterpart of the two device functions
of `retinanet_tpu/data/preprocessing.py`; the host pipeline comes later)."""

from __future__ import annotations

import torch

from retinanet_torch.core.device import device_constant


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
