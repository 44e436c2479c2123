"""Serving entry points (counterpart of `retinanet_tpu/export/serving.py`).

`build_serving_fn` gives the full serving function (images -> detections)
for a config, and `ServingModule.run_inference` answers one request of
numpy images with numpy detections. The artifact directory, msgpack
weights, serialized graph and int8 lanes wait for ROADMAP Queue 1 #6.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from retinanet_torch.core.config import ConfigDict
from retinanet_torch.core.device import resolve_device
from retinanet_torch.data import anchors as anchor_lib
from retinanet_torch.data.preprocessing import make_device_normalizer
from retinanet_torch.models.retinanet import _compute_dtype, build_model
from retinanet_torch.ops.postprocess import make_inference_fn

EXPORT_MODES = ("tf", "tf_tensorrt", "onnx", "onnx_tensorrt")
_NOT_PORTED = ("not ported yet: ROADMAP Queue 1 #6 (export and serving "
               "artifacts)")


def _mode_flags(mode: str) -> Tuple[bool, bool]:
    """(skip_decoding, skip_nms): 'tf' keeps everything, 'tf_tensorrt'
    skips NMS, 'onnx' / 'onnx_tensorrt' skip decode, top-k and NMS."""
    if mode == "tf":
        return False, False
    if mode == "tf_tensorrt":
        return False, True
    if mode in ("onnx", "onnx_tensorrt"):
        return True, True
    raise ValueError(f"mode must be one of {EXPORT_MODES}")


def build_serving_fn(params: ConfigDict, mode: str = "tf", device=None,
                     model: Optional[nn.Module] = None,
                     int8_scales: Optional[Dict[str, float]] = None
                     ) -> Callable:
    """Serving function: NHWC images (any dtype, raw pixels) -> detections.

    `model` is the detector to serve; without one, `build_model(params)`
    builds it with seeded random weights on `device` (None: the card)."""
    if int8_scales:
        raise NotImplementedError(f"int8 serving is {_NOT_PORTED}")
    skip_decoding, skip_nms = _mode_flags(mode)
    device = resolve_device(device)
    if model is None:
        model = build_model(params, device=device)
    return make_inference_fn(
        model, params, anchor_lib.from_params(params),
        make_device_normalizer(params),
        compute_dtype=_compute_dtype(params.floatx.precision),
        skip_decoding=skip_decoding, skip_nms=skip_nms, device=device)


class ServingModule:
    """A detector ready to answer requests.

    `run_inference(images)`: a batch of (B, H, W, 3) numpy images at the
    config's input shape -> numpy detections."""

    def __init__(self, params: ConfigDict, model: nn.Module, device=None):
        self.params = params
        self.model = model
        self.device = resolve_device(device)
        self._fn = build_serving_fn(params, "tf", self.device, model)

    def run_inference(self, images) -> Dict[str, np.ndarray]:
        det = self._fn(torch.as_tensor(np.asarray(images)))
        return {k: v.cpu().numpy() for k, v in det.items()}

    def run_exported(self, images):
        raise NotImplementedError(f"the serialized serving graph is "
                                  f"{_NOT_PORTED}")

    def prepare_image(self, image):
        raise NotImplementedError(f"host-side resize-with-pad is "
                                  f"{_NOT_PORTED}")


def export_artifact(*args, **kwargs):
    raise NotImplementedError(f"export_artifact is {_NOT_PORTED}")


def load_artifact(*args, **kwargs):
    raise NotImplementedError(f"load_artifact is {_NOT_PORTED}")
