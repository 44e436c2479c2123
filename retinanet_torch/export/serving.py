"""Model export and serving artifacts (counterpart of
`retinanet_tpu/export/serving.py`).

  * The artifact directory: `config.json`, `params.msgpack` (flax's layout
    and encoding of `{"params", "batch_stats"}`, through
    `convert.torch_to_flax` and `export/msgpack_codec.py`, so that either
    package serves the other's artifact) and the serving graph;
  * the graph is a `torch.export` program of the whole serving function,
    closed over the weights and frozen at `inference.batch_size`:
    `serving_default.pt2`, and `serving_int8.pt2` for the int8-activation
    lane (its int8 weights, packed for the kernel, are constants of the
    program). It is exported on the device it will serve on; its NMS and
    int8 convs are the custom ops of `retinanet_torch.ops`, which this
    module imports, so loading a graph finds them registered;
  * export modes: 'tf' keeps everything, 'tf_tensorrt' skips NMS,
    'onnx' / 'onnx_tensorrt' skip decoding, top-k and NMS;
  * `load_artifact` rebuilds the serving function from config + weights
    (any batch) and, with `use_exported`, loads the frozen graph too.

The weight-only and int8-activation lanes are in `export/quantize.py`, the
activation calibration in `export/calibration.py`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

import retinanet_torch.ops  # noqa: F401  (registers the custom ops)
from retinanet_torch.convert import load_flax_variables, torch_to_flax
from retinanet_torch.core.config import ConfigDict, from_dict
from retinanet_torch.core.device import resolve_device
from retinanet_torch.data import anchors as anchor_lib
from retinanet_torch.data.preprocessing import (HostPreprocessor,
                                                make_device_normalizer)
from retinanet_torch.export import msgpack_codec
from retinanet_torch.models.retinanet import _compute_dtype, build_model
from retinanet_torch.ops.postprocess import InferenceModule, inference_fn

EXPORT_MODES = ("tf", "tf_tensorrt", "onnx", "onnx_tensorrt")
WEIGHTS_FILE = "params.msgpack"
CONFIG_FILE = "config.json"
SCALES_FILE = "activation_scales.json"
GRAPH_FILE = "serving_default.pt2"
GRAPH_INT8_FILE = "serving_int8.pt2"


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


def build_serving_module(params: ConfigDict, mode: str = "tf", device=None,
                         model: Optional[nn.Module] = None,
                         int8_scales: Optional[Mapping[str, float]] = None
                         ) -> InferenceModule:
    """The serving function as a module (what `torch.export` traces): NHWC
    images on `device` -> detections. `model` is the detector to serve;
    without one, `build_model(params)` builds it with seeded random
    weights. `int8_scales` (from `calibrate_activations` or the artifact's
    activation_scales.json) serves it on int8 activations
    (`export/quantize.py:Int8Model`)."""
    skip_decoding, skip_nms = _mode_flags(mode)
    device = resolve_device(device)
    if model is None:
        model = build_model(params, device=device)
    if int8_scales:
        from retinanet_torch.export.quantize import Int8Model
        model = Int8Model(model, int8_scales)
    return InferenceModule(
        model, params, anchor_lib.from_params(params),
        make_device_normalizer(params),
        compute_dtype=_compute_dtype(params.floatx.precision),
        skip_decoding=skip_decoding, skip_nms=skip_nms, device=device)


def build_serving_fn(params: ConfigDict, mode: str = "tf", device=None,
                     model: Optional[nn.Module] = None,
                     int8_scales: Optional[Mapping[str, float]] = None
                     ) -> Callable:
    """Serving function: NHWC images (any dtype, raw pixels, on any
    device) -> detections, in inference mode (`build_serving_module`)."""
    device = resolve_device(device)
    return inference_fn(build_serving_module(
        params, mode, device, model, int8_scales), device)


def serialize_serving_graph(params: ConfigDict, model: nn.Module,
                            output_dir: str, mode: str = "tf",
                            int8_scales: Optional[Mapping[str, float]] = None
                            ) -> str:
    """`torch.export` the serving function of `model` (on int8 activations
    with `int8_scales`) at `inference.batch_size` float32 images, on the
    model's device, and save it in `output_dir`. Returns the path."""
    device = next(model.parameters()).device
    module = build_serving_module(params, mode, device, model, int8_scales)
    h, w = (int(v) for v in params.input.input_shape)
    example = torch.zeros(
        (int(params.inference.batch_size), h, w,
         int(params.input.channels)), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    path = os.path.join(output_dir,
                        GRAPH_INT8_FILE if int8_scales else GRAPH_FILE)
    torch.export.save(program, path)
    return path


def export_artifact(params: ConfigDict, model: nn.Module, output_dir: str,
                    mode: str = "tf",
                    serialize_graph: bool = True) -> Dict[str, str]:
    """Write a serving artifact directory of `model`'s weights. Returns
    {artifact: path}."""
    os.makedirs(output_dir, exist_ok=True)
    written = {}
    with open(os.path.join(output_dir, CONFIG_FILE), "w") as f:
        json.dump(params.to_dict(), f, indent=2)
    written["config"] = os.path.join(output_dir, CONFIG_FILE)

    state = torch_to_flax(model.state_dict())
    state.setdefault("batch_stats", {})
    weights_path = os.path.join(output_dir, WEIGHTS_FILE)
    msgpack_codec.write_file(weights_path, state)
    written["weights"] = weights_path

    if serialize_graph:
        written["graph"] = serialize_serving_graph(params, model,
                                                   output_dir, mode=mode)
    return written


class ServingModule:
    """A loaded serving artifact (or any detector) ready for requests.

    `run_inference(images)`: a batch of (B, H, W, 3) numpy images at the
    config's input shape -> numpy detections, through the rebuilt serving
    function (any batch; `module` is it as a module, `serve` the function
    on tensors). `run_exported(images)`: the same through the frozen graph.
    `prepare_image(image)`: one image of any size -> (input batch of 1,
    resize_scale), the host's aspect-preserving resize with mean padding
    (`HostPreprocessor.resize_with_pad`)."""

    def __init__(self, params: ConfigDict, model: nn.Module, device=None,
                 mode: str = "tf",
                 int8_scales: Optional[Mapping[str, float]] = None,
                 exported: Optional[Callable] = None):
        self.params = params
        self.model = model
        self.device = resolve_device(device)
        self.module = build_serving_module(params, mode, self.device,
                                           model, int8_scales)
        self.serve = inference_fn(self.module, self.device)
        self._exported = exported
        self._host_pre = HostPreprocessor(params)
        self._host_pre.use_augmentation = False
        self._host_pre.horizontal_flip = False
        self._host_pre.jitter = None

    def run_inference(self, images) -> Dict[str, np.ndarray]:
        det = self.serve(torch.from_numpy(np.ascontiguousarray(images)))
        return {k: v.cpu().numpy() for k, v in det.items()}

    def run_exported(self, images) -> Dict[str, np.ndarray]:
        """Through the frozen graph, at `inference.batch_size`: a smaller
        batch is padded with zero images and the result sliced back; a
        larger one raises."""
        if self._exported is None:
            raise ValueError("the artifact was loaded without its serving "
                             "graph (load_artifact(use_exported=True))")
        images = np.asarray(images, np.float32)
        frozen_bs = int(self.params.inference.batch_size)
        n = images.shape[0]
        if n > frozen_bs:
            raise ValueError(
                f"batch {n} exceeds the frozen serving batch {frozen_bs}")
        if n < frozen_bs:
            pad = np.zeros((frozen_bs - n,) + images.shape[1:], np.float32)
            images = np.concatenate([images, pad])
        with torch.inference_mode():
            out = self._exported(torch.from_numpy(images).to(self.device))
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def prepare_image(self, image: np.ndarray):
        out, scale = self._host_pre.resize_with_pad(np.asarray(image))
        return out[None], scale


def load_artifact(artifact_dir: str, mode: str = "tf",
                  use_exported: bool = False,
                  use_int8_activations: bool = False,
                  device=None) -> ServingModule:
    """Serve an artifact directory on `device` (None: the card).
    `use_int8_activations` serves the int8-activation lane with the
    artifact's activation_scales.json (`python -m retinanet_torch.export
    --int8_activations`); `use_exported` also loads the frozen graph of
    the lane, and raises here if it is missing."""
    device = resolve_device(device)
    with open(os.path.join(artifact_dir, CONFIG_FILE)) as f:
        params = from_dict(json.load(f))

    int8_scales = None
    if use_int8_activations:
        spath = os.path.join(artifact_dir, SCALES_FILE)
        if not os.path.exists(spath):
            raise FileNotFoundError(
                f"{spath} missing — export with --int8_activations to "
                "serve the int8 path")
        with open(spath) as f:
            int8_scales = json.load(f)["scales"]

    model = build_model(params, device=device)
    load_flax_variables(model, msgpack_codec.read_file(
        os.path.join(artifact_dir, WEIGHTS_FILE)))

    exported = None
    if use_exported:
        # a missing graph fails here for both lanes, not at the first
        # run_exported()
        path = os.path.join(artifact_dir, GRAPH_INT8_FILE
                            if use_int8_activations else GRAPH_FILE)
        if not os.path.exists(path):
            hint = ("export with --int8_activations (and --exported) to "
                    "serialize the int8 serving graph"
                    if use_int8_activations else
                    "export with serialize_graph=True (the CLI default) to "
                    "serialize the serving graph")
            raise FileNotFoundError(f"{path} missing — {hint}")
        exported = torch.export.load(path).module()

    return ServingModule(params, model, device, mode, int8_scales, exported)
