"""Post-training int8 quantization for serving (counterpart of
`retinanet_tpu/export/quantize.py`).

Two lanes:
  * weight-only (`quantize_params`, `dequantize_params`,
    `make_quantized_serving_fn`): every conv kernel per output channel in
    int8, scale `max(amax, 1e-8) / 127`, `np.round` half to even; the
    serving function runs on the dequantized float32 weights, which are
    `q * scale` in float32 as the JAX package computes them in its
    program. The trees are flax's (`convert.torch_to_flax` layout: HWIO
    kernels, flax names), so `params_int8.msgpack` is the same file in
    both packages;
  * int8 activations (`Int8Model`): every conv with a calibrated
    activation scale (`export/calibration.py`) except the prediction convs
    runs on int8: real (`real_int8=True`, the default) through the CUDA
    kernel of `ops/int8_conv_kernel.py` (its plain version on the CPU), or
    fake-quant (`real_int8=False`: the activation quantized and
    dequantized, the weights left in float), in the arithmetic order of
    the JAX interceptor (`quantize.py:132-159`).
Quality reports: `detection_agreement_ap` (the float detections as
pseudo ground truth under the full COCO protocol),
`int8_activation_report` and `quantization_report`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from retinanet_torch.models.layers import ConvParams, conv_hook
from retinanet_torch.ops.int8_conv import QMAX, pack_weights
from retinanet_torch.ops.int8_conv_kernel import int8_conv2d


def _is_q(leaf) -> bool:
    return isinstance(leaf, Mapping) and set(leaf) == {"q", "scale"}


def quantize_per_channel(kernel: np.ndarray,
                         axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """int8 `q` and float32 `scale` of `kernel`, one scale a channel of
    `axis`: `max(amax, 1e-8) / 127`, `np.round` half to even, clipped."""
    others = tuple(a for a in range(kernel.ndim) if a != axis)
    amax = np.maximum(np.abs(kernel).max(axis=others), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(kernel / np.expand_dims(scale, others)),
                -QMAX, QMAX).astype(np.int8)
    return q, scale


def quantize_params(params: Mapping) -> Tuple[Dict, Dict]:
    """Split a flax `params` tree of numpy leaves into int8 `{"q", "scale"}`
    leaves (every leaf whose name ends in `kernel`, with ndim >= 2:
    per-channel over the last axis) and float passthrough leaves. Returns
    (tree, stats)."""
    stats = {"quantized": 0, "passthrough": 0, "bytes_fp32": 0,
             "bytes_q": 0}

    def walk(tree: Mapping) -> Dict:
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, Mapping):
                out[key] = walk(leaf)
                continue
            leaf = np.asarray(leaf)
            stats["bytes_fp32"] += leaf.nbytes
            if str(key).endswith("kernel") and leaf.ndim >= 2:
                q, scale = quantize_per_channel(leaf, leaf.ndim - 1)
                out[key] = {"q": q, "scale": scale}
                stats["quantized"] += 1
                stats["bytes_q"] += q.nbytes + scale.nbytes
            else:
                out[key] = leaf
                stats["passthrough"] += 1
                stats["bytes_q"] += leaf.nbytes
        return out

    return walk(params), stats


def dequantize_params(qparams: Mapping) -> Dict:
    """Inverse of `quantize_params`: `q * scale` in float32."""
    out = {}
    for key, value in qparams.items():
        if _is_q(value):
            out[key] = (np.asarray(value["q"], np.float32)
                        * np.asarray(value["scale"], np.float32))
        elif isinstance(value, Mapping):
            out[key] = dequantize_params(value)
        else:
            out[key] = np.asarray(value)
    return out


def make_quantized_serving_fn(params_cfg, qparams: Mapping,
                              batch_stats: Mapping, mode: str = "tf",
                              device=None) -> Callable:
    """The serving function (images -> detections) of the weight-only lane:
    a model of `params_cfg` holding the dequantized weights."""
    from retinanet_torch.convert import load_flax_variables
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    model = build_model(params_cfg, device=device)
    load_flax_variables(model, {"params": dequantize_params(qparams),
                                "batch_stats": batch_stats})
    return build_serving_fn(params_cfg, mode, device=device, model=model)


# ---------------------------------------------------------------------------
# int8 activations: per-tensor activation scales from export/calibration.py
# drive real s8 x s8 -> s32 convolutions with per-output-channel int8
# weights and a float32 requantization plus bias in the epilogue.
# ---------------------------------------------------------------------------

def conv_paths(model: nn.Module) -> Dict[ConvParams, str]:
    """Every conv's flax path (`backbone/group1/block0/proj/conv`): the key
    of its activation scale, in both packages."""
    return {m: name.replace(".", "/") for name, m in model.named_modules()
            if isinstance(m, ConvParams)}


class Int8Model(nn.Module):
    """`model` with every calibrated conv on int8 activations: a drop-in
    for the detector in `ops/postprocess.py:InferenceModule`.

    A conv takes part when its path is in `scales` and contains none of
    `exclude` (the prediction convs by default, kept in float for logit
    fidelity); every other conv runs its float path unchanged, bit for
    bit. The plan of each conv (`s_a`; for the real lane the per-channel
    int8 weights packed for the kernel and `s_a * s_w`) is made here, once,
    from the weights `model` holds now: `plans` maps a conv to (s_a, and
    the names of its buffers: s_a, then the packed weights and the scale
    for the real lane)."""

    def __init__(self, model: nn.Module, scales: Mapping[str, float],
                 exclude: Tuple[str, ...] = ("prediction",),
                 real_int8: bool = True):
        super().__init__()
        self.model = model
        self.real_int8 = real_int8
        self.plans: Dict[ConvParams, tuple] = {}
        for index, (conv, path) in enumerate(conv_paths(model).items()):
            if path not in scales or any(e in path for e in exclude):
                continue
            s_a = float(np.float32(scales[path]))
            device = conv.weight.device
            self.register_buffer(
                f"s_a_{index}", torch.full((1,), s_a, dtype=torch.float32,
                                           device=device), persistent=False)
            plan = (s_a, f"s_a_{index}")
            if real_int8:
                qw, s_w = quantize_per_channel(
                    conv.weight.detach().to("cpu", torch.float32).numpy(), 0)
                packed = pack_weights(torch.from_numpy(qw), conv.groups)
                self.register_buffer(f"qw_{index}", packed.to(device),
                                     persistent=False)
                self.register_buffer(
                    f"scale_{index}",
                    torch.from_numpy(np.float32(s_a) * s_w).to(device),
                    persistent=False)
                plan += (f"qw_{index}", f"scale_{index}")
            self.plans[conv] = plan

    @property
    def num_int8_convs(self) -> int:
        return len(self.plans)

    def forward(self, images: torch.Tensor):
        with conv_hook(self._conv):
            return self.model(images)

    def _conv(self, x: torch.Tensor, p: ConvParams, stride: int,
              pads: Tuple[int, int, int, int], dtype: torch.dtype,
              float_conv: Callable) -> torch.Tensor:
        plan = self.plans.get(p)
        if plan is None:
            return float_conv(x)
        if not self.real_int8:
            s_a = getattr(self, plan[1])
            qx = torch.clamp(torch.round(x.to(torch.float32) / s_a),
                             -QMAX, QMAX)
            return float_conv((qx * s_a).to(x.dtype))
        x = x.permute(0, 2, 3, 1)
        if not x.is_contiguous():
            x = x.contiguous()
        kh, kw = p.weight.shape[2], p.weight.shape[3]
        y = int8_conv2d(x, getattr(self, plan[2]), getattr(self, plan[3]),
                        p.bias, plan[0], stride, pads, p.groups, kh, kw,
                        dtype)
        return y.permute(0, 3, 1, 2)


def detection_agreement_ap(fp_dets: Dict[str, np.ndarray],
                           q_dets: Dict[str, np.ndarray],
                           image_shape=(640, 640),
                           min_score: float = 0.05) -> float:
    """The float model's detections as pseudo ground truth, the quantized
    model's scored against them with the full COCO protocol: AP@0.50:0.95,
    1.0 for identical detections, -1 when the float model found nothing."""
    from retinanet_torch.eval.coco import COCOEval, COCOIndex

    images, anns, dts = [], [], []
    ann_id = 1
    n_img = fp_dets["scores"].shape[0]
    h, w = image_shape
    cats = set()
    for b in range(n_img):
        images.append({"id": b + 1, "height": int(h), "width": int(w)})
        # normalized (x1, y1, x2, y2) corners (ops/postprocess.py)
        for i in range(int(fp_dets["valid_detections"][b])):
            if float(fp_dets["scores"][b][i]) < min_score:
                continue
            x1, y1, x2, y2 = [float(v) for v in fp_dets["boxes"][b][i]]
            cat = int(fp_dets["classes"][b][i]) + 1
            cats.add(cat)
            anns.append({"id": ann_id, "image_id": b + 1,
                         "category_id": cat, "iscrowd": 0,
                         "bbox": [x1 * w, y1 * h,
                                  max((x2 - x1) * w, 1e-3),
                                  max((y2 - y1) * h, 1e-3)]})
            ann_id += 1
        for i in range(int(q_dets["valid_detections"][b])):
            x1, y1, x2, y2 = [float(v) for v in q_dets["boxes"][b][i]]
            cat = int(q_dets["classes"][b][i]) + 1
            cats.add(cat)
            dts.append({"image_id": b + 1, "category_id": cat,
                        "score": float(q_dets["scores"][b][i]),
                        "bbox": [x1 * w, y1 * h,
                                 max((x2 - x1) * w, 1e-3),
                                 max((y2 - y1) * h, 1e-3)]})
    if not anns:
        return -1.0
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": str(c)} for c in sorted(cats)]}
    ev = COCOEval(COCOIndex(gt), dts)
    ev.evaluate()
    ev.accumulate()
    return float(ev.stats[0])


def _as_numpy(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in det.items()}


def int8_activation_report(model: nn.Module, params_cfg,
                           scales: Mapping[str, float],
                           sample_batches: Iterable,
                           real_int8: bool = True) -> Dict[str, float]:
    """The int8-activation lane against the float lane on `sample_batches`
    (NHWC raw images), on the model's device: detection-agreement AP and
    mean |score| and |box| differences."""
    from retinanet_torch.export.serving import build_serving_fn
    device = next(model.parameters()).device
    fp_infer = build_serving_fn(params_cfg, device=device, model=model)
    q_infer = build_serving_fn(params_cfg, device=device, model=Int8Model(
        model, scales, real_int8=real_int8))
    ap_sum, score_mad, box_mad, n_ap, n_b = 0.0, 0.0, 0.0, 0, 0
    h, w = (int(params_cfg.input.input_shape[0]),
            int(params_cfg.input.input_shape[1]))
    for images in sample_batches:
        images = torch.from_numpy(np.ascontiguousarray(images))
        f = _as_numpy(fp_infer(images))
        q = _as_numpy(q_infer(images))
        ap = detection_agreement_ap(
            f, q, image_shape=(h, w),
            min_score=float(params_cfg.inference.score_threshold))
        if ap >= 0:
            ap_sum += ap
            n_ap += 1
        score_mad += float(np.abs(f["scores"] - q["scores"]).mean())
        box_mad += float(np.abs(f["boxes"] - q["boxes"]).mean())
        n_b += 1
    return {
        "num_calibrated_convs": len(scales),
        # -1 when no batch produced float detections to agree against
        "detection_agreement_ap": ap_sum / n_ap if n_ap else -1.0,
        "mean_abs_score_diff": score_mad / max(n_b, 1),
        "mean_abs_box_diff": box_mad / max(n_b, 1),
    }


def quantization_report(params_cfg, model: nn.Module,
                        sample_batches: Iterable) -> Dict[str, float]:
    """The weight-only lane against the float lane on `sample_batches`, on
    the model's device."""
    from retinanet_torch.convert import torch_to_flax
    from retinanet_torch.export.serving import build_serving_fn
    device = next(model.parameters()).device
    state = torch_to_flax(model.state_dict())
    qparams, stats = quantize_params(state["params"])
    qfn = make_quantized_serving_fn(params_cfg, qparams,
                                    state.get("batch_stats", {}),
                                    device=device)
    ffn = build_serving_fn(params_cfg, device=device, model=model)
    score_mad, box_mad, n = 0.0, 0.0, 0
    for images in sample_batches:
        images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        f = _as_numpy(ffn(images))
        q = _as_numpy(qfn(images))
        score_mad += float(np.abs(f["scores"] - q["scores"]).mean())
        box_mad += float(np.abs(f["boxes"] - q["boxes"]).mean())
        n += 1
    return {
        "num_quantized_tensors": stats["quantized"],
        "weight_bytes_fp32": stats["bytes_fp32"],
        "weight_bytes_int8": stats["bytes_q"],
        "compression": stats["bytes_fp32"] / max(stats["bytes_q"], 1),
        "mean_abs_score_diff": score_mad / max(n, 1),
        "mean_abs_box_diff": box_mad / max(n, 1),
    }

