"""Inference post-processing: fuse -> decode -> top-k -> NMS (counterpart of
`retinanet_tpu/ops/postprocess.py`).

* fuse_predictions: per-level (B,H,W,A*C) maps -> flat (B, anchors, C).
* decode: xy = t_xy * a_wh + a_xy, wh = exp(t_wh) * a_wh -> corners,
  normalized by the input shape; float32 throughout.
* filter_top_k: per-class or global pre-NMS top-k, through
  `ops/topk.py:select_top_k` (the kernel of `csrc/topk.cu` on the card).
* generate_detections: CombinedNMS / GlobalSoftNMS / GlobalHardNMS /
  PerClassSoftNMS / PerClassHardNMS, all through one NMS over lanes
  (`ops/nms_kernel.nms_lanes`: the CUDA kernel on the card).

Output: scores (B, max_det), boxes (B, max_det, 4) normalized corners,
classes (B, max_det) int32, valid_detections (B,) int32; empty slots -1.

Two selection lanes, as in the JAX package (`make_inference_fn`):

* the default lane (`inference.use_approx_top_k`, true by default): each
  level's class map is cast to bf16 before the concat, the pre-NMS top-k
  runs on the bf16 logits with the JAX package's packed key
  (`approx_max_k_packed`: "packed" mode up to 2^17 anchors, "bf16" above),
  and the sigmoid runs in float32 on the k winners only. The scores are
  the values the packed key keeps (see `ops/topk.py`);
* the exact lane (`use_approx_top_k=false`) and the export lanes
  (`skip_decoding`, `skip_nms`): float32 logits end to end, `lax.top_k`.

Off the TPU XLA computes the approximate top-k exactly, so both lanes are
deterministic and the port computes them bit for bit (`ops/topk.py`;
`inference.approx_recall_target` is checked and changes nothing). The
top-k over the NMS survivors is `lax.top_k` in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from retinanet_torch.core.device import device_constant, resolve_device
from retinanet_torch.data.anchors import AnchorGenerator
from retinanet_torch.ops.nms_kernel import nms_lanes
from retinanet_torch.ops.topk import check_recall_target, lane_mode, \
    select_top_k

NMS_MODES = ("CombinedNMS", "GlobalSoftNMS", "GlobalHardNMS",
             "PerClassSoftNMS", "PerClassHardNMS")


def top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: descending, ties to the lower
    index; int64 indices."""
    values, idx = select_top_k(x, k, lane_mode(x.dtype, x.shape[-1], False))
    return values, idx.long()


def fuse_predictions(predictions: Dict, min_level: int,
                     max_level: int,
                     logits_dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """Per-level (B,H,W,A*C) maps -> flat (B, total_anchors, C).

    `logits_dtype` (bf16 in the default lane) casts each level's class map
    before the concat, so that the concat moves half the bytes."""
    cls_preds = predictions["class-predictions"]
    box_preds = predictions["box-predictions"]
    first = str(min_level)
    anchors_per_loc = box_preds[first].shape[-1] // 4
    num_classes = cls_preds[first].shape[-1] // anchors_per_loc
    batch = box_preds[first].shape[0]

    logits, boxes = [], []
    for level in range(min_level, max_level + 1):
        key = str(level)
        _, h, w, _ = box_preds[key].shape
        n = h * w * anchors_per_loc
        cls_map = cls_preds[key]
        if logits_dtype is not None:
            cls_map = cls_map.to(logits_dtype)
        logits.append(cls_map.reshape(batch, n, num_classes))
        boxes.append(box_preds[key].reshape(batch, n, 4))
    return {
        "class_logits": torch.cat(logits, dim=1),
        "encoded_boxes": torch.cat(boxes, dim=1),
    }


def decode_box_regressions(encoded: torch.Tensor,
                           anchor_boxes: torch.Tensor,
                           input_shape,
                           box_variance=(0.1, 0.1, 0.2, 0.2),
                           scale_box_predictions: bool = False
                           ) -> torch.Tensor:
    """(..., 4) encoded regressions + matching (..., 4) cxcywh anchors ->
    normalized corner boxes. Shared by both decode lanes."""
    encoded = encoded.to(torch.float32)
    a_xy, a_wh = anchor_boxes[..., :2], anchor_boxes[..., 2:]
    if scale_box_predictions:
        encoded = encoded * device_constant(
            tuple(float(v) for v in box_variance), torch.float32,
            encoded.device)
    xy = encoded[..., :2] * a_wh + a_xy
    wh = torch.exp(encoded[..., 2:]) * a_wh
    half = wh / 2.0
    corners = torch.cat([xy - half, xy + half], dim=-1)
    h, w = float(input_shape[0]), float(input_shape[1])
    return corners / device_constant((w, h, w, h), torch.float32,
                                     corners.device)


def decode_detections(fused: Dict[str, torch.Tensor],
                      anchor_boxes: torch.Tensor,
                      input_shape,
                      box_variance=(0.1, 0.1, 0.2, 0.2),
                      scale_box_predictions: bool = False,
                      ) -> Dict[str, torch.Tensor]:
    logits = fused["class_logits"].to(torch.float32)
    corners = decode_box_regressions(
        fused["encoded_boxes"], anchor_boxes[None], input_shape,
        box_variance, scale_box_predictions)
    return {"scores": torch.sigmoid(logits), "boxes": corners}


def filter_top_k(detections: Dict[str, torch.Tensor],
                 k_max: int,
                 filter_per_class: bool = True,
                 approx: bool = False,
                 recall_target: float = 0.95,
                 anchor_boxes: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Pre-NMS top-k: `approx=True` is the JAX package's
    `approx_max_k_packed` lane, else `lax.top_k` (`ops/topk.py:lane_mode`
    picks the mode from the scores' type and the row length; all exact).
    With `anchor_boxes` (A, 4), each selected candidate's anchor row is
    gathered too, under "anchors"."""
    check_recall_target(recall_target)
    scores = detections["scores"]       # (B, A, C)
    boxes = detections["boxes"]         # (B, A, 4)
    b, num_anchors, num_classes = scores.shape

    if filter_per_class:
        k = min(k_max, num_anchors)
        # along the anchors of each (image, class), read in place
        top_scores, idx = select_top_k(
            scores, k, lane_mode(scores.dtype, num_anchors, approx),
            dim=1)                                        # (B, C, k)
        flat_idx = idx.reshape(b, num_classes * k).long()
        top_boxes = torch.gather(
            boxes, 1, flat_idx[..., None].expand(-1, -1, 4)).reshape(
                b, num_classes, k, 4)
        out = {
            "scores": top_scores.transpose(1, 2),          # (B, k, C)
            "boxes": top_boxes.transpose(1, 2),            # (B, k, C, 4)
        }
        if anchor_boxes is not None:
            out["anchors"] = anchor_boxes[flat_idx].reshape(
                b, num_classes, k, 4).transpose(1, 2)      # (B, k, C, 4)
        return out
    k = min(k_max, num_anchors * num_classes)
    _, idx = select_top_k(
        scores.reshape(b, num_anchors * num_classes), k,
        lane_mode(scores.dtype, num_anchors * num_classes, approx))
    anchor_idx = idx.long() // num_classes                 # (B, k)
    out = {
        "scores": torch.gather(
            scores, 1, anchor_idx[..., None].expand(-1, -1, num_classes)),
        "boxes": torch.gather(
            boxes, 1, anchor_idx[..., None].expand(-1, -1, 4)),
    }
    if anchor_boxes is not None:
        out["anchors"] = anchor_boxes[anchor_idx]
    return out


def _finalize(boxes, scores, classes, valid):
    """Mask empty / sub-threshold slots to -1."""
    mask = scores > -0.5
    slot = torch.arange(scores.shape[1], device=scores.device)[None]
    mask = mask & (slot < valid[:, None])
    return {
        "scores": torch.where(mask, scores, -1.0),
        "boxes": torch.where(mask[..., None], boxes, -1.0),
        "classes": torch.where(mask, classes, -1).to(torch.int32),
        "valid_detections": valid.to(torch.int32),
    }


def _lane_nms(boxes_l, scores_l, *, max_detections, iou_threshold,
              score_threshold, soft_nms_sigma, soft):
    """NMS over (L, k, 4)/(L, k) lanes -> (idx, scores, valid), through
    `nms_lanes`: the CUDA kernel for tensors on the card."""
    return nms_lanes(boxes_l.to(torch.float32).contiguous(),
                     scores_l.to(torch.float32).contiguous(), max_detections,
                     iou_threshold, score_threshold, soft_nms_sigma, soft)


def _per_class_nms(scores, boxes, *, num_classes, max_detections,
                   iou_threshold, score_threshold, soft_nms_sigma, soft):
    """scores (B, k, C); boxes (B, k, C, 4) or (B, k, 4) class-agnostic."""
    b, k = scores.shape[0], scores.shape[1]
    scores_c = scores.transpose(1, 2)                     # (B, C, k)
    if boxes.dim() == 4:
        boxes_c = boxes.transpose(1, 2)                   # (B, C, k, 4)
    else:
        boxes_c = boxes[:, None].expand(b, num_classes, k, 4)
    boxes_l = boxes_c.reshape(b * num_classes, k, 4)

    # NonMaxSuppressionV5 semantics: soft mode uses iou_threshold=1.0
    idx, sel_scores, _ = _lane_nms(
        boxes_l, scores_c.reshape(b * num_classes, k),
        max_detections=max_detections,
        iou_threshold=1.0 if (soft and soft_nms_sigma > 0.0)
        else iou_threshold,
        score_threshold=score_threshold,
        soft_nms_sigma=soft_nms_sigma, soft=soft)
    sel_boxes = torch.gather(
        boxes_l, 1, idx.long()[..., None].expand(-1, -1, 4))
    sel_boxes = sel_boxes.reshape(b, num_classes, max_detections, 4)
    sel_scores = torch.where(sel_scores > -0.5, sel_scores, -1.0)
    sel_scores = sel_scores.reshape(b, num_classes, max_detections)
    classes = torch.arange(num_classes, dtype=torch.int32,
                           device=scores.device)[None, :, None].expand(
                               b, num_classes, max_detections)

    flat_scores = sel_scores.reshape(b, -1)
    flat_boxes = sel_boxes.reshape(b, -1, 4)
    flat_classes = classes.reshape(b, -1)
    top_scores, idx = top_k(flat_scores, max_detections)
    top_boxes = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(flat_classes, 1, idx)
    keep = top_scores > score_threshold
    valid = keep.sum(dim=1, dtype=torch.int32)
    top_scores = torch.where(keep, top_scores, -1.0)
    return _finalize(top_boxes, top_scores, top_classes, valid)


def _global_nms(scores, boxes, *, max_detections, iou_threshold,
                score_threshold, soft_nms_sigma, soft):
    """scores (B, k, C); boxes (B, k, 4)."""
    max_scores = scores.max(dim=-1).values
    classes = torch.argmax(scores, dim=-1).to(torch.int32)

    idx, sel_scores, valid = _lane_nms(
        boxes, max_scores, max_detections=max_detections,
        iou_threshold=1.0 if (soft and soft_nms_sigma > 0.0)
        else iou_threshold,
        score_threshold=score_threshold,
        soft_nms_sigma=soft_nms_sigma, soft=soft)
    idx = idx.long()
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    sel_classes = torch.gather(classes, 1, idx)
    return _finalize(sel_boxes, sel_scores, sel_classes, valid)


def generate_detections(detections: Dict[str, torch.Tensor],
                        mode: str,
                        num_classes: int,
                        max_detections: int = 100,
                        iou_threshold: float = 0.5,
                        score_threshold: float = 0.05,
                        soft_nms_sigma: float = 0.5
                        ) -> Dict[str, torch.Tensor]:
    if mode not in NMS_MODES:
        raise ValueError(f"mode must be one of {NMS_MODES}, got {mode}")
    scores = detections["scores"].to(torch.float32)
    boxes = torch.clamp(detections["boxes"].to(torch.float32), 0.0, 1.0)

    common = dict(max_detections=max_detections,
                  iou_threshold=iou_threshold,
                  score_threshold=score_threshold)
    if mode in ("CombinedNMS", "PerClassHardNMS"):
        return _per_class_nms(scores, boxes, num_classes=num_classes,
                              soft_nms_sigma=0.0, soft=False, **common)
    if mode == "PerClassSoftNMS":
        return _per_class_nms(scores, boxes, num_classes=num_classes,
                              soft_nms_sigma=soft_nms_sigma / 2.0, soft=True,
                              **common)
    if mode == "GlobalHardNMS":
        return _global_nms(scores, boxes, soft_nms_sigma=0.0, soft=False,
                           **common)
    return _global_nms(scores, boxes, soft_nms_sigma=soft_nms_sigma / 2.0,
                       soft=True, **common)


def make_postprocess_fn(params, anchors: AnchorGenerator,
                        device=None) -> Callable:
    """Fused predictions -> final detections (the part of the serving
    function after the model)."""
    device = resolve_device(device)
    inf = params.inference
    num_classes = int(params.architecture.head.num_classes)
    input_shape = params.input.input_shape
    box_variance = tuple(params.encoder_params.box_variance)
    scale_boxes = bool(params.encoder_params.scale_box_targets)
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)
    # the default lane selects on bf16 logits (see the module docstring)
    approx = bool(inf.get("use_approx_top_k", True))
    recall_target = check_recall_target(
        inf.get("approx_recall_target", 0.95))
    # NMS candidate cap: greedy NMS only ever selects boxes above
    # score_threshold, and only a higher-scoring box can suppress one, so
    # the top `nms_top_k` candidates give the same detections as the full
    # pre_nms_top_k whenever fewer than nms_top_k per class clear the
    # threshold.
    nms_k = min(int(inf.get("nms_top_k", 256)), int(inf.pre_nms_top_k))
    # decode only the selected candidates instead of all anchors: the same
    # per-element program (decode_box_regressions), so the same detections.
    decode_after = bool(inf.get("decode_after_topk", False))

    def postprocess(fused: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        # top-k on the logits (sigmoid is monotonic), sigmoid on the k
        # survivors only; the default lane's logits are bf16 (a no-op where
        # `fuse_predictions` cast them already)
        logits = fused["class_logits"]
        if approx:
            logits = logits.to(torch.bfloat16)
        if decode_after:
            filtered = filter_top_k(
                {"scores": logits, "boxes": fused["encoded_boxes"]},
                nms_k, bool(inf.filter_per_class), approx=approx,
                recall_target=recall_target, anchor_boxes=anchor_boxes)
            filtered["boxes"] = decode_box_regressions(
                filtered["boxes"], filtered.pop("anchors"), input_shape,
                box_variance, scale_boxes)
        else:
            boxes = decode_box_regressions(
                fused["encoded_boxes"], anchor_boxes[None], input_shape,
                box_variance, scale_boxes)
            filtered = filter_top_k(
                {"scores": logits, "boxes": boxes}, nms_k,
                bool(inf.filter_per_class), approx=approx,
                recall_target=recall_target)
        filtered["scores"] = torch.sigmoid(
            filtered["scores"].to(torch.float32))
        return generate_detections(
            filtered, mode=inf.mode, num_classes=num_classes,
            max_detections=int(inf.max_detections),
            iou_threshold=float(inf.iou_threshold),
            score_threshold=float(inf.score_threshold),
            soft_nms_sigma=float(inf.soft_nms_sigma))

    return postprocess


class InferenceModule(nn.Module):
    """The serving function as a module: raw NHWC images, already on the
    device, -> final detections, with the export-mode skips
    (`skip_decoding` returns the fused maps, `skip_nms` the decoded
    pre-NMS top-k, both in float32). The full lane selects on bf16 logits
    unless `inference.use_approx_top_k` is false, as the JAX package's
    `make_inference_fn` does. No device copy and no inference mode inside,
    so that `torch.export` can trace it (`export/serving.py`); `model` is
    its child, and its weights the graph's parameters."""

    def __init__(self, model, params, anchors: AnchorGenerator, normalizer,
                 compute_dtype=torch.bfloat16, skip_decoding: bool = False,
                 skip_nms: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.model = model
        self.params = params
        self.normalizer = normalizer
        self.compute_dtype = compute_dtype
        self.skip_decoding = skip_decoding
        self.skip_nms = skip_nms
        ff = params.architecture.feature_fusion
        self.levels = (int(ff.min_level), int(ff.max_level))
        self.approx_lane = (bool(params.inference.get("use_approx_top_k",
                                                      True))
                            and not skip_decoding and not skip_nms)
        self.postprocess = make_postprocess_fn(params, anchors, device)
        self.register_buffer("anchor_boxes",
                             torch.from_numpy(anchors.boxes).to(device),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        params = self.params
        images = self.normalizer(images).to(self.compute_dtype)
        fused = fuse_predictions(
            self.model(images), *self.levels,
            logits_dtype=torch.bfloat16 if self.approx_lane else None)
        if self.skip_decoding:
            return fused
        if self.skip_nms:
            decoded = decode_detections(
                fused, self.anchor_boxes, params.input.input_shape,
                tuple(params.encoder_params.box_variance),
                bool(params.encoder_params.scale_box_targets))
            return filter_top_k(decoded, int(params.inference.pre_nms_top_k),
                                bool(params.inference.filter_per_class))
        return self.postprocess(fused)


def make_inference_fn(model, params, anchors: AnchorGenerator,
                      normalizer, compute_dtype=torch.bfloat16,
                      skip_decoding: bool = False, skip_nms: bool = False,
                      device=None) -> Callable:
    """End-to-end serving function: raw NHWC images (on any device) ->
    final detections, in inference mode (`InferenceModule`)."""
    device = resolve_device(device)
    return inference_fn(InferenceModule(
        model, params, anchors, normalizer, compute_dtype, skip_decoding,
        skip_nms, device), device)


def inference_fn(module: nn.Module, device: torch.device) -> Callable:
    """`module` as a function of images on any device: moved to `device`,
    run in inference mode."""

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return module(images.to(device))

    return infer
