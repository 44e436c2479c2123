"""Inference post-processing: fuse -> decode -> top-k -> NMS (counterpart of
`retinanet_tpu/ops/postprocess.py`).

* fuse_predictions: per-level (B,H,W,A*C) maps -> flat (B, anchors, C).
* decode: xy = t_xy * a_wh + a_xy, wh = exp(t_wh) * a_wh -> corners,
  normalized by the input shape; float32 throughout.
* filter_top_k: per-class or global pre-NMS top-k.
* generate_detections: CombinedNMS / GlobalSoftNMS / GlobalHardNMS /
  PerClassSoftNMS / PerClassHardNMS, all through one NMS over lanes
  (`ops/nms_kernel.nms_lanes`: the CUDA kernel on the card).

Output: scores (B, max_det), boxes (B, max_det, 4) normalized corners,
classes (B, max_det) int32, valid_detections (B,) int32; empty slots -1.

Top-k is exact. The JAX package's default serving lane selects with XLA's
approximate top-k (`approx_max_k_packed`), which has no PyTorch
counterpart; its exact lane (`inference.use_approx_top_k=false`) computes
the set the approximate lane approximates, and that is the lane ported
here, with the logits in float32. `lax.top_k` breaks ties toward the lower
index while `torch.topk` on CUDA promises no order among ties, so top-k is
a stable descending sort cut to k.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from retinanet_torch.core.device import device_constant, resolve_device
from retinanet_torch.data.anchors import AnchorGenerator
from retinanet_torch.ops.nms_kernel import nms_lanes

NMS_MODES = ("CombinedNMS", "GlobalSoftNMS", "GlobalHardNMS",
             "PerClassSoftNMS", "PerClassHardNMS")


def top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: descending, ties to the lower
    index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def fuse_predictions(predictions: Dict, min_level: int,
                     max_level: int) -> Dict[str, torch.Tensor]:
    """Per-level (B,H,W,A*C) maps -> flat (B, total_anchors, C)."""
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
        logits.append(cls_preds[key].reshape(batch, n, num_classes))
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
                 anchor_boxes: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Exact pre-NMS top-k. With `anchor_boxes` (A, 4), each selected
    candidate's anchor row is gathered too, under "anchors"."""
    scores = detections["scores"]       # (B, A, C)
    boxes = detections["boxes"]         # (B, A, 4)
    b, num_anchors, num_classes = scores.shape

    if filter_per_class:
        k = min(k_max, num_anchors)
        scores_t = scores.transpose(1, 2)                 # (B, C, A)
        top_scores, idx = top_k(scores_t, k)              # (B, C, k)
        flat_idx = idx.reshape(b, num_classes * k)
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
    _, idx = top_k(scores.reshape(b, num_anchors * num_classes), k)
    anchor_idx = idx // num_classes                        # (B, k)
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
        # survivors only
        if decode_after:
            filtered = filter_top_k(
                {"scores": fused["class_logits"],
                 "boxes": fused["encoded_boxes"]},
                nms_k, bool(inf.filter_per_class), anchor_boxes=anchor_boxes)
            filtered["boxes"] = decode_box_regressions(
                filtered["boxes"], filtered.pop("anchors"), input_shape,
                box_variance, scale_boxes)
        else:
            decoded = decode_detections(fused, anchor_boxes, input_shape,
                                        box_variance, scale_boxes)
            filtered = filter_top_k(
                {"scores": fused["class_logits"], "boxes": decoded["boxes"]},
                nms_k, bool(inf.filter_per_class))
        filtered["scores"] = torch.sigmoid(
            filtered["scores"].to(torch.float32))
        return generate_detections(
            filtered, mode=inf.mode, num_classes=num_classes,
            max_detections=int(inf.max_detections),
            iou_threshold=float(inf.iou_threshold),
            score_threshold=float(inf.score_threshold),
            soft_nms_sigma=float(inf.soft_nms_sigma))

    return postprocess


def make_inference_fn(model, params, anchors: AnchorGenerator,
                      normalizer, compute_dtype=torch.bfloat16,
                      skip_decoding: bool = False, skip_nms: bool = False,
                      device=None) -> Callable:
    """End-to-end serving function: raw NHWC images -> final detections,
    with the export-mode skips (`skip_decoding` returns the fused maps,
    `skip_nms` the decoded pre-NMS top-k)."""
    device = resolve_device(device)
    inf = params.inference
    ff = params.architecture.feature_fusion
    min_level, max_level = int(ff.min_level), int(ff.max_level)
    postprocess = make_postprocess_fn(params, anchors, device)
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = normalizer(images.to(device)).to(compute_dtype)
        fused = fuse_predictions(model(images), min_level, max_level)
        if skip_decoding:
            return fused
        if skip_nms:
            decoded = decode_detections(
                fused, anchor_boxes, params.input.input_shape,
                tuple(params.encoder_params.box_variance),
                bool(params.encoder_params.scale_box_targets))
            return filter_top_k(decoded, int(inf.pre_nms_top_k),
                                bool(inf.filter_per_class))
        return postprocess(fused)

    return infer
