"""Anchor-matching label encoder on the device, batched (counterpart of
`retinanet_tpu/data/label_encoder.py`).

Ground truth arrives padded (`max_boxes` rows and a validity mask), so a
whole batch encodes on the card inside the train step.

Matching rules:
  * matches[a] = argmax_g IoU(g, a)        if max_g IoU > match_iou
  * matches[a] = -2 (ignore)               if ignore_iou <= max IoU < match_iou
  * matches[a] = -1 (background)           otherwise
  * force-match: every valid box claims its best anchor (several boxes on
    one anchor: the lowest box index wins).

Box target: [(gt_xy - a_xy) / a_wh, log(gt_wh / a_wh)], optionally divided
by `box_variance`; zero for anchors that are not positive; the matched box
is clamped to >= 1e-8 first.

Where the JAX package worked around the TPU, the port uses the direct form:
the force-match is a `scatter_reduce(amin)` over (B, A) (a minimum does not
depend on the order of the atomics, so it is deterministic), and the matched
boxes and classes are a `torch.gather` from the (G, 5) table with the rows
of unmatched anchors set to 0, which is what the one-hot product gives.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from retinanet_torch.core.device import device_constant, resolve_device
from retinanet_torch.data import box_utils
from retinanet_torch.data.anchors import AnchorGenerator
from retinanet_torch.ops.match_kernel import match_lanes


class EncodedLabels(NamedTuple):
    """Flat per-anchor targets of a batch; `to_pyramid` splits them."""
    cls_target: torch.Tensor     # (B, A) float32: class id, -1 bg, -2 ignore
    box_target: torch.Tensor     # (B, A, 4) float32
    iou_target: torch.Tensor     # (B, A) float32, -1 where unmatched
    num_positives: torch.Tensor  # (B,) float32


def _finish_matches(max_ious: torch.Tensor, matched_gt_idx: torch.Tensor,
                    best_anchor_per_gt: torch.Tensor, gt_valid: torch.Tensor,
                    match_iou: float, ignore_iou: float) -> torch.Tensor:
    """(B, A) int32 matches from the four lanes of the matcher."""
    num_gt = gt_valid.shape[1]
    matches = torch.where(max_ious > match_iou, matched_gt_idx, -1)
    matches = torch.where(
        (max_ious >= ignore_iou) & (match_iou > max_ious), -2, matches)

    gt_ids = torch.arange(num_gt, dtype=torch.int32, device=gt_valid.device)
    claims = torch.where(gt_valid, gt_ids, num_gt)              # (B, G)
    forced = torch.full_like(matches, num_gt)
    forced.scatter_reduce_(1, best_anchor_per_gt.to(torch.int64), claims,
                           "amin", include_self=True)
    matches = torch.where(forced < num_gt, forced, matches)

    any_valid = gt_valid.any(dim=1, keepdim=True)
    return torch.where(any_valid, matches, -1)


def match_anchors(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, match_iou: float,
                  ignore_iou: float, matcher: Callable = match_lanes
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (matches int32 (B, A), max_ious float32 (B, A)).

    anchor_boxes (A, 4), gt_boxes (B, G, 4) centre format, padded; gt_valid
    (B, G) bool. `matcher` is `match_lanes`: the CUDA kernel for tensors on
    the card, its plain version for tensors on the CPU."""
    max_ious, matched_gt_idx, _, best_anchor_per_gt = matcher(
        anchor_boxes, gt_boxes, gt_valid)
    matches = _finish_matches(max_ious, matched_gt_idx, best_anchor_per_gt,
                              gt_valid, match_iou, ignore_iou)
    return matches, max_ious


def _box_target(anchor_boxes: torch.Tensor, matched_gt_boxes: torch.Tensor,
                matches: torch.Tensor, box_variance,
                scale_box_targets: bool, eps: float = 1e-8) -> torch.Tensor:
    gt = torch.clamp(matched_gt_boxes, min=eps)
    target = torch.cat([
        (gt[..., :2] - anchor_boxes[:, :2]) / anchor_boxes[:, 2:],
        torch.log(gt[..., 2:] / anchor_boxes[:, 2:]),
    ], dim=-1)
    target = torch.where((matches >= 0)[..., None], target, 0.0)
    if scale_box_targets:
        target = target / device_constant(
            tuple(float(v) for v in box_variance), torch.float32,
            target.device)
    return target


def encode(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
           gt_classes: torch.Tensor, gt_valid: torch.Tensor,
           match_iou: float = 0.5, ignore_iou: float = 0.5,
           box_variance=(0.1, 0.1, 0.2, 0.2),
           scale_box_targets: bool = False,
           matcher: Callable = match_lanes) -> EncodedLabels:
    """Encode a batch.

    anchor_boxes (A, 4) centre-format pixel anchors; gt_boxes (B, G, 4)
    centre-format pixel boxes padded with zeros; gt_classes (B, G) integer
    class ids; gt_valid (B, G) bool."""
    anchor_boxes = anchor_boxes.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32).contiguous()
    gt_valid = gt_valid.contiguous()
    matches, _ = match_anchors(anchor_boxes, gt_boxes, gt_valid, match_iou,
                               ignore_iou, matcher)
    positive = matches >= 0

    table = torch.cat([gt_boxes, gt_classes.to(torch.float32)[..., None]],
                      dim=-1)                                   # (B, G, 5)
    index = matches.clamp(min=0).to(torch.int64)[..., None].expand(-1, -1, 5)
    gathered = torch.where(positive[..., None],
                           torch.gather(table, 1, index), 0.0)  # (B, A, 5)
    matched_boxes = gathered[..., :4]
    # the -1 / -2 sentinels pass through
    cls_target = torch.where(positive, gathered[..., 4],
                             matches.to(torch.float32))

    box_target = _box_target(anchor_boxes, matched_boxes, matches,
                             box_variance, scale_box_targets)
    iou_target = box_utils.compute_iou(anchor_boxes, matched_boxes,
                                       pairwise=False)
    iou_target = torch.where(positive, iou_target, -1.0)
    num_positives = positive.to(torch.float32).sum(dim=1)
    return EncodedLabels(cls_target, box_target, iou_target, num_positives)


def to_pyramid(encoded: EncodedLabels, anchors: AnchorGenerator,
               use_iou_targets: bool = False) -> Dict:
    """Reshape flat batched targets to per-level dense pyramids keyed by
    level, (B, fh, fw, a) and (B, fh, fw, 4a): the NHWC shapes of the heads'
    outputs, in the (h, w, anchor) order of `data/anchors.py`."""
    targets = {"class-targets": {}, "box-targets": {}}
    if use_iou_targets:
        targets["iou-targets"] = {}
    a = anchors.num_anchors
    for i, lvl in enumerate(range(anchors.min_level, anchors.max_level + 1)):
        lo, hi = anchors.boundaries[i], anchors.boundaries[i + 1]
        fh, fw = anchors.feature_shapes[i]
        key = str(lvl)
        targets["class-targets"][key] = encoded.cls_target[:, lo:hi].reshape(
            -1, fh, fw, a)
        targets["box-targets"][key] = encoded.box_target[:, lo:hi].reshape(
            -1, fh, fw, 4 * a)
        if use_iou_targets:
            targets["iou-targets"][key] = encoded.iou_target[
                :, lo:hi].reshape(-1, fh, fw, a)
    targets["num-positives"] = encoded.num_positives
    return targets


def make_batched_encoder(anchors: AnchorGenerator, encoder_params,
                         use_iou_targets: bool = False, device=None,
                         matcher: Callable = match_lanes):
    """Returns fn(gt_boxes (B,G,4), gt_classes (B,G), gt_valid (B,G)) ->
    pyramid targets with batched leaves, for tensors on `device`, where the
    anchors are copied once. The encoder takes no gradient."""
    device = resolve_device(device)
    anchor_const = torch.from_numpy(anchors.boxes).to(device)
    match_iou = float(encoder_params.match_iou)
    ignore_iou = float(encoder_params.ignore_iou)
    variance = tuple(float(v) for v in encoder_params.box_variance)
    scale_targets = bool(encoder_params.scale_box_targets)

    @torch.no_grad()
    def _batched(gt_boxes, gt_classes, gt_valid):
        enc = encode(anchor_const, gt_boxes, gt_classes, gt_valid, match_iou,
                     ignore_iou, variance, scale_targets, matcher)
        return to_pyramid(enc, anchors, use_iou_targets)

    return _batched
