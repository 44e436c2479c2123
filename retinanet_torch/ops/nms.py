"""Greedy (soft-)NMS in plain PyTorch (counterpart of
`retinanet_tpu/ops/nms.py`).

This is the plain version of the CUDA kernel in `ops/nms_kernel.py`: the
CPU path of the wrapper and the yardstick the kernel is held to on the card.

Each of `max_detections` rounds picks the first-index argmax, stops the lane
for good once that score is not above `score_threshold`, takes the IoU of
the pick against every candidate and suppresses:
  * hard: IoU > iou_threshold -> -1e10;
  * soft, sigma > 0: score *= exp(-iou^2 / (2 sigma)), zeroed past the
    threshold (NonMaxSuppressionV5; callers pass sigma/2 and threshold 1.0);
  * soft, sigma = 0: keep only IoU <= iou_threshold;
and finally sets the pick itself to -1e10. The box area is
max(x2-x1, 0) * max(y2-y1, 0) and the union is clamped at 1e-8.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from retinanet_torch.core.device import device_constant

_NEG_INF = -1e10


class NMSResult(NamedTuple):
    indices: torch.Tensor  # (max_det,) int32 into the candidate axis
    scores: torch.Tensor   # (max_det,) float32; -1 for empty slots
    valid: torch.Tensor    # () int32 number of selections


def batched_nms(boxes: torch.Tensor,
                scores: torch.Tensor,
                max_detections: int,
                iou_threshold: float = 0.5,
                score_threshold: float = float("-inf"),
                soft_nms_sigma: float = 0.0,
                soft: bool = False) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Greedy NMS over L independent lanes.

    boxes: (L, k, 4) corners; scores: (L, k). Returns (indices (L, max_det)
    int32, -1 padded then clamped to 0; scores (L, max_det) float32, -1
    where empty; valid (L,) int32)."""
    boxes = boxes.to(torch.float32)
    cur = scores.to(torch.float32)
    lanes = cur.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)                          # (L, k)
    area = (torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0))
    # a tensor divisor keeps this an IEEE division on every device (a Python
    # scalar divisor becomes a multiply by its reciprocal on CUDA)
    two_sigma = device_constant((2.0 * soft_nms_sigma,), torch.float32,
                                cur.device)
    out_idx, out_scores = [], []
    for _ in range(max_detections):
        idx = torch.argmax(cur, dim=1, keepdim=True)           # (L, 1)
        best = torch.gather(cur, 1, idx)                       # (L, 1)
        ok = best > score_threshold
        sel = torch.gather(boxes, 1, idx[..., None].expand(lanes, 1, 4))
        sx1, sy1, sx2, sy2 = sel.unbind(-1)                    # (L, 1)
        sarea = (torch.clamp_min(sx2 - sx1, 0.0)
                 * torch.clamp_min(sy2 - sy1, 0.0))
        iw = torch.clamp_min(torch.minimum(sx2, x2) - torch.maximum(sx1, x1),
                             0.0)
        ih = torch.clamp_min(torch.minimum(sy2, y2) - torch.maximum(sy1, y1),
                             0.0)
        inter = iw * ih
        union = torch.clamp_min(sarea + area - inter, 1e-8)
        iou = inter / union
        if soft:
            if soft_nms_sigma > 0.0:
                scale = torch.exp(-(iou * iou) / two_sigma)
                scale = torch.where(iou > iou_threshold, 0.0, scale)
            else:
                scale = (iou <= iou_threshold).to(torch.float32)
            new = cur * scale
        else:
            new = torch.where(iou > iou_threshold, _NEG_INF, cur)
        new = new.scatter(1, idx, _NEG_INF)
        cur = torch.where(ok, new, cur)
        out_idx.append(torch.where(ok, idx, -1))
        out_scores.append(torch.where(ok, best, -1.0))
    indices = torch.cat(out_idx, dim=1).to(torch.int32)
    valid = (indices >= 0).sum(dim=1, dtype=torch.int32)
    return (torch.clamp_min(indices, 0), torch.cat(out_scores, dim=1),
            valid)


def nms_select(boxes: torch.Tensor,
               scores: torch.Tensor,
               max_detections: int,
               iou_threshold: float = 0.5,
               score_threshold: float = float("-inf"),
               soft_nms_sigma: float = 0.0,
               soft: bool = False) -> NMSResult:
    """Greedy NMS over one lane: (k, 4) boxes, (k,) scores."""
    idx, sc, valid = batched_nms(boxes[None], scores[None], max_detections,
                                 iou_threshold, score_threshold,
                                 soft_nms_sigma, soft)
    return NMSResult(idx[0], sc[0], valid[0])
