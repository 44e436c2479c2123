"""Box math on tensors (counterpart of `retinanet_tpu/data/box_utils.py`).

Boxes are `[x, y, w, h]` (centre format) or `[x1, y1, x2, y2]` (corners).
`compute_iou` is the arithmetic that the matching kernel `csrc/match.cu`
repeats operation for operation: halves by a multiply with 0.5 (exact, and
what a division by the scalar 2 becomes on the card), the union clamped at
1e-8, the quotient of two tensors, the result clipped to [0, 1].
"""

from __future__ import annotations

import torch


def swap_xy(boxes: torch.Tensor) -> torch.Tensor:
    """[y, x, y2, x2] <-> [x, y, x2, y2]."""
    return torch.stack(
        [boxes[..., 1], boxes[..., 0], boxes[..., 3], boxes[..., 2]], dim=-1)


def convert_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """Corners -> centre format."""
    return torch.cat(
        [(boxes[..., :2] + boxes[..., 2:]) * 0.5,
         boxes[..., 2:] - boxes[..., :2]], dim=-1)


def convert_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """Centre format -> corners."""
    half = boxes[..., 2:] * 0.5
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def compute_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                pairwise: bool = True) -> torch.Tensor:
    """IoU of centre-format boxes.

    pairwise=True:  boxes1 (..., M, 4), boxes2 (N, 4) -> (..., M, N)
    pairwise=False: elementwise with broadcasting -> (...,)
    """
    c1 = convert_to_corners(boxes1)
    c2 = convert_to_corners(boxes2)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    if pairwise:
        c1 = c1[..., :, None, :]
        area1 = area1[..., :, None]

    lu = torch.maximum(c1[..., :2], c2[..., :2])
    rd = torch.minimum(c1[..., 2:], c2[..., 2:])
    intersection = torch.clamp(rd - lu, min=0.0)
    intersection_area = intersection[..., 0] * intersection[..., 1]
    union_area = torch.clamp(area1 + area2 - intersection_area, min=1e-8)
    return torch.clamp(intersection_area / union_area, 0.0, 1.0)
