"""Anchor <-> ground-truth matching lanes, plain PyTorch.

This is the plain version of the CUDA kernel in `ops/match_kernel.py`: the
same function on the same inputs, written with `compute_iou` and PyTorch's
reductions. The CPU tests run it against the JAX package, `chip_smoke.py`
holds the kernel against it on the card, and the wrapper takes it for
tensors that lie on the CPU. It materialises the (B, G, A) IoU tensor, which
the kernel never does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from retinanet_torch.data.box_utils import compute_iou


def match_lanes_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """anchors (A, 4) and gt_boxes (B, G, 4) float32 in centre format,
    gt_valid (B, G) bool. Returns
      max_iou (B, A) float32: the best IoU of each anchor over the valid
        boxes, -1 where the image has none;
      argmax_gt (B, A) int32: the lowest box index attaining it;
      gt_best_iou (B, G) float32: the best IoU of each box over the anchors,
        -1 for an invalid box;
      gt_best_anchor (B, G) int32: the lowest anchor index attaining it, 0
        for an invalid box.
    An invalid box counts as IoU -1 everywhere, as in the XLA lane of the
    JAX package (`data/label_encoder.py:101-107`)."""
    iou = compute_iou(gt_boxes, anchors, pairwise=True)        # (B, G, A)
    iou = torch.where(gt_valid[..., None], iou, iou.new_full((), -1.0))
    max_iou, argmax_gt = iou.max(dim=1)
    gt_best_iou, gt_best_anchor = iou.max(dim=2)
    return (max_iou, argmax_gt.to(torch.int32), gt_best_iou,
            gt_best_anchor.to(torch.int32))
