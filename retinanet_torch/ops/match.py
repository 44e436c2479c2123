"""Anchor <-> ground-truth matching lanes, plain PyTorch.

This is the plain version of the CUDA kernel in `ops/match_kernel.py`: the
same function on the same inputs, written with `compute_iou` and PyTorch's
reductions. The CPU tests run it against the JAX package, `chip_smoke.py`
holds the kernel against it on the card, and the wrapper takes it for
tensors that lie on the CPU. It materialises the (B, G, A) IoU tensor, which
the kernel never does.

`tile_cull_mask` is the kernel's test of which boxes a tile of anchors has
to look at, in plain PyTorch: the tests hold it to its claim (a dropped pair
has IoU exactly 0) and `chip_smoke.py` reports the share of pairs kept.
"""

from __future__ import annotations

from typing import Tuple

import torch

from retinanet_torch.data.box_utils import compute_iou, convert_to_corners


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


def tile_cull_mask(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   tile: int) -> torch.Tensor:
    """Which boxes each tile of `tile` consecutive anchors keeps (the kernel's
    tile is `ops/match_kernel.py:TILE`): anchors (A, 4), gt_boxes (B, G, 4)
    in centre format -> (B, T, G) bool, T = ceil(A / tile).

    A box is dropped iff it lies at or past one side of the bounding box of
    the tile's anchors' corners: `bx2 <= tx1 or bx1 >= tx2 or by2 <= ty1 or
    by1 >= ty2`. Then the intersection's width or height, and so the IoU, is
    exactly 0 with every anchor of the tile. A NaN corner makes every
    comparison false, which keeps the box. Validity is not looked at."""
    corners = convert_to_corners(anchors)                      # (A, 4)
    pad = -anchors.shape[0] % tile
    lo = torch.cat([corners[:, :2], corners.new_full((pad, 2), float("inf"))])
    hi = torch.cat([corners[:, 2:],
                    corners.new_full((pad, 2), float("-inf"))])
    tile_lo = lo.reshape(-1, tile, 2).amin(dim=1)              # (T, 2)
    tile_hi = hi.reshape(-1, tile, 2).amax(dim=1)
    box = convert_to_corners(gt_boxes)[:, None]                # (B, 1, G, 4)
    dropped = ((box[..., 2:] <= tile_lo[None, :, None]).any(-1)
               | (box[..., :2] >= tile_hi[None, :, None]).any(-1))
    return ~dropped
