"""RetinaNet losses (counterpart of `retinanet_tpu/losses/losses.py`).

Elementwise losses and masked sums over the dense per-level target
pyramids, in float32 whatever the compute dtype. The gradients come from
plain autograd: the JAX package's hand-derived gradient of the class loss
saved memory on the TPU and has no kernel behind it.

The normalizer is `sum(num_positives) + 1` over the batch on the card. The
moving-average variant threads its state through the caller.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets_one_hot: torch.Tensor,
                       alpha: float, gamma: float,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss."""
    y = targets_one_hot
    y_smooth = y * (1.0 - label_smoothing) + 0.5 * label_smoothing
    # stable sigmoid cross-entropy with logits
    ce = (torch.clamp(logits, min=0.0) - logits * y_smooth
          + torch.log1p(torch.exp(-torch.abs(logits))))
    probs = torch.sigmoid(logits)
    positive = y == 1.0
    alpha_t = torch.where(positive, alpha, 1.0 - alpha)
    pt = torch.where(positive, probs, 1.0 - probs)
    return alpha_t * torch.pow(1.0 - pt, gamma) * ce


def huber_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
               delta: float) -> torch.Tensor:
    """Elementwise Huber."""
    abs_err = torch.abs(y_pred - y_true)
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def class_loss(targets: Dict[str, torch.Tensor],
               predictions: Dict[str, torch.Tensor], num_classes: int,
               alpha: float, gamma: float,
               label_smoothing: float) -> torch.Tensor:
    """Summed focal loss over all levels; anchors with target -2 are ignored.

    targets[level] (B, H, W, A) float class ids with -1 background and -2
    ignore; predictions[level] (B, H, W, A*K) logits. The positive-class
    predicate `target == class index` is the only expanded operand; the
    cross-entropy, p_t and alpha_t are selected from it, which equals the
    one-hot sigmoid focal loss."""
    ls = float(label_smoothing)
    total = None
    for key, tgt in targets.items():
        b, h, w, a = tgt.shape
        logits = predictions[key].to(torch.float32).reshape(
            b, h, w, a, num_classes)
        classes = torch.arange(num_classes, dtype=tgt.dtype,
                               device=tgt.device)
        pos = tgt[..., None] == classes
        softplus = torch.logaddexp(logits, torch.zeros_like(logits))
        ce = torch.where(pos, softplus - logits * (1.0 - 0.5 * ls),
                         softplus - logits * (0.5 * ls))
        p = torch.sigmoid(logits)
        focal = torch.where(pos,
                            alpha * torch.pow(1.0 - p, gamma) * ce,
                            (1.0 - alpha) * torch.pow(p, gamma) * ce)
        valid = (tgt != -2.0)[..., None]
        level = torch.where(valid, focal, 0.0).sum()
        total = level if total is None else total + level
    return total


def box_loss(targets: Dict[str, torch.Tensor],
             predictions: Dict[str, torch.Tensor],
             delta: float) -> torch.Tensor:
    """Summed Huber over nonzero box targets, / 4."""
    total = None
    for key, tgt in targets.items():
        pred = predictions[key].to(torch.float32)
        mask = (tgt != 0.0).to(torch.float32)
        level = (huber_loss(tgt, pred, delta) * mask).sum()
        total = level if total is None else total + level
    return total / 4.0


def iou_prediction_loss(targets: Dict[str, torch.Tensor],
                        predictions: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
    """Summed squared error over anchors with IoU target > -1."""
    total = None
    for key, tgt in targets.items():
        pred = predictions[key].to(torch.float32)
        mask = (tgt > -1.0).to(torch.float32)
        level = (torch.square(pred - tgt) * mask).sum()
        total = level if total is None else total + level
    return total


class RetinaNetLoss:
    """Weighted detection loss; a callable without hidden state. With the
    moving-average normalizer, pass `normalizer_ema` (a scalar tensor from
    the train state); the updated value comes back beside the losses."""

    def __init__(self, num_classes: int, params):
        self.num_classes = int(num_classes)
        fl = params.focal_loss
        self.alpha = float(fl.alpha)
        self.gamma = float(fl.gamma)
        self.label_smoothing = float(fl.label_smoothing)
        self.delta = float(params.smooth_l1_loss.delta)
        self.box_weight = float(params.box_loss_weight)
        self.class_weight = float(params.class_loss_weight)
        self.aux_weight = float(params.auxillary_loss_weight)
        self.use_moving_average = bool(params.normalizer.use_moving_average)
        self.normalizer_momentum = float(params.normalizer.momentum)

    def __call__(self, targets: Dict, predictions: Dict,
                 normalizer_ema: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        batch_normalizer = targets["num-positives"].sum() + 1.0

        new_ema = None
        if self.use_moving_average:
            if normalizer_ema is None:
                raise ValueError(
                    "moving-average normalizer requires `normalizer_ema`")
            m = self.normalizer_momentum
            new_ema = normalizer_ema * m + batch_normalizer * (1.0 - m)
            normalizer = new_ema
        else:
            normalizer = batch_normalizer

        cls = class_loss(targets["class-targets"],
                         predictions["class-predictions"], self.num_classes,
                         self.alpha, self.gamma,
                         self.label_smoothing) / normalizer
        box = box_loss(targets["box-targets"],
                       predictions["box-predictions"],
                       self.delta) / normalizer

        weighted = self.box_weight * box + self.class_weight * cls
        losses = {
            "box-loss": box,
            "class-loss": cls,
            "weighted-loss": weighted,
            "num-anchors-matched": normalizer,
        }
        if "iou-predictions" in predictions:
            iou = iou_prediction_loss(
                targets["iou-targets"],
                predictions["iou-predictions"]) / normalizer
            losses["weighted-loss"] = weighted + self.aux_weight * iou
            losses["iou-prediction-loss"] = iou
        else:
            losses["iou-prediction-loss"] = torch.zeros(
                (), dtype=torch.float32, device=normalizer.device)
        return losses, new_ema
