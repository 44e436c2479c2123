"""Detection heads (counterpart of `retinanet_tpu/models/heads.py`).

* `num_convs` 3x3 convs whose weights are shared across pyramid levels,
  each followed by a BatchNorm of its own per level (`conv{i}_p{level}_bn`).
* Plain convs start from normal(stddev=0.01); separable ones from variance
  scaling.
* The prediction conv runs in float32 on a float32 input, whatever the
  compute dtype.
* Class head bias prior -log((1 - 0.01) / 0.01); box head bias zero.
* Outputs are NHWC, (B, H, W, A*K): the (h, w, a) order that the anchors
  and `ops/postprocess.fuse_predictions` assume.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.models.layers import BatchNorm, Conv2D


class DetectionHead(nn.Module):
    def __init__(self, in_channels: int, num_convs: int = 4,
                 filters: int = 256, output_filters: int = 36,
                 min_level: int = 3, max_level: int = 7,
                 prediction_bias_prior: Optional[float] = None,
                 separable_conv: bool = False, bn_epsilon: float = 1e-3,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_convs = num_convs
        self.min_level = min_level
        self.max_level = max_level
        self.activation = activation
        kernel_init = "normal" if not separable_conv else "variance_scaling"
        channels = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2D(
                channels, filters, 3, separable=separable_conv,
                kernel_init=kernel_init, dtype=dtype, device=device))
            channels = filters
            for level in range(min_level, max_level + 1):
                self.add_module(f"conv{i}_p{level}_bn", BatchNorm(
                    filters, bn_epsilon, dtype, device=device))
        bias = (0.0 if prediction_bias_prior is None else
                -math.log((1.0 - prediction_bias_prior)
                          / prediction_bias_prior))
        self.prediction = Conv2D(
            channels, output_filters, 3, separable=separable_conv,
            kernel_init=kernel_init, bias_value=bias, dtype=torch.float32,
            device=device)

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        outputs = {}
        for level in range(self.min_level, self.max_level + 1):
            key = str(level)
            x = features[key]
            for i in range(self.num_convs):
                x = getattr(self, f"conv{i}")(x)
                x = getattr(self, f"conv{i}_p{key}_bn")(x)
                x = self.activation(x)
            y = self.prediction(x.to(torch.float32))
            outputs[key] = y.permute(0, 2, 3, 1)
        return outputs


def build_detection_heads(head_params, in_channels: int, min_level: int,
                          max_level: int, separable_conv: bool,
                          bn_epsilon: float, activation: Callable,
                          dtype: torch.dtype, device=None):
    """(box_head, class_head)."""
    common = dict(
        in_channels=in_channels,
        num_convs=int(head_params.num_convs),
        filters=int(head_params.filters),
        min_level=min_level, max_level=max_level,
        separable_conv=separable_conv, bn_epsilon=bn_epsilon,
        activation=activation, dtype=dtype, device=device)
    box_head = DetectionHead(
        output_filters=int(head_params.num_anchors) * 4,
        prediction_bias_prior=None, **common)
    class_head = DetectionHead(
        output_filters=(int(head_params.num_anchors)
                        * int(head_params.num_classes)),
        prediction_bias_prior=0.01, **common)
    return box_head, class_head


def build_auxillary_head(*args, **kwargs):
    raise NotImplementedError(
        "The auxiliary IoU head is not ported yet: ROADMAP Queue 1 #5 (rest "
        "of the model zoo)")
