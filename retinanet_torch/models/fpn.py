"""Feature Pyramid Network neck (counterpart of `retinanet_tpu/models/fpn.py`).

* Coarse levels P6..P(max) come from the raw backbone max level through its
  own 1x1 conv + BN, then a chain of 2x2/2 VALID max pools.
* Backbone levels get a 1x1 lateral conv + BN.
* Top-down: nearest x2 upsample, cropped to the lower level's size, fused
  (sum / fast attention) and activated.
* Each level ends in a 3x3 conv + BN. FPN convs keep their bias.

`FPNP5` waits for ROADMAP Queue 1 #5.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.models.layers import (BatchNorm, Conv2D, FeatureFusion,
                                           max_pool, nearest_upsample)


class FPN(nn.Module):
    def __init__(self, in_channels: Dict[str, int], filters: int = 256,
                 min_level: int = 3, max_level: int = 7,
                 backbone_max_level: int = 5, fusion_mode: str = "sum",
                 separable_conv: bool = False, bn_epsilon: float = 1e-3,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.min_level = min_level
        self.max_level = max_level
        self.backbone_max_level = backbone_max_level
        self.activation = activation

        def conv(cin, kernel_size):
            return Conv2D(cin, filters, kernel_size,
                          separable=separable_conv, dtype=dtype,
                          device=device)

        def bn():
            return BatchNorm(filters, bn_epsilon, dtype, device=device)

        if max_level > backbone_max_level:
            self.backbone_max_level_conv = conv(
                in_channels[str(backbone_max_level)], 1)
            self.backbone_max_level_bn = bn()
        for level in range(min_level, backbone_max_level + 1):
            self.add_module(f"p{level}_in_conv",
                            conv(in_channels[str(level)], 1))
            self.add_module(f"p{level}_in_bn", bn())
        for low in range(min_level, max_level):
            self.add_module(f"p{low}_fusion", FeatureFusion(
                fusion_mode, filters, dtype, device))
        for level in range(min_level, max_level + 1):
            self.add_module(f"p{level}_out_conv", conv(filters, 3))
            self.add_module(f"p{level}_out_bn", bn())

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        outputs = dict(features)
        m = lambda name: getattr(self, name)  # noqa: E731

        for level in range(self.backbone_max_level + 1, self.max_level + 1):
            x = outputs[str(level - 1)]
            if level == self.backbone_max_level + 1:
                x = self.backbone_max_level_bn(
                    self.backbone_max_level_conv(x))
            outputs[str(level)] = max_pool(x, 2, 2, padding="VALID")

        for level in range(self.min_level, self.backbone_max_level + 1):
            key = str(level)
            outputs[key] = m(f"p{key}_in_bn")(
                m(f"p{key}_in_conv")(outputs[key]))

        for level in range(self.max_level, self.min_level, -1):
            low = str(level - 1)
            up = nearest_upsample(outputs[str(level)], 2)
            up = up[:, :, :outputs[low].shape[2], :outputs[low].shape[3]]
            fused = m(f"p{low}_fusion")(outputs[low], up)
            outputs[low] = self.activation(fused)

        for level in range(self.min_level, self.max_level + 1):
            key = str(level)
            outputs[key] = m(f"p{key}_out_bn")(
                m(f"p{key}_out_conv")(outputs[key]))

        return {str(l): outputs[str(l)]
                for l in range(self.min_level, self.max_level + 1)}


class FPNP5(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FPNP5 is not ported yet: ROADMAP Queue 1 #5 (rest of the model "
            "zoo)")
