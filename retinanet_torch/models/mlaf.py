"""Multi-Level Attention Fusion necks (counterpart of
`retinanet_tpu/models/mlaf.py`).

* A lateral 1x1 conv (first block only), BN and relu on each backbone
  level.
* For each target level, every level resized to it (nearest upsample /
  VALID max pool), summed, averaged over H, W (in float32), projected
  (1x1 conv, BN over the B values of the (B, C, 1, 1) map, relu), turned
  into one weight a level (a weight a level and channel with
  `use_channel_attention`) by a 1x1 conv and a softmax over the levels,
  and the levels summed with those weights.
* Extra levels by stride-2 3x3 convs: P6 from the P5 output before its
  BN, deeper levels from the relu of the level above; an output BN on
  every level.

`StackedMultiLevelAttentionFusion` chains `num_repeats` blocks (`mlaf_1`,
...): the lateral convs only in the first, the levels above the backbone
only in the last.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.models.layers import (BatchNorm, Conv2D, max_pool,
                                           nearest_upsample, spatial_mean)


class MultiLevelAttentionFusion(nn.Module):
    def __init__(self, in_channels: Dict[str, int], filters: int = 256,
                 projection_dim: int = 64, min_level: int = 3,
                 max_level: int = 7, backbone_max_level: int = 5,
                 use_lateral_conv: bool = True,
                 use_channel_attention: bool = True,
                 use_bias_before_bn: bool = False,
                 separable_conv: bool = False, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.min_level = min_level
        self.max_level = max_level
        self.backbone_max_level = backbone_max_level
        self.use_lateral_conv = use_lateral_conv
        self.num_features = backbone_max_level - min_level + 1
        self.att_channels = filters if use_channel_attention else 1

        def conv(cin, cout, kernel_size=1, strides=1,
                 use_bias=use_bias_before_bn):
            return Conv2D(cin, cout, kernel_size, strides, use_bias,
                          separable=separable_conv, dtype=dtype,
                          device=device)

        def bn(channels):
            return BatchNorm(channels, bn_epsilon, dtype, device=device)

        channels = None
        for level in range(min_level, backbone_max_level + 1):
            channels = in_channels[str(level)]
            if use_lateral_conv:
                self.add_module(f"l{level}_conv", conv(channels, filters))
                channels = filters
            self.add_module(f"l{level}_intermediate_bn", bn(channels))
        # every level reaching the fusion has this many channels
        for level in range(min_level, backbone_max_level + 1):
            self.add_module(f"l{level}_projection_conv",
                            conv(channels, projection_dim))
            self.add_module(f"l{level}_projection_bn", bn(projection_dim))
            self.add_module(f"l{level}_attention_conv", conv(
                projection_dim, self.num_features * self.att_channels,
                use_bias=True))
        for level in range(min_level, max_level + 1):
            stride = 2 if level > backbone_max_level else 1
            self.add_module(f"p{level}_conv", conv(
                channels if level <= backbone_max_level else filters,
                filters, 3, stride))
            self.add_module(f"p{level}_bn", bn(filters))

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        m = lambda name: getattr(self, name)  # noqa: E731
        levels = range(self.min_level, self.backbone_max_level + 1)
        intermediate = {}
        for level in levels:
            x = features[str(level)]
            if self.use_lateral_conv:
                x = m(f"l{level}_conv")(x)
            intermediate[level] = F.relu(m(f"l{level}_intermediate_bn")(x))

        outputs = {}
        for current in levels:
            fused = []
            for level in levels:
                x = intermediate[level]
                if level > current:
                    x = nearest_upsample(x, 2 ** (level - current))
                elif level < current:
                    f = 2 ** (current - level)
                    x = max_pool(x, f, f, padding="VALID")
                fused.append(x)
            summed = sum(fused)
            stacked = torch.stack(fused, 1)                 # (B,L,C,H,W)

            g = spatial_mean(summed).to(summed.dtype)
            g = m(f"l{current}_projection_conv")(g)
            g = F.relu(m(f"l{current}_projection_bn")(g))
            att = m(f"l{current}_attention_conv")(g)        # (B,L*att,1,1)
            att = att.view(att.shape[0], self.num_features,
                           self.att_channels, 1, 1)
            att = torch.softmax(att, dim=1)
            outputs[current] = (stacked * att).sum(1)

        for level in range(self.min_level, self.max_level + 1):
            if level <= self.backbone_max_level:
                x = outputs[level]
            elif level == self.backbone_max_level + 1:
                x = outputs[level - 1]
            else:
                x = F.relu(outputs[level - 1])
            outputs[level] = m(f"p{level}_conv")(x)

        return {str(l): m(f"p{l}_bn")(outputs[l])
                for l in range(self.min_level, self.max_level + 1)}


class StackedMultiLevelAttentionFusion(nn.Module):
    def __init__(self, in_channels: Dict[str, int], filters: int = 256,
                 projection_dim: int = 64, num_repeats: int = 2,
                 min_level: int = 3, max_level: int = 7,
                 backbone_max_level: int = 5,
                 use_channel_attention: bool = True,
                 use_bias_before_bn: bool = False,
                 separable_conv: bool = False, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_repeats = num_repeats
        channels = in_channels
        for i in range(num_repeats):
            block_max = (max_level if i == num_repeats - 1
                         else backbone_max_level)
            self.add_module(f"mlaf_{i + 1}", MultiLevelAttentionFusion(
                channels, filters=filters, projection_dim=projection_dim,
                min_level=min_level, max_level=block_max,
                backbone_max_level=backbone_max_level,
                use_lateral_conv=(i == 0),
                use_channel_attention=use_channel_attention,
                use_bias_before_bn=use_bias_before_bn,
                separable_conv=separable_conv, bn_epsilon=bn_epsilon,
                dtype=dtype, device=device))
            channels = {str(l): filters
                        for l in range(min_level, block_max + 1)}

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        for i in range(self.num_repeats):
            features = getattr(self, f"mlaf_{i + 1}")(features)
        return features
