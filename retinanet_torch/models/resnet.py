"""Post-activation ResNet v1 backbones (counterpart of
`retinanet_tpu/models/resnet.py`).

Depths 10..200, a 7x7/2 stem and a 3x3/2 "SAME" max pool, explicit fixed
padding for strided convs, convs without bias, zero-initialised gamma on
each block's last BN, and ReLU throughout. `forward` takes an NCHW tensor
and returns {'2': C2, '3': C3, '4': C4, '5': C5} in NCHW.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from retinanet_torch.models.layers import BatchNorm, ConvParams, conv2d, \
    max_pool, recomputing

MODEL_CONFIG = {
    10: ("residual", (1, 1, 1, 1)),
    14: ("bottleneck", (1, 1, 1, 1)),
    18: ("residual", (2, 2, 2, 2)),
    26: ("bottleneck", (2, 2, 2, 2)),
    34: ("residual", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


class ConvFixedPadding(nn.Module):
    """Conv without bias; a strided conv pads (k-1)//2 before and the rest
    after, whatever the input size, then runs VALID; stride 1 is "SAME"."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv = ConvParams(in_channels, filters, kernel_size,
                               use_bias=False, device=device)
        self.kernel_size = kernel_size
        self.strides = strides
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strides == 1:
            return conv2d(x, self.conv, 1, self.kernel_size // 2, self.dtype)
        pad_total = self.kernel_size - 1
        beg = pad_total // 2
        end = pad_total - beg
        if pad_total:
            x = F.pad(x, (beg, end, beg, end))
        return conv2d(x, self.conv, self.strides, 0, self.dtype)


class ResidualBlock(nn.Module):
    """Basic 2-conv residual block."""
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int,
                 use_projection: bool, bn_epsilon: float,
                 dtype: torch.dtype, device=None):
        super().__init__()

        def bn(zero_init=False):
            return BatchNorm(filters, bn_epsilon, dtype,
                             zero_init=zero_init, device=device)

        self.use_projection = use_projection
        if use_projection:
            self.proj = ConvFixedPadding(in_channels, filters, 1, strides,
                                         dtype, device)
            self.proj_bn = bn()
        self.conv1 = ConvFixedPadding(in_channels, filters, 3, strides,
                                      dtype, device)
        self.bn1 = bn()
        self.conv2 = ConvFixedPadding(filters, filters, 3, 1, dtype, device)
        self.bn2 = bn(zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.proj_bn(self.proj(x)) if self.use_projection else x
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.bn2(self.conv2(x))
        return F.relu(x + shortcut)


class BottleneckBlock(nn.Module):
    """1-3-1 bottleneck block, 4x expansion."""
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int,
                 use_projection: bool, bn_epsilon: float,
                 dtype: torch.dtype, device=None):
        super().__init__()

        def bn(channels, zero_init=False):
            return BatchNorm(channels, bn_epsilon, dtype,
                             zero_init=zero_init, device=device)

        self.use_projection = use_projection
        if use_projection:
            self.proj = ConvFixedPadding(in_channels, 4 * filters, 1,
                                         strides, dtype, device)
            self.proj_bn = bn(4 * filters)
        self.conv1 = ConvFixedPadding(in_channels, filters, 1, 1, dtype,
                                      device)
        self.bn1 = bn(filters)
        self.conv2 = ConvFixedPadding(filters, filters, 3, strides, dtype,
                                      device)
        self.bn2 = bn(filters)
        self.conv3 = ConvFixedPadding(filters, 4 * filters, 1, 1, dtype,
                                      device)
        self.bn3 = bn(4 * filters, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.proj_bn(self.proj(x)) if self.use_projection else x
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))
        return F.relu(x + shortcut)


def _remat_contexts():
    # (first forward, second forward in the backward pass)
    return contextlib.nullcontext(), recomputing()


class BlockGroup(nn.Module):
    """First block projects and strides; the rest are identity blocks.

    With `remat`, a training forward keeps only each block's input and runs
    the block again in the backward pass (`torch.utils.checkpoint`): compute
    for activation memory, for high-resolution configs. The second run
    leaves the BatchNorm running statistics alone. Parameter names and
    values are the same with or without it."""

    def __init__(self, in_channels: int, filters: int, block_type: str,
                 blocks: int, strides: int, bn_epsilon: float,
                 dtype: torch.dtype, remat: bool = False, device=None):
        super().__init__()
        self.remat = remat
        block_cls = (BottleneckBlock if block_type == "bottleneck"
                     else ResidualBlock)
        self.num_blocks = blocks
        channels = in_channels
        for i in range(blocks):
            self.add_module(f"block{i}", block_cls(
                channels, filters, strides if i == 0 else 1,
                use_projection=(i == 0), bn_epsilon=bn_epsilon, dtype=dtype,
                device=device))
            channels = filters * block_cls.expansion
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.num_blocks):
            block = getattr(self, f"block{i}")
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=_remat_contexts)
            else:
                x = block(x)
        return x


class ResNet(nn.Module):
    """ResNet backbone emitting {'2': C2, '3': C3, '4': C4, '5': C5}.

    `remat` recomputes each block in the backward pass of a training step
    (see `BlockGroup`); it changes nothing in eval mode."""

    def __init__(self, depth: int = 50, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32,
                 remat: bool = False, in_channels: int = 3, device=None):
        super().__init__()
        if depth not in MODEL_CONFIG:
            raise ValueError(f"Unsupported ResNet depth: {depth}")
        block_type, layers = MODEL_CONFIG[depth]
        self.stem = ConvFixedPadding(in_channels, 64, 7, 2, dtype, device)
        self.stem_bn = BatchNorm(64, bn_epsilon, dtype,
                                 device=device)
        channels = 64
        self.out_channels = {}
        for i, (filters, strides) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2))):
            group = BlockGroup(channels, filters, block_type, layers[i],
                               strides, bn_epsilon, dtype, remat, device)
            self.add_module(f"group{i + 1}", group)
            channels = group.out_channels
            self.out_channels[str(i + 2)] = channels

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = max_pool(x, 3, 2, padding="SAME")
        outputs = {}
        for i in range(4):
            x = getattr(self, f"group{i + 1}")(x)
            outputs[str(i + 2)] = x
        return outputs
