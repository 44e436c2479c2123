"""EfficientNet backbones (counterpart of
`retinanet_tpu/models/efficientnet.py`).

* Block strings such as 'r1_k3_s11_e1_i32_o16_se0.25', the b0-b8, l2 and
  lite0-lite4 coefficient tables, width and depth rounding (depth divisor
  8, never more than 10% down).
* MBConv: expand 1x1 -> depthwise kxk -> squeeze-excite -> project 1x1,
  with an identity skip; the fused form (one kxk conv in place of expand
  and depthwise) and `conv_type == 1` (no depthwise).
* Lite variants: relu6, no squeeze-excite, stem and first / last stage not
  scaled (`fix_head_stem`).
* Conv kernels start from normal(stddev sqrt(2 / fan_out)).
* `forward` takes NCHW and returns {'2': reduction 2, ..., '5': reduction 5}.

Channels are carried by hand where flax infers them. A block knows its
declared input filters (which decide the skip and the squeeze-excite width)
and the channels that really reach it: with `fix_head_stem` the stem keeps
32 while block 0 declares `round_filters(32, w)`, and its depthwise conv
runs over the 32.

Stochastic depth engages only in training and only when a
`torch.Generator` is passed to `forward`, as the JAX model drops only
when a 'dropout' rng is given; the train step passes none.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.models.layers import BatchNorm, ConvParams, conv2d, \
    conv2d_same, spatial_mean
from retinanet_torch.parallel import distributed


class BlockArgs(NamedTuple):
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    id_skip: bool
    strides: int
    se_ratio: Optional[float]
    conv_type: int
    fused_conv: bool


DEFAULT_BLOCKS = (
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25",
    "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25",
    "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
)

# (width_coefficient, depth_coefficient, resolution, dropout_rate)
PARAMS_B = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}
PARAMS_LITE = {
    "efficientnet-lite0": (1.0, 1.0, 224, 0.2),
    "efficientnet-lite1": (1.0, 1.1, 240, 0.2),
    "efficientnet-lite2": (1.1, 1.2, 260, 0.3),
    "efficientnet-lite3": (1.2, 1.4, 280, 0.3),
    "efficientnet-lite4": (1.4, 1.8, 300, 0.3),
}

_ACTIVATIONS = {"swish": F.silu, "relu6": F.relu6, "relu": F.relu}


def decode_block_string(block_string: str) -> BlockArgs:
    options = {}
    for op in block_string.split("_"):
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            options[splits[0]] = splits[1]
    if "s" not in options or len(options["s"]) != 2:
        raise ValueError("Strides options should be a pair of integers.")
    if options["s"][0] != options["s"][1]:
        raise ValueError("Only square strides are supported.")
    if int(options.get("p", 0)) != 0:
        raise NotImplementedError(
            "super_pixel blocks are not supported (no shipped spec uses "
            "them)")
    if "cc" in block_string:
        raise NotImplementedError("condconv is not supported")
    return BlockArgs(
        kernel_size=int(options["k"]),
        num_repeat=int(options["r"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        expand_ratio=int(options["e"]),
        id_skip="noskip" not in block_string,
        strides=int(options["s"][0]),
        se_ratio=float(options["se"]) if "se" in options else None,
        conv_type=int(options.get("c", 0)),
        fused_conv=bool(int(options.get("f", 0))),
    )


def round_filters(filters: int, width_coefficient: Optional[float],
                  depth_divisor: int = 8, skip: bool = False) -> int:
    if skip or not width_coefficient:
        return int(filters)
    filters *= width_coefficient
    new_filters = max(depth_divisor,
                      int(filters + depth_divisor / 2)
                      // depth_divisor * depth_divisor)
    if new_filters < 0.9 * filters:
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: Optional[float],
                  skip: bool = False) -> int:
    if skip or not depth_coefficient:
        return int(repeats)
    return int(math.ceil(depth_coefficient * repeats))


def drop_connect(x: torch.Tensor, uniform: torch.Tensor,
                 survival_prob: float) -> torch.Tensor:
    """Stochastic depth on a (B, 1, 1, 1) draw `uniform` from [0, 1), in
    x's dtype: each image's branch is kept, scaled by 1 / survival_prob,
    when survival_prob + uniform >= 1, and zeroed otherwise."""
    binary = torch.floor(survival_prob + uniform)
    return x / survival_prob * binary


def _uniform(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw a image for `drop_connect`, made on the generator's device.
    Under a process grid the draws are those of the global batch, of which
    this process takes its data index's slice: each image gets the draw one
    process gives it, and every band of an image the same one."""
    grid = distributed.grid()
    n = x.shape[0]
    u = torch.rand((n * grid.data_count, 1, 1, 1), generator=generator,
                   dtype=x.dtype, device=generator.device)
    return u[grid.data_index * n:(grid.data_index + 1) * n].to(x.device)


def _conv(cin, cout, k, groups=1, use_bias=False, device=None):
    return ConvParams(cin, cout, k, groups=groups, use_bias=use_bias,
                      init="fan_out", device=device)


class SqueezeExcite(nn.Module):
    """Mean over H, W (accumulated in float32) -> 1x1 conv -> act -> 1x1
    conv -> sigmoid gate on the input."""

    def __init__(self, channels: int, se_filters: int, act: Callable,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.reduce = _conv(channels, se_filters, 1, use_bias=True,
                            device=device)
        self.expand = _conv(se_filters, channels, 1, use_bias=True,
                            device=device)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = spatial_mean(x)
        se = self.act(conv2d(se.to(x.dtype), self.reduce, 1, 0, self.dtype))
        se = conv2d(se, self.expand, 1, 0, self.dtype)
        return torch.sigmoid(se) * x


class MBConvBlock(nn.Module):
    """One MBConv block; `in_channels` is what reaches it, `args` what it
    declares."""

    def __init__(self, args: BlockArgs, in_channels: int, use_se: bool,
                 act: Callable, bn_epsilon: float,
                 survival_prob: Optional[float], dtype: torch.dtype,
                 device=None):
        super().__init__()
        a = args
        self.args = a
        self.act = act
        self.survival_prob = survival_prob
        self.dtype = dtype
        filters = a.input_filters * a.expand_ratio
        k = a.kernel_size

        def bn(channels):
            return BatchNorm(channels, bn_epsilon, dtype, device=device)

        self.has_expand = a.expand_ratio != 1
        if a.conv_type == 1:
            channels = in_channels
            if self.has_expand:
                self.expand_conv = _conv(in_channels, filters, k,
                                         device=device)
                self.bn0 = bn(filters)
                channels = filters
            self.project_conv = _conv(channels, a.output_filters, 1,
                                      device=device)
            self.bn1 = bn(a.output_filters)
        else:
            if a.fused_conv:
                self.fused_conv = _conv(in_channels, filters, k,
                                        device=device)
                self.bn1 = bn(filters)
                channels = filters
            else:
                channels = in_channels
                if self.has_expand:
                    self.expand_conv = _conv(in_channels, filters, 1,
                                             device=device)
                    self.bn0 = bn(filters)
                    channels = filters
                self.depthwise_conv = _conv(channels, channels, k,
                                            groups=channels, device=device)
                self.bn1 = bn(channels)
            self.use_se = bool(use_se and a.se_ratio
                               and 0 < a.se_ratio <= 1)
            if self.use_se:
                se_filters = max(1, int(a.input_filters * a.se_ratio))
                self.se = SqueezeExcite(channels, se_filters, act, dtype,
                                        device)
            self.project_conv = _conv(channels, a.output_filters, 1,
                                      device=device)
            self.bn2 = bn(a.output_filters)
        self.skip = (a.id_skip and a.strides == 1
                     and a.input_filters == a.output_filters)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a, dt = self.args, self.dtype
        inputs = x
        if a.conv_type == 1:
            if self.has_expand:
                x = self.act(self.bn0(conv2d_same(x, self.expand_conv, 1,
                                                  dt)))
            x = self.bn1(conv2d_same(x, self.project_conv, a.strides, dt))
        else:
            if a.fused_conv:
                x = self.act(self.bn1(conv2d_same(x, self.fused_conv,
                                                  a.strides, dt)))
            else:
                if self.has_expand:
                    x = self.act(self.bn0(conv2d(x, self.expand_conv, 1, 0,
                                                 dt)))
                x = self.act(self.bn1(conv2d_same(x, self.depthwise_conv,
                                                  a.strides, dt)))
            if self.use_se:
                x = self.se(x)
            x = self.bn2(conv2d(x, self.project_conv, 1, 0, dt))
        if self.skip:
            if (self.training and self.survival_prob
                    and generator is not None):
                x = drop_connect(x, _uniform(x, generator),
                                 self.survival_prob)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone emitting {'2'..'5'} = reduction_2..reduction_5, with
    `out_channels` per endpoint."""

    def __init__(self, width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0,
                 blocks: Sequence[str] = DEFAULT_BLOCKS,
                 use_se: bool = True, fix_head_stem: bool = False,
                 activation: str = "swish", survival_prob: float = 0.8,
                 bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device=None):
        super().__init__()
        act = _ACTIVATIONS[activation]
        self.act = act
        self.dtype = dtype
        decoded = [decode_block_string(s) for s in blocks]

        stem_filters = round_filters(decoded[0].input_filters,
                                     width_coefficient, skip=fix_head_stem)
        self.stem_conv = _conv(in_channels, stem_filters, 3, device=device)
        self.stem_bn = BatchNorm(stem_filters, bn_epsilon, dtype,
                                 device=device)

        all_blocks: List[BlockArgs] = []
        n_stages = len(decoded)
        for i, args in enumerate(decoded):
            in_f = round_filters(args.input_filters, width_coefficient)
            out_f = round_filters(args.output_filters, width_coefficient)
            repeats = round_repeats(
                args.num_repeat, depth_coefficient,
                skip=fix_head_stem and (i == 0 or i == n_stages - 1))
            args = args._replace(input_filters=in_f, output_filters=out_f,
                                 num_repeat=repeats)
            all_blocks.append(args)
            for _ in range(repeats - 1):
                all_blocks.append(args._replace(input_filters=out_f,
                                                strides=1))

        self.num_blocks = len(all_blocks)
        self.endpoints: Dict[int, str] = {}
        self.out_channels: Dict[str, int] = {}
        channels = stem_filters
        reduction_idx = 0
        n = len(all_blocks)
        for idx, args in enumerate(all_blocks):
            sp = None
            if survival_prob:
                sp = 1.0 - (1.0 - survival_prob) * float(idx) / n
            self.add_module(f"blocks_{idx}", MBConvBlock(
                args, channels, use_se, act, bn_epsilon, sp, dtype, device))
            channels = args.output_filters
            if idx == n - 1 or all_blocks[idx + 1].strides > 1:
                reduction_idx += 1
                if 2 <= reduction_idx <= 5:
                    self.endpoints[idx] = str(reduction_idx)
                    self.out_channels[str(reduction_idx)] = channels

    @classmethod
    def from_name(cls, model_name: str, bn_epsilon: float = 1e-3,
                  dtype: torch.dtype = torch.float32,
                  override_params: Optional[Dict] = None,
                  device=None) -> "EfficientNet":
        if model_name in PARAMS_B:
            w, d, _, _ = PARAMS_B[model_name]
            cfg = dict(width_coefficient=w, depth_coefficient=d,
                       use_se=True, fix_head_stem=False, activation="swish")
        elif model_name in PARAMS_LITE:
            w, d, _, _ = PARAMS_LITE[model_name]
            cfg = dict(width_coefficient=w, depth_coefficient=d,
                       use_se=False, fix_head_stem=True, activation="relu6")
        else:
            raise ValueError(f"Unknown EfficientNet variant: {model_name}")
        cfg.update(dict(override_params or {}))
        return cls(bn_epsilon=bn_epsilon, dtype=dtype, device=device, **cfg)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        x = self.act(self.stem_bn(conv2d_same(x, self.stem_conv, 2,
                                              self.dtype)))
        outputs = {}
        for idx in range(self.num_blocks):
            x = getattr(self, f"blocks_{idx}")(x, generator)
            if idx in self.endpoints:
                outputs[self.endpoints[idx]] = x
        return outputs
