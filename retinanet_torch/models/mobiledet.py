"""MobileDet backbones (counterpart of `retinanet_tpu/models/mobiledet.py`).

Four hand-written variants (cpu / dsp / edge_tpu / gpu) built from:
  * conv: conv with a bias, then BN, then the activation;
  * depthwise conv with a bias, its init stddev sqrt(2 / k^2) / 0.8796
    before the cut at two standard deviations;
  * squeeze-excite with hidden width scale_filters(channels, 0.25);
  * inverted bottleneck, with or without expansion; fused conv; Tucker
    conv;
  * swish6, h * relu6(h + 3) / 6, for the cpu variant, relu6 for the rest;
  * base-8 filter scaling by `multiplier`;
emitting endpoints {'1'..'5'}, with `out_channels` per endpoint.

The flax model names every conv, depthwise conv and BN from one counter
per backbone (`conv_1`, `bn_2`, `dwconv_3`, ...), flat under the backbone.
The builder below makes the torch modules in the same order under the same
names, and records what `forward` runs as a list of steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.models.layers import _TRUNC_STD_CORRECTION, \
    BatchNorm, ConvParams, conv2d_same, spatial_mean, swish6


def scale_filters(filters: int, multiplier: float, base: int = 8) -> int:
    round_half_up = int(int(filters) * multiplier / base + 0.5)
    return max(int(round_half_up * base), base)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Builder:
    """Registers the modules of one variant on `module` in flax's order and
    appends the steps of its forward to `steps`:
      ("conv", conv name, bn name or None, stride, activation),
      ("se", first conv name, second conv name),
      ("save",) / ("add",) around a residual block,
      ("endpoint", key)."""

    def __init__(self, module: nn.Module, act: Callable, bn_epsilon: float,
                 dtype: torch.dtype, channels: int, device):
        self.m = module
        self.act = act
        self.bn_epsilon = bn_epsilon
        self.dtype = dtype
        self.ch = channels
        self.device = device
        self.counter = 0
        self.steps: List[Tuple] = []
        self.out_channels: Dict[str, int] = {}

    def _name(self, kind: str) -> str:
        self.counter += 1
        return f"{kind}_{self.counter}"

    def _bn(self, channels: int) -> str:
        name = self._name("bn")
        self.m.add_module(name, BatchNorm(channels, self.bn_epsilon,
                                          self.dtype, device=self.device))
        return name

    def endpoint(self, key: str) -> None:
        self.steps.append(("endpoint", key))
        self.out_channels[key] = self.ch

    def conv(self, filters, kernel_size, strides=1, use_bn=True,
             act: Optional[Callable] = None):
        name = self._name("conv")
        self.m.add_module(name, ConvParams(self.ch, filters, kernel_size,
                                           device=self.device))
        bn = self._bn(filters) if use_bn else None
        self.steps.append(("conv", name, bn, strides,
                           self.act if act is None else act))
        self.ch = filters

    def depthwise(self, kernel_size, strides=1):
        name = self._name("dwconv")
        std = (2.0 / kernel_size ** 2) ** 0.5 / _TRUNC_STD_CORRECTION
        self.m.add_module(name, ConvParams(
            self.ch, self.ch, kernel_size, groups=self.ch,
            init="truncated_normal", init_std=std, device=self.device))
        bn = self._bn(self.ch)
        self.steps.append(("conv", name, bn, strides, self.act))

    def squeeze_excite(self, hidden_dim):
        ch = self.ch
        first = self._name("conv")
        self.m.add_module(first, ConvParams(ch, hidden_dim, 1,
                                            device=self.device))
        second = self._name("conv")
        self.m.add_module(second, ConvParams(hidden_dim, ch, 1,
                                             device=self.device))
        self.steps.append(("se", first, second))

    def _residual(self, residual, body):
        if residual:
            self.steps.append(("save",))
        body()
        if residual:
            self.steps.append(("add",))

    # -- blocks --------------------------------------------------------------

    def ibn_no_expansion(self, filters, kernel_size=3, strides=1,
                         use_se=False):
        ch = self.ch
        self.depthwise(kernel_size, strides)
        if use_se:
            self.squeeze_excite(scale_filters(ch, 0.25))
        self.conv(filters, 1, act=_identity)

    def ibn(self, filters, kernel_size=3, expansion=8, strides=1,
            use_se=False, residual=True):
        def body():
            expanded = self.ch * expansion
            self.conv(expanded, 1)
            self.depthwise(kernel_size, strides)
            if use_se:
                self.squeeze_excite(scale_filters(expanded, 0.25))
            self.conv(filters, 1, act=_identity)
        self._residual(residual, body)

    def fused(self, filters, kernel_size=3, expansion=8, strides=1,
              use_se=False, residual=True):
        def body():
            expanded = self.ch * expansion
            self.conv(expanded, kernel_size, strides=strides)
            if use_se:
                self.squeeze_excite(scale_filters(expanded, 0.25))
            self.conv(filters, 1, act=_identity)
        self._residual(residual, body)

    def tucker(self, filters, kernel_size=3, input_rank_ratio=0.25,
               output_rank_ratio=0.25, strides=1, residual=True):
        def body():
            self.conv(scale_filters(self.ch, input_rank_ratio), 1)
            self.conv(scale_filters(filters, output_rank_ratio), kernel_size,
                      strides=strides)
            self.conv(filters, 1, act=_identity)
        self._residual(residual, body)


def _cpu(c: _Builder, s):
    c.conv(s(16), 3, strides=2)
    c.ibn_no_expansion(s(8), use_se=True)
    c.endpoint("1")
    c.ibn(s(16), expansion=4, strides=2, use_se=True, residual=False)
    c.endpoint("2")
    c.ibn(s(32), expansion=8, strides=2, use_se=True, residual=False)
    for _ in range(3):
        c.ibn(s(32), expansion=4, use_se=True)
    c.endpoint("3")
    c.ibn(s(72), kernel_size=5, expansion=8, strides=2, use_se=True,
          residual=False)
    c.ibn(s(72), expansion=8, use_se=True)
    c.ibn(s(72), kernel_size=5, expansion=4, use_se=True)
    c.ibn(s(72), expansion=4, use_se=True)
    c.ibn(s(72), expansion=8, use_se=True, residual=False)
    for _ in range(3):
        c.ibn(s(72), expansion=8, use_se=True)
    c.endpoint("4")
    c.ibn(s(104), kernel_size=5, expansion=8, strides=2, use_se=True,
          residual=False)
    c.ibn(s(104), kernel_size=5, expansion=4, use_se=True)
    c.ibn(s(104), kernel_size=5, expansion=4, use_se=True)
    c.ibn(s(104), expansion=4, use_se=True)
    c.ibn(s(144), expansion=8, use_se=True, residual=False)
    c.endpoint("5")


def _dsp(c: _Builder, s):
    c.conv(s(32), 3, strides=2)
    c.ibn_no_expansion(s(24))
    c.endpoint("1")
    c.fused(s(32), expansion=4, strides=2, residual=False)
    c.fused(s(32), expansion=4)
    c.ibn(s(32), expansion=4)
    c.tucker(s(32), input_rank_ratio=0.25, output_rank_ratio=0.75)
    c.endpoint("2")
    c.fused(s(64), expansion=8, strides=2, residual=False)
    c.ibn(s(64), expansion=4)
    c.fused(s(64), expansion=4)
    c.fused(s(64), expansion=4)
    c.endpoint("3")
    c.fused(s(120), expansion=8, strides=2, residual=False)
    c.ibn(s(120), expansion=4)
    c.ibn(s(120), expansion=8)
    c.ibn(s(120), expansion=8)
    c.fused(s(144), expansion=8, residual=False)
    c.ibn(s(144), expansion=8)
    c.ibn(s(144), expansion=8)
    c.ibn(s(144), expansion=8)
    c.endpoint("4")
    c.ibn(s(160), expansion=4, strides=2, residual=False)
    c.ibn(s(160), expansion=4)
    c.fused(s(160), expansion=4)
    c.tucker(s(160), input_rank_ratio=0.75, output_rank_ratio=0.75)
    c.ibn(s(240), expansion=8, residual=False)
    c.endpoint("5")


def _edge_tpu(c: _Builder, s):
    c.conv(s(32), 3, strides=2)
    c.tucker(s(16), input_rank_ratio=0.25, output_rank_ratio=0.75,
             residual=False)
    c.endpoint("1")
    c.fused(s(16), expansion=8, strides=2, residual=False)
    c.fused(s(16), expansion=4)
    c.fused(s(16), expansion=8)
    c.fused(s(16), expansion=4)
    c.endpoint("2")
    c.fused(s(40), expansion=8, kernel_size=5, strides=2, residual=False)
    c.fused(s(40), expansion=4)
    c.fused(s(40), expansion=4)
    c.fused(s(40), expansion=4)
    c.endpoint("3")
    c.ibn(s(72), expansion=8, strides=2, residual=False)
    c.ibn(s(72), expansion=8)
    c.fused(s(72), expansion=4)
    c.fused(s(72), expansion=4)
    c.ibn(s(96), expansion=8, kernel_size=5, residual=False)
    c.ibn(s(96), expansion=8, kernel_size=5)
    c.ibn(s(96), expansion=8)
    c.ibn(s(96), expansion=8)
    c.endpoint("4")
    c.ibn(s(120), expansion=8, kernel_size=5, strides=2, residual=False)
    c.ibn(s(120), expansion=8)
    c.ibn(s(120), expansion=4, kernel_size=5)
    c.ibn(s(120), expansion=8)
    c.ibn(s(384), expansion=8, kernel_size=5, residual=False)
    c.endpoint("5")


def _gpu(c: _Builder, s):
    c.conv(s(32), 3, strides=2)
    c.tucker(s(16), input_rank_ratio=0.25, output_rank_ratio=0.25,
             residual=False)
    c.endpoint("1")
    c.fused(s(32), expansion=8, strides=2, residual=False)
    for _ in range(3):
        c.tucker(s(32), input_rank_ratio=0.25, output_rank_ratio=0.25)
    c.endpoint("2")
    c.fused(s(64), expansion=8, strides=2, residual=False)
    c.fused(s(64), expansion=8)
    c.fused(s(64), expansion=8)
    c.fused(s(64), expansion=4)
    c.endpoint("3")
    c.fused(s(128), expansion=8, strides=2, residual=False)
    for _ in range(3):
        c.fused(s(128), expansion=4)
    c.fused(s(128), expansion=8, residual=False)
    for _ in range(3):
        c.fused(s(128), expansion=8)
    c.endpoint("4")
    c.fused(s(128), expansion=4, strides=2, residual=False)
    for _ in range(3):
        c.fused(s(128), expansion=4)
    c.ibn(s(384), expansion=8, residual=False)
    c.endpoint("5")


_VARIANTS = {
    "mobiledet_cpu": (_cpu, swish6),
    "mobiledet_dsp": (_dsp, F.relu6),
    "mobiledet_edge_tpu": (_edge_tpu, F.relu6),
    "mobiledet_gpu": (_gpu, F.relu6),
}


class MobileDet(nn.Module):
    """Backbone emitting {'1'..'5'} endpoints."""

    def __init__(self, variant: str = "mobiledet_edge_tpu",
                 multiplier: float = 1.0, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device=None):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"Unknown MobileDet variant: {variant}. "
                             f"Available: {sorted(_VARIANTS)}")
        build_fn, act = _VARIANTS[variant]
        self.dtype = dtype
        builder = _Builder(self, act, bn_epsilon, dtype, in_channels, device)
        build_fn(builder, lambda f: scale_filters(f, multiplier))
        self.act = act
        self.steps = builder.steps
        self.out_channels = builder.out_channels

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs, shortcut = {}, None
        for step in self.steps:
            kind = step[0]
            if kind == "conv":
                _, conv, bn, strides, act = step
                x = conv2d_same(x, getattr(self, conv), strides, self.dtype)
                if bn is not None:
                    x = getattr(self, bn)(x)
                x = act(x)
            elif kind == "se":
                u = spatial_mean(x)
                u = self.act(conv2d_same(u.to(x.dtype), getattr(self, step[1]),
                                         1, self.dtype))
                u = torch.sigmoid(conv2d_same(u, getattr(self, step[2]), 1,
                                              self.dtype))
                x = u * x
            elif kind == "save":
                shortcut = x
            elif kind == "add":
                x = x + shortcut
            else:
                outputs[step[1]] = x
        return outputs
