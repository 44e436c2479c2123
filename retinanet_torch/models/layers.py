"""Shared model building blocks (counterpart of
`retinanet_tpu/models/layers.py`).

Tensors are NCHW inside the model. Mixed precision is written out as flax
does it, with no autocast:
  * parameters are stored in float32;
  * a conv casts its input, kernel and bias to the compute dtype;
  * BatchNorm normalizes in float32 and casts back to the compute dtype.

Padding follows TF/flax "SAME": for a stride above 1 the end side may get one
more row than the beginning, which `padding=` of a torch conv or pool cannot
express, so it is padded explicitly (with -inf for max pools).

BatchNorm runs on its running statistics in eval mode and on batch
statistics, updating the running ones, in training mode.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from retinanet_torch.core.device import device_constant

_SUPPORTED_ACTIVATIONS = ("relu", "relu6", "swish")

# flax variance_scaling(1.0, "fan_in", "truncated_normal"): the normal is cut
# at two standard deviations and rescaled by this constant so that the
# truncated distribution keeps the variance 1 / fan_in.
_TRUNC_STD_CORRECTION = 0.87962566103423978


def get_activation(activation_type: str) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    if activation_type not in _SUPPORTED_ACTIVATIONS:
        raise ValueError(
            f"Unsupported activation '{activation_type}'. "
            f"Available: {_SUPPORTED_ACTIVATIONS}")
    return {"relu": F.relu, "relu6": F.relu6, "swish": F.silu}[
        activation_type]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(begin, end) padding of TF/flax "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvParams(nn.Module):
    """The parameters of one flax `nn.Conv`: `weight` (O, I/groups, kh, kw)
    from the flax HWIO `kernel`, and an optional `bias`.

    `init` names the flax kernel initializer: "variance_scaling" (fan-in,
    truncated normal) or "normal" (stddev 0.01)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1, use_bias: bool = True,
                 init: str = "variance_scaling", bias_value: float = 0.0,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size,
            device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if use_bias else None)
        self.groups = groups
        self.init = init
        self.bias_value = float(bias_value)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init == "normal":
            self.weight.normal_(0.0, 0.01, generator=generator)
        elif self.init == "variance_scaling":
            fan_in = self.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        else:
            raise ValueError(f"Unknown kernel init: {self.init}")
        if self.bias is not None:
            self.bias.fill_(self.bias_value)


def conv2d(x: torch.Tensor, p: ConvParams, stride: int, pad: int,
           dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv` in `dtype` (input, kernel and bias cast first) with
    `pad` zeros on every side: k // 2 is "SAME" for an odd kernel at stride
    1, 0 is "VALID"."""
    bias = None if p.bias is None else p.bias.to(dtype)
    return F.conv2d(x.to(dtype), p.weight.to(dtype), bias, stride, pad,
                    1, p.groups)


# True while a checkpointed block is run again in the backward pass: the
# running statistics were updated by the first run and must not move twice.
_RECOMPUTING = contextvars.ContextVar("bn_recomputing", default=False)


@contextlib.contextmanager
def recomputing():
    """Inside, a training-mode BatchNorm leaves its running statistics as
    they are (the second forward of `torch.utils.checkpoint`)."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


class _BatchStatsNorm(torch.autograd.Function):
    """(x - mean) * rsqrt(var + eps) * weight + bias for `mean` and `var`
    that are the batch statistics of `x` over (N, H, W), computed by the
    caller. Forward and backward are one fused ATen kernel each, in float32
    inside whatever the dtype of `x`; the backward is the BatchNorm gradient
    through the statistics, so `mean` and `var` come in without a graph.
    Only `x` is kept for the backward pass, in its own dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = torch.ops.aten.native_batch_norm_backward(
            grad_out, x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return dx, dweight, dbias, None, None, None


class BatchNorm(nn.Module):
    """flax BatchNorm: float32 statistics and arithmetic, output in `dtype`.

    Eval mode normalizes by the running statistics. Training mode takes the
    batch mean and the biased variance over (N, H, W) in float32, the
    variance as max(0, E[x^2] - E[x]^2) as flax computes it, and moves the
    running statistics by `ra = momentum * ra + (1 - momentum) * batch`, with
    the biased variance (torch's own update takes the unbiased one, so the
    buffers are updated here by hand). One card sees the whole batch, so
    `use_sync` has nothing to add.

    An input that already has `dtype` is not cast: the statistics are
    reduced and the normalization is computed in float32 from it (the casts
    happen inside the kernels), and the result is rounded to `dtype` once,
    as flax rounds it.

    `frozen = True` keeps one BatchNorm in eval mode inside a model that is
    in training mode (a frozen layer neither normalizes by batch moments nor
    moves its running statistics).

    The parameters sit in the child `bn` so that their names follow the
    flax paths (`<name>/bn/scale`). The running statistics are plain
    buffers (no `num_batches_tracked`)."""

    def __init__(self, channels: int, epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False,
                 momentum: float = 0.99, device=None):
        super().__init__()
        self.bn = _BNParams(channels, zero_init, device)
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.bn
        if x.dtype != self.dtype:
            x = x.to(torch.float32)
        if not self.training or self.frozen:
            y = F.batch_norm(x, p.running_mean, p.running_var, p.weight,
                             p.bias, False, 0.0, self.epsilon)
            return y.to(self.dtype)
        with torch.no_grad():
            dims = (0, 2, 3)
            count = x.numel() // x.shape[1]
            mean = x.mean(dim=dims, dtype=torch.float32)
            mean_sq = torch.linalg.vector_norm(
                x, dim=dims, dtype=torch.float32).square() / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not _RECOMPUTING.get():
                p.running_mean.mul_(self.momentum).add_(
                    mean, alpha=1.0 - self.momentum)
                p.running_var.mul_(self.momentum).add_(
                    var, alpha=1.0 - self.momentum)
        y = _BatchStatsNorm.apply(x, p.weight, p.bias, mean, var,
                                  self.epsilon)
        return y.to(self.dtype)


class _BNParams(nn.Module):
    def __init__(self, channels: int, zero_init: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.empty(channels, device=device))
        self.register_buffer("running_var",
                             torch.empty(channels, device=device))
        self.zero_init = zero_init

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class Conv2D(nn.Module):
    """Plain conv (child `conv`) or depthwise + pointwise separable conv
    (children `depthwise`, `pointwise`), with bias, stride 1, "SAME"."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 separable: bool = False,
                 kernel_init: str = "variance_scaling",
                 bias_value: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pad = kernel_size // 2
        self.separable = separable
        self.dtype = dtype
        if not separable:
            self.conv = ConvParams(in_channels, filters, kernel_size,
                                   init=kernel_init, bias_value=bias_value,
                                   device=device)
        else:
            # flax builds both halves with variance scaling whatever
            # kernel_init says; only the pointwise half has a bias
            self.depthwise = ConvParams(in_channels, in_channels,
                                        kernel_size, groups=in_channels,
                                        use_bias=False, device=device)
            self.pointwise = ConvParams(in_channels, filters, 1,
                                        bias_value=bias_value, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.separable:
            return conv2d(x, self.conv, 1, self.pad, self.dtype)
        x = conv2d(x, self.depthwise, 1, self.pad, self.dtype)
        return conv2d(x, self.pointwise, 1, 0, self.dtype)


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest upsample by an integer factor (each pixel repeated)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
    return x.reshape(b, c, h * scale, w * scale)


def max_pool(x: torch.Tensor, window: int, strides: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax `nn.max_pool`; "SAME" pads with -inf, end side >= begin side."""
    if padding == "SAME":
        ph = same_pads(x.shape[2], window, strides)
        pw = same_pads(x.shape[3], window, strides)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"Unsupported padding: {padding}")
    return F.max_pool2d(x, window, strides)


def _nearest_indices(size_in: int, size_out: int, device) -> torch.Tensor:
    # jax.image.resize(method="nearest"): half-pixel centres, computed in
    # float32 as ((i + 0.5) * in) / out and floored. The same rule as torch's
    # "nearest-exact", but evaluated in jax's order so that no index can
    # round differently.
    offsets = (np.arange(size_out, dtype=np.float32) + 0.5) * size_in
    offsets = offsets / np.float32(size_out)
    rows = np.minimum(np.floor(offsets).astype(np.int64), size_in - 1)
    return device_constant(tuple(rows.tolist()), torch.int64, device)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize to an arbitrary size (BalanceFeatures)."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    if oh % h == 0 and ow % w == 0 and oh // h == ow // w:
        return nearest_upsample(x, oh // h)
    return (x.index_select(2, _nearest_indices(h, oh, x.device))
            .index_select(3, _nearest_indices(w, ow, x.device)))


class FeatureFusion(nn.Module):
    """'sum' | 'fast_attention' | 'fast_channel_attention' fusion of two
    maps; the weighted modes hold relu-gated, normalized float32 weights."""

    def __init__(self, mode: str = "sum", filters: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if mode not in ("sum", "fast_attention", "fast_channel_attention"):
            raise ValueError(f"Unsupported fusion mode: {mode}")
        self.mode = mode
        self.dtype = dtype
        if mode != "sum":
            n = 1 if mode == "fast_attention" else filters
            self.lower_level_weight = nn.Parameter(
                torch.empty(n, device=device))
            self.upper_level_weight = nn.Parameter(
                torch.empty(n, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        if self.mode != "sum":
            self.lower_level_weight.fill_(1.0)
            self.upper_level_weight.fill_(1.0)

    def forward(self, lower: torch.Tensor,
                upper: torch.Tensor) -> torch.Tensor:
        if self.mode == "sum":
            return lower + upper
        w_lower = F.relu(self.lower_level_weight)
        w_upper = F.relu(self.upper_level_weight)
        denom = w_lower + w_upper + 1e-4
        lower = lower * (w_lower / denom).to(self.dtype).view(1, -1, 1, 1)
        upper = upper * (w_upper / denom).to(self.dtype).view(1, -1, 1, 1)
        return lower + upper


class BalanceFeatures(nn.Module):
    """Libra-R-CNN balanced features: resize every level to the
    intermediate one, average, then add the mean back to every level."""

    def __init__(self, min_level: int, max_level: int,
                 intermediate_level: int):
        super().__init__()
        self.min_level = min_level
        self.max_level = max_level
        self.intermediate_level = intermediate_level

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        inter = self.intermediate_level
        target_hw = features[str(inter)].shape[2:4]
        num_levels = self.max_level - self.min_level + 1

        pooled = []
        for level in range(self.min_level, self.max_level + 1):
            x = features[str(level)]
            if level < inter:
                factor = 2 ** (inter - level)
                x = max_pool(x, factor, factor, padding="SAME")
            elif level > inter:
                x = resize_nearest(x, target_hw)
            pooled.append(x)
        mean_feat = sum(pooled) / num_levels

        outputs = {}
        for level in range(self.min_level, self.max_level + 1):
            x = mean_feat
            if level < inter:
                x = resize_nearest(x, features[str(level)].shape[2:4])
            elif level > inter:
                factor = 2 ** (level - inter)
                x = max_pool(x, factor, factor, padding="SAME")
            outputs[str(level)] = features[str(level)] + x
        return outputs


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from its flax initializer, in module
    order, from one generator."""
    for m in module.modules():
        if isinstance(m, (ConvParams, _BNParams, FeatureFusion)):
            m.reset_parameters(generator)
