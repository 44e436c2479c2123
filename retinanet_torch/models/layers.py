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

Under a spatial partition (`spatial_partition`, `parallel/spatial.py`) the
model's maps are row bands: every op here that reads across rows (a conv
taller than one row or strided, a pool, a resize, a mean over the rows)
fetches the rows its output band needs from the ranks that own them and
runs with the padding of the whole map, and `map_hw` gives a band's global
size.
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
from retinanet_torch.parallel import distributed
from retinanet_torch.parallel.spatial import Partition

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


def swish6(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6 (MobileDet-CPU), each op rounded in x's dtype
    as the JAX package rounds it."""
    return x * F.relu6(x + 3.0) * (1.0 / 6.0)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(begin, end) padding of TF/flax "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvParams(nn.Module):
    """The parameters of one flax `nn.Conv`: `weight` (O, I/groups, kh, kw)
    from the flax HWIO `kernel`, and an optional `bias`.

    `init` names the flax kernel initializer: "variance_scaling" (fan-in,
    truncated normal), "normal" (stddev `init_std`), "fan_out" (EfficientNet:
    normal with stddev sqrt(2 / (kh * kw * O))) or "truncated_normal" (cut
    at two standard deviations of the normal of stddev `init_std`, as
    flax's `truncated_normal(init_std)`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1, use_bias: bool = True,
                 init: str = "variance_scaling", bias_value: float = 0.0,
                 init_std: float = 0.01, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size,
            device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if use_bias else None)
        self.groups = groups
        self.init = init
        self.init_std = float(init_std)
        self.bias_value = float(bias_value)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init == "normal":
            self.weight.normal_(0.0, self.init_std, generator=generator)
        elif self.init == "fan_out":
            o, _, kh, kw = self.weight.shape
            self.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * o)),
                                generator=generator)
        elif self.init in ("variance_scaling", "truncated_normal"):
            std = (math.sqrt(1.0 / self.weight[0].numel())
                   / _TRUNC_STD_CORRECTION
                   if self.init == "variance_scaling" else self.init_std)
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        else:
            raise ValueError(f"Unknown kernel init: {self.init}")
        if self.bias is not None:
            self.bias.fill_(self.bias_value)


# The conv hook: while one is set (`conv_hook`), every conv of the port
# (both functions below) calls it with the input as flax's `nn.Conv` sees
# it, before any cast or "SAME" padding:
#     hook(x, p, stride, pads, dtype, float_conv) -> tensor
# with `pads` (top, bottom, left, right) and `float_conv(x)` the float path
# of this module, unchanged. The calibration observer
# (`export/calibration.py`) records x and returns float_conv(x); the int8
# lanes (`export/quantize.py`) return float_conv of the fake-quantized x or
# the real int8 conv. Unset, nothing differs.
_CONV_HOOK = contextvars.ContextVar("conv_hook", default=None)


@contextlib.contextmanager
def conv_hook(hook: Callable):
    """Route every conv through `hook` inside the block (see above)."""
    token = _CONV_HOOK.set(hook)
    try:
        yield
    finally:
        _CONV_HOOK.reset(token)


def _conv_float(x: torch.Tensor, p: ConvParams, stride: int, pad,
                dtype: torch.dtype) -> torch.Tensor:
    bias = None if p.bias is None else p.bias.to(dtype)
    return F.conv2d(x.to(dtype), p.weight.to(dtype), bias, stride, pad,
                    1, p.groups)


def conv2d(x: torch.Tensor, p: ConvParams, stride: int, pad,
           dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv` in `dtype` (input, kernel and bias cast first) with
    `pad` zeros on both sides of each spatial axis (an int, or one int an
    axis): k // 2 is "SAME" for an odd kernel at stride 1, 0 is "VALID"."""
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    part = _SPATIAL.get()
    if part is not None:
        return _band_conv(part, x, p, stride, (ph, ph), (pw, pw), dtype)
    hook = _CONV_HOOK.get()
    if hook is None:
        return _conv_float(x, p, stride, pad, dtype)
    return hook(x, p, stride, (ph, ph, pw, pw), dtype,
                lambda x: _conv_float(x, p, stride, pad, dtype))


def conv2d_padded(x: torch.Tensor, p: ConvParams, stride: int,
                  pads: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """`pads` (begin, end) zeros on both spatial axes, then a "VALID" conv
    (the ResNet's fixed padding of a strided conv)."""
    part = _SPATIAL.get()
    if part is not None:
        return _band_conv(part, x, p, stride, pads, pads, dtype)
    if any(pads):
        x = F.pad(x, (pads[0], pads[1], pads[0], pads[1]))
    return conv2d(x, p, stride, 0, dtype)


def conv2d_same(x: torch.Tensor, p: ConvParams, stride: int,
                dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv` with padding "SAME" at any stride. Where the end of an
    axis gets one more row than its beginning (a stride above 1 on a size
    the stride divides, for an odd kernel), the input is padded first."""
    kh, kw = p.weight.shape[2], p.weight.shape[3]
    pw = same_pads(x.shape[3], kw, stride)
    part = _SPATIAL.get()
    if part is not None:
        ph = ((0, 0) if kh == 1 and stride == 1
              else same_pads(part.height(x), kh, stride))
        return _band_conv(part, x, p, stride, ph, pw, dtype)
    ph = same_pads(x.shape[2], kh, stride)
    hook = _CONV_HOOK.get()
    if hook is None:
        return _conv_same_float(x, p, stride, ph, pw, dtype)
    return hook(x, p, stride, ph + pw, dtype,
                lambda x: _conv_same_float(x, p, stride, ph, pw, dtype))


def _conv_same_float(x: torch.Tensor, p: ConvParams, stride: int, ph, pw,
                     dtype: torch.dtype) -> torch.Tensor:
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _conv_float(x, p, stride, (ph[0], pw[0]), dtype)
    x = F.pad(x.to(dtype), (pw[0], pw[1], ph[0], ph[1]))
    return _conv_float(x, p, stride, 0, dtype)


# The spatial partition: while one is set (`spatial_partition`), the maps of
# the model are row bands (`parallel/spatial.py`) and the ops below run on
# them. Unset, nothing differs.
_SPATIAL = contextvars.ContextVar("spatial_partition", default=None)


@contextlib.contextmanager
def spatial_partition(part: Partition):
    """Run the model's ops on row bands of `part` inside the block (None:
    on whole maps)."""
    token = _SPATIAL.set(part)
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def current_partition():
    return _SPATIAL.get()


def map_hw(x: torch.Tensor) -> Tuple[int, int]:
    """The (H, W) of the whole map of which x (NCHW) is a band: x's own
    outside a spatial partition."""
    part = _SPATIAL.get()
    h = x.shape[2] if part is None else part.height(x)
    return int(h), int(x.shape[3])


def _strided_windows(part: Partition, out_h: int, k: int, stride: int,
                     pad_begin: int):
    """Every rank's input rows for its output band of a sliding window op
    (k rows, `stride`, `pad_begin` rows of padding on top). A rank with no
    output rows asks for k rows above the map, all fill: the op still runs,
    and its one row of output is dropped."""
    windows = []
    for j in range(part.count):
        o0, o1 = part.band(out_h, j)
        windows.append((-k, 0) if o0 == o1 else
                       (o0 * stride - pad_begin,
                        (o1 - 1) * stride - pad_begin + k))
    return windows


def _band_conv(part: Partition, x: torch.Tensor, p: ConvParams, stride: int,
               ph: Tuple[int, int], pw: Tuple[int, int],
               dtype: torch.dtype) -> torch.Tensor:
    """A conv with (top, bottom) pads `ph` of the whole map and (left,
    right) pads `pw` on this rank's band: rows fetched, zeros on top and
    bottom of the map, W padded as usual. A 1x1 conv of stride 1 reads its
    own row only and runs as it is (also on maps that are no band, such as
    a squeeze-excite's (B, C, 1, 1))."""
    if _CONV_HOOK.get() is not None:
        raise RuntimeError("a conv hook (calibration, int8) runs on whole "
                           "images; serving and export are not partitioned")
    kh = p.weight.shape[2]
    if kh == 1 and stride == 1 and not any(ph):
        if x.shape[2]:
            return _conv_same_float(x, p, 1, (0, 0), pw, dtype)
        # an empty band: a row of zeros through the conv, none of it kept
        return _conv_same_float(F.pad(x, (0, 0, 0, 1)), p, 1, (0, 0), pw,
                                dtype).narrow(2, 0, 0)
    height = part.height(x)
    out_h = (height + ph[0] + ph[1] - kh) // stride + 1
    x = part.fetch(x.to(dtype), height,
                   _strided_windows(part, out_h, kh, stride, ph[0]))
    y = _conv_same_float(x, p, stride, (0, 0), pw, dtype)
    o0, o1 = part.band(out_h)
    part.register(out_h, y.shape[3])
    return y.narrow(2, 0, o1 - o0)


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
    Only `x` is kept for the backward pass, in its own dtype.

    With `count`, the statistics are those of the global batch of every
    process, `count` values a channel. The backward then sums dy and
    dy * x_hat over the processes before the input gradient, as
    `nn.SyncBatchNorm` does; the weight and bias gradients stay this
    process's sums, which the train step sums with every other gradient.
    That path is plain tensor ops in float32 (ATen's
    `batch_norm_backward_reduce` has no CPU kernel)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, count=None):
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), count)
        ctx.eps = eps
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd, count = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if count is None:
            dx, dweight, dbias = torch.ops.aten.native_batch_norm_backward(
                grad_out, x, weight, None, None, mean, invstd, True, ctx.eps,
                list(needs))
        else:
            dx, dweight, dbias = _synced_batch_norm_backward(
                grad_out, x, weight, mean, invstd, count, needs)
        return dx, dweight, dbias, None, None, None, None


def _global_moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, ...]:
    """The mean and the biased variance max(0, E[x^2] - E[x]^2) over the
    batches of every process, and their count a channel: one all-reduce of
    (sum x, sum x^2, count), in float32."""
    c = x.shape[1]
    stats = torch.cat([
        x.sum(dim=dims, dtype=torch.float32),
        torch.linalg.vector_norm(x, dim=dims, dtype=torch.float32).square(),
        torch.full((1,), x.numel() // c, dtype=torch.float32,
                   device=x.device)])
    distributed.all_reduce_sum_(stats)
    count = stats[2 * c]
    mean = stats[:c] / count
    var = torch.clamp(stats[c:2 * c] / count - mean * mean, min=0.0)
    return mean, var, count


def _synced_batch_norm_backward(grad_out, x, weight, mean, invstd, count,
                                needs):
    shape = (1, -1, 1, 1)
    dims = (0, 2, 3)
    dy = grad_out.to(torch.float32)
    x_hat = (x.to(torch.float32) - mean.view(shape)) * invstd.view(shape)
    sum_dy = dy.sum(dim=dims)
    sum_dy_x_hat = (dy * x_hat).sum(dim=dims)
    dx = None
    if needs[0]:
        c = sum_dy.shape[0]
        sums = distributed.all_reduce_sum_(torch.cat([sum_dy, sum_dy_x_hat]))
        dx = ((dy - (sums[:c] / count).view(shape)
               - x_hat * (sums[c:] / count).view(shape))
              * (invstd * weight).view(shape)).to(grad_out.dtype)
    return (dx, sum_dy_x_hat if needs[1] else None,
            sum_dy if needs[2] else None)


class BatchNorm(nn.Module):
    """flax BatchNorm: float32 statistics and arithmetic, output in `dtype`.

    Eval mode normalizes by the running statistics. Training mode takes the
    batch mean and the biased variance over (N, H, W) in float32, the
    variance as max(0, E[x^2] - E[x]^2) as flax computes it, and moves the
    running statistics by `ra = momentum * ra + (1 - momentum) * batch`, with
    the biased variance (torch's own update takes the unbiased one, so the
    buffers are updated here by hand). In one process the whole batch is
    on its device, so `use_sync` has nothing to add; under a process group
    of several (`parallel/distributed.py`, which `build_model` allows only
    with `use_sync`) the statistics and their gradients are summed over the
    processes, so every process normalizes by the global batch's moments.

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
            global_count = None
            if distributed.process_count() > 1:
                mean, var, global_count = _global_moments(x, dims)
            else:
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
                                  self.epsilon, global_count)
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
    (children `depthwise`, `pointwise`; the stride is the depthwise
    half's), "SAME" padding, with a bias unless `use_bias` is False."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 strides: int = 1, use_bias: bool = True,
                 separable: bool = False,
                 kernel_init: str = "variance_scaling",
                 bias_value: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.strides = strides
        self.separable = separable
        self.dtype = dtype
        if not separable:
            self.conv = ConvParams(in_channels, filters, kernel_size,
                                   use_bias=use_bias, init=kernel_init,
                                   bias_value=bias_value, device=device)
        else:
            # flax builds both halves with variance scaling whatever
            # kernel_init says; only the pointwise half may have a bias
            self.depthwise = ConvParams(in_channels, in_channels,
                                        kernel_size, groups=in_channels,
                                        use_bias=False, device=device)
            self.pointwise = ConvParams(in_channels, filters, 1,
                                        use_bias=use_bias,
                                        bias_value=bias_value, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.separable:
            return conv2d_same(x, self.conv, self.strides, self.dtype)
        x = conv2d_same(x, self.depthwise, self.strides, self.dtype)
        return conv2d(x, self.pointwise, 1, 0, self.dtype)


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest upsample by an integer factor (each pixel repeated)."""
    part = _SPATIAL.get()
    if part is not None:
        h = part.height(x)
        return _band_rows(part, x, [r // scale for r in range(h * scale)],
                          _repeat_columns(x, scale))
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
    return x.reshape(b, c, h * scale, w * scale)


def upsample_crop(x: torch.Tensor, scale: int,
                  like: torch.Tensor) -> torch.Tensor:
    """`nearest_upsample(x, scale)` cropped to the size of the map `like`
    (the FPN's top-down path onto a level of odd size)."""
    part = _SPATIAL.get()
    if part is None:
        return nearest_upsample(x, scale)[:, :, :like.shape[2],
                                          :like.shape[3]]
    h, w = map_hw(like)
    return _band_rows(part, x, [r // scale for r in range(h)],
                      _repeat_columns(x, scale)[:w])


def _repeat_columns(x: torch.Tensor, scale: int) -> list:
    return [c // scale for c in range(x.shape[3] * scale)]


def _band_rows(part: Partition, x: torch.Tensor, rows: list,
               columns: list) -> torch.Tensor:
    """A resize that copies pixels: output row r of the whole map is input
    row rows[r] (nondecreasing), output column c is input column
    columns[c]. The rows of this rank's output band are fetched."""
    height = part.height(x)
    windows = []
    for j in range(part.count):
        o0, o1 = part.band(len(rows), j)
        windows.append((0, 0) if o0 == o1 else (rows[o0], rows[o1 - 1] + 1))
    x = part.fetch(x, height, windows)
    o0, o1 = part.band(len(rows))
    lo = windows[part.index][0]
    x = x.index_select(2, device_constant(
        tuple(r - lo for r in rows[o0:o1]), torch.int64, x.device))
    x = x.index_select(3, device_constant(tuple(columns), torch.int64,
                                          x.device))
    part.register(len(rows), x.shape[3])
    return x


def max_pool(x: torch.Tensor, window: int, strides: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax `nn.max_pool`; "SAME" pads with -inf, end side >= begin side."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"Unsupported padding: {padding}")
    part = _SPATIAL.get()
    h, w = map_hw(x)
    ph = pw = (0, 0)
    if padding == "SAME":
        ph = same_pads(h, window, strides)
        pw = same_pads(w, window, strides)
    if part is not None:
        out_h = (h + ph[0] + ph[1] - window) // strides + 1
        x = part.fetch(x, h, _strided_windows(part, out_h, window, strides,
                                              ph[0]), fill=float("-inf"))
        ph = (0, 0)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    y = F.max_pool2d(x, window, strides)
    if part is None:
        return y
    o0, o1 = part.band(out_h)
    part.register(out_h, y.shape[3])
    return y.narrow(2, 0, o1 - o0)


def _nearest_rows(size_in: int, size_out: int) -> list:
    # jax.image.resize(method="nearest"): half-pixel centres, computed in
    # float32 as ((i + 0.5) * in) / out and floored. The same rule as torch's
    # "nearest-exact", but evaluated in jax's order so that no index can
    # round differently.
    offsets = (np.arange(size_out, dtype=np.float32) + 0.5) * size_in
    offsets = offsets / np.float32(size_out)
    return np.minimum(np.floor(offsets).astype(np.int64),
                      size_in - 1).tolist()


def _nearest_indices(size_in: int, size_out: int, device) -> torch.Tensor:
    return device_constant(tuple(_nearest_rows(size_in, size_out)),
                           torch.int64, device)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize to an arbitrary size (BalanceFeatures); `out_hw` is
    the size of the whole map."""
    h, w = map_hw(x)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    exact = oh % h == 0 and ow % w == 0 and oh // h == ow // w
    part = _SPATIAL.get()
    if part is not None:
        if exact:
            rows = [r // (oh // h) for r in range(oh)]
            columns = [c // (ow // w) for c in range(ow)]
        else:
            rows, columns = _nearest_rows(h, oh), _nearest_rows(w, ow)
        return _band_rows(part, x, rows, columns)
    if exact:
        return nearest_upsample(x, oh // h)
    return (x.index_select(2, _nearest_indices(h, oh, x.device))
            .index_select(3, _nearest_indices(w, ow, x.device)))


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W, accumulated and returned in float32, with the
    kept (B, C, 1, 1) shape; under a spatial partition over the whole map:
    the bands' sums summed over the group."""
    part = _SPATIAL.get()
    if part is None:
        return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    h, w = map_hw(x)
    total = part.sum(x.sum(dim=(2, 3), keepdim=True, dtype=torch.float32))
    return total / float(h * w)


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
        target_hw = map_hw(features[str(inter)])
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
                x = resize_nearest(x, map_hw(features[str(level)]))
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
