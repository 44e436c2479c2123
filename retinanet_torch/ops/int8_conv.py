"""The int8 convolution of the int8-activation serving lane in plain
PyTorch: the reference that `csrc/int8_conv.cu` is held to, bit for bit.

Counterpart of the real-int8 branch of
`retinanet_tpu/export/quantize.py:make_int8_conv_interceptor` (:137-159):
  * the activation is quantized per tensor, `clip(round(float32(x) / s_a),
    -127, 127)`: a division, not a multiply by the reciprocal, rounding
    half to even;
  * the int8 activation and the per-output-channel int8 weights are summed
    in int32 (`lax.conv_general_dilated(..., preferred_element_type=
    int32)`); here in float64, exact because every partial sum stays
    below 2^53, so any order of summation gives the same int32;
  * the epilogue requantizes in float32 in two roundings,
    `float32(acc) * (s_a * s_w)`, then `+ bias`, then a cast to the conv's
    dtype.

Activations are NHWC here, as the kernel takes them. Dense weights (groups
1) are packed once for the kernel as (O, K_pad) int32 words: for each output
channel its kh * kw taps in (row, column) order, each tap `tap_channels(C)`
int8 channels (four a word, the channels past C zero), then zero words up
to a multiple of K_WORDS_ALIGN; depthwise weights (groups = C = O) as
(kh * kw, C) int8. `unpack_weights` inverts either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

QMAX = 127
INT32_MAX = 2 ** 31 - 1
# K words a stage of the kernel's wgmma design (`kChunk` of
# csrc/int8_conv.cu: 128 int8 channels); a packed row is padded to it
K_WORDS_ALIGN = 32
# above this many input channels a dense conv takes the wgmma design, whose
# taps are whole k32 steps of its tensor-core product
WGMMA_MIN_CHANNELS = 17


def tap_channels(in_channels: int) -> int:
    """int8 channels a tap holds in the packed weights and in the kernel's
    quantized input: a multiple of 32 (one wgmma k-step, and TMA's 16-byte
    rows) from WGMMA_MIN_CHANNELS on, of 4 (one int32 word of the mma.sync
    design) below."""
    step = 32 if in_channels >= WGMMA_MIN_CHANNELS else 4
    return -(-in_channels // step) * step


def dense_k_words(in_channels: int, kh: int, kw: int) -> Tuple[int, int]:
    """(K words, K words padded) of a dense conv's packed weights."""
    words = kh * kw * tap_channels(in_channels) // 4
    return words, -(-words // K_WORDS_ALIGN) * K_WORDS_ALIGN


def conv_out_size(size: int, kernel: int, stride: int, pad_lo: int,
                  pad_hi: int) -> int:
    return (size + pad_lo + pad_hi - kernel) // stride + 1


def check_accumulator_bound(kh: int, kw: int, in_per_group: int) -> None:
    """Every int32 accumulator holds at most kh * kw * C/groups products of
    magnitude <= 127^2; refuse a conv whose sum could overflow."""
    terms = kh * kw * in_per_group
    if terms * QMAX * QMAX > INT32_MAX:
        raise ValueError(f"an int8 conv of {terms} terms a sum can overflow "
                         "its int32 accumulator")


def quantize_activation(x: torch.Tensor, s_a: float) -> torch.Tensor:
    """int8 `clip(round(float32(x) / float32(s_a)), -127, 127)`. The scale
    is a float32 tensor on x's device: ATen divides by a CPU scalar as a
    multiply by its reciprocal on the card, which rounds differently."""
    scale = torch.full((1,), s_a, dtype=torch.float32, device=x.device)
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def pack_weights(qw: torch.Tensor, groups: int) -> torch.Tensor:
    """int8 OIHW weights -> the kernel's layout (see the module doc)."""
    o, cpg, kh, kw = qw.shape
    if groups == 1:
        words, padded = dense_k_words(cpg, kh, kw)
        w = qw.permute(0, 2, 3, 1)                        # (O, kh, kw, C)
        w = F.pad(w, (0, tap_channels(cpg) - cpg))
        w = w.reshape(o, 4 * words).contiguous().view(torch.int32)
        return F.pad(w, (0, padded - words)).contiguous()
    if cpg == 1 and groups == o:
        return qw.reshape(o, kh * kw).t().contiguous()
    raise ValueError(f"int8 conv takes groups 1 or depthwise, got groups "
                     f"{groups} for weights {tuple(qw.shape)}")


def unpack_weights(packed: torch.Tensor, out_channels: int,
                   in_channels: int, kh: int, kw: int,
                   groups: int) -> torch.Tensor:
    """The kernel's layout -> int8 OIHW weights."""
    if groups == 1:
        words, _ = dense_k_words(in_channels, kh, kw)
        w = packed[:, :words].contiguous().view(torch.int8).reshape(
            out_channels, kh, kw, -1)[..., :in_channels]  # (O, kh, kw, C)
        return w.permute(0, 3, 1, 2).contiguous()
    return packed.t().reshape(out_channels, 1, kh, kw).contiguous()


def int8_conv_acc(qx: torch.Tensor, qw: torch.Tensor, stride: int,
                  pads: Tuple[int, int, int, int],
                  groups: int) -> torch.Tensor:
    """int32 accumulators, NHWC, of int8 NHWC `qx` and int8 OIHW `qw` with
    `pads` (top, bottom, left, right) of zeros: float64 products and sums,
    exact below 2^53. On the card cuDNN is bypassed for the native im2col
    and GEMM, which cannot take an inexact (FFT) algorithm."""
    top, bottom, left, right = pads
    x = F.pad(qx.permute(0, 3, 1, 2).to(torch.float64),
              (left, right, top, bottom))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, qw.to(torch.float64), None, stride, 0, 1, groups)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def requantize(acc: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """float32(acc) * scale, then + bias, each rounded once, then a cast."""
    y = acc.to(torch.float32) * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def int8_conv2d_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor],
                      s_a: float, stride: int,
                      pads: Tuple[int, int, int, int], groups: int, kh: int,
                      kw: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The whole conv: NHWC float `x` -> NHWC `out_dtype`, from the packed
    weights the kernel takes."""
    in_channels = x.shape[3]
    out_channels = scale.shape[0]
    qw = unpack_weights(packed, out_channels,
                        in_channels if groups == 1 else 1, kh, kw, groups)
    acc = int8_conv_acc(quantize_activation(x, s_a), qw, stride, pads,
                        groups)
    return requantize(acc, scale, bias, out_dtype)
