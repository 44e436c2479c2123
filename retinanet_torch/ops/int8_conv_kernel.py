"""Real int8 convolution: the CUDA kernel of `csrc/int8_conv.cu`, its
binding and its wrapper.

Replaces the real-int8 XLA path of
`retinanet_tpu/export/quantize.py:100 make_int8_conv_interceptor`
(`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` and
the float32 requantization). The plain version is
`ops/int8_conv.py:int8_conv2d_plain`; the wrapper takes it only for tensors
on the CPU. On a CUDA tensor it launches the kernel or raises.

`int8_conv2d` reaches its implementations through the custom op
`torch.ops.retinanet_torch.int8_conv2d`, dispatched by device, with a fake
implementation for the output shape, so that `torch.export` can capture
the int8 serving graph. Importing this module (or `retinanet_torch.ops`)
registers the op, which loading such a graph needs. `kernel.launches`
counts the convolutions launched (a dense one is two CUDA kernels on one
stream, the quantizing pass and the GEMM; a depthwise one is one);
`kernel.launches_by` splits them into "dense" and "depthwise".

Build: `ops/cuda_build.py` compiles `csrc/int8_conv.cu` with `nvcc` on
first use and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.int8_conv import (check_accumulator_bound,
                                           conv_out_size, dense_k_words,
                                           int8_conv2d_plain)

_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def declare(lib: ctypes.CDLL) -> None:
    lib.int8_conv_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_float]
        + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    lib.int8_conv_launch.restype = ctypes.c_int
    lib.int8_conv_error_string.argtypes = [ctypes.c_int]
    lib.int8_conv_error_string.restype = ctypes.c_char_p


# the built library, and the counts of kernel launches
kernel = CudaLibrary("int8_conv", declare)


def output_shape(x_shape, out_channels: int, stride: int,
                 pads: Tuple[int, int, int, int], kh: int,
                 kw: int) -> Tuple[int, int, int, int]:
    n, h, w, _ = x_shape
    return (n, conv_out_size(h, kh, stride, pads[0], pads[1]),
            conv_out_size(w, kw, stride, pads[2], pads[3]), out_channels)


def launch(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor], s_a: float, stride: int,
           pads: Tuple[int, int, int, int], groups: int, kh: int, kw: int,
           out_dtype: torch.dtype) -> torch.Tensor:
    """Launches the kernel on checked CUDA tensors; `int8_conv2d` is the
    public entry."""
    n, h, w, c = x.shape
    shape = output_shape(x.shape, scale.shape[0], stride, pads, kh, kw)
    y = torch.empty(shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernel.build()
    depthwise = groups != 1
    # the quantized input of a dense conv: (N, H, W, ceil(C / 4)) words
    words = torch.empty(0 if depthwise else n * h * w * (-(-c // 4)),
                        dtype=torch.int32, device=x.device)
    err = lib.int8_conv_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
        scale.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), int(out_dtype == torch.bfloat16), words.data_ptr(),
        float(s_a), n, h, w, c, shape[1], shape[2], shape[3], kh, kw, stride,
        pads[0], pads[2], int(depthwise), device_index(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("int8 conv kernel launch failed: "
                           + lib.int8_conv_error_string(err).decode())
    kernel.launches += 1
    kernel.launches_by["depthwise" if depthwise else "dense"] += 1
    return y


def int8_conv2d(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], s_a: float, stride: int,
                pads: Tuple[int, int, int, int], groups: int, kh: int,
                kw: int, out_dtype: torch.dtype) -> torch.Tensor:
    """One int8 convolution of the int8-activation lane.

    x (N, H, W, C) float32 or bfloat16, contiguous; `packed` the weights
    in the kernel's layout (`ops/int8_conv.py:pack_weights`); scale (O,)
    float32 `s_a * s_w`; bias (O,) float32 or None; pads (top, bottom,
    left, right); groups 1 or C. Returns (N, OH, OW, O) in `out_dtype`.
    On the card one kernel launch."""
    if x.dim() != 4 or x.dtype not in _FLOAT_TYPES:
        raise TypeError(f"x must be NHWC float32 or bfloat16, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if out_dtype not in _FLOAT_TYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    c, o = x.shape[3], scale.shape[0]
    if groups == 1:
        want = (o, dense_k_words(c, kh, kw)[1])
        in_per_group = c
        if packed.dtype != torch.int32:
            raise TypeError(f"dense weights must be packed int32, got "
                            f"{packed.dtype}")
    elif groups == c == o:
        want = (kh * kw, c)
        in_per_group = 1
        if packed.dtype != torch.int8:
            raise TypeError(f"depthwise weights must be int8, got "
                            f"{packed.dtype}")
    else:
        raise ValueError(f"groups must be 1 or C = O, got groups {groups}, "
                         f"C {c}, O {o}")
    if tuple(packed.shape) != want:
        raise ValueError(f"packed weights {tuple(packed.shape)}, expected "
                         f"{want}")
    check_accumulator_bound(kh, kw, in_per_group)
    tensors = [x, packed, scale] + ([] if bias is None else [bias])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, weights, scale and bias must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, weights, scale and bias must be contiguous")
    if scale.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError("scale and bias must be float32")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    if min(output_shape(x.shape, o, stride, pads, kh, kw)[1:3]) < 1:
        raise ValueError(f"empty output for input {tuple(x.shape)}")
    return torch.ops.retinanet_torch.int8_conv2d(
        x, packed, scale, bias, float(s_a), int(stride), *map(int, pads),
        int(groups), int(kh), int(kw), out_dtype)


@torch.library.custom_op("retinanet_torch::int8_conv2d", mutates_args=(),
                         device_types="cpu")
def _int8_conv2d_op(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    s_a: float, stride: int, pad_t: int, pad_b: int,
                    pad_l: int, pad_r: int, groups: int, kh: int, kw: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    return int8_conv2d_plain(x, packed, scale, bias, s_a, stride,
                             (pad_t, pad_b, pad_l, pad_r), groups, kh, kw,
                             out_dtype)


@_int8_conv2d_op.register_kernel("cuda")
def _int8_conv2d_cuda(x, packed, scale, bias, s_a, stride, pad_t, pad_b,
                      pad_l, pad_r, groups, kh, kw, out_dtype):
    return launch(x, packed, scale, bias, s_a, stride,
                  (pad_t, pad_b, pad_l, pad_r), groups, kh, kw, out_dtype)


@_int8_conv2d_op.register_fake
def _int8_conv2d_fake(x, packed, scale, bias, s_a, stride, pad_t, pad_b,
                      pad_l, pad_r, groups, kh, kw, out_dtype):
    return x.new_empty(output_shape(x.shape, scale.shape[0], stride,
                                    (pad_t, pad_b, pad_l, pad_r), kh, kw),
                       dtype=out_dtype)
