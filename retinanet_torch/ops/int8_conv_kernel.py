"""Real int8 convolution: the CUDA kernels of `csrc/int8_conv.cu`, their
binding and their wrapper.

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
registers the op, which loading such a graph needs.

`int8_design` picks one of three designs from the shape alone (the source's
note says what each does): "wgmma" (dense, C > 16: TMA and wgmma),
"mma_sync" (dense, C <= 16: the stem) and "depthwise". No design stands in
for another: a launch that fails raises. `kernel.launches` counts the
convolutions launched (a dense one is two CUDA kernels on one stream, the
quantizing pass and the GEMM; a depthwise one is one); `kernel.launches_by`
splits them by design.

The wgmma design reads its input through an im2col-mode TMA tensor map.
`im2col_plan` gives the numbers the wrapper passes for it (the quantized
input's shape, the box's corners, the traversal stride); the CPU tests walk
a numpy model of the copies from those numbers and hold it to `F.unfold`.

Build: `ops/cuda_build.py` compiles `csrc/int8_conv.cu` with `nvcc` on
first use and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.int8_conv import (WGMMA_MIN_CHANNELS,
                                           check_accumulator_bound,
                                           conv_out_size, dense_k_words,
                                           int8_conv2d_plain, tap_channels)

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_DESIGN_CODE = {"depthwise": 0, "mma_sync": 1, "wgmma": 2}  # `Design` in C
TILE_M = 128             # `kTileM`: output pixels a tile of the wgmma design
TILE_NS = (64, 128, 256)  # its output channels a tile
CHUNKS = (32, 64, 128)   # its int8 channels a stage: the swizzle widths
SMS = 132                # H100 SXM


def int8_design(c: int, o: int, kh: int, kw: int, stride: int,
                groups: int) -> str:
    """The design that runs a conv, from its shape alone. Depthwise convs
    keep their loop. A dense conv with C > 16 takes wgmma: its taps are
    `tap_channels(C)`, a multiple of 32, so every stage is whole k32 steps
    (C = 24 and 40 of EfficientNet-lite pad to 32 and 64). C <= 16 keeps
    the mma.sync GEMM, whose taps are 4 bytes: on wgmma the 7x7/2 stem
    (C = 3) would copy 49 taps of 32-byte rows a tile, and measured 3.3x
    slower there (`tools/int8_conv_experiments.py`, PERF.md)."""
    del o, kh, kw, stride  # the same design at every window and width
    if groups != 1:
        return "depthwise"
    return "wgmma" if c >= WGMMA_MIN_CHANNELS else "mma_sync"


def wgmma_chunk(c_tap: int) -> int:
    """int8 channels a stage of the wgmma design takes from a tap (its CH,
    and the width of its 128-, 64- or 32-byte swizzle): all of a tap of 32
    or 64 channels, else 128, so that a stage holds four k32 steps. A last
    chunk past c_tap (c_tap 96, 160, ...) is TMA's zero fill."""
    return c_tap if c_tap <= 64 else 128


def wgmma_tile_n(o: int, m: int) -> int:
    """Output channels a tile of the wgmma design takes (its BN): the
    narrowest tile that holds O up to 128 channels, so that 64-channel
    convs waste no half tile; past that 256, unless there would then be
    fewer tiles than the card's SMs."""
    if o <= 64:
        return 64
    if o <= 128:
        return 128
    m_tiles = -(-m // TILE_M)
    return 256 if m_tiles * -(-o // 256) >= SMS else 128


@dataclass(frozen=True)
class Im2colPlan:
    """What the wgmma design quantizes and how its A map walks it.

    The quantizing pass writes q (N, qh, qw, c_tap) int8, pixel (qy, qx)
    from input pixel (qy * sub - sub_pads[0], qx * sub - sub_pads[1]): a
    strided 1x1 conv, whose input is subsampled and then a plain GEMM
    operand, has sub > 1; any other conv sub 1 and sub_pads 0. The conv
    then runs over q with window (kh, kw) at stride `stride`. The im2col
    map's box walks window origins (w, h) from `lower` to the largest
    lower + i * stride <= size - 1 + upper in each axis, w fastest, then
    h, then the image; a copy brings TILE_M consecutive origins, each
    shifted by the tap, with zeros where that falls outside q."""
    qh: int
    qw: int
    c_tap: int
    sub: int
    sub_pads: Tuple[int, int]  # (top, left)
    kh: int
    kw: int
    stride: int
    lower: Tuple[int, int]   # (w, h)
    upper: Tuple[int, int]   # (w, h)
    oh: int
    ow: int


def im2col_plan(h: int, w: int, c: int, kh: int, kw: int, stride: int,
                pads: Tuple[int, int, int, int]) -> Im2colPlan:
    top, bottom, left, right = pads
    oh = conv_out_size(h, kh, stride, top, bottom)
    ow = conv_out_size(w, kw, stride, left, right)
    if kh == kw == 1 and stride > 1:
        return Im2colPlan(oh, ow, tap_channels(c), stride, (top, left), 1,
                          1, 1, (0, 0), (0, 0), oh, ow)
    return Im2colPlan(h, w, tap_channels(c), 1, (0, 0), kh, kw, stride,
                      (-left, -top), (right - (kw - 1), bottom - (kh - 1)),
                      oh, ow)


def declare(lib: ctypes.CDLL) -> None:
    lib.int8_conv_launch.argtypes = (
        [ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p])
    lib.int8_conv_launch.restype = ctypes.c_int
    lib.int8_conv_encode_ns.argtypes = [ctypes.POINTER(_Args),
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.int8_conv_encode_ns.restype = ctypes.c_double
    lib.int8_conv_error_string.argtypes = [ctypes.c_int]
    lib.int8_conv_error_string.restype = ctypes.c_char_p


class _Args(ctypes.Structure):
    """`Int8ConvArgs` of csrc/int8_conv.cu, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "h", "w", "c", "oh", "ow", "o", "kh", "kw", "stride", "pad_t",
        "pad_l", "design", "k_pad", "qh", "qw", "c_tap", "sub", "q_stride",
        "lower_w", "lower_h", "upper_w", "upper_h", "tile_n", "chunk")]


# the built library, and the counts of kernel launches
kernel = CudaLibrary("int8_conv", declare)


def output_shape(x_shape, out_channels: int, stride: int,
                 pads: Tuple[int, int, int, int], kh: int,
                 kw: int) -> Tuple[int, int, int, int]:
    n, h, w, _ = x_shape
    return (n, conv_out_size(h, kh, stride, pads[0], pads[1]),
            conv_out_size(w, kw, stride, pads[2], pads[3]), out_channels)


def conv_args(x_shape, packed_shape, out_channels: int, stride: int,
              pads: Tuple[int, int, int, int], groups: int, kh: int,
              kw: int) -> Tuple[str, _Args, int]:
    """(design, the kernel's Int8ConvArgs, bytes of the quantized-input
    scratch)."""
    n, h, w, c = x_shape
    _, oh, ow, o = output_shape(x_shape, out_channels, stride, pads, kh, kw)
    design = int8_design(c, o, kh, kw, stride, groups)
    args = _Args(n=n, h=h, w=w, c=c, oh=oh, ow=ow, o=o, kh=kh, kw=kw,
                 stride=stride, pad_t=pads[0], pad_l=pads[2],
                 design=_DESIGN_CODE[design],
                 k_pad=packed_shape[1] if groups == 1 else 0)
    scratch = 0
    if design == "wgmma":
        plan = im2col_plan(h, w, c, kh, kw, stride, pads)
        args.qh, args.qw, args.c_tap, args.sub = (plan.qh, plan.qw,
                                                  plan.c_tap, plan.sub)
        args.q_stride = plan.stride
        args.lower_w, args.lower_h = plan.lower
        args.upper_w, args.upper_h = plan.upper
        args.tile_n = wgmma_tile_n(o, n * oh * ow)
        args.chunk = wgmma_chunk(plan.c_tap)
        scratch = n * plan.qh * plan.qw * plan.c_tap
    elif design == "mma_sync":
        scratch = n * h * w * 4 * (-(-c // 4))
    return design, args, scratch


def launch(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor], s_a: float, stride: int,
           pads: Tuple[int, int, int, int], groups: int, kh: int, kw: int,
           out_dtype: torch.dtype) -> torch.Tensor:
    """Launches the kernel on checked CUDA tensors; `int8_conv2d` is the
    public entry."""
    shape = output_shape(x.shape, scale.shape[0], stride, pads, kh, kw)
    y = torch.empty(shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernel.build()
    design, args, scratch = conv_args(x.shape, packed.shape, scale.shape[0],
                                      stride, pads, groups, kh, kw)
    # the quantized input of a dense conv (int32 words keep it 16-byte
    # aligned)
    q = torch.empty(-(-scratch // 4), dtype=torch.int32, device=x.device)
    err = lib.int8_conv_launch(
        ctypes.byref(args), x.data_ptr(), int(x.dtype == torch.bfloat16),
        packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16), q.data_ptr(), float(s_a),
        device_index(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel ({design}) launch failed: "
                           + lib.int8_conv_error_string(err).decode())
    kernel.launches += 1
    kernel.launches_by[design] += 1
    return y


def encode_us(x: torch.Tensor, packed: torch.Tensor, out_channels: int,
              stride: int, pads: Tuple[int, int, int, int], kh: int,
              kw: int, out_dtype: torch.dtype, reps: int = 1000) -> float:
    """Host microseconds that encoding the three tensor maps of one wgmma
    conv (input, weights, output) adds to its launch, the mean of `reps`;
    nothing is launched."""
    lib = kernel.build()
    design, args, scratch = conv_args(x.shape, packed.shape, out_channels,
                                      stride, pads, 1, kh, kw)
    if design != "wgmma":
        raise ValueError(f"a {design} conv encodes no tensor map")
    q = torch.empty(-(-scratch // 4), dtype=torch.int32, device=x.device)
    y = torch.empty(output_shape(x.shape, out_channels, stride, pads, kh,
                                 kw), dtype=out_dtype, device=x.device)
    ns = lib.int8_conv_encode_ns(ctypes.byref(args), q.data_ptr(),
                                 packed.data_ptr(), y.data_ptr(),
                                 int(out_dtype == torch.bfloat16), reps)
    if ns < 0:
        raise RuntimeError("tensor map refused: "
                           + lib.int8_conv_error_string(int(-ns)).decode())
    return ns / 1e3


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
