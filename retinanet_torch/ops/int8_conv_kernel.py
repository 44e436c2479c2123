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

`int8_design` picks one of five designs from the shape alone (and, for a
depthwise conv, the input's 16-byte alignment, which TMA needs; the
source's note says what each does): "wgmma" (dense, C > 16: TMA and
wgmma), "narrow" (dense, 4 <= C <= 16: one launch, the input box quantized
once into shared memory, mma.sync from ldmatrix), "stem" (dense, C < 4:
narrow's walk with 4-byte pixels, one word a tap), "depthwise" (windows
1, 3 and 5 at stride 1 or 2, C % 8 == 0: tiles by TMA, quantized once
into shared memory, dp4a) and "depthwise_generic" (every other depthwise
conv: the same tiles, loaded by the threads). A sixth, "mma_sync" (the
GEMM the stems took before "stem"), is on no path: it is
reached only by routing (`tools/int8_conv_experiments.py:STEM_ROUTES`),
as the yardstick that the stem design is timed beside. No design stands
in for another: a launch that fails raises. `kernel.launches` counts the
convolutions launched (a wgmma or mma_sync one is two CUDA kernels on one
stream, the quantizing pass and the GEMM; a narrow, stem or depthwise one
is one); `kernel.launches_by` splits them by design.

The wgmma design reads its input through an im2col-mode TMA tensor map.
`im2col_plan` gives the numbers the wrapper passes for it (the quantized
input's shape, the box's corners, the traversal stride); the CPU tests walk
a numpy model of the copies from those numbers and hold it to `F.unfold`.
`depthwise_plan` gives the depthwise designs' tile, box and shared-memory
layout, `narrow_plan` the narrow design's, `stem_plan` the stem's; the CPU
tests check each at every such conv of the configs and walk numpy models
of their items to the plain int32 conv.

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
_DESIGN_CODE = {"depthwise": 0, "mma_sync": 1, "wgmma": 2,
                "depthwise_generic": 3, "narrow": 4,
                "stem": 5}  # `Design` in C
TILE_M = 128             # `kTileM`: output pixels a tile of the wgmma design
TILE_NS = (64, 128, 256)  # its output channels a tile
CHUNKS = (32, 64, 128)   # its int8 channels a stage: the swizzle widths
SMS = 132                # H100 SXM
SMEM_LIMIT = 232_448     # `kSmemLimit`: a block's shared memory
SM_SMEM = 233_472        # an SM's; each resident block also holds 1 KB

# The depthwise designs (csrc/int8_conv.cu, "depthwise")
DW_WINDOWS = (1, 3, 5)   # square windows with a kernel of their own
DW_STRIDES = (1, 2)
DW_THREADS = 256         # `kDwThreads`
DW_BLOCK = 4             # `kDwBlock`: a thread's outputs are 4 x 4 blocks
DW_CHUNK = 32            # channels a work item (fewer where C is smaller)
DW_STAGES = 2            # raw boxes in the ring, at most
# output tiles (rows, columns), in the order tried: the first whose
# shared memory fits DW_SMEM_BUDGET (three CTAs an SM: the quantization is
# bound by latency, and a third CTA hides more of it than a second raw box
# does) at the most stages
DW_TILES = ((8, 32), (8, 16), (4, 32), (4, 16), (4, 8), (4, 4))
DW_SMEM_BUDGET = SM_SMEM // 3 - 1024
# "depthwise_generic": shared-memory budgets tried in order (three CTAs an
# SM, then one) for the whole window's box; where none fits, the window in
# blocks of DW_TAP_BLOCK taps a side (a multiple of 4: whole tap words)
GENERIC_SMEM_BUDGETS = (DW_SMEM_BUDGET, SMEM_LIMIT)
DW_TAP_BLOCK = 16
# "depthwise_generic": a warp's list of a box's elements in doubt
# (`kGenDoubts`), the lists `GEN_DOUBTS_OFF` bytes past the barriers
GEN_DOUBTS = 128
GEN_DOUBTS_OFF = 64

# The narrow design (csrc/int8_conv.cu, "narrow")
NARROW_MIN_CHANNELS = 4  # dense convs with fewer channels: the stem
# output channels a warp's unit (the kernel's kTileN): the narrowest that
# holds O, up to 64 (units of 128 measured slower at O = 128: their 64
# accumulators a thread cost resident warps; PERF.md)
NARROW_TILE_NS = (32, 64)
NARROW_PIXEL = 16        # bytes of a quantized pixel: C <= 16 int8, zeros
# output pixels an item, in the order tried: the largest that leaves at
# least NARROW_MIN_ITEMS items (fewer items than that leave SMs idle in the
# last round; larger ones pass fewer barriers a pixel)
NARROW_TILE_MS = (256, 128, 64)
NARROW_MIN_ITEMS = 4 * SMS
NARROW_STAGES = 2        # raw boxes in the ring, at most
NARROW_OUT_BUFS = 2      # staging tiles, at most
# inputs of fewer pixels (the squeeze-excite convs' 1x1 maps) are loaded and
# stored by the threads: no tensor map is encoded for them
NARROW_MAP_MIN_PIXELS = 4096
# three CTAs an SM first, then two, then one: each CTA's items pass through
# phases that few of its warps fill (the quantization, the epilogue), and
# more CTAs hide them (the tool's plan variants, PERF.md)
NARROW_SMEM_BUDGETS = (SM_SMEM // 3 - 1024, SM_SMEM // 2 - 1024, SMEM_LIMIT)

# The stem design (csrc/int8_conv.cu, "stem"): dense convs with C <=
# STEM_MAX_CHANNELS (one int32 word a tap) and C < NARROW_MIN_CHANNELS;
# every other such conv takes "mma_sync" (0 routes every stem there)
STEM_MAX_CHANNELS = 3
STEM_PIXEL = 4           # bytes of a quantized pixel: C <= 3 int8, zeros
STEM_TILE_W = 32         # output columns an item (16 where the output is
                         # at most 16 wide): a fragment's 16 pixels in a row
# output pixels an item, in the order tried (as NARROW_TILE_MS): 512 first,
# whose box's halo is a smaller share (items of 512 measured 8-20% faster
# than 256 at the three stems: PERF.md, B.6)
STEM_TILE_MS = (512, 256, 128, 64)
STEM_STAGES = 2          # raw boxes in the ring, at most (1 or 2)
# two CTAs an SM first (the kernel's registers hold no third), then one
STEM_SMEM_BUDGETS = (SM_SMEM // 2 - 1024, SMEM_LIMIT)


def int8_design(c: int, o: int, kh: int, kw: int, stride: int,
                groups: int, aligned: bool = True) -> str:
    """The design that runs a conv, from its shape alone (and, depthwise,
    whether the input is 16-byte aligned). A depthwise conv with a square
    window of 1, 3 or 5 at stride 1 or 2 and C a multiple of 8 (so that
    TMA takes the input's and the output's rows) takes "depthwise", any
    other "depthwise_generic". A dense conv with C > 16 takes wgmma: its
    taps are `tap_channels(C)`, a multiple of 32, so every stage is whole
    k32 steps (C = 24 and 40 of EfficientNet-lite pad to 32 and 64). 4 <=
    C <= 16 takes "narrow": a 16-byte quantized pixel a tap, two taps a
    k32 step. C < 4 (the stems, C = 3) takes "stem", which replaces the
    mma_sync GEMM there: that design's quantizing pass wrote the whole
    input as int32 words and its GEMM gathered each word again from ~12
    overlapping windows, 4 bytes a copy, into 128-channel tiles for 16 to
    64 channels, over K padded to 64 words (49 or 9 taps); narrow's 16-byte
    pixels would carry 3 channels in 16 bytes (5.3x the terms). The stem
    is bound by its bytes, most of them the output (85% at the flagship),
    so it keeps narrow's one launch, ring of raw boxes and TMA stores, and
    makes K the taps: a 4-byte pixel a tap, 8 taps a k32 step, units of O
    channels (PERF.md, B.6)."""
    del o  # the same design at every width
    if groups != 1:
        tiled = (kh == kw and kh in DW_WINDOWS and stride in DW_STRIDES
                 and c % 8 == 0 and aligned)
        return "depthwise" if tiled else "depthwise_generic"
    if c >= WGMMA_MIN_CHANNELS:
        return "wgmma"
    if c >= NARROW_MIN_CHANNELS:
        return "narrow"
    return "stem" if c <= STEM_MAX_CHANNELS else "mma_sync"


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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align(a: int, b: int) -> int:
    return _ceil(a, b) * b


@dataclass(frozen=True)
class DepthwisePlan:
    """How a depthwise design walks a conv (the fields of the same names
    in `Int8ConvArgs`; `chunk` is its dw_chunk). A work item is tile_h x
    tile_w output pixels of one image x `chunk` channels; its input box,
    box_h x box_w pixels from (oy0 * stride - pad_t, ox0 * stride - pad_l),
    is the tile plus its halo for a window block of taps_h x taps_w taps
    (the whole window but where "depthwise_generic" takes it in blocks).
    The box is quantized into `chunk` int8 planes of box_h rows of
    row_pitch bytes, plane_pitch bytes apart (plane_pitch / 4 odd, so that
    32 channels read one word each on 32 banks). Shared memory: `stages`
    raw boxes from 0, the planes at q_off, the staging tile at out_off, the
    stages' barriers at bar_off, `smem` bytes with 128 of alignment slack.
    "depthwise_generic" also: a raw box is runs of raw_pitch bytes (a box
    row of box_w x C elements when one chunk holds every channel, else a
    pixel's chunk; each run's 16-byte units), the tap words (kh x
    ceil(kw / 4) x chunk int32) at w_off, the staging tile's runs (a tile
    row, or a pixel's chunk) out_pitch bytes apart, and the warps' lists of
    elements in doubt GEN_DOUBTS_OFF bytes past bar_off. (The kernel sizes
    its persistent grid from the CTAs the card holds.)"""
    tile_h: int
    tile_w: int
    chunk: int
    box_h: int
    box_w: int
    taps_h: int
    taps_w: int
    row_pitch: int
    plane_pitch: int
    stages: int
    q_off: int
    out_off: int
    bar_off: int
    smem: int
    raw_pitch: int = 0
    w_off: int = 0
    out_pitch: int = 0


def _plane_pitch(box_h: int, row_pitch: int) -> int:
    pitch = box_h * row_pitch
    return pitch + 4 if (pitch // 4) % 2 == 0 else pitch


def dw_chunk(c: int) -> int:
    """Channels a depthwise work item takes: DW_CHUNK, or the power of two
    (at least 8) that holds a smaller C."""
    return DW_CHUNK if c >= DW_CHUNK else max(8, 1 << (c - 1).bit_length())


def generic_words(stride: int, taps_w: int) -> int:
    """int32 words of a block's input row that the generic kernel reads
    from the block's first column: its 4 outputs' taps (bytes S i + 4 g ..
    + 3 for the ceil(taps_w / 4) tap words g) and the word after each, which
    the shift to an output's first byte takes."""
    return (3 * stride + 4 * _ceil(taps_w, 4)) // 4 + 1


def _generic_plan(c: int, oh: int, ow: int, kh: int, kw: int, stride: int,
                  in_bytes: int, out_bytes: int) -> DepthwisePlan:
    """"depthwise_generic": tiles of whole 4 x 4 blocks from DW_TILES (cut
    to the plane) and the ring's depth, the first that fits a budget of
    GENERIC_SMEM_BUDGETS, in order, with the whole window; where none fits,
    the window in blocks of DW_TAP_BLOCK taps a side, in tiles of at most
    one block a thread (whose sums stay in registers across the blocks)."""
    s = stride
    chunk = dw_chunk(c)
    rows = c <= chunk  # a run is a box row, else a pixel's chunk
    tiles = [(min(th, _align(oh, DW_BLOCK)), min(tw, _align(ow, DW_BLOCK)))
             for th, tw in DW_TILES]
    blocked = (min(kh, DW_TAP_BLOCK), min(kw, DW_TAP_BLOCK))
    for taps_h, taps_w in dict.fromkeys(((kh, kw), blocked)):
        for budget in GENERIC_SMEM_BUDGETS:
            for th, tw in tiles:
                if (taps_h, taps_w) != (kh, kw) and (
                        (th // DW_BLOCK) * (tw // DW_BLOCK)
                        > DW_THREADS // chunk):
                    continue
                box_h, box_w = (th - 1) * s + taps_h, (tw - 1) * s + taps_w
                raw_pitch = _align((box_w * c if rows else chunk) * in_bytes
                                   + 15, 16)
                raw = _align((box_h if rows else box_h * box_w) * raw_pitch,
                             128)
                # a block row's reads, and the quantizer's words of 8
                # pixels
                row_pitch = max((tw - DW_BLOCK) * s
                                + 4 * generic_words(s, taps_w),
                                _align(box_w, 8))
                plane_pitch = _plane_pitch(box_h, row_pitch)
                out_pitch = _align((tw * c if rows else chunk) * out_bytes
                                   + 15, 16)
                out = (th if rows else th * tw) * out_pitch
                for stages in range(DW_STAGES, 0, -1):
                    q_off = stages * raw
                    w_off = q_off + _align(chunk * plane_pitch, 128)
                    out_off = w_off + _align(kh * _ceil(kw, 4) * chunk * 4,
                                             128)
                    bar_off = out_off + _align(out, 128)
                    smem = (bar_off + GEN_DOUBTS_OFF + DW_THREADS // 32
                            * (GEN_DOUBTS + 1) * 4 + 128)
                    if smem <= budget:
                        return DepthwisePlan(
                            th, tw, chunk, box_h, box_w, taps_h, taps_w,
                            row_pitch, plane_pitch, stages, q_off, out_off,
                            bar_off, smem, raw_pitch, w_off, out_pitch)
    raise ValueError(f"no depthwise_generic tile fits shared memory for a "
                     f"{kh}x{kw} window at stride {stride} over {c} channels")


def depthwise_plan(design: str, c: int, oh: int, ow: int, kh: int, kw: int,
                   stride: int, in_bytes: int,
                   out_bytes: int) -> DepthwisePlan:
    """The plan of a depthwise conv (., ., ., C) -> (., oh, ow, C) with a
    kh x kw window at `stride`, in_bytes / out_bytes the element sizes.

    "depthwise": tiles of whole 4 x 4 blocks from DW_TILES (cut to the
    plane), the first whose box sides stay within TMA's 256 and whose
    shared memory, at DW_STAGES raw boxes or fewer, fits DW_SMEM_BUDGET. A
    block's input row is read as `words` 4-byte words from its first
    column, so a row holds (tile_w - 4) * stride + 4 * words bytes.
    "depthwise_generic": `_generic_plan`."""
    if design != "depthwise":
        return _generic_plan(c, oh, ow, kh, kw, stride, in_bytes, out_bytes)
    s = stride
    chunk = dw_chunk(c)
    for th, tw in DW_TILES:
        th = min(th, _align(oh, DW_BLOCK))
        tw = min(tw, _align(ow, DW_BLOCK))
        box_h, box_w = (th - 1) * s + kh, (tw - 1) * s + kw
        if max(box_h, box_w) > 256:
            continue
        words = _ceil(3 * s + kw, 4)
        row_pitch = (tw - DW_BLOCK) * s + 4 * words
        raw = _align(box_h * box_w * chunk * in_bytes, 128)
        out = th * tw * chunk * out_bytes
        plane_pitch = _plane_pitch(box_h, row_pitch)
        for stages in range(DW_STAGES, 0, -1):
            q_off = stages * raw
            out_off = q_off + _align(chunk * plane_pitch, 128)
            bar_off = out_off + _align(out, 128)
            smem = bar_off + 8 * stages + 128
            if smem <= DW_SMEM_BUDGET:
                return DepthwisePlan(th, tw, chunk, box_h, box_w, kh, kw,
                                     row_pitch, plane_pitch, stages, q_off,
                                     out_off, bar_off, smem)
    raise ValueError(f"no {design} tile fits shared memory for a {kh}x{kw} "
                     f"window at stride {stride}")


@dataclass(frozen=True)
class NarrowPlan:
    """How the narrow design walks a conv (the fields of the same names in
    `Int8ConvArgs`; tile_n is `Int8ConvArgs.tile_n`, the kernel's kTileN:
    output channels of a warp's unit, which is kUnitM fragments of 16
    output pixels). `flat`: a 1x1 conv at stride 1 without pads, whose N H
    W input pixels the kernel views as one row (N, H, W = 1, 1, N H W). A
    work item is tile_h x tile_w output pixels of one image of that view
    (tiles in row-major order, then images); its input box, box_h x box_w
    pixels from (ty tile_h stride - pad_t, tx tile_w stride - pad_l), is
    quantized into NARROW_PIXEL-byte pixels, box_h rows of row_pitch bytes
    = stride phases of row_pitch / (16 stride) pixels (column x at phase x
    % stride, place x // stride). K is k_steps k32 steps, two taps of 16
    bytes a step; the weights in shared memory are o_pad rows (O rounded up
    to 16) of w_pitch bytes (32 k_steps + 16, so that 8 rows fall on 32
    banks). The output leaves in ceil(O / o_box) boxes of o_box channels a
    pixel, by TMA from a staging tile whose rows of o_box channels are
    swizzled at their width (tma_out; ceil(o_pad / o_box) rows a pixel, so
    that the channels past O have a place), else by the threads. The input
    comes by TMA into `stages` raw boxes (tma_in), else the threads load
    it (stages 0). Shared memory, from a 1024-byte aligned base: the raw
    boxes from 0, the quantized box at q_off, the weights at w_off, scale
    and bias (o_pad floats each) at sb_off, the taps' byte offsets (2
    k_steps ints) at tap_off, `out_bufs` staging tiles at out_off, the
    ring's barriers at bar_off, `smem` bytes with 1024 of alignment slack.
    (The kernel sizes its persistent grid from the CTAs the card holds.)"""
    flat: bool
    tile_n: int
    tile_h: int
    tile_w: int
    box_h: int
    box_w: int
    row_pitch: int
    k_steps: int
    w_pitch: int
    o_pad: int
    o_box: int
    tma_in: bool
    tma_out: bool
    stages: int
    out_bufs: int
    q_off: int
    w_off: int
    sb_off: int
    tap_off: int
    out_off: int
    bar_off: int
    smem: int


def narrow_staging_bytes(tile_h: int, tile_w: int, o: int, o_box: int,
                         out_bytes: int, tma_out: bool) -> int:
    """`narrow_staging_bytes` of the source: one staging tile."""
    rows = _ceil(_align(o, 16), o_box) if tma_out else 1
    return _align(tile_h * tile_w * rows * o_box * out_bytes, 1024)


def narrow_plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
                stride: int, pads: Tuple[int, int, int, int], in_bytes: int,
                out_bytes: int, aligned: bool = True) -> NarrowPlan:
    """The plan of a dense conv (n, h, w, c) -> (n, ., ., o), 4 <= c <= 16,
    with a kh x kw window at `stride`; in_bytes / out_bytes the element
    sizes; aligned: the input's address is a multiple of 16.

    Items of the first of NARROW_TILE_MS output pixels that leaves
    NARROW_MIN_ITEMS items (else the last): a run of them in a flat conv, a
    tile 16 wide (8 where the output is at most 8 wide) otherwise. TMA
    takes the input where its pixels' rows are whole 16-byte units, and
    the output where its rows are; neither on maps of fewer than
    NARROW_MAP_MIN_PIXELS pixels. The first ring depth (NARROW_STAGES
    down) and staging count (NARROW_OUT_BUFS down) whose shared memory
    fits a budget of NARROW_SMEM_BUDGETS, in order."""
    top, bottom, left, right = pads
    s = stride
    oh = conv_out_size(h, kh, s, top, bottom)
    ow = conv_out_size(w, kw, s, left, right)
    flat = kh == kw == 1 and s == 1 and not any(pads)
    tm = next((t for t in NARROW_TILE_MS
               if n * oh * ow >= t * NARROW_MIN_ITEMS), NARROW_TILE_MS[-1])
    if flat:
        tile_h, tile_w = 1, min(tm, _align(n * h * w, 16))
    else:
        tile_w = 16 if ow > 8 else 8
        tile_h = min(tm // tile_w, _align(oh, 16 // tile_w))
    box_h, box_w = (tile_h - 1) * s + kh, (tile_w - 1) * s + kw
    if max(box_h, box_w) > 256:
        raise ValueError(f"a narrow box of {box_h} x {box_w} pixels: TMA "
                         "takes at most 256 a side")
    maps = n * h * w >= NARROW_MAP_MIN_PIXELS
    tma_in = maps and aligned and (c * in_bytes) % 16 == 0
    tma_out = maps and (o * out_bytes) % 16 == 0
    # a staging row: a power of two of 16 to 128 bytes, so that the swizzle
    # of that width spreads 8 rows on 32 banks, no wider than the output's
    # rows; of those the one that leaves the fewest channels of the last box
    # empty, then the widest; the threads' store reads rows of O channels
    o_box = o
    if tma_out:
        widths = [b // out_bytes for b in (128, 64, 32, 16)
                  if b <= o * out_bytes]
        o_box = min(widths, key=lambda b: _ceil(o, b) * b)
    k_steps = _ceil(kh * kw, 2)
    w_pitch = 32 * k_steps + 16
    o_pad = _align(o, 16)
    tile_n = next((t for t in NARROW_TILE_NS if t >= o_pad),
                  NARROW_TILE_NS[-1])
    row_pitch = s * _ceil(box_w, s) * NARROW_PIXEL
    raw = _align(box_h * box_w * c * in_bytes, 128)
    staging = narrow_staging_bytes(tile_h, tile_w, o, o_box, out_bytes,
                                   tma_out)
    for budget in NARROW_SMEM_BUDGETS:
        for stages in (range(NARROW_STAGES, 0, -1) if tma_in else (0,)):
            for bufs in (range(NARROW_OUT_BUFS, 0, -1) if tma_out
                         else (1,)):
                q_off = stages * raw
                w_off = q_off + _align(box_h * row_pitch, 128)
                sb_off = w_off + o_pad * w_pitch
                tap_off = sb_off + 8 * o_pad
                out_off = _align(tap_off + 8 * k_steps, 1024)
                bar_off = out_off + bufs * staging
                smem = bar_off + 8 * stages + 1024
                if smem <= budget:
                    return NarrowPlan(flat, tile_n, tile_h, tile_w, box_h,
                                      box_w, row_pitch, k_steps, w_pitch,
                                      o_pad, o_box, tma_in, tma_out, stages,
                                      bufs, q_off, w_off, sb_off, tap_off,
                                      out_off, bar_off, smem)
    raise ValueError(f"no narrow plan fits shared memory for a {kh}x{kw} "
                     f"window over {c} channels into {o}")


@dataclass(frozen=True)
class StemPlan:
    """How the stem design walks a conv (the fields of the same names in
    `Int8ConvArgs`; tile_n, a warp's unit of output channels, as
    `NarrowPlan`'s: a unit computes no N tile of 16 past o_pad). A work item is tile_h x tile_w output pixels of one
    image (tiles in row-major order, then images); its input box, box_h x
    box_w pixels from (ty tile_h stride - pad_t, tx tile_w stride - pad_l),
    comes by the threads' 16-byte copies into one of `stages` raw boxes
    (rows of raw_pitch bytes: the box row's bytes in the input from the
    16-byte unit that holds its first one) and is quantized into box_h rows
    of row_pitch bytes of STEM_PIXEL-byte pixels: `stride` phases of
    `stem_phase` pixels, then 8 words. K is k_steps k32 steps of 8 one-word
    slots (`stem_slots`). The weights (o_pad rows of w_pitch bytes) and the
    output's `out_bufs` staging tiles and store are narrow's (`NarrowPlan`).
    Shared memory, from a 1024-byte aligned base: the raw boxes from 0, the
    quantized box at q_off, the weights at w_off, scale and bias at sb_off,
    the slots' offsets (8 k_steps ints) at tap_off, the staging tiles at
    out_off, the ring's barriers at bar_off, `smem` bytes with 1024 of
    alignment slack. (The kernel sizes its persistent grid from the CTAs
    the card holds.)"""
    tile_n: int
    tile_h: int
    tile_w: int
    box_h: int
    box_w: int
    row_pitch: int
    raw_pitch: int
    k_steps: int
    w_pitch: int
    o_pad: int
    o_box: int
    tma_out: bool
    stages: int
    out_bufs: int
    q_off: int
    w_off: int
    sb_off: int
    tap_off: int
    out_off: int
    bar_off: int
    smem: int


def stem_slots(kh: int, kw: int) -> list:
    """`stem_slot` of the source for every slot of K: (tap or -1, row,
    column). Four rows of one window column a group of four slots,
    ceil(kh / 4) groups a column, column by column, then a zero group to
    a whole k32 step; a slot past the window reads its group's first row
    (past the last column, row 0 of column 0) with a zero weight."""
    blocks = _ceil(kh, 4)
    out = []
    for j in range(8 * _ceil(kw * blocks, 2)):
        c, rb = divmod(j // 4, blocks)
        r0 = 4 * rb
        r = r0 + j % 4
        if c >= kw:
            out.append((-1, 0, 0))
        elif r >= kh:
            out.append((-1, r0, c))
        else:
            out.append((r * kw + c, r, c))
    return out


def stem_phase(box_w: int, stride: int) -> int:
    """Pixels a column phase of a stem's quantized box row: the least that
    holds ceil(box_w / stride) and puts stride * pw at a multiple of 32
    words, so that the row, 8 words past it, puts rows r .. r + 3 of a
    column on 8 banks each; at stride 2, 16 past a multiple of 32, so that
    a warp's 32 consecutive pixels (16 of each phase) fall on 32 banks when
    quantized."""
    least = _ceil(box_w, stride)
    if stride == 2:
        return least + (16 - least) % 32
    return _align(least, 32)


def stem_plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
              stride: int, pads: Tuple[int, int, int, int], in_bytes: int,
              out_bytes: int) -> StemPlan:
    """The plan of a dense conv (n, h, w, c) -> (n, ., ., o), c <= 3, with a
    kh x kw window at `stride`; in_bytes / out_bytes the element sizes.

    Tiles STEM_TILE_W wide (16 where the output is at most 16 wide) of the
    first of STEM_TILE_MS output pixels that leaves NARROW_MIN_ITEMS items
    (else the last), cut to the output's height. The output by TMA where
    its rows are whole 16-byte units and the map has at least
    NARROW_MAP_MIN_PIXELS input pixels (narrow's rule). The first ring
    depth (STEM_STAGES down) and staging count (NARROW_OUT_BUFS down) whose
    shared memory fits a budget of STEM_SMEM_BUDGETS, in order; a ValueError
    where none does."""
    top, bottom, left, right = pads
    s = stride
    oh = conv_out_size(h, kh, s, top, bottom)
    ow = conv_out_size(w, kw, s, left, right)
    tm = next((t for t in STEM_TILE_MS
               if n * oh * ow >= t * NARROW_MIN_ITEMS), STEM_TILE_MS[-1])
    tile_w = STEM_TILE_W if ow > 16 else 16
    tile_h = max(1, min(tm // tile_w, oh))
    box_h, box_w = (tile_h - 1) * s + kh, (tile_w - 1) * s + kw
    row_pitch = STEM_PIXEL * (s * stem_phase(box_w, s) + 8)
    raw_pitch = 16 * _ceil(box_w * c * in_bytes + 15, 16)
    raw = _align(box_h * raw_pitch, 128)
    maps = n * h * w >= NARROW_MAP_MIN_PIXELS
    tma_out = maps and (o * out_bytes) % 16 == 0
    o_box = o
    if tma_out:
        widths = [b // out_bytes for b in (128, 64, 32, 16)
                  if b <= o * out_bytes]
        o_box = min(widths, key=lambda b: _ceil(o, b) * b)
    k_steps = len(stem_slots(kh, kw)) // 8
    w_pitch = 32 * k_steps + 16
    o_pad = _align(o, 16)
    tile_n = next((t for t in NARROW_TILE_NS if t >= o_pad),
                  NARROW_TILE_NS[-1])
    staging = narrow_staging_bytes(tile_h, tile_w, o, o_box, out_bytes,
                                   tma_out)
    for budget in STEM_SMEM_BUDGETS:
        for stages in range(STEM_STAGES, 0, -1):
            for bufs in (range(NARROW_OUT_BUFS, 0, -1) if tma_out else (1,)):
                q_off = stages * raw
                w_off = q_off + _align(box_h * row_pitch, 128)
                sb_off = w_off + o_pad * w_pitch
                tap_off = sb_off + 8 * o_pad
                out_off = _align(tap_off + 32 * k_steps, 1024)
                bar_off = out_off + bufs * staging
                smem = bar_off + 8 * stages + 1024
                if smem <= budget:
                    return StemPlan(tile_n, tile_h, tile_w, box_h, box_w,
                                    row_pitch, raw_pitch, k_steps, w_pitch,
                                    o_pad, o_box, tma_out, stages, bufs,
                                    q_off, w_off, sb_off, tap_off, out_off,
                                    bar_off, smem)
    raise ValueError(f"no stem plan fits shared memory for a {kh}x{kw} "
                     f"window at stride {stride} over {c} channels into {o}")


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
        "lower_w", "lower_h", "upper_w", "upper_h", "tile_n", "chunk",
        "tile_h", "tile_w", "dw_chunk", "box_h", "box_w", "taps_h",
        "taps_w", "row_pitch", "plane_pitch", "stages", "q_off", "out_off",
        "bar_off", "smem", "flat", "w_off", "w_pitch", "sb_off", "tap_off",
        "k_steps", "o_pad", "o_box", "out_bufs", "tma_in", "tma_out",
        "raw_pitch", "out_pitch")]


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
              kw: int, in_bytes: int = 2, out_bytes: int = 2,
              aligned: bool = True) -> Tuple[str, _Args, int]:
    """(design, the kernel's Int8ConvArgs, bytes of the quantized-input
    scratch). in_bytes / out_bytes: the input's and the output's element
    sizes; aligned: the input's address is a multiple of 16."""
    n, h, w, c = x_shape
    _, oh, ow, o = output_shape(x_shape, out_channels, stride, pads, kh, kw)
    design = int8_design(c, o, kh, kw, stride, groups, aligned)
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
    elif design in ("narrow", "stem"):
        plan = (narrow_plan(n, h, w, c, o, kh, kw, stride, pads, in_bytes,
                            out_bytes, aligned) if design == "narrow" else
                stem_plan(n, h, w, c, o, kh, kw, stride, pads, in_bytes,
                          out_bytes))
        for name in type(plan).__dataclass_fields__:
            setattr(args, name, int(getattr(plan, name)))
    else:
        plan = depthwise_plan(design, c, oh, ow, kh, kw, stride, in_bytes,
                              out_bytes)
        args.tile_h, args.tile_w, args.dw_chunk = (plan.tile_h, plan.tile_w,
                                                   plan.chunk)
        args.box_h, args.box_w = plan.box_h, plan.box_w
        args.taps_h, args.taps_w = plan.taps_h, plan.taps_w
        args.row_pitch, args.plane_pitch = plan.row_pitch, plan.plane_pitch
        args.stages, args.q_off = plan.stages, plan.q_off
        args.out_off, args.bar_off = plan.out_off, plan.bar_off
        args.smem = plan.smem
        args.raw_pitch, args.w_off = plan.raw_pitch, plan.w_off
        args.out_pitch = plan.out_pitch
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
    design, args, scratch = conv_args(
        x.shape, packed.shape, scale.shape[0], stride, pads, groups, kh, kw,
        x.element_size(), y.element_size(), x.data_ptr() % 16 == 0)
    # the quantized input of a wgmma or mma_sync conv (int32 words keep it
    # 16-byte aligned); the narrow, stem and depthwise designs take none
    q = (torch.empty(-(-scratch // 4), dtype=torch.int32, device=x.device)
         if scratch else None)
    err = lib.int8_conv_launch(
        ctypes.byref(args), x.data_ptr(), int(x.dtype == torch.bfloat16),
        packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16),
        None if q is None else q.data_ptr(), float(s_a),
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
