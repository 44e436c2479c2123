"""What the int8 conv kernel's designs rest on, checked where no card is.

  * `int8_design` is a function of the shape: every int8 conv of the
    flagship (ResNet50-FPN), of EfficientNet-lite2 and -lite3, B2 768 and
    B3 896, and of MobileDet cpu, edge_tpu and gpu gets the design the rule
    gives (the C = 3 stems "stem", 4 <= C <= 16 "narrow", every other
    dense conv wgmma, every depthwise conv "depthwise"); the numbers passed
    for the wgmma design fit the tensor maps' limits, and the depthwise,
    narrow and stem plans fit shared memory and TMA's boxes at every such
    call (the stem's walk: `test_torch_int8_stem.py`).
  * The packed weights' padded layout round-trips, and a tensor packed in
    the earlier layout (ceil(C / 4) words a tap, rows padded to 16 words)
    is refused by the shape check.
  * A numpy model of the im2col-mode copies, built from the very numbers
    the wrapper passes for the descriptor (`conv_args`), equals `F.unfold`
    for 3x3/1, 3x3/2 with asymmetric "SAME" pads, 1x1/2 and 7x7/2, with
    tiles that cross rows and images and a ragged last tile.
  * The strided 1x1 quantizing pass's plain model equals
    `quantize_activation` of the subsampled input.
  * A numpy model of the depthwise designs' walk (items, the box's origin
    and halo, TMA's zero fill as the padding, the int8 planes, the dp4a
    weight words of "depthwise", the window blocks of "depthwise_generic",
    the store clipped at the edges), from the numbers the wrapper passes,
    equals the plain int32 accumulators, and the fast quantization's
    float32 arithmetic equals `quantize_activation`.
  * A numpy model of the narrow design's walk (items across rows and
    images or tiles of one image, the box's origin and halo, the zero fill
    as the padding, 16-byte quantized pixels stored by column phase, the
    A rows that each lane's ldmatrix address gathers, the weights widened
    from `pack_weights` order to 16 bytes a tap, units of 32 or 64
    channels in N tiles of 8, the ragged last item, the store clipped at
    the edges),
    from the numbers the wrapper passes, equals the plain int32
    accumulators at every narrow shape class of the eight configs.
No JAX is compiled; the models are walked on `device="meta"`.
"""

import json
from pathlib import Path
from typing import Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.export.quantize import conv_paths  # noqa: E402
from retinanet_torch.models.layers import conv_hook, same_pads  # noqa: E402
from retinanet_torch.models.retinanet import build_model  # noqa: E402
from retinanet_torch.ops.int8_conv import (  # noqa: E402
    K_WORDS_ALIGN, conv_out_size, dense_k_words, int8_conv_acc,
    pack_weights, quantize_activation, tap_channels, unpack_weights)
from retinanet_torch.ops import \
    int8_conv_kernel as int8_conv_kernel_module  # noqa: E402
from retinanet_torch.ops.int8_conv_kernel import (  # noqa: E402
    CHUNKS, DW_BLOCK, DW_SMEM_BUDGET, DW_THREADS, GEN_DOUBTS,
    GEN_DOUBTS_OFF, NARROW_MAP_MIN_PIXELS,
    NARROW_PIXEL, NARROW_SMEM_BUDGETS, NARROW_TILE_NS, SMEM_LIMIT, TILE_M,
    TILE_NS, Im2colPlan, conv_args, generic_words, int8_conv2d, int8_design,
    narrow_staging_bytes, wgmma_chunk, wgmma_tile_n)
from test_torch_threads import one_thread  # noqa: E402,F401


_REPO = Path(__file__).resolve().parent.parent
_CONFIGS = {
    "flagship": "configs/v3-8/mscoco-retinanet-resnet50-640x640-30x-64.json",
    "lite2": ("configs/v3-32/mscoco-retinanet-efficientnet-lite2-512x512-"
              "30x-256.json"),
    "lite3": ("configs/v3-32/mscoco-retinanet-efficientnet-lite3-512x512-"
              "30x-256.json"),
    "b2": "configs/v3-8/mscoco-retinanet-efficientnet-b2-768x768-30x-64.json",
    "b3": ("configs/v3-32/mscoco-retinanet-efficientnet-b3-896x896-30x-"
           "256.json"),
    "mobiledet_cpu": ("configs/v3-8/mscoco-retinanet-mobiledet-cpu-448x448-"
                      "30x-64.json"),
    "mobiledet_edge_tpu": ("configs/v3-8/mscoco-retinanet-mobiledet-edge-"
                           "tpu-448x448-30x-64.json"),
    "mobiledet_gpu": ("configs/v3-8/mscoco-retinanet-mobiledet-gpu-512x512-"
                      "30x-64.json"),
}
# int8 conv calls of one request by design (the prediction convs stay
# float)
_DESIGNS = {
    "flagship": {"stem": 1, "wgmma": 101},
    "lite2": {"stem": 1, "narrow": 1, "wgmma": 69, "depthwise": 50},
    "lite3": {"stem": 1, "wgmma": 96, "depthwise": 73},
    "b2": {"stem": 1, "narrow": 12, "wgmma": 117, "depthwise": 62},
    "b3": {"stem": 1, "narrow": 9, "wgmma": 142, "depthwise": 75},
    "mobiledet_cpu": {"stem": 1, "narrow": 6, "wgmma": 93,
                      "depthwise": 43},
    "mobiledet_edge_tpu": {"stem": 1, "narrow": 7, "wgmma": 70,
                           "depthwise": 43},
    "mobiledet_gpu": {"stem": 1, "narrow": 9, "wgmma": 68,
                      "depthwise": 30},
}


def _int8_calls(name):
    """(C, O, kh, kw, stride, groups, pads, (N, H, W)) of every conv that
    the int8 lane runs on int8, from a forward on `device="meta"`."""
    params = torch_cfg.from_dict(json.loads((_REPO / _CONFIGS[name])
                                            .read_text()))
    model = build_model(params, device="meta").eval()
    paths = conv_paths(model)
    calls = []

    def hook(x, p, stride, pads, dtype, float_conv):
        if "prediction" not in paths[p]:
            o, cpg, kh, kw = p.weight.shape
            calls.append((cpg * p.groups, o, kh, kw, stride, p.groups, pads,
                          (x.shape[0], x.shape[2], x.shape[3])))
        return float_conv(x)

    h, w = (int(v) for v in params.input.input_shape)
    with torch.no_grad(), conv_hook(hook):
        model(torch.empty(8, h, w, 3, device="meta"))
    return calls


def _want_design(c, kh, kw, stride, groups):
    """The rule, said again: depthwise convs with a square window of 1, 3
    or 5 at stride 1 or 2 and C % 8 == 0 are tiled by TMA; dense convs
    with 4 <= C <= 16 are narrow, the C = 3 stems "stem"."""
    if groups != 1:
        tiled = (kh == kw and kh in (1, 3, 5) and stride in (1, 2)
                 and c % 8 == 0)
        return "depthwise" if tiled else "depthwise_generic"
    if c < 4:
        return "stem"
    return "narrow" if c <= 16 else "wgmma"


def _check_depthwise_args(args, c, in_bytes, out_bytes,
                          budget=DW_SMEM_BUDGET):
    """The plan's limits: shared memory, TMA's boxes and strides, the
    block rows' reads inside a row, the planes' banks; the generic
    design's runs, tap words, staging runs and window blocks."""
    assert args.smem <= (budget if args.design == 0 else SMEM_LIMIT)
    assert budget <= SMEM_LIMIT
    assert DW_THREADS % args.dw_chunk == 0
    assert args.box_h == (args.tile_h - 1) * args.stride + args.taps_h
    assert args.box_w == (args.tile_w - 1) * args.stride + args.taps_w
    assert args.row_pitch % 4 == 0 and args.row_pitch >= args.box_w
    assert args.plane_pitch >= args.box_h * args.row_pitch
    assert (args.plane_pitch // 4) % 2 == 1 and args.plane_pitch % 4 == 0
    q_bytes = args.dw_chunk * args.plane_pitch
    assert args.q_off + q_bytes <= args.out_off
    assert args.q_off % 128 == 0 and args.out_off % 128 == 0
    if args.design == 0:  # "depthwise"
        assert args.taps_h == args.kh and args.taps_w == args.kw
        assert args.tile_h % DW_BLOCK == 0 and args.tile_w % DW_BLOCK == 0
        assert max(args.box_h, args.box_w, args.dw_chunk, args.tile_w,
                   args.tile_h) <= 256
        # TMA: global strides and the boxes' rows in multiples of 16 bytes
        assert (c * in_bytes) % 16 == 0 and (c * out_bytes) % 16 == 0
        assert (args.dw_chunk * in_bytes) % 16 == 0
        assert (args.dw_chunk * out_bytes) % 16 == 0
        assert args.stages >= 1
        raw = args.box_h * args.box_w * args.dw_chunk * in_bytes
        assert args.q_off == args.stages * (-(-raw // 128) * 128)
        staging = args.tile_h * args.tile_w * args.dw_chunk * out_bytes
        assert args.out_off + staging <= args.bar_off
        assert args.bar_off % 8 == 0
        assert args.bar_off + 8 * args.stages + 128 <= args.smem
        # a block's input row: words from column 4 bx S
        words = -(-(3 * args.stride + args.kw) // 4)
        assert ((args.tile_w - DW_BLOCK) * args.stride + 4 * words
                <= args.row_pitch)
    else:
        def align(v, b):
            return -(-v // b) * b
        chunk = args.dw_chunk
        rows = c <= chunk  # a run: a box (tile) row, else a pixel's chunk
        assert args.tile_h % DW_BLOCK == 0 and args.tile_w % DW_BLOCK == 0
        assert args.stages >= 1
        run_in = (args.box_w * c if rows else chunk) * in_bytes
        assert args.raw_pitch % 16 == 0 and args.raw_pitch >= run_in + 15
        runs = args.box_h if rows else args.box_h * args.box_w
        assert args.q_off == args.stages * align(runs * args.raw_pitch, 128)
        # a block row's reads (its outputs' tap words and the next word),
        # and the quantizer's words of 8 pixels
        assert args.row_pitch == max(
            (args.tile_w - DW_BLOCK) * args.stride
            + 4 * generic_words(args.stride, args.taps_w),
            align(args.box_w, 8))
        assert args.w_off % 128 == 0 and args.out_off % 128 == 0
        assert args.q_off + q_bytes <= args.w_off
        taps = args.kh * -(-args.kw // 4) * chunk * 4
        assert args.w_off + taps <= args.out_off
        run_out = (args.tile_w * c if rows else chunk) * out_bytes
        assert args.out_pitch % 16 == 0 and args.out_pitch >= run_out + 15
        staging = (args.tile_h if rows else args.tile_h * args.tile_w) * \
            args.out_pitch
        assert args.out_off + staging <= args.bar_off
        assert args.bar_off % 8 == 0
        assert 8 * args.stages <= GEN_DOUBTS_OFF
        # the warps' lists of elements in doubt, after the barriers
        assert (args.bar_off + GEN_DOUBTS_OFF
                + DW_THREADS // 32 * (GEN_DOUBTS + 1) * 4 + 128 <= args.smem)
        if args.taps_h < args.kh or args.taps_w < args.kw:
            # whole tap words a block; a thread's sums in registers across
            # the blocks: one block of outputs a thread
            assert args.taps_w % 4 == 0
            assert (args.tile_h // DW_BLOCK) * (args.tile_w // DW_BLOCK) \
                <= DW_THREADS // chunk


def _check_narrow_args(args, in_bytes, out_bytes):
    """The narrow plan's limits: shared memory and its layout, TMA's boxes
    and strides, the ldmatrix rows' alignment and banks, the staging
    swizzle's period."""
    c, o, s = args.c, args.o, args.stride
    tm = args.tile_h * args.tile_w
    assert args.smem <= max(NARROW_SMEM_BUDGETS) == SMEM_LIMIT
    assert args.tile_w % 8 == 0 and tm % 16 == 0
    assert args.box_h == (args.tile_h - 1) * s + args.kh
    assert args.box_w == (args.tile_w - 1) * s + args.kw
    assert max(args.box_h, args.box_w, args.tile_h, args.tile_w) <= 256
    assert args.flat == (args.kh == args.kw == 1 and s == 1
                         and args.pad_t == args.pad_l == 0
                         and args.oh == args.h and args.ow == args.w)
    if args.flat:
        assert args.tile_h == 1
    assert args.row_pitch == s * -(-args.box_w // s) * NARROW_PIXEL
    assert args.k_steps == -(-args.kh * args.kw // 2)
    # 8 weight rows of one ldmatrix phase on 8 distinct 16-byte bank groups
    assert args.w_pitch == 32 * args.k_steps + 16
    assert (args.w_pitch // 16) % 2 == 1
    assert args.o_pad % 16 == 0 and o <= args.o_pad < o + 16
    # a warp's unit: the narrowest that holds O, up to 128 channels (the
    # tile widths the module holds now: a plan variant may change them)
    tile_ns = int8_conv_kernel_module.NARROW_TILE_NS
    assert args.tile_n in tile_ns and set(tile_ns) <= set(NARROW_TILE_NS)
    assert args.tile_n >= args.o_pad or args.tile_n == max(tile_ns)
    assert args.q_off % 128 == 0 and args.w_off % 16 == 0
    assert args.out_off % 1024 == 0 and args.bar_off % 8 == 0
    assert args.q_off + args.box_h * args.row_pitch <= args.w_off
    assert args.w_off + args.o_pad * args.w_pitch <= args.sb_off
    assert args.sb_off + 8 * args.o_pad <= args.tap_off
    assert args.tap_off + 8 * args.k_steps <= args.out_off
    staging = narrow_staging_bytes(args.tile_h, args.tile_w, o, args.o_box,
                                   out_bytes, args.tma_out)
    assert args.out_off + args.out_bufs * staging <= args.bar_off
    assert args.bar_off + 8 * args.stages + 1024 <= args.smem
    maps = args.n * args.h * args.w >= NARROW_MAP_MIN_PIXELS
    assert args.tma_in == (maps and (c * in_bytes) % 16 == 0)
    assert args.tma_out == (maps and (o * out_bytes) % 16 == 0)
    if args.tma_in:
        # TMA: the box's rows whole 16-byte units, a ring of raw boxes
        raw = -(-args.box_h * args.box_w * c * in_bytes // 128) * 128
        assert args.stages >= 1 and args.q_off == args.stages * raw
    else:
        assert args.stages == 0 and args.q_off == 0
    if args.tma_out:
        # staging rows of 16 to 128 bytes, a power of two (the swizzle's
        # width), no wider than the output's rows; each box's tile a whole
        # number of swizzle periods (8 rows)
        rb = args.o_box * out_bytes
        assert rb in (16, 32, 64, 128) and args.o_box <= o
        assert (tm * rb) % (8 * rb) == 0 and args.out_bufs in (1, 2)
    else:
        assert args.o_box == o and args.out_bufs == 1


def _check_stem_args(args, in_bytes, out_bytes):
    """The stem plan's limits: shared memory and its layout, the box's rows
    (raw and quantized, the latter 8 words past a multiple of 32), K slots
    of one word, the output map's boxes and the staging swizzle's period."""
    c, o, s = args.c, args.o, args.stride
    tm = args.tile_h * args.tile_w
    assert c <= 3 and args.design == 5
    assert args.smem <= SMEM_LIMIT
    assert args.tile_w in (16, 32) and tm % 16 == 0
    assert args.box_h == (args.tile_h - 1) * s + args.kh
    assert args.box_w == (args.tile_w - 1) * s + args.kw
    assert not args.flat and not args.tma_in
    words = args.row_pitch // 4
    assert args.row_pitch % 4 == 0 and words % 32 == 8
    assert (words - 8) % s == 0 and (words - 8) // s >= -(-args.box_w // s)
    # a raw row holds the box row's bytes from a 16-byte unit's start
    assert args.raw_pitch % 16 == 0
    assert args.raw_pitch >= args.box_w * c * in_bytes + 15
    assert args.k_steps == -(-args.kw * -(-args.kh // 4) // 2)
    assert args.w_pitch == 32 * args.k_steps + 16
    assert (args.w_pitch // 16) % 2 == 1
    assert args.o_pad % 16 == 0 and o <= args.o_pad < o + 16
    tile_ns = int8_conv_kernel_module.NARROW_TILE_NS
    assert args.tile_n in tile_ns
    assert args.tile_n >= args.o_pad or args.tile_n == max(tile_ns)
    assert args.stages in (1, 2)
    raw = -(-args.box_h * args.raw_pitch // 128) * 128
    assert args.q_off == args.stages * raw
    assert args.q_off + args.box_h * args.row_pitch <= args.w_off
    assert args.w_off + args.o_pad * args.w_pitch <= args.sb_off
    assert args.sb_off + 8 * args.o_pad <= args.tap_off
    assert args.tap_off + 32 * args.k_steps <= args.out_off
    assert args.out_off % 1024 == 0
    staging = narrow_staging_bytes(args.tile_h, args.tile_w, o, args.o_box,
                                   out_bytes, args.tma_out)
    assert args.out_off + args.out_bufs * staging <= args.bar_off
    assert args.bar_off % 8 == 0
    assert args.bar_off + 8 * args.stages + 1024 <= args.smem
    maps = args.n * args.h * args.w >= NARROW_MAP_MIN_PIXELS
    assert args.tma_out == (maps and (o * out_bytes) % 16 == 0)
    if args.tma_out:
        rb = args.o_box * out_bytes
        assert rb in (16, 32, 64, 128) and args.o_box <= o
        assert args.tile_w <= 256 and args.tile_h <= 256
        assert args.out_bufs in (1, 2)
    else:
        assert args.o_box == o and args.out_bufs == 1


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_design_of_every_int8_conv(name):
    calls = _int8_calls(name)
    assert len(calls) == sum(_DESIGNS[name].values())
    designs = {}
    for c, o, kh, kw, stride, groups, pads, (n, h, w) in calls:
        design = int8_design(c, o, kh, kw, stride, groups)
        assert design == _want_design(c, kh, kw, stride, groups), \
            (c, o, kh, stride, groups)
        designs[design] = designs.get(design, 0) + 1
        if design == "depthwise":
            for in_bytes, out_bytes in ((2, 2), (4, 4), (2, 4), (4, 2)):
                _, args, scratch = conv_args(
                    (n, h, w, c), (kh * kw, c), o, stride, pads, groups, kh,
                    kw, in_bytes, out_bytes)
                assert scratch == 0
                _check_depthwise_args(args, c, in_bytes, out_bytes)
            continue
        if design == "narrow":
            packed_shape = (o, dense_k_words(c, kh, kw)[1])
            for in_bytes, out_bytes in ((2, 2), (4, 4), (2, 4), (4, 2)):
                _, args, scratch = conv_args(
                    (n, h, w, c), packed_shape, o, stride, pads, groups, kh,
                    kw, in_bytes, out_bytes)
                assert scratch == 0
                _check_narrow_args(args, in_bytes, out_bytes)
            continue
        if design == "stem":
            packed_shape = (o, dense_k_words(c, kh, kw)[1])
            for in_bytes, out_bytes in ((2, 2), (4, 4), (2, 4), (4, 2)):
                _, args, scratch = conv_args(
                    (n, h, w, c), packed_shape, o, stride, pads, groups, kh,
                    kw, in_bytes, out_bytes)
                assert scratch == 0
                _check_stem_args(args, in_bytes, out_bytes)
            continue
        if design != "wgmma":
            continue
        packed_shape = (o, dense_k_words(c, kh, kw)[1])
        _, args, scratch = conv_args((n, h, w, c), packed_shape, o, stride,
                                     pads, groups, kh, kw)
        assert args.tile_n in TILE_NS
        assert args.c_tap % 32 == 0 and scratch % 16 == 0
        assert args.chunk in CHUNKS and (4 * args.k_pad) % args.chunk == 0
        # the im2col map's limits for a 4-d tensor: corners in [-128, 127],
        # traversal strides in [1, 8]
        for v in (args.lower_w, args.lower_h, args.upper_w, args.upper_h):
            assert -128 <= v <= 127
        assert 1 <= args.q_stride <= 8
        assert args.sub == (stride if kh == kw == 1 and stride > 1 else 1)
    assert designs == _DESIGNS[name]


def test_design_rule():
    assert int8_design(3, 64, 7, 7, 2, 1) == "stem"     # the stems
    assert int8_design(3, 32, 3, 3, 2, 1) == "stem"
    assert int8_design(3, 16, 3, 3, 2, 1) == "stem"
    assert int8_design(1, 8, 3, 3, 1, 1) == "stem"
    assert int8_design(2, 70, 5, 5, 2, 1, aligned=False) == "stem"
    assert int8_design(16, 96, 1, 1, 1, 1) == "narrow"
    assert int8_design(4, 16, 1, 1, 1, 1) == "narrow"
    assert int8_design(8, 16, 3, 3, 1, 1) == "narrow"
    assert int8_design(16, 128, 5, 5, 2, 1) == "narrow"
    # the alignment does not move a dense conv off narrow (its threads load
    # what TMA cannot take)
    assert int8_design(8, 32, 1, 1, 1, 1, aligned=False) == "narrow"
    assert int8_design(17, 64, 3, 3, 1, 1) == "wgmma"
    # EfficientNet-lite's C = 24 and 40: wgmma, taps padded to 32 and 64
    assert int8_design(24, 144, 1, 1, 1, 1) == "wgmma"
    assert tap_channels(24) == 32
    assert int8_design(40, 240, 1, 1, 1, 1) == "wgmma"
    assert tap_channels(40) == 64
    assert int8_design(256, 512, 1, 1, 2, 1) == "wgmma"
    assert int8_design(96, 96, 3, 3, 2, 96) == "depthwise"
    assert [tap_channels(c) for c in (3, 6, 16, 64, 88, 208)] == \
        [4, 8, 16, 64, 96, 224]
    # depthwise: TMA takes windows of 1, 3 and 5 at stride 1 or 2 with C a
    # multiple of 8 on an aligned input; the generic design all the rest
    for k in (1, 3, 5):
        for stride in (1, 2):
            assert int8_design(16, 16, k, k, stride, 16) == "depthwise"
    assert int8_design(7, 7, 5, 5, 1, 7) == "depthwise_generic"
    assert int8_design(12, 12, 3, 3, 1, 12) == "depthwise_generic"
    assert int8_design(16, 16, 7, 7, 1, 16) == "depthwise_generic"
    assert int8_design(16, 16, 3, 5, 1, 16) == "depthwise_generic"
    assert int8_design(16, 16, 3, 3, 3, 16) == "depthwise_generic"
    assert int8_design(16, 16, 3, 3, 1, 16, aligned=False) == \
        "depthwise_generic"
    # the alignment is a depthwise matter only
    assert int8_design(64, 64, 3, 3, 1, 1, aligned=False) == "wgmma"


def test_chunk_follows_c_tap():
    assert [wgmma_chunk(c) for c in (32, 64, 96, 128, 160, 256, 2048)] == \
        [32, 64, 128, 128, 128, 128, 128]


def test_tile_n_follows_o():
    m = 8 * 80 * 80
    assert wgmma_tile_n(36, m) == 64
    assert wgmma_tile_n(64, m) == 64
    assert wgmma_tile_n(128, m) == 128
    assert wgmma_tile_n(256, m) == 256
    assert wgmma_tile_n(720, m) == 256
    # fewer 256-wide tiles than the card's SMs
    assert wgmma_tile_n(256, 8 * 10 * 10) == 128


@pytest.mark.parametrize("c,k", [(3, 7), (6, 3), (16, 1), (17, 3), (24, 3),
                                 (40, 1), (64, 1), (88, 3), (256, 3)],
                         ids=["c3k7", "c6k3", "c16k1", "c17k3", "c24k3",
                              "c40k1", "c64k1", "c88k3", "c256k3"])
def test_pack_round_trip_padded_layout(c, k):
    rng = np.random.default_rng(c + k)
    o = 5
    qw = torch.from_numpy(rng.integers(-127, 128, (o, c, k, k))
                          .astype(np.int8))
    packed = pack_weights(qw, 1)
    words, padded = dense_k_words(c, k, k)
    assert packed.dtype == torch.int32
    assert packed.shape == (o, padded) and padded % K_WORDS_ALIGN == 0
    assert torch.equal(unpack_weights(packed, o, c, k, k, 1), qw)
    # tap t of output channel j holds its c weights at bytes t * c_tap,
    # then zeros up to the next tap, and zero words past K
    raw = packed.view(torch.int8).reshape(o, 4 * padded)
    c_tap = tap_channels(c)
    taps = raw[:, :4 * words].reshape(o, k * k, c_tap)
    assert torch.equal(taps[:, :, :c],
                       qw.permute(0, 2, 3, 1).reshape(o, k * k, c))
    assert not taps[:, :, c:].any() and not raw[:, 4 * words:].any()


def _earlier_layout(qw):
    """The earlier layout: ceil(C / 4) words a tap, rows padded to 16."""
    o, c, kh, kw = qw.shape
    cw = -(-c // 4)
    w = F.pad(qw.permute(0, 2, 3, 1), (0, 4 * cw - c))
    w = w.reshape(o, 4 * kh * kw * cw).contiguous().view(torch.int32)
    return F.pad(w, (0, -(-w.shape[1] // 16) * 16 - w.shape[1])).contiguous()


@pytest.mark.parametrize("c,k", [(24, 3), (64, 1)], ids=["c24k3", "c64k1"])
def test_earlier_layout_is_refused(c, k):
    qw = torch.ones((8, c, k, k), dtype=torch.int8)
    old = _earlier_layout(qw)
    assert old.shape != pack_weights(qw, 1).shape
    x = torch.zeros((1, 6, 6, c))
    with pytest.raises(ValueError, match="packed weights"):
        int8_conv2d(x, old, torch.ones(8), None, 0.1, 1,
                    (k // 2,) * 4, 1, k, k, torch.float32)


# (name, N, H, W, C, k, stride, pads or "SAME"): every case has a ragged
# last tile; the 3x3/1 tiles cross rows and images; C = 136 has a second,
# ragged channel chunk
_TRAVERSALS = [
    ("3x3_s1_same", 2, 13, 11, 40, 3, 1, "SAME"),
    ("3x3_s2_same_asym", 3, 14, 12, 24, 3, 2, "SAME"),
    ("3x3_s1_c136", 1, 9, 17, 136, 3, 1, "SAME"),
    ("1x1_s2", 3, 15, 16, 64, 1, 2, (0, 0, 0, 0)),
    ("7x7_s2", 2, 20, 19, 32, 7, 2, (3, 3, 3, 3)),
]


def tile_start(plan: Im2colPlan, m0: int) -> Tuple[int, int, int]:
    """(w, h, n) of output pixel m0's window origin: the coordinates the
    kernel's producer gives every copy of the CTA whose tile starts at
    m0."""
    pixels = plan.oh * plan.ow
    n0, rem = divmod(m0, pixels)
    return (plan.lower[0] + (rem % plan.ow) * plan.stride,
            plan.lower[1] + (rem // plan.ow) * plan.stride, n0)


def im2col_origins(plan: Im2colPlan, start: Tuple[int, int, int],
                   rows: int = TILE_M) -> np.ndarray:
    """(rows, 3) window origins (n, h, w) that one copy walks from
    `start`, in the map's traversal order."""
    w, h, n = start
    last_w = plan.qw - 1 + plan.upper[0]
    last_h = plan.qh - 1 + plan.upper[1]
    out = np.empty((rows, 3), np.int64)
    for r in range(rows):
        out[r] = (n, h, w)
        w += plan.stride
        if w > last_w:
            w, h = plan.lower[0], h + plan.stride
            if h > last_h:
                h, n = plan.lower[1], n + 1
    return out


def im2col_tile(q: np.ndarray, plan: Im2colPlan, m0: int, tap: int,
                chunk: int, width: int) -> np.ndarray:
    """The (TILE_M, width) int8 tile that the copy of stage (tap, chunk)
    brings for the CTA at m0, stages `width` channels wide, from q (N, qh,
    qw, c_tap): zero where the shifted origin or the channel falls outside
    q."""
    origins = im2col_origins(plan, tile_start(plan, m0))
    n, h, w = origins[:, 0], origins[:, 1] + tap // plan.kw, \
        origins[:, 2] + tap % plan.kw
    inside = ((n < q.shape[0]) & (h >= 0) & (h < plan.qh) & (w >= 0)
              & (w < plan.qw))
    tile = np.zeros((TILE_M, width), np.int8)
    c0 = chunk * width
    real = max(0, min(width, plan.c_tap - c0))
    tile[inside, :real] = q[n[inside], h[inside], w[inside], c0:c0 + real]
    return tile


def quantized_input_plain(x: torch.Tensor, s_a: float,
                          plan: Im2colPlan) -> torch.Tensor:
    """The wgmma design's quantizing pass in plain PyTorch: x (N, H, W, C)
    -> q (N, qh, qw, c_tap) int8 as `Im2colPlan` says, the channels past C
    and the pixels outside x zero."""
    n, h, w, c = x.shape
    top, left = plan.sub_pads
    src = torch.zeros((n, plan.qh, plan.qw, c), dtype=x.dtype,
                      device=x.device)
    ys = torch.arange(plan.qh) * plan.sub - top
    xs = torch.arange(plan.qw) * plan.sub - left
    iy = ((ys >= 0) & (ys < h)).nonzero().flatten()
    ix = ((xs >= 0) & (xs < w)).nonzero().flatten()
    src[:, iy[:, None], ix] = x[:, ys[iy][:, None], xs[ix]]
    q = torch.zeros((n, plan.qh, plan.qw, plan.c_tap), dtype=torch.int8,
                    device=x.device)
    q[..., :c] = quantize_activation(src, s_a)
    return q


def _plan_of(args):
    """The plan as the kernel sees it: from the fields passed to it."""
    return Im2colPlan(args.qh, args.qw, args.c_tap, args.sub,
                      (args.pad_t, args.pad_l) if args.sub > 1 else (0, 0),
                      args.kh, args.kw, args.q_stride,
                      (args.lower_w, args.lower_h),
                      (args.upper_w, args.upper_h), args.oh, args.ow)


@pytest.mark.parametrize("case", _TRAVERSALS, ids=[t[0] for t in _TRAVERSALS])
def test_im2col_copies_equal_unfold(case):
    _, n, h, w, c, k, stride, pads = case
    if pads == "SAME":
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    rng = np.random.default_rng(k * 10 + stride)
    # integers within int8 at s_a = 1: the quantized input is x itself
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c))
                         .astype(np.float32))
    qw = torch.ones((4, c, k, k), dtype=torch.int8)
    design, args, scratch = conv_args(x.shape, pack_weights(qw, 1).shape, 4,
                                      stride, pads, 1, k, k)
    assert design == "wgmma"
    plan = _plan_of(args)
    q = quantized_input_plain(x, 1.0, plan).numpy()
    assert q.size == scratch
    top, bottom, left, right = pads
    cols = F.unfold(F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom)),
                    (k, k), stride=stride)              # (N, C k k, L)
    want = cols.reshape(n, c, k * k, -1).permute(0, 3, 2, 1).reshape(
        -1, k * k, c).numpy()                           # (M, taps, C)
    m = want.shape[0]
    assert m == n * args.oh * args.ow and m % TILE_M != 0
    chunks = -(-args.c_tap // args.chunk)
    taps = plan.kh * plan.kw
    for m0 in range(0, m, TILE_M):
        rows = min(TILE_M, m - m0)
        for tap in range(taps):
            got = np.concatenate([im2col_tile(q, plan, m0, tap, ch,
                                              args.chunk)
                                  for ch in range(chunks)], axis=1)
            np.testing.assert_array_equal(got[:rows, :c],
                                          want[m0:m0 + rows, tap])
            assert not got[:rows, c:].any()


def test_strided_1x1_quantizing_pass():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 2, (2, 15, 16, 40))
                         .astype(np.float32)).to(torch.bfloat16)
    s_a = 0.031
    _, args, _ = conv_args(x.shape, (8, dense_k_words(40, 1, 1)[1]), 8, 2,
                           (0, 0, 0, 0), 1, 1, 1)
    plan = _plan_of(args)
    assert (plan.sub, plan.qh, plan.qw, plan.c_tap) == (2, 8, 8, 64)
    got = quantized_input_plain(x, s_a, plan)
    want = quantize_activation(x[:, ::2, ::2], s_a)
    assert torch.equal(got[..., :40], want)
    assert not got[..., 40:].any()


def test_experiment_edits_apply():
    """Every one-edit variant of `tools/int8_conv_experiments.py` still
    applies to `csrc/int8_conv.cu`, each edit exactly once; every plan
    variant names constants of the wrapper and gives a plan that fits."""
    from retinanet_torch.ops import int8_conv_kernel
    from retinanet_torch.tools.int8_conv_experiments import (
        DW_PLANS, DW_SHAPES, DW_VARIANTS, GEN_PLANS, GEN_VARIANTS,
        GENERIC_SHAPES, NARROW_PLANS, NARROW_ROUTES, NARROW_SHAPES,
        NARROW_VARIANTS, STEM_PLANS, STEM_ROUTES, VARIANTS, plan_constants,
        routed)
    from retinanet_torch.tools.kernel_variants import variant_source
    kernel = int8_conv_kernel.kernel
    for name, edits in {**VARIANTS, **DW_VARIANTS, **GEN_VARIANTS,
                        **NARROW_VARIANTS}.items():
        source = variant_source(kernel, name, edits)
        assert source != kernel.source.read_text()
    # the generic plan variants fit at every generic call of the tool, each
    # a call the generic design takes
    for name, changes in {"base": {}, **GEN_PLANS}.items():
        for constant in changes:
            assert hasattr(int8_conv_kernel, constant), (name, constant)
        for label, (n, h, w, c), k, stride, offset in GENERIC_SHAPES:
            pads = same_pads(h, k, stride) + same_pads(w, k, stride)
            with plan_constants(changes):
                design, args, _ = conv_args((n, h, w, c), (k * k, c), c,
                                            stride, pads, c, k, k, 2, 2,
                                            offset == 0)
            assert design == "depthwise_generic", label
            _check_depthwise_args(args, c, 2, 2)
    # the narrow plan variants fit at every narrow shape of the tool, and
    # each route sends its shapes to the other design
    for name, changes in NARROW_PLANS.items():
        for constant in changes:
            assert hasattr(int8_conv_kernel, constant), (name, constant)
        for label, (n, h, w, c), o, k, stride, pads in NARROW_SHAPES:
            if c < int8_conv_kernel.NARROW_MIN_CHANNELS:
                continue
            packed_shape = (o, dense_k_words(c, k, k)[1])
            with plan_constants(changes):
                _, args, _ = conv_args((n, h, w, c), packed_shape, o, stride,
                                       pads, 1, k, k)
                _check_narrow_args(args, 2, 2)
    # the stem plan variants fit at the tool's stems
    for name, changes in STEM_PLANS.items():
        for constant in changes:
            assert hasattr(int8_conv_kernel, constant), (name, constant)
        for label, (n, h, w, c), o, k, stride, pads in NARROW_SHAPES:
            if c >= int8_conv_kernel.NARROW_MIN_CHANNELS:
                continue
            packed_shape = (o, dense_k_words(c, k, k)[1])
            with plan_constants(changes):
                _, args, _ = conv_args((n, h, w, c), packed_shape, o, stride,
                                       pads, 1, k, k)
                _check_stem_args(args, 2, 2)
    for label, (n, h, w, c), o, k, stride, pads in NARROW_SHAPES:
        base = int8_design(c, o, k, k, stride, 1)
        routes = (NARROW_ROUTES if base == "narrow" else STEM_ROUTES)
        for other, route in routes.items():
            with routed(route):
                assert int8_design(c, o, k, k, stride, 1) == other, label
        assert base in ("narrow", "stem")
        assert int8_design(c, o, k, k, stride, 1) == base
    for name, changes in DW_PLANS.items():
        for constant in changes:
            assert hasattr(int8_conv_kernel, constant), (name, constant)
        plans = set()
        for label, (n, h, w, c), k, stride in DW_SHAPES:
            pads = same_pads(h, k, stride) + same_pads(w, k, stride)
            with plan_constants(changes):
                _, args, _ = conv_args((n, h, w, c), (k * k, c), c, stride,
                                       pads, c, k, k)
                budget = int8_conv_kernel.DW_SMEM_BUDGET
            _check_depthwise_args(args, c, 2, 2, budget)
            plans.add((args.tile_h, args.tile_w, args.dw_chunk,
                       args.stages))
        _, args, _ = conv_args((8, 64, 64, 160), (9, 160), 160, 1,
                               (1, 1, 1, 1), 160, 3, 3)
        # the base plan is back after the block
        assert (args.dw_chunk, args.stages) == (32, 2)


# -- the depthwise designs ----------------------------------------------------

def _dw_items(args, n, oh, ow, c):
    """The work items in the kernel's order: (image, tile row, tile col,
    chunk), chunk fastest."""
    tiles_y = -(-oh // args.tile_h)
    tiles_x = -(-ow // args.tile_w)
    chunks = -(-c // args.dw_chunk)
    for item in range(n * tiles_y * tiles_x * chunks):
        ci, rest = item % chunks, item // chunks
        tx, rest = rest % tiles_x, rest // tiles_x
        yield rest // tiles_y, rest % tiles_y, tx, ci


def _dw_planes(qx, args, img, y0, x0, c0, rng):
    """The int8 planes (chunk, box_h, row_pitch) that one box becomes: the
    box from (y0, x0) of image `img`, channels from c0, zero outside the
    input (TMA's fill) and past C; the bytes of a row past the quantized
    words are left as they were (here: noise)."""
    _, h, w, c = qx.shape
    chunk = args.dw_chunk
    planes = rng.integers(-128, 128, (chunk, args.box_h, args.row_pitch))
    planes[:, :, :-(-args.box_w // 4) * 4] = 0
    ys = np.arange(args.box_h) + y0
    xs = np.arange(args.box_w) + x0
    iy = np.flatnonzero((ys >= 0) & (ys < h))
    ix = np.flatnonzero((xs >= 0) & (xs < w))
    cs = min(chunk, c - c0)
    box = np.zeros((args.box_h, args.box_w, chunk), np.int64)
    box[iy[:, None], ix, :cs] = qx[img, ys[iy][:, None], xs[ix], c0:c0 + cs]
    planes[:, :, :args.box_w] = box.transpose(2, 0, 1)
    return planes


def _dw_weight_words(wk, k, s):
    """The "depthwise" kernel's dp4a weight words as bytes: (chunk, K, 4,
    words, 4), w[r][q] at byte b of word kk for output i of a block, where
    q = 4 kk + b - s i; wk (K, K, chunk)."""
    words = -(-(3 * s + k) // 4)
    out = np.zeros((wk.shape[2], k, DW_BLOCK, words, 4), np.int64)
    for i in range(DW_BLOCK):
        for kk in range(words):
            for b in range(4):
                q = 4 * kk + b - s * i
                if 0 <= q < k:
                    out[:, :, i, kk, b] = wk[:, q, :].T
    return out


def _store(acc, tile, img, oy0, ox0, c0):
    """The tile's store, clipped at the plane's and the channels' edges
    (TMA's, or the generic kernel's bounds); counts each output written."""
    _, oh, ow, c = acc.shape
    rows, cols = min(tile.shape[0], oh - oy0), min(tile.shape[1], ow - ox0)
    cs = min(tile.shape[2], c - c0)
    acc[img, oy0:oy0 + rows, ox0:ox0 + cols, c0:c0 + cs] += \
        tile[:rows, :cols, :cs]
    return rows * cols * cs


def depthwise_walk(qx, wq, args, pads):
    """int32 accumulators of the "depthwise" kernel, walked as it walks:
    qx (N, H, W, C) int8, wq (K K, C) int8, `args` the wrapper's."""
    n, _, _, c = qx.shape
    k, s = args.kh, args.stride
    rng = np.random.default_rng(0)
    acc = np.zeros((n, args.oh, args.ow, c), np.int64)
    written = 0
    rows = (DW_BLOCK - 1) * s + k
    words = -(-(3 * s + k) // 4)
    chunk = args.dw_chunk
    for img, ty, tx, ci in _dw_items(args, n, args.oh, args.ow, c):
        c0 = ci * chunk
        planes = _dw_planes(qx, args, img, ty * args.tile_h * s - pads[0],
                            tx * args.tile_w * s - pads[2], c0, rng)
        wk = np.zeros((k, k, chunk), np.int64)
        wk[:, :, :min(chunk, c - c0)] = \
            wq.reshape(k, k, c)[:, :, c0:c0 + chunk]
        wt = _dw_weight_words(wk, k, s)
        tile = np.zeros((args.tile_h, args.tile_w, chunk), np.int64)
        for by in range(args.tile_h // DW_BLOCK):
            for bx in range(args.tile_w // DW_BLOCK):
                col = DW_BLOCK * bx * s
                assert col + 4 * words <= args.row_pitch
                block = planes[:, DW_BLOCK * by * s:DW_BLOCK * by * s + rows,
                               col:col + 4 * words]
                assert block.shape[1] == rows
                block = block.reshape(chunk, rows, words, 4)
                for j in range(DW_BLOCK):
                    for i in range(DW_BLOCK):
                        tile[DW_BLOCK * by + j, DW_BLOCK * bx + i] = sum(
                            (block[:, j * s + r] * wt[:, r, i]).sum((1, 2))
                            for r in range(k))
        written += _store(acc, tile, img, ty * args.tile_h,
                          tx * args.tile_w, c0)
    assert written == acc.size          # every output once
    return acc


def generic_units(args, n, oh, ow, c):
    """The generic kernel's load units in one CTA's order: for each item
    (`_dw_items`), its window blocks (row-major), as (item tuple, r0, q0)."""
    blocks_w = -(-args.kw // args.taps_w)
    blocks_h = -(-args.kh // args.taps_h)
    for item in _dw_items(args, n, oh, ow, c):
        for wb in range(blocks_h * blocks_w):
            yield item, wb // blocks_w * args.taps_h, \
                wb % blocks_w * args.taps_w


def generic_box(args, item, r0, q0, pads):
    """`gen_box`: the box's origin in the input, its columns in the input
    [lo, hi) (hi == lo where none is: a window block wholly right of the
    input), the chunk's channels."""
    img, ty, tx, ci = item
    s = args.stride
    iy0 = ty * args.tile_h * s - pads[0] + r0
    ix0 = tx * args.tile_w * s - pads[2] + q0
    lo = max(0, -ix0)
    hi = max(lo, min(args.box_w, args.w - ix0))
    cs = min(args.dw_chunk, args.c - ci * args.dw_chunk)
    return iy0, ix0, lo, hi, cs


def generic_copies(buf, x_off, args, in_bytes, item, iy0, ix0, lo, hi, cs):
    """`gen_copy_box`: the 16-byte units the threads copy, as (slot byte,
    input byte) pairs; `buf` holds the input from byte x_off (byte 0 of
    buf 16-byte aligned). Each unit holds a byte of the input."""
    img, _, _, ci = item
    h, w, c, e = args.h, args.w, args.c, in_bytes
    rows = c <= args.dw_chunk
    nbytes = args.n * h * w * c * e
    out = []
    if hi <= lo:
        return out
    for yy in range(max(0, -iy0), min(args.box_h, h - iy0)):
        if rows:
            col0 = x_off + ((img * h + iy0 + yy) * w + ix0) * c * e
            first = col0 + lo * c * e
            src = first // 16 * 16
            end = -(-(first + (hi - lo) * c * e) // 16) * 16
            dst = yy * args.raw_pitch + src - col0 // 16 * 16
            assert dst >= yy * args.raw_pitch
            assert dst + end - src <= (yy + 1) * args.raw_pitch
            out += [(dst + k, src + k) for k in range(0, end - src, 16)]
        else:
            per = args.raw_pitch // 16
            for xx in range(lo, hi):
                first = x_off + (((img * h + iy0 + yy) * w + ix0 + xx) * c
                                 + ci * args.dw_chunk) * e
                for k in range(per):
                    src = first // 16 * 16 + 16 * k
                    if src < first + cs * e:
                        out.append(((yy * args.box_w + xx) * args.raw_pitch
                                    + 16 * k, src))
    for _, src in out:
        assert src < x_off + nbytes and src + 16 > x_off, "a unit past x"
        assert 0 <= src and src + 16 <= len(buf)
    return out


def generic_element_at(args, in_bytes, x_off, item, iy0, ix0, yy, xx, c):
    """Where `gen_quantize_box` reads element (yy, xx, c) of the box in the
    raw box: the run's slot, its lead mod 16, the element's place."""
    img, _, _, ci = item
    e = in_bytes
    lead0 = x_off + ((img * args.h + iy0) * args.w + ix0) * args.c * e
    if args.c > args.dw_chunk:
        lead0 += ci * args.dw_chunk * e
    lead = lead0 + yy * args.w * args.c * e
    if args.c <= args.dw_chunk:
        return yy * args.raw_pitch + lead % 16 + (xx * args.c + c) * e
    return ((yy * args.box_w + xx) * args.raw_pitch
            + (lead + xx * args.c * e) % 16 + c * e)


def _decode(raw_bytes, in_bytes):
    """float32 values of little-endian bfloat16 (2) or float32 (4) bytes."""
    if in_bytes == 2:
        bits = raw_bytes.view("<u2").astype(np.uint32) << 16
        return bits.view(np.float32)
    return raw_bytes.view("<f4").astype(np.float32)


def generic_raw_box(buf, x_off, args, in_bytes, item, box, stage):
    """One load into a ring stage (bytes, kept across loads): the copies
    land; returns the stage and the mask of the bytes this load wrote."""
    copies = generic_copies(buf, x_off, args, in_bytes, item, *box)
    fresh = np.zeros(stage.shape, bool)
    for dst, src in copies:
        stage[dst:dst + 16] = buf[src:src + 16]
        fresh[dst:dst + 16] = True
    return fresh


def generic_box_values(args, in_bytes, x_off, item, box, stage, fresh):
    """The box's float32 values as `gen_quantize_box` reads them (zeros
    outside the input and past cs), each from bytes this load wrote."""
    iy0, ix0, lo, hi, cs = box
    yy, xx, cc = np.meshgrid(np.arange(args.box_h), np.arange(args.box_w),
                             np.arange(args.dw_chunk), indexing="ij")
    # the kernel's test: (unsigned)(x - lo) < (unsigned)(hi - lo)
    live = ((iy0 + yy >= 0) & (iy0 + yy < args.h)
            & (((xx - lo) & 0xFFFFFFFF) < ((hi - lo) & 0xFFFFFFFF))
            & (cc < cs))
    vals = np.zeros(yy.shape, np.float32)
    if live.any():
        at = generic_element_at(args, in_bytes, x_off, item, iy0, ix0,
                                yy[live], xx[live], cc[live])
        idx = at[:, None] + np.arange(in_bytes)
        assert fresh[idx].all(), "an element no copy of this box wrote"
        vals[live] = _decode(np.ascontiguousarray(stage[idx]).reshape(-1),
                             in_bytes)
    return vals


def generic_tap_words(wq, args, ci):
    """The chunk's tap words as bytes (kh, ceil(kw / 4), chunk, 4):
    w[r][4 g + k] at byte k, zeros past the window and past C."""
    kh, kw, c, chunk = args.kh, args.kw, args.c, args.dw_chunk
    groups = -(-kw // 4)
    out = np.zeros((kh, groups * 4, chunk), np.int64)
    cs = min(chunk, c - ci * chunk)
    out[:, :kw, :cs] = wq.reshape(kh, kw, c)[:, :, ci * chunk:ci * chunk + cs]
    return out.reshape(kh, groups, 4, chunk).transpose(0, 1, 3, 2)


def _words(b):
    """int32 words (little-endian) of bytes b (..., 4k) as uint64."""
    b = b.astype(np.uint64)
    return (b[..., 0::4] | b[..., 1::4] << 8 | b[..., 2::4] << 16
            | b[..., 3::4] << 24)


def _dp4a(word, wbytes):
    """__dp4a(word, w, 0): the signed bytes of `word` dotted with wbytes
    (..., 4) signed."""
    parts = [((word >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.int64)
             for k in range(4)]
    return sum(np.where(p > 127, p - 256, p) * wbytes[..., k]
               for k, p in enumerate(parts))


def generic_products(planes, taps, args, r0, q0, acc):
    """`gen_products` over every 4 x 4 block of the tile and every channel
    at once: acc (chunk, nby, nbx, 4, 4) += the window block's sums, from
    the block rows' int32 words, shifted to each output's first byte."""
    s, chunk = args.stride, args.dw_chunk
    rows = min(args.taps_h, args.kh - r0)
    groups = -(-min(args.taps_w, args.kw - q0) // 4)
    nby, nbx = args.tile_h // DW_BLOCK, args.tile_w // DW_BLOCK
    words = _words(planes)  # (chunk, box_h, row_pitch / 4)
    by = np.arange(nby)[:, None]
    bx = np.arange(nbx)[None, :]
    for yy in range(3 * s + rows):
        for gg in range(groups):
            sh = []
            for i in range(DW_BLOCK):
                off = s * i + 4 * gg
                k = bx * s + (off >> 2)
                assert (k + 1 < words.shape[2]).all()
                lo = words[:, DW_BLOCK * by * s + yy, k]
                hi = words[:, DW_BLOCK * by * s + yy, k + 1]
                sh.append(((hi << np.uint64(32) | lo)
                           >> np.uint64(8 * (off & 3))) & np.uint64(0xFFFFFFFF))
            for j in range(DW_BLOCK):
                r = yy - j * s
                if not 0 <= r < rows:
                    continue
                wt = taps[r0 + r, q0 // 4 + gg][:, None, None, :]
                for i in range(DW_BLOCK):
                    acc[:, :, :, j, i] += _dp4a(sh[i], wt)


def generic_quantize(vals, s_a, planes):
    """`gen_quantize_box` into the planes (chunk, box_h, row_pitch): two
    words of eight pixels a row at a time, the bytes past them left as
    they were."""
    chunk, box_h, box_w = vals.shape[2], vals.shape[0], vals.shape[1]
    q = quantize_byte_model(vals, s_a).astype(np.int64) & 0xFF
    width = -(-box_w // 8) * 8
    assert width <= planes.shape[2]
    planes[:, :, :width] = 0
    planes[:, :, :box_w] = q.transpose(2, 0, 1)


def generic_store(acc_tile, args, item, y_vals, y_count, out_bytes):
    """The epilogue's staging runs and the threads' 16-byte units to y:
    y_vals / y_count indexed by y's bytes (an element's value at its first
    byte); the tile's outputs past the plane are not staged."""
    img, ty, tx, ci = item
    c, chunk, e = args.c, args.dw_chunk, out_bytes
    rows = c <= chunk
    oy0, ox0 = ty * args.tile_h, tx * args.tile_w
    th, tw = min(args.tile_h, args.oh - oy0), min(args.tile_w, args.ow - ox0)
    cs = min(chunk, c - ci * chunk)
    nruns = args.tile_h if rows else args.tile_h * args.tile_w
    stage = np.full(nruns * args.out_pitch, -(1 << 40), np.int64)

    def first_of(oy, ox):  # the run's first element in y (bytes)
        if rows:
            return ((img * args.oh + oy0 + oy) * args.ow + ox0) * c * e
        return (((img * args.oh + oy0 + oy) * args.ow + ox0 + ox) * c
                + ci * chunk) * e
    oy, ox, cl = np.meshgrid(np.arange(th), np.arange(tw), np.arange(cs),
                             indexing="ij")
    first = first_of(oy, 0 if rows else ox)
    run = oy if rows else oy * args.tile_w + ox
    place = first % 16 + ((ox * c + cl) if rows else cl) * e
    assert (place + e <= args.out_pitch).all()
    stage[run * args.out_pitch + place] = acc_tile[oy, ox, cl]
    per = args.out_pitch // 16
    for run in range(nruns):
        oy, ox = (run, 0) if rows else divmod(run, args.tile_w)
        if oy >= th or ox >= tw:
            continue
        first = first_of(oy, ox)
        end = first + (tw * c if rows else cs) * e
        for k in range(per):
            dst = first // 16 * 16 + 16 * k
            if dst >= end:
                continue
            src = run * args.out_pitch + 16 * k
            for b in range(0, 16, e):
                if first <= dst + b < end:
                    y_vals[dst + b] = stage[src + b]
                    y_count[dst + b] += 1


def generic_walk(qx, wq, args, pads, in_bytes=2, out_bytes=2,
                 x_off=2, grid=3):
    """int32 accumulators of the "depthwise_generic" kernel, walked as it
    walks: the input (qx as bfloat16 or float32 values, quantized at s_a =
    1, which gives qx back) x_off bytes past a 16-byte unit of a buffer of
    NaN and inf; `grid` CTAs, each with its ring of raw boxes, its planes
    and staging kept across its load units (noise at first); the copies,
    the quantization, the tap words, the products and the store to y's
    bytes, each as the kernel does them."""
    n, _, _, c = qx.shape
    rng = np.random.default_rng(1)
    e = in_bytes
    xv = qx.astype(np.float32)
    raw = (xv.view(np.uint32) >> 16).astype("<u2") if e == 2 else \
        xv.astype("<f4")
    pad = np.frombuffer(np.float32([np.nan, np.inf, -np.inf, np.nan] * 8)
                        .tobytes(), np.uint8)
    buf = np.concatenate([pad[:x_off], raw.view(np.uint8).reshape(-1),
                          pad[:32]])
    chunk = args.dw_chunk
    y_vals = np.zeros(n * args.oh * args.ow * c * out_bytes + 32, np.int64)
    y_count = np.zeros_like(y_vals)
    raw_stride = args.q_off // args.stages
    units = list(generic_units(args, n, args.oh, args.ow, c))
    blocks = -(-args.kh // args.taps_h) * -(-args.kw // args.taps_w)
    items = len(units) // blocks
    for cta in range(min(grid, items)):
        mine = [u for k, u in enumerate(units) if (k // blocks) % grid == cta]
        ring = rng.integers(0, 256, (args.stages, raw_stride), np.uint8)
        planes = rng.integers(0, 256, (chunk, args.box_h, args.row_pitch),
                              np.uint8)
        for load, (item, r0, q0) in enumerate(mine):
            box = generic_box(args, item, r0, q0, pads)
            stage = ring[load % args.stages]
            fresh = generic_raw_box(buf, x_off, args, e, item, box, stage)
            vals = generic_box_values(args, e, x_off, item, box, stage,
                                      fresh)
            generic_quantize(vals, 1.0, planes)
            if r0 == 0 and q0 == 0:
                acc = np.zeros((chunk, args.tile_h // DW_BLOCK,
                                args.tile_w // DW_BLOCK, DW_BLOCK, DW_BLOCK),
                               np.int64)
            generic_products(planes.astype(np.int64), generic_tap_words(
                wq, args, item[3]), args, r0, q0, acc)
            if (r0, q0) == ((args.kh - 1) // args.taps_h * args.taps_h,
                            (args.kw - 1) // args.taps_w * args.taps_w):
                tile = acc.transpose(1, 3, 2, 4, 0).reshape(
                    args.tile_h, args.tile_w, chunk)
                generic_store(tile, args, item, y_vals, y_count, out_bytes)
    elem = np.arange(n * args.oh * args.ow * c) * out_bytes
    assert (y_count[elem] == 1).all() and y_count.sum() == elem.size
    return y_vals[elem].reshape(n, args.oh, args.ow, c)


# (name, N, H, W, C, kh, kw, stride, pads or "SAME"): edge tiles in both
# axes, C past the chunk and not a multiple of it, planes from 4 x 4 up
_DW_WALKS = [
    ("3x3_s1_c40", 2, 13, 11, 40, 3, 3, 1, "SAME"),
    ("3x3_s2_same_asym", 1, 36, 70, 40, 3, 3, 2, "SAME"),
    ("5x5_s2_same_asym", 2, 21, 14, 72, 5, 5, 2, "SAME"),
    ("5x5_s1_c8", 1, 19, 34, 8, 5, 5, 1, "SAME"),
    ("1x1_s1", 2, 9, 17, 48, 1, 1, 1, (0, 0, 0, 0)),
    ("1x1_s2", 1, 15, 16, 24, 1, 1, 2, (0, 0, 0, 0)),
    ("3x3_s1_4x4", 3, 4, 4, 160, 3, 3, 1, "SAME"),
    # depthwise_generic: C = 7, an odd window, kh != kw, stride 3, C = 40
    # (two chunks, a pixel's chunk a run, the second ragged), a 19x17
    # window (whole: its box fits), each kernel of the launcher's (G, S),
    # and a window in blocks of taps (its whole box fits no budget)
    ("g5x5_s1_c7", 2, 15, 13, 7, 5, 5, 1, "SAME"),
    ("g7x7_s1", 1, 12, 20, 40, 7, 7, 1, "SAME"),
    ("g3x5_s1", 1, 9, 10, 16, 3, 5, 1, (1, 1, 2, 2)),
    ("g3x3_s3", 2, 14, 17, 8, 3, 3, 3, (1, 1, 1, 1)),
    ("g19x17_s2_blocks", 1, 23, 21, 12, 19, 17, 2, (9, 9, 8, 8)),
    ("g3x3_s1_c12", 2, 11, 38, 12, 3, 3, 1, "SAME"),
    ("g3x3_s2_c20", 1, 19, 22, 20, 3, 3, 2, "SAME"),
    ("g5x5_s2_c36", 1, 17, 15, 36, 5, 5, 2, "SAME"),
    ("g48x48_s1_blocks", 1, 12, 13, 32, 48, 48, 1, "SAME"),
    # window blocks wholly right of the input (the second tile's last)
    ("g48x48_s1_blocks_outside", 1, 8, 20, 32, 48, 48, 1, "SAME"),
    # a plane 4 wide: a box row of one unit of 8 pixels
    ("g3x3_s1_c12_4x4", 2, 4, 4, 12, 3, 3, 1, "SAME"),
]


def _generic_kernel(args):
    """(G, S) of the generic kernel the launcher picks (0: read from the
    shape): the tap words of a window row and the stride, for a whole
    window of up to 8 x 8 taps at stride 1 or 2."""
    groups = -(-args.kw // 4)
    whole = args.taps_h == args.kh and args.taps_w == args.kw
    if whole and args.stride <= 2 and groups <= 2 and args.kh <= 8:
        return groups, args.stride
    return 0, 0


@pytest.mark.parametrize("case", _DW_WALKS, ids=[t[0] for t in _DW_WALKS])
@pytest.mark.parametrize("in_bytes,out_bytes", [(2, 2), (4, 4)],
                         ids=["bf16", "f32"])
def test_depthwise_walk_equals_conv(case, in_bytes, out_bytes):
    name, n, h, w, c, kh, kw, stride, pads = case
    if pads == "SAME":
        pads = same_pads(h, kh, stride) + same_pads(w, kw, stride)
    rng = np.random.default_rng(len(name))
    qx = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    qw = rng.integers(-127, 128, (c, 1, kh, kw)).astype(np.int8)
    packed = pack_weights(torch.from_numpy(qw), c)      # (kh kw, C)
    design, args, _ = conv_args((n, h, w, c), packed.shape, c, stride, pads,
                                c, kh, kw, in_bytes, out_bytes)
    assert design == ("depthwise_generic" if name.startswith("g")
                      else "depthwise")
    _check_depthwise_args(args, c, in_bytes, out_bytes)
    assert args.oh == conv_out_size(h, kh, stride, pads[0], pads[1])
    if design == "depthwise":
        got = depthwise_walk(qx, packed.numpy(), args, pads)
    else:
        # the input a few bytes past a 16-byte unit
        got = generic_walk(qx, packed.numpy(), args, pads, in_bytes,
                           out_bytes, x_off=len(name) * in_bytes % 16)
    want = int8_conv_acc(torch.from_numpy(qx), torch.from_numpy(qw), stride,
                         pads, c)
    np.testing.assert_array_equal(got, want.numpy())


def test_depthwise_walks_meet_every_branch():
    """The walks above reach: edge tiles in both axes, a ragged chunk, a
    chunk narrower than 32, the plan's tiles and ring depths of both
    designs, and of the generic design: runs of a box row and of a pixel's
    chunk, every kernel of the launcher's (G, S), a window in more than one
    block of taps, the larger budget, a thread's blocks one and several,
    and a box wholly right of the input."""
    seen = set()
    for name, n, h, w, c, kh, kw, stride, pads in _DW_WALKS:
        if pads == "SAME":
            pads = same_pads(h, kh, stride) + same_pads(w, kw, stride)
        for nbytes in (2, 4):
            _, a, _ = conv_args((n, h, w, c), (kh * kw, c), c, stride, pads,
                                c, kh, kw, nbytes, nbytes)
            seen |= {("edge_y", a.oh % a.tile_h != 0),
                     ("edge_x", a.ow % a.tile_w != 0),
                     ("ragged_chunk", c % a.dw_chunk != 0),
                     ("narrow_chunk", a.dw_chunk < 32),
                     ("tap_blocks", a.taps_h < kh or a.taps_w < kw),
                     ("tile", a.design, a.tile_h, a.tile_w),
                     ("stages", a.design, a.stages)}
            if a.design == 3:
                blocks = a.tile_h // DW_BLOCK * (a.tile_w // DW_BLOCK)
                boxes = [generic_box(a, item, r0, q0, pads)
                         for item, r0, q0 in generic_units(a, n, a.oh, a.ow,
                                                           c)]
                seen |= {("runs", "rows" if c <= a.dw_chunk else "pixels"),
                         ("kernel", _generic_kernel(a)),
                         ("big_budget", a.smem > DW_SMEM_BUDGET),
                         ("blocks_a_thread", blocks > DW_THREADS
                          // a.dw_chunk),
                         ("box_outside", any(lo == hi
                                             for _, _, lo, hi, _ in boxes))}
    for branch in ("edge_y", "edge_x", "ragged_chunk", "narrow_chunk",
                   "tap_blocks", "big_budget", "blocks_a_thread",
                   "box_outside"):
        assert (branch, True) in seen, branch
    assert {("tile", 0, 8, 32), ("tile", 0, 8, 16), ("tile", 0, 4, 4)} <= seen
    assert {("stages", d, n) for d in (0, 3) for n in (1, 2)} <= seen
    assert {("runs", "rows"), ("runs", "pixels")} <= seen
    assert {("kernel", k) for k in ((1, 1), (1, 2), (2, 1), (2, 2),
                                    (0, 0))} <= seen


def test_generic_constants_are_the_kernels():
    """The plan's doubt lists and the (G, S) kernels' window rows mirror
    `csrc/int8_conv.cu` (`kGenDoubts`, `kGenDoubtsOff`, `kGenTapRows`)."""
    import re
    source = (Path(__file__).resolve().parents[1] / "retinanet_torch"
              / "csrc" / "int8_conv.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))
    assert constant("kGenDoubts") == GEN_DOUBTS
    assert constant("kGenDoubtsOff") == GEN_DOUBTS_OFF
    assert constant("kGenTapRows") == 8  # `_generic_kernel`'s kh <= 8


def _umulhi_div(n, d):
    """n / d as the generic kernel takes it by a multiply-high: the magic
    2^32 / d rounded up, and n itself where d = 1 (whose magic would be
    0)."""
    return n if d == 1 else (n * (0xFFFFFFFF // d + 1)) >> 32


def test_generic_divisions_are_exact():
    """The generic kernel's divisions by multiply-high (a unit's row by the
    8-pixel units of a box row, a copy's pixel by a slot's 16-byte units)
    are exact for every n < 2^32 / d, d = 1 included (a box row of one
    unit: planes at most 4 wide), at the edge of that range too."""
    rng = np.random.default_rng(0)
    for d in list(range(1, 300)) + [1000, 4097, 65535]:
        top = (1 << 32) // d - 1
        ns = np.concatenate([np.arange(0, min(top, 5000)),
                             rng.integers(0, top, 2000),
                             [top]]).astype(object)
        assert all(_umulhi_div(int(n), d) == int(n) // d for n in ns), d


# (C, bytes of an element, the input's byte offset from a 16-byte unit):
# every offset an element can have, C of one chunk (7 and 12: runs of box
# rows) and of two (40: runs of a pixel's chunk, the second ragged)
_LOADER_CASES = [(c, e, off) for c in (7, 12, 40) for e in (2, 4)
                 for off in range(0, 16, e)]


@pytest.mark.parametrize("c,in_bytes,x_off", _LOADER_CASES,
                         ids=[f"c{c}_{'bf16' if e == 2 else 'f32'}_off{o}"
                              for c, e, o in _LOADER_CASES])
def test_generic_loader_rebuilds_every_box(c, in_bytes, x_off):
    """The generic kernel's loader (`gen_copy_box`'s 16-byte units, which
    land at each run's slot, and `gen_quantize_box`'s byte leads) rebuilds
    every box of a 3x3 "SAME" conv exactly, the input x_off bytes past a
    16-byte unit between bytes of NaN and inf: every element read is one
    its box's copies wrote, each unit copied holds a byte of the input,
    and the box's pixels outside the input and its channels past C are
    zero."""
    n, h, w, k = 2, 9, 11, 3
    pads = same_pads(h, k, 1) + same_pads(w, k, 1)
    rng = np.random.default_rng(c * 100 + x_off)
    x = rng.normal(0, 3, (n, h, w, c)).astype(np.float32)
    if in_bytes == 2:
        x = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)  # bfloat16
        raw = (x.view(np.uint32) >> 16).astype("<u2")
    else:
        raw = x.astype("<f4")
    pad = np.frombuffer(np.float32([np.nan, np.inf, -np.inf, np.nan] * 8)
                        .tobytes(), np.uint8)
    buf = np.concatenate([pad[:x_off], raw.view(np.uint8).reshape(-1),
                          pad[:32]])
    design, a, _ = conv_args((n, h, w, c), (k * k, c), c, 1, pads, c, k, k,
                             in_bytes, 2, aligned=False)
    assert design == "depthwise_generic"
    xp = np.pad(x, ((0, 0), (a.box_h, a.box_h), (a.box_w, a.box_w),
                    (0, a.dw_chunk)))
    stages = rng.integers(0, 256, (a.stages, a.q_off // a.stages), np.uint8)
    for load, (item, r0, q0) in enumerate(generic_units(a, n, a.oh, a.ow,
                                                        c)):
        box = generic_box(a, item, r0, q0, pads)
        stage = stages[load % a.stages]
        fresh = generic_raw_box(buf, x_off, a, in_bytes, item, box, stage)
        got = generic_box_values(a, in_bytes, x_off, item, box, stage, fresh)
        iy0, ix0, _, _, cs = box
        c0 = item[3] * a.dw_chunk
        want = xp[item[0], a.box_h + iy0:a.box_h + iy0 + a.box_h,
                  a.box_w + ix0:a.box_w + ix0 + a.box_w, c0:c0 + a.dw_chunk]
        want = np.where(np.arange(a.dw_chunk) < cs, want, 0)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))


def quantize_byte_model(v: np.ndarray, s_a: float) -> np.ndarray:
    """`quantize_byte` of csrc/int8_conv.cu in float32 numpy: the product
    by the reciprocal, the clamp, the rounding by 1.5 * 2^23, the low byte,
    taken where |t| >= 128 or t is more than 3e-5 from a half-integer;
    elsewhere, and on NaN, the division (`quantize`)."""
    s = np.float32(s_a)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        inv = np.float32(1) / s
        if not (np.isfinite(inv) and abs(inv) >= np.finfo(np.float32).tiny
                and abs(s) >= np.finfo(np.float32).tiny):
            inv = np.float32(np.nan)
        t = v * inv
        tc = np.minimum(np.maximum(t, np.float32(-127)), np.float32(127))
        m = tc + np.float32(12582912)
        r = m - np.float32(12582912)
        fast = (np.abs(t) >= 128) | (np.abs(t - r) < np.float32(0.49997))
        slow = np.clip(np.rint(v / s), -127, 127)
    low = (m.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return np.where(fast, low, np.nan_to_num(slow).astype(np.int8))


@pytest.mark.parametrize("s_a", [0.0137, 0.5, 3e-39],
                         ids=["s_a", "s_a_half", "s_a_subnormal"])
def test_fast_quantization_equals_the_division(s_a):
    """On, one float32 step beside, and up to 3e-5 (the band) and 4.6e-5
    (twice the product's error bound) away from every half-integer
    multiple of s_a up to the clip and past it, and random values."""
    half = np.arange(-140, 141) + 0.5
    base = (half * np.float32(s_a)).astype(np.float32)
    rng = np.random.default_rng(3)
    near = np.concatenate([(half + d) * s_a for d in
                           (-4.6e-5, -3e-5, -2.3e-5, 2.3e-5, 3e-5, 4.6e-5)])
    edge = np.float32([127.5, 128.0, -127.5, -128.0]) * np.float32(s_a)
    v = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                        np.nextafter(base, np.float32(-np.inf)),
                        near.astype(np.float32),
                        edge, np.nextafter(edge, np.float32(0)),
                        (rng.normal(0, 60, 20000) * s_a).astype(np.float32),
                        np.float32([0.0, -0.0, 1e30, -1e30, np.inf,
                                    -np.inf])])
    v = v.astype(np.float32)
    got = quantize_byte_model(v, s_a)
    want = quantize_activation(torch.from_numpy(v), s_a).numpy()
    np.testing.assert_array_equal(got, want)


# -- the narrow design --------------------------------------------------------

def narrow_walk(qx, packed, args, pads):
    """int32 accumulators of the "narrow" kernel, walked as it walks: qx
    (N, H, W, C) int8, `packed` the (O, K_pad) int32 weights of
    `pack_weights`, `args` the wrapper's."""
    n, h, w, c = qx.shape
    o, s, kh, kw = args.o, args.stride, args.kh, args.kw
    taps = kh * kw
    if args.flat:     # one row of N H W pixels
        view, voh, vow = qx.reshape(1, 1, n * h * w, c), 1, n * h * w
    else:
        view, voh, vow = qx, args.oh, args.ow
    vn, vh, vw = view.shape[:3]
    # the weights widened: tap t at bytes 16 t .. 16 t + 15 of a row, its
    # c_tap channels (a word of the packed row for every 4) then zeros
    cw = -(-c // 4)
    wbytes = packed.view(np.int8).reshape(o, -1).astype(np.int64)
    wide = np.zeros((args.o_pad, 32 * args.k_steps), np.int64)
    for tap in range(taps):
        wide[:o, 16 * tap:16 * tap + 4 * cw] = \
            wbytes[:, 4 * cw * tap:4 * cw * (tap + 1)]
    # byte offset of each tap in the quantized box (past the window: 0)
    pw = args.row_pitch // (NARROW_PIXEL * s)
    toff = [(t // kw) * args.row_pitch
            + ((t % kw % s) * pw + t % kw // s) * NARROW_PIXEL
            if t < taps else 0 for t in range(2 * args.k_steps)]
    tm = args.tile_h * args.tile_w
    p = np.arange(tm)
    # each lane's A row: its output pixel's first tap
    a_row = (p // args.tile_w) * s * args.row_pitch \
        + (p % args.tile_w) * NARROW_PIXEL
    cols = np.arange(NARROW_PIXEL)
    yy, xx = np.meshgrid(np.arange(args.box_h), np.arange(args.box_w),
                         indexing="ij")
    at = yy * args.row_pitch + ((xx % s) * pw + xx // s) * NARROW_PIXEL
    tiles_y, tiles_x = -(-voh // args.tile_h), -(-vow // args.tile_w)
    mfrags = tm // 16
    units = mfrags * -(-args.o_pad // args.tile_n)
    rng = np.random.default_rng(0)
    acc = np.zeros((vn, voh, vow, o), np.int64)
    written = np.zeros(acc.shape, np.int64)
    for item in range(vn * tiles_y * tiles_x):
        tx, rest = item % tiles_x, item // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        iy = ty * args.tile_h * s - pads[0] + yy
        ix = tx * args.tile_w * s - pads[2] + xx
        inside = (iy >= 0) & (iy < vh) & (ix >= 0) & (ix < vw)
        # the quantized box; what no pixel's store reaches keeps noise
        q = rng.integers(-128, 128, args.box_h * args.row_pitch)
        pix = np.zeros((args.box_h, args.box_w, NARROW_PIXEL), np.int64)
        pix[inside, :c] = view[img, iy[inside], ix[inside]]
        q[at[..., None] + cols] = pix
        # A (tm, 32 k_steps): taps 2 kk and 2 kk + 1 of each pixel, 16 bytes
        # each, as its lane's ldmatrix address reads them
        a = np.concatenate([q[a_row[:, None] + toff[2 * kk + half] + cols]
                            for kk in range(args.k_steps)
                            for half in (0, 1)], axis=1)
        tile = np.zeros((tm, args.o_pad), np.int64)
        count = np.zeros(tile.shape, np.int64)
        for u in range(units):   # a warp's unit: 16 pixels x tile_n channels
            rows = slice(u % mfrags * 16, u % mfrags * 16 + 16)
            n0 = u // mfrags * args.tile_n
            for pair in range(args.tile_n // 16):
                if n0 + 16 * pair >= args.o_pad:
                    break
                for nt in (2 * pair, 2 * pair + 1):   # N tiles of 8
                    ch = slice(n0 + 8 * nt, n0 + 8 * nt + 8)
                    tile[rows, ch] += a[rows] @ wide[ch].T
                    count[rows, ch] += 1
        assert (count[:, :o] == 1).all()
        # the store, clipped at the output's edges
        oy = ty * args.tile_h + p // args.tile_w
        ox = tx * args.tile_w + p % args.tile_w
        keep = (oy < voh) & (ox < vow)
        acc[img, oy[keep], ox[keep]] += tile[keep, :o]
        written[img, oy[keep], ox[keep]] += 1
    assert (written == 1).all()          # every output once
    return acc.reshape(n, args.oh, args.ow, o)


# (name, N, H, W, C, O, k, stride, pads or "SAME"): the narrow shape classes
# of the eight configs with H and W cut to <= 32 (1x1 at stride 1 across rows
# and images, with and without tensor maps; 3x3/1 and 3x3/2 "SAME"; 5x5/2;
# the squeeze-excite convs on 1x1 maps at every C they have), and C = 6,
# O = 10 off every alignment
_NARROW_WALKS = [
    ("1x1_c16_o96_maps", 4, 32, 32, 16, 96, 1, 1, (0, 0, 0, 0)),
    ("1x1_c8_o32_ragged", 3, 27, 29, 8, 32, 1, 1, (0, 0, 0, 0)),
    ("1x1_c16_o8", 2, 30, 31, 16, 8, 1, 1, (0, 0, 0, 0)),
    ("1x1_c16_o128", 4, 32, 32, 16, 128, 1, 1, (0, 0, 0, 0)),
    ("1x1_c8_o16", 5, 32, 32, 8, 16, 1, 1, (0, 0, 0, 0)),
    ("3x3_s1_c8_o16", 4, 32, 32, 8, 16, 3, 1, (1, 1, 1, 1)),
    ("3x3_s1_c16_o64", 2, 19, 23, 16, 64, 3, 1, (1, 1, 1, 1)),
    ("3x3_s1_c8_o8_edge", 1, 13, 6, 8, 8, 3, 1, (1, 1, 1, 1)),
    ("3x3_s2_c16_o128", 4, 32, 32, 16, 128, 3, 2, "SAME"),
    ("5x5_s2_c16_o128", 2, 29, 31, 16, 128, 5, 2, (1, 2, 1, 2)),
    ("se_c4_o96", 8, 1, 1, 4, 96, 1, 1, (0, 0, 0, 0)),
    ("se_c6_o144", 8, 1, 1, 6, 144, 1, 1, (0, 0, 0, 0)),
    ("se_c8_o32", 8, 1, 1, 8, 32, 1, 1, (0, 0, 0, 0)),
    ("se_c10_o40", 8, 1, 1, 10, 40, 1, 1, (0, 0, 0, 0)),
    ("se_c12_o288", 8, 1, 1, 12, 288, 1, 1, (0, 0, 0, 0)),
    ("se_c16_o4", 8, 1, 1, 16, 4, 1, 1, (0, 0, 0, 0)),
    ("c6_o10_3x3", 3, 17, 17, 6, 10, 3, 1, "SAME"),
]


@pytest.mark.parametrize("case", _NARROW_WALKS,
                         ids=[t[0] for t in _NARROW_WALKS])
@pytest.mark.parametrize("in_bytes,out_bytes", [(2, 2), (4, 4)],
                         ids=["bf16", "f32"])
def test_narrow_walk_equals_conv(case, in_bytes, out_bytes):
    name, n, h, w, c, o, k, stride, pads = case
    if pads == "SAME":
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    rng = np.random.default_rng(len(name))
    qx = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    qw = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    packed = pack_weights(torch.from_numpy(qw), 1)
    design, args, scratch = conv_args((n, h, w, c), packed.shape, o, stride,
                                      pads, 1, k, k, in_bytes, out_bytes)
    assert design == "narrow" and scratch == 0
    _check_narrow_args(args, in_bytes, out_bytes)
    got = narrow_walk(qx, packed.numpy(), args, pads)
    want = int8_conv_acc(torch.from_numpy(qx), torch.from_numpy(qw), stride,
                         pads, 1)
    np.testing.assert_array_equal(got, want.numpy())


def test_narrow_walks_meet_every_branch():
    """The walks above reach: flat runs and tiles, a ragged last item, edge
    tiles, tensor maps both ways and the threads' loads and stores, more
    than one store box a pixel, one and two staging tiles, no ring and a
    ring of two raw boxes, an odd window's zero half step."""
    seen = set()
    for name, n, h, w, c, o, k, stride, pads in _NARROW_WALKS:
        if pads == "SAME":
            pads = same_pads(h, k, stride) + same_pads(w, k, stride)
        for nbytes in (2, 4):
            _, a, _ = conv_args((n, h, w, c), (o, dense_k_words(c, k, k)[1]),
                                o, stride, pads, 1, k, k, nbytes, nbytes)
            m = a.oh * a.ow * (n if a.flat else 1)
            seen |= {("flat", a.flat), ("tma_in", a.tma_in),
                     ("tma_out", a.tma_out),
                     ("ragged", (m if a.flat else a.ow) % a.tile_w != 0),
                     ("boxes", -(-o // a.o_box) > 1),
                     ("bufs", a.out_bufs), ("stages", a.stages),
                     ("odd_taps", k * k % 2 == 1 and k > 1)}
    for branch in ("flat", "tma_in", "tma_out", "ragged", "boxes",
                   "odd_taps"):
        assert (branch, True) in seen and (branch, False) in seen, branch
    assert {("bufs", 1), ("bufs", 2), ("stages", 0), ("stages", 2)} <= seen


@pytest.mark.parametrize("rb", [16, 32, 64, 128])
def test_narrow_staging_swizzle_is_a_permutation(rb):
    """The epilogue's swizzle (16-byte unit u of byte a becomes u ^ ((a >>
    7) & mask), mask = rb / 16 - 1) maps a staging box onto itself, and
    the 8 rows that one store instruction writes at one column fall on 8
    distinct 16-byte bank groups (rows of 16 bytes are 8 consecutive
    units already)."""
    tm, mask = 128, rb // 16 - 1
    a = np.arange(tm * rb)
    swz = a ^ (((a >> 7) & mask) << 4)
    assert sorted(swz) == list(a)
    for col in range(0, rb, 16):
        for r0 in range(0, tm, 8):
            groups = {(swz[(r0 + r) * rb + col] // 16) % 8 for r in range(8)}
            assert len(groups) == 8, (rb, col, r0)
