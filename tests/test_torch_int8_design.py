"""What the int8 conv kernel's designs rest on, checked where no card is.

  * `int8_design` is a function of the shape: every int8 conv of the
    flagship (ResNet50-FPN) and of EfficientNet-lite2 gets the design the
    rule gives (the stem mma_sync, every other dense conv of the flagship
    wgmma, depthwise its loop), and the numbers passed for the wgmma design
    fit the tensor maps' limits.
  * The packed weights' padded layout round-trips, and a tensor packed in
    the earlier layout (ceil(C / 4) words a tap, rows padded to 16 words)
    is refused by the shape check.
  * A numpy model of the im2col-mode copies, built from the very numbers
    the wrapper passes for the descriptor (`conv_args`), equals `F.unfold`
    for 3x3/1, 3x3/2 with asymmetric "SAME" pads, 1x1/2 and 7x7/2, with
    tiles that cross rows and images and a ragged last tile.
  * The strided 1x1 quantizing pass's plain model equals
    `quantize_activation` of the subsampled input.
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
    K_WORDS_ALIGN, dense_k_words, pack_weights, quantize_activation,
    tap_channels, unpack_weights)
from retinanet_torch.ops.int8_conv_kernel import (  # noqa: E402
    CHUNKS, TILE_M, TILE_NS, Im2colPlan, conv_args, int8_conv2d,
    int8_design, wgmma_chunk, wgmma_tile_n)

_REPO = Path(__file__).resolve().parent.parent
_CONFIGS = {
    "flagship": "configs/v3-8/mscoco-retinanet-resnet50-640x640-30x-64.json",
    "lite2": ("configs/v3-32/mscoco-retinanet-efficientnet-lite2-512x512-"
              "30x-256.json"),
}
# int8 conv calls of one request (the prediction convs stay float)
_CALLS = {"flagship": 102, "lite2": 121}


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


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_design_of_every_int8_conv(name):
    calls = _int8_calls(name)
    assert len(calls) == _CALLS[name]
    designs = {}
    for c, o, kh, kw, stride, groups, pads, (n, h, w) in calls:
        design = int8_design(c, o, kh, kw, stride, groups)
        want = ("depthwise" if groups != 1 else
                "mma_sync" if c <= 16 else "wgmma")
        assert design == want, (c, o, kh, stride, groups)
        designs[design] = designs.get(design, 0) + 1
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
    if name == "flagship":
        # the stem alone keeps mma.sync
        assert designs == {"mma_sync": 1, "wgmma": 101}
    else:
        assert designs == {"mma_sync": 2, "wgmma": 69, "depthwise": 50}


def test_design_rule():
    assert int8_design(3, 64, 7, 7, 2, 1) == "mma_sync"     # the stem
    assert int8_design(16, 96, 1, 1, 1, 1) == "mma_sync"
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
    applies to `csrc/int8_conv.cu`, each edit exactly once."""
    from retinanet_torch.ops.int8_conv_kernel import kernel
    from retinanet_torch.tools.int8_conv_experiments import VARIANTS
    from retinanet_torch.tools.kernel_variants import variant_source
    for name, edits in VARIANTS.items():
        source = variant_source(kernel, name, edits)
        assert source != kernel.source.read_text()
