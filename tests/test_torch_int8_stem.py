"""The int8 conv kernel's "stem" design (dense convs with C < 4), checked
where no card is.

A numpy model of the kernel's walk, `stem_walk`, built from the numbers
the wrapper passes (`conv_args`) and nothing else: the items (tiles of one
image, the ragged last ones), each box's origin and halo, one bulk copy a
box row that lies in the input, of whole 16-byte units into a raw row
(from the unit that holds the row's first pixel; the bytes around it are
noise; on the card a warp copies a row, a lane a unit),
the 4-byte quantized pixels stored by column phase of the stride (the pads
zero, the rest of the quantized box noise), the K slots (`stem_slots`:
four rows of a window column a group; a slot past the window reads its
group's first row against a zero weight), the A words each lane loads
from its own pixel plus its slot's offset, the packed weights copied into
the slots, units of 32 or 64 channels in N tiles of 8, the staging tile's
swizzle (a permutation of each box) and the store clipped at the edges.
Its int32 sums equal `int8_conv_acc` (the plain version's) and JAX's
`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` at
the three stems' shapes cut to small planes, C = 1 and 2, O = 70, 5x5
with asymmetric pads, float32 and bfloat16 in and out; requantized, they
equal `int8_conv2d_plain`. The walks meet every branch of the plan.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from retinanet_torch.models.layers import same_pads  # noqa: E402
from retinanet_torch.ops.int8_conv import (  # noqa: E402
    int8_conv2d_plain, int8_conv_acc, pack_weights, quantize_activation,
    requantize)
from retinanet_torch.ops.int8_conv_kernel import (  # noqa: E402
    NARROW_TILE_NS, STEM_PIXEL, conv_args, int8_design,
    narrow_staging_bytes, stem_plan, stem_slots)
from test_torch_int8_design import _check_stem_args  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

_ELEM = {2: np.int16, 4: np.int32}   # an element's bytes, as the walk holds it


def _slot_words(args):
    """Each K slot's word offset in the quantized box, as the kernel's tap
    table holds it (in bytes there)."""
    s = args.stride
    pw = (args.row_pitch // STEM_PIXEL - 8) // s
    return np.array([r * (args.row_pitch // STEM_PIXEL) + (c % s) * pw
                     + c // s for _, r, c in stem_slots(args.kh, args.kw)])


def stem_walk(qx, packed, args, pads, in_bytes, out_bytes, base=0):
    """int32 accumulators of the "stem" kernel, walked as it walks: qx
    (N, H, W, C) int8, `packed` the (O, K_pad) int32 weights of
    `pack_weights`, `args` the wrapper's; the input starts `base` bytes
    past a 16-byte boundary."""
    n, h, w, c = qx.shape
    o, s, kh, kw = args.o, args.stride, args.kh, args.kw
    rng = np.random.default_rng(1)
    # the input as bytes, each element an integer of in_bytes (the walk
    # leaves the quantization out: qx is already int8), noise around it
    # standing for the memory the copies' 16-byte units reach past it
    body = qx.astype(_ELEM[in_bytes]).reshape(-1).view(np.uint8)
    mem = np.concatenate([rng.integers(0, 256, base, dtype=np.uint8), body,
                          rng.integers(0, 256, 32, dtype=np.uint8)])
    pb = c * in_bytes
    # the weights in shared memory: slot j of row o the packed word of its
    # tap, zero past the window and past O
    slots = stem_slots(kh, kw)
    assert len(slots) == 8 * args.k_steps
    wbytes = packed.view(np.int8).reshape(o, -1, 4).astype(np.int64)
    wsm = np.zeros((args.o_pad, len(slots), 4), np.int64)
    for j, (tap, _, _) in enumerate(slots):
        if tap >= 0:
            wsm[:o, j] = wbytes[:, tap]
    wsm = wsm.reshape(args.o_pad, -1)
    toff = _slot_words(args)
    words = args.row_pitch // STEM_PIXEL
    pw = (words - 8) // s
    assert pw * s + 8 == words and pw >= -(-args.box_w // s)
    assert words % 32 == 8 and (s != 2 or pw % 32 == 16)
    yy, xx = np.meshgrid(np.arange(args.box_h), np.arange(args.box_w),
                         indexing="ij")
    at = yy * words + (xx % s) * pw + xx // s       # a pixel's word
    tm = args.tile_h * args.tile_w
    assert tm % 16 == 0
    p = np.arange(tm)
    a_px = (p // args.tile_w) * s * words + p % args.tile_w
    # every slot's word lies in the quantized box
    assert a_px.max() + toff.max() < args.box_h * words
    tiles_y, tiles_x = -(-args.oh // args.tile_h), -(-args.ow // args.tile_w)
    mfrags = tm // 16
    units = mfrags * -(-args.o_pad // args.tile_n)
    # the staging tile: rows of o_box channels swizzled at their width under
    # TMA (ceil(o_pad / o_box) boxes a pixel), else rows of O channels
    rb = args.o_box * out_bytes
    mask = rb // 16 - 1 if args.tma_out else 0
    staging = narrow_staging_bytes(args.tile_h, args.tile_w, o, args.o_box,
                                   out_bytes, args.tma_out)
    ch = np.arange(args.o_pad if args.tma_out else o)
    pp, cc = np.meshgrid(p, ch, indexing="ij")
    box = cc // args.o_box if args.tma_out else 0 * cc
    addr = box * tm * rb + pp * rb + (
        ((cc - box * args.o_box) * out_bytes) ^ (((pp * rb) >> 7 & mask) << 4))
    # a permutation of the elements' places, within the staging tile
    assert len(np.unique(addr)) == addr.size and addr.max() < staging
    assert (addr % out_bytes == 0).all()
    acc = np.zeros((n, args.oh, args.ow, o), np.int64)
    written = np.zeros(acc.shape, np.int64)
    seen = set()
    for item in range(n * tiles_y * tiles_x):
        tx, rest = item % tiles_x, item // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        iy0 = ty * args.tile_h * s - pads[0]
        ix0 = tx * args.tile_w * s - pads[2]
        lo, hi = max(ix0, 0), min(ix0 + args.box_w, w)
        # the copies: a box row in the input, from the 16-byte unit that
        # holds its first pixel to the end of the unit that holds its last;
        # the raw rows start as noise
        raw = rng.integers(0, 256, (args.box_h, args.raw_pitch),
                           dtype=np.uint8)
        copied = np.zeros(raw.shape, bool)
        lead = np.zeros(args.box_h, np.int64)
        for r in range(args.box_h):
            iy = iy0 + r
            if not 0 <= iy < h or hi <= lo:
                continue
            first = base + ((img * h + iy) * w + lo) * pb
            end = base + ((img * h + iy) * w + hi) * pb
            lead[r] = first % 16
            src = first - first % 16
            size = -(-end // 16) * 16 - src
            assert size % 16 == 0 and size <= args.raw_pitch
            raw[r, :size] = mem[src:src + size]
            copied[r, :size] = True
            seen.add(("lead", lead[r] != 0))
        # the quantized box: every pixel's word written (the pads 0), the
        # rest of each row noise
        q = rng.integers(-128, 128, (args.box_h * words, 4))
        iy, ix = iy0 + yy, ix0 + xx
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        pix = np.zeros((args.box_h, args.box_w, 4), np.int64)
        for e in range(c):
            pos = lead[yy] + (ix - lo) * pb + e * in_bytes
            pos = np.where(inside, pos, 0)
            assert (pos + in_bytes <= args.raw_pitch).all()
            took = np.stack([raw[yy, pos + b] for b in range(in_bytes)], -1)
            assert copied[yy, pos][inside].all()
            val = took.copy().view(_ELEM[in_bytes])[..., 0]
            pix[..., e] = np.where(inside, val, 0)
        q[at] = pix
        # A (tm, 32 k_steps): each lane's word at its pixel plus the slot
        a = q[a_px[:, None] + toff[None, :]].reshape(tm, -1)
        tile = np.zeros((tm, args.o_pad), np.int64)
        count = np.zeros(tile.shape, np.int64)
        for u in range(units):   # a warp's unit: 16 pixels x tile_n channels
            rows = slice(u % mfrags * 16, u % mfrags * 16 + 16)
            n0 = u // mfrags * args.tile_n
            for pair in range(args.tile_n // 16):
                if n0 + 16 * pair >= args.o_pad:
                    break
                for nt in (2 * pair, 2 * pair + 1):   # N tiles of 8
                    chs = slice(n0 + 8 * nt, n0 + 8 * nt + 8)
                    tile[rows, chs] += a[rows] @ wsm[chs].T
                    count[rows, chs] += 1
        assert (count == 1).all()
        # the epilogue into the staging tile, the store out of it, clipped
        # at the output's edges and at O
        flat = np.zeros(staging // out_bytes, np.int64)
        flat[addr // out_bytes] = tile[pp, cc]
        got = flat[addr // out_bytes][:, :o]
        oy = ty * args.tile_h + p // args.tile_w
        ox = tx * args.tile_w + p % args.tile_w
        keep = (oy < args.oh) & (ox < args.ow)
        acc[img, oy[keep], ox[keep]] += got[keep]
        written[img, oy[keep], ox[keep]] += 1
    assert (written == 1).all()          # every output once
    return acc, seen


# (name, N, H, W, C, O, k, stride, pads or "SAME"): the three stems on small
# planes (the flagship's 7x7/2 without pads, lite2's and MobileDet-cpu's
# 3x3/2 with (0, 1, 0, 1)), with and without the output's tensor map; C = 1
# and 2; O = 70 (a ragged second unit); 5x5/2 with asymmetric pads; a plane
# wider than a tile with ragged last items
_STEM_WALKS = [
    ("stem7x7_s2_o64", 2, 38, 38, 3, 64, 7, 2, (0, 0, 0, 0)),
    ("stem7x7_s2_o64_maps", 1, 80, 75, 3, 64, 7, 2, (0, 0, 0, 0)),
    ("stem3x3_s2_o32", 2, 33, 33, 3, 32, 3, 2, (0, 1, 0, 1)),
    ("stem3x3_s2_o16", 2, 33, 33, 3, 16, 3, 2, (0, 1, 0, 1)),
    ("stem3x3_s2_o32_maps", 3, 48, 50, 3, 32, 3, 2, (0, 1, 0, 1)),
    ("c1_3x3_s1", 2, 21, 19, 1, 32, 3, 1, (1, 1, 1, 1)),
    ("c2_3x3_s2", 3, 25, 27, 2, 16, 3, 2, "SAME"),
    ("c3_o70_3x3_s2", 1, 23, 23, 3, 70, 3, 2, "SAME"),
    ("c3_5x5_s2_asym", 2, 29, 31, 3, 24, 5, 2, (1, 3, 2, 2)),
    ("c2_7x7_pad3_maps", 2, 47, 45, 2, 40, 7, 2, (3, 3, 3, 3)),
]
_IDS = [t[0] for t in _STEM_WALKS]


def _case(case, seed_extra=0):
    name, n, h, w, c, o, k, stride, pads = case
    if pads == "SAME":
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    rng = np.random.default_rng(len(name) + seed_extra)
    qx = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    qw = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    return qx, qw, pads


def _walk(case, in_bytes, out_bytes, base=0):
    name, n, h, w, c, o, k, stride, _ = case
    qx, qw, pads = _case(case)
    packed = pack_weights(torch.from_numpy(qw), 1)
    design, args, scratch = conv_args((n, h, w, c), packed.shape, o, stride,
                                      pads, 1, k, k, in_bytes, out_bytes,
                                      base % 16 == 0)
    assert design == "stem" and scratch == 0
    _check_stem_args(args, in_bytes, out_bytes)
    acc, seen = stem_walk(qx, packed.numpy(), args, pads, in_bytes,
                          out_bytes, base)
    return qx, qw, pads, args, acc, seen


@pytest.mark.parametrize("case", _STEM_WALKS, ids=_IDS)
@pytest.mark.parametrize("in_bytes,out_bytes", [(2, 2), (4, 4), (2, 4),
                                                (4, 2)],
                         ids=["bf16", "f32", "bf16_f32", "f32_bf16"])
def test_stem_walk_equals_conv(case, in_bytes, out_bytes):
    qx, qw, pads, args, acc, _ = _walk(case, in_bytes, out_bytes)
    want = int8_conv_acc(torch.from_numpy(qx), torch.from_numpy(qw),
                         args.stride, pads, 1)
    np.testing.assert_array_equal(acc, want.numpy())


@pytest.mark.parametrize("case", _STEM_WALKS, ids=_IDS)
def test_stem_walk_equals_lax_int8_conv(case):
    """Through an input 6 bytes off 16-byte alignment: the copies' units
    start before it."""
    qx, qw, pads, args, acc, _ = _walk(case, 2, 2, base=6)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(qx), jnp.asarray(qw.transpose(2, 3, 1, 0)),
        (args.stride, args.stride), ((pads[0], pads[1]), (pads[2], pads[3])),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("case", _STEM_WALKS[:5], ids=_IDS[:5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stem_walk_requantized_equals_plain(case, dtype):
    """Float inputs quantized by the plain version's division, walked, and
    requantized in the plain version's two roundings: `int8_conv2d_plain`
    bit for bit, with and without bias."""
    name, n, h, w, c, o, k, stride, _ = case
    _, qw, pads = _case(case)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 1.5, (n, h, w, c)).astype(
        np.float32)).to(dtype)
    s_a = float(x.float().abs().max()) / 127.0 * 0.8
    qx = quantize_activation(x, s_a).numpy()
    packed = pack_weights(torch.from_numpy(qw), 1)
    nbytes = x.element_size()
    _, args, _ = conv_args(x.shape, packed.shape, o, stride, pads, 1, k, k,
                           nbytes, nbytes)
    acc, _ = stem_walk(qx, packed.numpy(), args, pads, nbytes, nbytes)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, o).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, o).astype(np.float32))
    for b in (bias, None):
        got = requantize(torch.from_numpy(acc.astype(np.int32)), scale, b,
                         dtype)
        want = int8_conv2d_plain(x, packed, scale, b, s_a, stride, pads, 1,
                                 k, k, dtype)
        assert torch.equal(got, want)


def test_stem_walks_meet_every_branch():
    """The walks above reach: both tile widths, ragged last items in both
    axes, the output's tensor map and the threads' store, more than one
    store box a pixel, one and two staging tiles, units of 32 and 64
    channels and O past one unit, raw rows whose first pixel sits past a
    16-byte boundary and on one, slots past the window's rows and a zero
    group past its columns, C = 1, 2 and 3, strides 1 and 2."""
    seen = set()
    for case in _STEM_WALKS:
        name, n, h, w, c, o, k, stride, _ = case
        for nbytes in (2, 4):
            _, _, _, a, _, lead = _walk(case, nbytes, nbytes)
            seen |= lead
            seen |= {("tile_w", a.tile_w), ("tma_out", bool(a.tma_out)),
                     ("ragged_x", a.ow % a.tile_w != 0),
                     ("ragged_y", a.oh % a.tile_h != 0),
                     ("boxes", a.tma_out and -(-o // a.o_box) > 1),
                     ("bufs", a.out_bufs), ("tile_n", a.tile_n),
                     ("units_of_o", a.o_pad > a.tile_n), ("c", c),
                     ("stride", stride),
                     ("rows_past", any(t < 0 and r > 0 for t, r, _
                                       in stem_slots(k, k))),
                     ("zero_group", (k * -(-k // 4)) % 2 == 1)}
    for branch in ("tma_out", "ragged_x", "ragged_y", "boxes", "lead",
                   "units_of_o", "rows_past", "zero_group"):
        assert (branch, True) in seen and (branch, False) in seen, branch
    assert {("tile_w", 16), ("tile_w", 32), ("bufs", 1), ("bufs", 2),
            ("c", 1), ("c", 2), ("c", 3), ("stride", 1), ("stride", 2)} \
        <= seen
    assert {("tile_n", t) for t in NARROW_TILE_NS} <= seen


def test_stem_slots():
    """K is the taps, eight slots a k32 step: 7 steps for 7x7 (56 slots,
    49 taps), 2 for 3x3; every tap in exactly one slot; each group of four
    slots is four rows of one column (32 banks in one load)."""
    for k, steps in ((7, 7), (3, 2), (5, 5), (1, 1)):
        slots = stem_slots(k, k)
        assert len(slots) == 8 * steps
        taps = [t for t, _, _ in slots if t >= 0]
        assert sorted(taps) == list(range(k * k))
        for g in range(0, len(slots), 4):
            group = slots[g:g + 4]
            assert len({c for _, _, c in group}) == 1
            real = [r for t, r, _ in group if t >= 0]
            assert real == list(range(real[0], real[0] + len(real))) \
                if real else True
    # the flagship's stem: 23.5 G operations at batch 8, not the 53.7 G of
    # mma_sync's 128-channel tiles over 64 words
    _, a, _ = conv_args((8, 646, 646, 3), (64, 64), 64, 2, (0, 0, 0, 0), 1,
                        7, 7)
    assert a.k_steps == 7 and a.o_pad == 64
    assert 8 * 320 * 320 * a.o_pad * 32 * a.k_steps * 2 == 23_488_102_400


@pytest.mark.parametrize("o", [16, 32, 64], ids=["o16", "o32", "o64"])
def test_stem_design_and_plan_at_the_stems(o):
    """Every C < 4 dense conv takes "stem", with no scratch; the plan at
    the three stems' full planes fits two CTAs an SM in bfloat16."""
    k, stride, size, pads = {64: (7, 2, 646, (0, 0, 0, 0)),
                             32: (3, 2, 512, (0, 1, 0, 1)),
                             16: (3, 2, 448, (0, 1, 0, 1))}[o]
    assert int8_design(3, o, k, k, stride, 1) == "stem"
    for nbytes in (2, 4):
        design, a, scratch = conv_args((8, size, size, 3), (o, 64), o,
                                       stride, pads, 1, k, k, nbytes, nbytes)
        assert design == "stem" and scratch == 0
        _check_stem_args(a, nbytes, nbytes)
        if nbytes == 2:
            # two CTAs an SM, items of 512 output pixels
            assert a.smem <= 233_472 // 2 - 1024 and a.tma_out
            assert (a.tile_h, a.tile_w) == (16, 32)
    with pytest.raises(ValueError, match="no stem plan"):
        stem_plan(1, 3000, 3000, 3, 64, 99, 99, 1, (0, 0, 0, 0), 4, 4)
