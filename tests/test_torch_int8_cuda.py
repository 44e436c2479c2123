"""The CUDA int8 convolution against its plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py`.
The output is bit-equal: the accumulators are exact integers and the
epilogue rounds in the same two places. The cases meet every branch of the
five designs (`int8_design`); `test_cases_meet_every_branch` checks that
on the CPU too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.models.layers import same_pads  # noqa: E402
from retinanet_torch.ops.int8_conv import (int8_conv2d_plain,  # noqa: E402
                                           pack_weights, tap_channels)
from retinanet_torch.ops.int8_conv_kernel import (  # noqa: E402
    TILE_M, conv_args, int8_conv2d, kernel)

# (name, batch, size, C, O, k, stride, groups, pads): pads None is "SAME"
_CASES = [
    ("stem7x7_c3_s2", 2, 64, 3, 64, 7, 2, 1, (3, 3, 3, 3)),
    ("3x3_s1", 2, 40, 64, 64, 3, 1, 1, None),
    ("3x3_s2_asym", 2, 40, 128, 128, 3, 2, 1, None),
    ("1x1_s2_proj", 2, 40, 256, 512, 1, 2, 1, (0, 0, 0, 0)),
    ("1x1_c2048", 1, 10, 2048, 256, 1, 1, 1, (0, 0, 0, 0)),
    ("3x3_c512", 1, 12, 512, 512, 3, 1, 1, None),
    ("c6_odd", 3, 17, 6, 10, 3, 1, 1, None),
    ("c16_head", 2, 20, 16, 16, 3, 1, 1, None),
    ("c3_3x3_ragged", 1, 23, 3, 70, 3, 2, 1, None),
    # wgmma: tiles 64, 128 and 256 wide, O past a tile's edge (and rows of
    # O not 16-byte aligned in bf16), M past a tile's edge, padding wider
    # than a window's reach into a row, asymmetric pads, the subsampled 1x1,
    # C = 24, and a second, ragged 128-channel chunk
    ("n256_c64", 2, 96, 64, 256, 3, 1, 1, None),
    ("n256_o300", 2, 96, 128, 300, 1, 1, 1, (0, 0, 0, 0)),
    ("n64_o36", 2, 17, 32, 36, 3, 1, 1, None),
    ("n128_o70_s2", 1, 23, 48, 70, 3, 2, 1, None),
    ("7x7_pad3_c32", 2, 20, 32, 64, 7, 1, 1, (3, 3, 3, 3)),
    ("5x5_s2_asym_c24", 2, 21, 24, 40, 5, 2, 1, (1, 3, 2, 2)),
    ("1x1_s2_odd", 2, 15, 64, 128, 1, 2, 1, (0, 0, 0, 0)),
    ("c136_chunks", 1, 12, 136, 64, 3, 1, 1, None),
    # depthwise: every window and stride of its own kernel, planes from 4
    # x 4 to lite2's largest (256 x 256, more items than CTAs, so that the
    # ring wraps), edge tiles, C = 40 and 72 (past a chunk, not a multiple
    # of it), 16 (a narrow chunk), and more chunks than resident CTAs (a
    # CTA changes chunk between items)
    ("dw3x3_s1", 2, 32, 96, 96, 3, 1, 96, None),
    ("dw3x3_s2", 2, 33, 144, 144, 3, 2, 144, None),
    ("dw5x5_s2", 2, 32, 240, 240, 5, 2, 240, None),
    ("dw5x5_s1_c40", 2, 23, 40, 40, 5, 1, 40, None),
    ("dw5x5_s2_c72", 1, 29, 72, 72, 5, 2, 72, None),
    ("dw1x1_s1", 2, 16, 352, 352, 1, 1, 352, (0, 0, 0, 0)),
    ("dw1x1_s2_c16", 1, 15, 16, 16, 1, 2, 16, (0, 0, 0, 0)),
    ("dw3x3_4x4", 8, 4, 160, 160, 3, 1, 160, None),
    ("dw3x3_s1_256", 2, 256, 32, 32, 3, 1, 32, None),
    ("dw3x3_s2_256", 1, 256, 96, 96, 3, 2, 96, None),
    ("dw3x3_chunks", 1, 4, 34816, 34816, 3, 1, 34816, None),
    # depthwise_generic: C = 7, a 7x7 window, stride 3, and a window past
    # one block of taps
    ("dw5x5_s1_c7", 1, 15, 7, 7, 5, 1, 7, None),
    ("dw7x7_g", 1, 20, 16, 16, 7, 1, 16, None),
    ("dw3x3_s3_g", 2, 17, 8, 8, 3, 3, 8, (1, 1, 1, 1)),
    ("dw19x19_s2_g", 1, 30, 12, 12, 19, 2, 12, None),
    # narrow (c6_odd and c16_head above too): 1x1 runs across rows and
    # images with a ragged last item, tensor maps both ways (4,096 pixels
    # and more), more than one store box a pixel, 3x3/1 with edge tiles,
    # 3x3/2 "SAME", 5x5/2, C = 12 (bfloat16 rows of 24 bytes: the threads
    # load, TMA stores), and the squeeze-excite convs on 1x1 maps (the
    # threads load and store; O = 4 and 288)
    ("n1x1_c16_o96", 2, 48, 16, 96, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c8_o32", 3, 40, 8, 32, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c16_o8", 2, 50, 16, 8, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c16_o128", 2, 56, 16, 128, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c12_o24", 2, 48, 12, 24, 1, 1, 1, (0, 0, 0, 0)),
    ("n3x3_s1_c8_o16", 2, 50, 8, 16, 3, 1, 1, (1, 1, 1, 1)),
    ("n3x3_s1_c16_o64", 2, 48, 16, 64, 3, 1, 1, (1, 1, 1, 1)),
    ("n3x3_s2_c16_o128", 2, 64, 16, 128, 3, 2, 1, None),
    ("n5x5_s2_c16_o128", 2, 57, 16, 128, 5, 2, 1, (1, 2, 1, 2)),
    ("se_c4_o96", 8, 1, 4, 96, 1, 1, 1, (0, 0, 0, 0)),
    ("se_c12_o288", 8, 1, 12, 288, 1, 1, 1, (0, 0, 0, 0)),
    ("se_c16_o4", 8, 1, 16, 4, 1, 1, 1, (0, 0, 0, 0)),
]
_DTYPES = [("f32", torch.float32), ("bf16", torch.bfloat16)]


def _case_inputs(case, in_dtype, seed):
    _, n, size, c, o, k, stride, groups, pads = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1.5, (n, size, size, c))
                         .astype(np.float32)).to(in_dtype)
    cpg = c // groups
    qw = torch.from_numpy(rng.integers(-127, 128, (o, cpg, k, k))
                          .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, o).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, o).astype(np.float32))
    if pads is None:
        pads = same_pads(size, k, stride) + same_pads(size, k, stride)
    return x, pack_weights(qw, groups), scale, bias, pads


def _case_args(case):
    """(design, the kernel's Int8ConvArgs) the wrapper gives a case."""
    _, n, size, c, o, k, stride, groups, pads = case
    if pads is None:
        pads = same_pads(size, k, stride) + same_pads(size, k, stride)
    packed_shape = (o, -(-k * k * tap_channels(c) // 128) * 32)
    return conv_args((n, size, size, c), packed_shape, o, stride, pads,
                     groups, k, k)[:2]


def test_cases_meet_every_branch():
    args = {case[0]: _case_args(case) for case in _CASES}
    designs = {d for d, _ in args.values()}
    assert designs == {"wgmma", "mma_sync", "depthwise", "depthwise_generic",
                       "narrow"}
    # narrow, in bfloat16 (the lane's type) and float32
    for nbytes in (2, 4):
        nar = [conv_args((case[1], case[2], case[2], case[3]),
                         (case[4], 32), case[4], case[6],
                         case[8] or same_pads(case[2], case[5], case[6]) * 2,
                         1, case[5], case[5], nbytes, nbytes)[1]
               for case in _CASES if _case_args(case)[0] == "narrow"]
        for flag in ("flat", "tma_in", "tma_out"):
            assert {getattr(a, flag) for a in nar} == {0, 1}, flag
        assert {a.out_bufs for a in nar} == {1, 2}
        assert any(-(-a.o // a.o_box) > 1 and a.tma_out for a in nar)
        # C = 12 in bfloat16: rows of 24 bytes
        assert any(a.tma_out and not a.tma_in for a in nar) == (nbytes == 2)
        assert any(a.flat and (a.n * a.h * a.w) % a.tile_w for a in nar)
        assert any(not a.flat and a.ow % a.tile_w and a.tma_out
                   for a in nar)
        assert {(a.kh, a.stride) for a in nar} >= {(1, 1), (3, 1), (3, 2),
                                                  (5, 2)}
        assert {a.o for a in nar} >= {4, 288}
    dw = [a for d, a in args.values() if d == "depthwise"]
    assert {(a.kh, a.stride) for a in dw} == {(k, s) for k in (1, 3, 5)
                                              for s in (1, 2)}
    assert any(a.c % a.dw_chunk and a.c > a.dw_chunk for a in dw)
    assert any(a.dw_chunk < 32 for a in dw)
    assert any(a.oh % a.tile_h and a.ow % a.tile_w for a in dw)
    assert min(a.oh for a in dw) == 4 and max(a.h for a in dw) == 256
    # more items than any card holds CTAs (8 an SM of 132), and more chunks
    items = [a.n * -(-a.oh // a.tile_h) * -(-a.ow // a.tile_w)
             * -(-a.c // a.dw_chunk) for a in dw]
    assert max(items) > 8 * 132
    assert max(-(-a.c // a.dw_chunk) for a in dw) > 8 * 132
    assert {a.stages for a in dw} >= {2}
    gen = [a for d, a in args.values() if d == "depthwise_generic"]
    assert any(a.c % 8 for a in gen) and any(a.stride > 2 for a in gen)
    assert any(a.taps_h < a.kh for a in gen)
    wg = {name: a for name, (d, a) in args.items() if d == "wgmma"}
    assert {a.tile_n for a in wg.values()} == {64, 128, 256}
    assert any(a.o % a.tile_n for a in wg.values())
    assert any((a.o * 2) % 16 for a in wg.values())        # bf16 rows
    assert any((a.n * a.oh * a.ow) % TILE_M for a in wg.values())
    assert any(a.sub > 1 for a in wg.values())
    assert any(-a.lower_h != a.upper_h + a.kh - 1 for a in wg.values())
    assert any(a.c == 24 for a in wg.values())
    assert {a.chunk for a in wg.values()} == {32, 64, 128}
    assert any(a.c_tap > a.chunk and a.c_tap % a.chunk for a in wg.values())
    assert any(a.lower_h < -2 for a in wg.values())


@pytest.mark.cuda
@pytest.mark.parametrize("in_name,in_dtype", _DTYPES, ids=["in_f32",
                                                           "in_bf16"])
@pytest.mark.parametrize("out_name,out_dtype", _DTYPES, ids=["out_f32",
                                                             "out_bf16"])
@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_int8_conv_kernel_equals_plain(case, in_name, in_dtype, out_name,
                                       out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    x, packed, scale, bias, pads = _case_inputs(case, in_dtype,
                                                seed=len(case[0]))
    x, packed, scale, bias = (t.cuda() for t in (x, packed, scale, bias))
    _, _, _, _, _, k, stride, groups, _ = case
    s_a = float(x.float().abs().max()) / 127.0 * 0.8  # some clipping
    design, _ = _case_args(case)
    for b in (bias, None):
        before = kernel.launches_by[design]
        got = int8_conv2d(x, packed, scale, b, s_a, stride, pads, groups, k,
                          k, out_dtype)
        torch.cuda.synchronize()
        assert kernel.launches_by[design] == before + 1
        want = int8_conv2d_plain(x, packed, scale, b, s_a, stride, pads,
                                 groups, k, k, out_dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
def test_int8_conv_unaligned_input_takes_the_scalar_loads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    case = ("3x3_s1", 1, 12, 64, 32, 3, 1, 1, None)
    x, packed, scale, bias, pads = _case_inputs(case, torch.float32, seed=3)
    flat = torch.empty(x.numel() + 1, device="cuda")
    x_odd = flat[1:].view(x.shape)              # 4 bytes off 16
    x_odd.copy_(x.cuda())
    args = (packed.cuda(), scale.cuda(), bias.cuda(), 0.02, 1, pads, 1, 3,
            3, torch.float32)
    got = int8_conv2d(x_odd, *args)
    want = int8_conv2d_plain(x_odd, *args)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_depthwise_unaligned_input_takes_the_generic_design():
    """TMA needs a 16-byte aligned input: a depthwise conv on one that is
    not takes "depthwise_generic", chosen before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    case = ("dw3x3_s1", 2, 12, 32, 32, 3, 1, 32, None)
    x, packed, scale, bias, pads = _case_inputs(case, torch.bfloat16, seed=4)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = flat[1:].view(x.shape)              # 2 bytes off 16
    x_odd.copy_(x.cuda())
    args = (packed.cuda(), scale.cuda(), bias.cuda(), 0.02, 1, pads, 32, 3,
            3, torch.bfloat16)
    before = dict(kernel.launches_by)
    got = int8_conv2d(x_odd, *args)
    torch.cuda.synchronize()
    assert kernel.launches_by["depthwise_generic"] == \
        before.get("depthwise_generic", 0) + 1
    assert torch.equal(got, int8_conv2d_plain(x_odd, *args))


@pytest.mark.cuda
def test_int8_narrow_unaligned_input_takes_the_threads_loads():
    """TMA needs a 16-byte aligned input: a narrow conv on one that is not
    stays on "narrow", its threads loading the box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    case = ("n1x1_c16_o96", 2, 48, 16, 96, 1, 1, 1, (0, 0, 0, 0))
    x, packed, scale, bias, pads = _case_inputs(case, torch.bfloat16, seed=7)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = flat[1:].view(x.shape)              # 2 bytes off 16
    x_odd.copy_(x.cuda())
    args = (packed.cuda(), scale.cuda(), bias.cuda(), 0.02, 1, pads, 1, 1,
            1, torch.bfloat16)
    _, a, _ = conv_args(x.shape, packed.shape, 96, 1, pads, 1, 1, 1,
                        aligned=False)
    assert not a.tma_in and a.tma_out
    before = kernel.launches_by["narrow"]
    got = int8_conv2d(x_odd, *args)
    torch.cuda.synchronize()
    assert kernel.launches_by["narrow"] == before + 1
    assert torch.equal(got, int8_conv2d_plain(x_odd, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(24, 3), (64, 1)], ids=["c24k3", "c64k1"])
def test_int8_conv_refuses_the_earlier_layout(c, k):
    """Weights packed as before (ceil(C / 4) words a tap, rows padded to 16
    words) fail the shape check and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    o = 8
    qw = torch.ones((o, c, k, k), dtype=torch.int8)
    cw = -(-c // 4)
    old = torch.nn.functional.pad(qw.permute(0, 2, 3, 1), (0, 4 * cw - c))
    old = old.reshape(o, 4 * k * k * cw).contiguous().view(torch.int32)
    old = torch.nn.functional.pad(
        old, (0, -(-old.shape[1] // 16) * 16 - old.shape[1])).contiguous()
    assert old.shape != pack_weights(qw, 1).shape
    before = kernel.launches
    with pytest.raises(ValueError, match="packed weights"):
        int8_conv2d(torch.zeros((1, 8, 8, c), device="cuda"), old.cuda(),
                    torch.ones(o, device="cuda"), None, 0.1, 1,
                    (k // 2,) * 4, 1, k, k, torch.float32)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("design,c,groups,size", [("wgmma", 64, 1, 12),
                                                  ("mma_sync", 3, 1, 12),
                                                  ("depthwise", 8, 8, 12),
                                                  ("depthwise_generic", 7, 7,
                                                   12),
                                                  ("narrow", 8, 1, 12),
                                                  ("narrow", 16, 1, 48)],
                         ids=["wgmma", "mma_sync", "depthwise",
                              "depthwise_generic", "narrow", "narrow_tma"])
@pytest.mark.parametrize("s_a", [0.0137, 3e-39], ids=["s_a", "s_a_subnormal"])
def test_int8_conv_quantizes_ties_like_the_division(design, c, groups, size,
                                                    s_a):
    """Inputs on and one float32 step beside every half-integer multiple of
    s_a up to the clip, and past it: the kernels' quantization (a
    reciprocal product checked against its error bound, else the
    division) equals the plain version's division bit for bit. A
    subnormal s_a has no normal reciprocal and always divides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    base = ((np.arange(-140, 140) + 0.5) * np.float32(s_a)).astype(
        np.float32)
    vals = np.concatenate([base, np.nextafter(base, np.inf),
                           np.nextafter(base, -np.inf), [0.0, -0.0]])
    rng = np.random.default_rng(5)
    vals = np.resize(rng.permutation(vals), 2 * size * size * c).astype(
        np.float32)
    x = torch.from_numpy(vals.reshape(2, size, size, c)).cuda()
    o = c if groups > 1 else 16
    qw = torch.from_numpy(rng.integers(1, 128, (o, c // groups, 1, 1))
                          .astype(np.int8))
    args = (pack_weights(qw, groups).cuda(),
            torch.full((o,), 1e-3, device="cuda"), None, s_a, 1,
            (0, 0, 0, 0), groups, 1, 1, torch.float32)
    before = kernel.launches_by[design]
    got = int8_conv2d(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches_by[design] == before + 1
    assert torch.equal(got, int8_conv2d_plain(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("design,c", [("depthwise", 16),
                                      ("depthwise_generic", 7)],
                         ids=["depthwise", "depthwise_generic"])
@pytest.mark.parametrize("s_a", [0.0625, 0.0137], ids=["exact_ties", "s_a"])
def test_int8_depthwise_quantizes_bf16_ties_like_the_division(design, c,
                                                              s_a):
    """bfloat16 inputs on the ties: at s_a = 1/16 every (k + 1/2) s_a is a
    bfloat16, and t = x / s_a is exactly a half-integer, so nearly every
    element of the box is in doubt; the depthwise designs equal the plain
    version's division bit for bit, with a 3x3 window reading each element
    nine times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 conv kernel has no CPU "
                    "mode")
    rng = np.random.default_rng(6)
    half = (rng.integers(-140, 140, (2, 13, 11, c)) + 0.5) * s_a
    x = torch.from_numpy(half.astype(np.float32)).to(torch.bfloat16).cuda()
    qw = torch.from_numpy(rng.integers(-127, 128, (c, 1, 3, 3))
                          .astype(np.int8))
    args = (pack_weights(qw, c).cuda(), torch.full((c,), 1e-3,
                                                   device="cuda"),
            None, s_a, 1, (1, 1, 1, 1), c, 3, 3, torch.bfloat16)
    before = kernel.launches_by[design]
    got = int8_conv2d(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches_by[design] == before + 1
    assert torch.equal(got, int8_conv2d_plain(x, *args))
