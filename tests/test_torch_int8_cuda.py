"""The CUDA int8 convolution against its plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py`.
The output is bit-equal: the accumulators are exact integers and the
epilogue rounds in the same two places."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.models.layers import same_pads  # noqa: E402
from retinanet_torch.ops.int8_conv import (int8_conv2d_plain,  # noqa: E402
                                           pack_weights)
from retinanet_torch.ops.int8_conv_kernel import (int8_conv2d,  # noqa: E402
                                                  kernel)

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
    ("dw3x3_s1", 2, 32, 96, 96, 3, 1, 96, None),
    ("dw3x3_s2", 2, 33, 144, 144, 3, 2, 144, None),
    ("dw5x5_s2", 2, 32, 240, 240, 5, 2, 240, None),
    ("dw5x5_s1_c7", 1, 15, 7, 7, 5, 1, 7, None),
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
    for b in (bias, None):
        before = kernel.launches
        got = int8_conv2d(x, packed, scale, b, s_a, stride, pads, groups, k,
                          k, out_dtype)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
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
