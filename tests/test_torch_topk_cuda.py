"""The CUDA top-k kernel against its plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_topk_cuda.py`.
Indices and value bits exactly equal in every mode ("packed" with drop 0
and 1, "bf16", "f32"), on normal logits around the class prior, on
quarter-step logits and rows of one value (heavy ties), on signed zeros,
at k from 1 to 8192 and on rows laid out in place ((B, N, C), stride C)
and as one long row ((B, N, 1))."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.ops.topk import (  # noqa: E402
    select_top_k, top_k_rows_plain)
from retinanet_torch.ops.topk_kernel import kernel, launch  # noqa: E402

_CASES = [
    # mode, batch, n, classes, k, kind
    ("packed", 8, 76725, 80, 256, "normal"),    # the flagship, drop 1
    ("packed", 2, 37485, 80, 256, "quarter"),   # drop 0
    ("packed", 2, 110484, 8, 1000, "normal"),   # drop 1
    ("packed", 2, 3069, 5, 3069, "quarter"),    # k = N
    ("packed", 3, 774, 7, 1, "one"),            # one value, k = 1
    ("bf16", 2, 150381, 4, 256, "quarter"),     # above 2^17
    ("bf16", 2, 306900, 2, 5000, "normal"),
    ("bf16", 1, 9207 * 80, 1, 256, "normal"),   # the global lane
    ("f32", 2, 76725, 16, 256, "normal"),       # the exact lane
    ("f32", 2, 76725, 8, 5000, "quarter"),      # the skip_nms lane
    ("f32", 8, 8000, 1, 100, "zeros"),          # the NMS survivors
    ("f32", 1, 20000, 3, 8192, "one"),          # the largest k
]


def _rows(case):
    mode, batch, n, classes, _, kind = case
    rng = np.random.default_rng(n + classes)
    x = rng.normal(-4.6, 1.5, (batch, n, classes))
    if kind == "quarter":
        x = np.round(x * 4) / 4
    elif kind == "one":
        x = np.full_like(x, -2.0)
    elif kind == "zeros":
        x = np.round(x) * 0.0           # +0.0 and -0.0
    t = torch.from_numpy(x.astype(np.float32)).cuda()
    return t if mode == "f32" else t.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=str)
def test_topk_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the top-k kernel has no CPU mode")
    mode, _, _, _, k, _ = case
    x = _rows(case)
    before = kernel.launches_by[mode]
    got_v, got_i = launch(x, k, mode)
    assert kernel.launches_by[mode] == before + 1
    want_v, want_i = top_k_rows_plain(x, k, mode)
    torch.cuda.synchronize()
    view = torch.int32 if mode == "f32" else torch.int16
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(view), want_v.view(view))


@pytest.mark.cuda
def test_select_top_k_dispatches_to_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the top-k kernel has no CPU mode")
    x = torch.randn(2, 3, 4000, device="cuda")
    before = kernel.launches
    values, idx = select_top_k(x, 50, "f32")
    assert kernel.launches == before + 1
    want = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(idx.long(), want.indices[..., :50])
    assert torch.equal(values, want.values[..., :50])
    with pytest.raises(ValueError):
        launch(torch.zeros((1, 9000, 1), device="cuda"), 8193, "f32")
