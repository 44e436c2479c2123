"""The CUDA top-k kernels against their plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_topk_cuda.py`.
Both designs ("row" and "slab", forced through `launch(design=...)`) on
every case: indices and value bits exactly equal in every mode ("packed"
with drop 0 and 1, "bf16", "f32"), on normal logits around the class
prior, on quarter-step logits and rows of one value (heavy ties), on signed
zeros, at k from 1 to N (past 16,384 winners the sort runs in global
scratch) and on rows laid out in place ((B, N, C), stride
C) and as one long row ((B, N, 1), the global lane); the slab design also
with a candidate buffer of k keys, so that rows overflow it and read the
slab again; the row design on the NMS survivors' rows (mostly or all -1.0)
at batch 1 and 8, k on both sides of its counting sort's limit; the row
design's constants in csrc/topk.cu against the wrapper's."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.ops.topk import (  # noqa: E402
    select_top_k, top_k_rows_plain)
from retinanet_torch.ops import topk_kernel as tk  # noqa: E402
from retinanet_torch.ops.topk_kernel import (  # noqa: E402
    kernel, launch, slab_trace, topk_design)
from retinanet_torch.tools.topk_experiments import (  # noqa: E402
    trained_like_survivors)

_CASES = [
    # mode, batch, n, classes, k, kind
    ("packed", 8, 76725, 80, 256, "normal"),    # the flagship, drop 1
    ("packed", 8, 76725, 80, 5000, "quarter"),
    ("packed", 2, 37485, 80, 256, "quarter"),   # drop 0
    ("packed", 8, 37485, 80, 256, "one"),       # rows of one value
    ("packed", 2, 110484, 8, 1000, "normal"),   # drop 1
    ("packed", 2, 3069, 5, 3069, "quarter"),    # k = N
    ("packed", 3, 774, 7, 1, "one"),            # one value, k = 1
    ("bf16", 2, 150381, 4, 256, "quarter"),     # above 2^17
    ("bf16", 2, 306900, 2, 5000, "normal"),
    ("bf16", 1, 9207 * 80, 1, 256, "normal"),   # the global lane
    ("bf16", 8, 76725 * 80, 1, 256, "normal"),  # ... at batch 8
    ("bf16", 2, 76725 * 80, 1, 8192, "one"),
    ("f32", 2, 76725, 16, 256, "normal"),       # the exact lane
    ("f32", 8, 76725, 80, 256, "sigmoid"),
    ("f32", 2, 76725, 8, 5000, "quarter"),      # the skip_nms lane
    ("f32", 2, 76725, 80, 8192, "quarter"),
    ("f32", 8, 8000, 1, 100, "zeros"),          # the NMS survivors
    ("f32", 1, 20000, 3, 8192, "one"),          # the old cap
    ("f32", 2, 70001, 3, 300, "zeros"),         # odd rows: unaligned images
    # past 8,192 winners: the on-chip sort up to 16,384, then in scratch
    ("packed", 2, 76725, 8, 8193, "quarter"),
    ("packed", 2, 76725, 8, 16384, "one"),
    ("f32", 2, 20000, 1, 16385, "zeros"),
    ("f32", 1, 20000, 3, 20000, "one"),         # k = N in scratch
    ("bf16", 1, 76725, 4, 76725, "normal"),
    ("bf16", 1, 300000, 1, 40000, "quarter"),   # a long row, k = 40,000
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
    elif kind == "sigmoid":
        x = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 0.3, x.shape)))
    t = torch.from_numpy(x.astype(np.float32)).cuda()
    return t if mode == "f32" else t.to(torch.bfloat16)


def _check(x, k, mode, got_v, got_i):
    want_v, want_i = top_k_rows_plain(x, k, mode)
    torch.cuda.synchronize()
    view = torch.int32 if mode == "f32" else torch.int16
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(view), want_v.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["row", "slab"])
@pytest.mark.parametrize("case", _CASES, ids=str)
def test_topk_kernel_matches_plain(case, design):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the top-k kernel has no CPU mode")
    mode, _, _, _, k, _ = case
    x = _rows(case)
    before = dict(kernel.launches_by), dict(kernel.launches_by_design)
    got_v, got_i = launch(x, k, mode, design=design)
    assert kernel.launches_by[mode] == before[0].get(mode, 0) + 1
    assert kernel.launches_by_design[design] == before[1].get(design, 0) + 1
    _check(x, k, mode, got_v, got_i)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in _CASES if c[2] > c[4]],
                         ids=str)
def test_slab_rows_that_overflow_read_the_slab_again(case):
    """A buffer of k keys: a row whose candidates at the digit found exceed
    it takes another level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the top-k kernel has no CPU mode")
    mode, _, _, _, k, kind = case
    x = _rows(case)
    got_v, got_i = launch(x, k, mode, design="slab", capacity=k)
    _check(x, k, mode, got_v, got_i)
    trace = slab_trace(x, k, mode, capacity=k)
    if kind in ("one", "quarter", "zeros"):
        assert trace["levels"] > 2, trace


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("kind", ["trained", "fill"])
@pytest.mark.parametrize("n,k", [(8000, 1), (8000, 100), (8000, 128),
                                 (8000, 129), (16383, 8192)])
def test_row_design_on_survivors(n, k, kind, batch):
    """The row design on the survivors' rows (trained-like: a few kept
    scores a class, >= 95% -1.0 fill; or all fill), on both sides of the
    counting sort's limit (k = 128) and at the largest k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the top-k kernel has no CPU mode")
    x = (trained_like_survivors(batch, n) if kind == "trained" else
         torch.full((batch, n, 1), -1.0, device="cuda"))
    assert topk_design(batch, n, 1, k) == "row"
    got_v, got_i = launch(x, k, "f32", design="row")
    _check(x, k, "f32", got_v, got_i)


@pytest.mark.cuda
def test_row_constants_match_the_wrapper():
    """The row design's constants in csrc/topk.cu are the wrapper's, from
    which the CPU walk of the design is made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds only there")
    fn = kernel.build().topk_row_constants
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    got = np.zeros(5, np.int32)
    fn(got.ctypes.data)
    assert got.tolist() == [tk.ROW_THREADS, tk.ROW_ITEMS, tk.ROW_DIGIT_BITS,
                            tk.ROW_RANK_SORT_MAX, tk.ROW_RANK_LANES]


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
    # the flagship's default lane takes the slab design, by shape alone
    x = torch.zeros((1, 76725, 80), dtype=torch.bfloat16, device="cuda")
    assert topk_design(1, 76725, 80, 256) == "slab"
    before = kernel.launches_by_design["slab"]
    select_top_k(x, 256, "packed", dim=1)
    assert kernel.launches_by_design["slab"] == before + 1
