"""The CUDA NMS kernels against their plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py`.
Indices and valid counts exact; scores to rtol 1e-5, atol 1e-6 through the
round kernel (soft decay) and exactly equal through the sweep."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.ops.nms import batched_nms  # noqa: E402
from retinanet_torch.ops.nms_kernel import (  # noqa: E402
    kernel, launch_design, nms_design, nms_lanes)

_CASES = [
    # lanes, k, max_det, soft, sigma, score_threshold
    (640, 256, 100, False, 0.0, 0.05),   # PerClassHardNMS at batch 8
    (640, 256, 100, True, 0.25, 0.05),   # PerClassSoftNMS
    (8, 256, 100, False, 0.0, 0.05),     # Global modes at batch 8
    (3, 77, 10, False, 0.0, 0.2),        # ragged lanes and candidates
    (4, 1000, 50, True, 0.0, 0.05),      # soft with sigma 0, k > 256
    (2, 5000, 100, False, 0.0, 0.05),    # k above 48 KB of shared memory
]


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=str)
def test_nms_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
    lanes, k, md, soft, sigma, thr = case
    boxes, scores = _lanes(np.random.default_rng(lanes * k), lanes, k)
    b = torch.from_numpy(boxes).cuda()
    s = torch.from_numpy(scores).cuda()
    kw = dict(iou_threshold=1.0 if (soft and sigma > 0) else 0.5,
              score_threshold=thr, soft_nms_sigma=sigma, soft=soft)
    design = nms_design(soft, k, thr)
    before = kernel.launches, kernel.launches_by[design]
    idx, sc, valid = nms_lanes(b, s, md, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_by[design]) == (
        before[0] + 1, before[1] + 1)
    w_idx, w_sc, w_valid = batched_nms(b, s, md, **kw)
    np.testing.assert_array_equal(valid.cpu().numpy(), w_valid.cpu().numpy())
    np.testing.assert_array_equal(idx.cpu().numpy(), w_idx.cpu().numpy())
    np.testing.assert_allclose(sc.cpu().numpy(), w_sc.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_nms_kernel_all_below_threshold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
    idx, sc, valid = nms_lanes(torch.zeros((2, 64, 4), device="cuda"),
                               torch.full((2, 64), 0.01, device="cuda"), 5,
                               score_threshold=0.5)
    assert valid.tolist() == [0, 0]
    assert (sc == -1.0).all() and (idx == 0).all()


def _sweep_case(name):
    """(boxes, scores, max_det, iou_thr, score_thr, expected design)."""
    rng = np.random.default_rng(5)
    if name in ("k=300", "k=1000", "k=1024"):
        return (*_lanes(rng, 5, int(name[2:])), 100, 0.5, 0.05, "sweep")
    if name == "k=1025":
        return (*_lanes(rng, 2, 1025), 100, 0.5, 0.05, "rounds")
    boxes, scores = _lanes(rng, 37, 256)
    md, iou_thr, thr, design = 100, 0.5, 0.05, "sweep"
    if name == "sorted":
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    elif name == "ties":
        scores = np.round(scores * 8) / 8
    elif name == "all_equal":
        scores[:] = 0.5
    elif name == "duplicates":
        boxes[:, 128:] = boxes[:, :128]
        scores[:, 128:] = scores[:, :128]
    elif name == "zero_area":
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        thr = float(np.float32(0.3))
    elif name == "one_survivor":
        boxes[:] = boxes[:, :1]
    elif name == "neg_inf_padding":
        scores[:, 40:] = -np.inf
    elif name == "signed_zeros":
        scores[:, ::2], scores[:, 1::2], thr = 0.0, -0.0, -1.0
    elif name == "threshold_at_suppressed":
        thr = -1e10
    elif name == "negative_iou_threshold":
        iou_thr = -0.5
    elif name == "iou_threshold_0":
        iou_thr = 0.0
    elif name == "trained_like":
        scores = (scores * 0.06).astype(np.float32)
    elif name == "iou_at_threshold":
        # corners on a grid of eighths: many IoUs are exactly 1/2 or 1/3
        xy = rng.integers(0, 6, (37, 256, 2)) / 8
        wh = rng.integers(1, 4, (37, 256, 2)) / 8
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        iou_thr = 0.5 if rng.integers(2) else float(np.float32(1 / 3))
    elif name == "threshold_-inf":
        thr, design = float("-inf"), "rounds"
    elif name == "max_det_above_k":
        boxes, scores, md = boxes[:, :50], scores[:, :50], 80
    elif name != "unsorted":
        raise ValueError(name)
    return (np.ascontiguousarray(boxes), np.ascontiguousarray(scores), md,
            iou_thr, thr, design)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "unsorted", "sorted", "ties", "all_equal", "duplicates", "zero_area",
    "at_threshold", "one_survivor", "neg_inf_padding", "signed_zeros",
    "threshold_at_suppressed", "negative_iou_threshold", "trained_like",
    "iou_at_threshold", "iou_threshold_0", "threshold_-inf", "max_det_above_k", "k=300", "k=1000", "k=1024",
    "k=1025"])
def test_hard_nms_designs_equal_plain(name):
    """Hard mode through `nms_lanes` (the design it picks) and through the
    other design where that one takes the shape: all equal to plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    boxes, scores, md, iou_thr, thr, design = _sweep_case(name)
    b = torch.from_numpy(boxes).cuda()
    s = torch.from_numpy(scores).cuda()
    assert nms_design(False, b.shape[1], thr) == design
    before = kernel.launches_by[design]
    got = nms_lanes(b, s, md, iou_thr, thr)
    torch.cuda.synchronize()
    assert kernel.launches_by[design] == before + 1
    want = batched_nms(b, s, md, iou_thr, thr)
    for label, g, w in zip(("indices", "scores", "valid"), got, want):
        assert torch.equal(g, w), (design, label)
    if design == "sweep":
        other = launch_design("rounds", b, s, md, iou_thr, thr)
        torch.cuda.synchronize()
        for label, g, w in zip(("indices", "scores", "valid"), other, want):
            assert torch.equal(g, w), ("rounds", label)


@pytest.mark.cuda
def test_sweep_takes_unaligned_boxes_and_no_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    boxes, scores = _lanes(np.random.default_rng(9), 3, 64)
    flat = torch.zeros(boxes.size + 1, device="cuda")
    flat[1:] = torch.from_numpy(boxes).cuda().reshape(-1)
    b = flat[1:].view(3, 64, 4)
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    s = torch.from_numpy(scores).cuda()
    got = nms_lanes(b, s, 20, 0.5, 0.1)
    torch.cuda.synchronize()
    for g, w in zip(got, batched_nms(b, s, 20, 0.5, 0.1)):
        assert torch.equal(g, w)
    idx, sc, valid = nms_lanes(b[:0], s[:0], 20, 0.5, 0.1)
    assert idx.shape == (0, 20) and sc.shape == (0, 20) and valid.shape == (0,)
