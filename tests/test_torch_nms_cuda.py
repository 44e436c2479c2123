"""The CUDA NMS kernels against their plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py`.
Indices and valid counts exact; scores to rtol 1e-5, atol 1e-6 through the
soft designs (the card's `expf` against torch's `exp`) and exactly equal
through the sweep and the scan. The decay and compact designs, and the
scan, equal the round kernel bit for bit on the same tensors."""

import ctypes

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
        return (*_lanes(rng, 2, 1025), 100, 0.5, 0.05, "scan")
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
        thr, design = float("-inf"), "scan"   # with its tail
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


def _soft_case(name):
    """(boxes, scores, max_det, iou_thr, score_thr, sigma)."""
    rng = np.random.default_rng(11)
    if name.startswith("L="):
        return (*_lanes(rng, int(name[2:]), 256), 100, 1.0, 0.05, 0.25)
    if name.startswith("k="):
        return (*_lanes(rng, 3, int(name[2:])), 100, 1.0, 0.05, 0.25)
    boxes, scores = _lanes(rng, 37, 256)
    md, iou_thr, thr, sigma = 100, 1.0, 0.05, 0.25
    if name == "sigma=0":
        iou_thr, sigma = 0.5, 0.0
    elif name == "sigma=0 k=1000":
        boxes, scores = _lanes(rng, 4, 1000)
        iou_thr, sigma = 0.5, 0.0
    elif name == "ties":
        scores = np.round(scores * 8) / 8          # nine levels, zeros too
    elif name == "every box the same":
        boxes[:] = boxes[:, :1]
    elif name == "all below threshold":
        thr = 1.5
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        thr = float(np.float32(0.3))               # equal is not picked
    elif name == "threshold 0, zero scores":
        scores[:, ::2] = 0.0
        scores[:, 1::4] = -0.0
        thr = 0.0
    elif name == "trained_like":
        scores = (scores * 0.06).astype(np.float32)  # few clear 0.05
    elif name == "negative_iou_threshold":
        iou_thr = -0.5                             # IoU 0 zeroes too
    elif name == "iou_at_threshold":
        xy = rng.integers(0, 6, (37, 256, 2)) / 8
        wh = rng.integers(1, 4, (37, 256, 2)) / 8
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        iou_thr, sigma = 0.5, 0.0
    elif name == "max_det_above_k":
        boxes, scores, md = boxes[:, :50], scores[:, :50], 80
    elif name != "unsorted":
        raise ValueError(name)
    return (np.ascontiguousarray(boxes), np.ascontiguousarray(scores), md,
            iou_thr, thr, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "L=640", "L=80", "L=8", "L=1", "unsorted", "sigma=0", "sigma=0 k=1000",
    "ties", "every box the same", "all below threshold", "at_threshold",
    "threshold 0, zero scores", "trained_like", "negative_iou_threshold",
    "iou_at_threshold", "max_det_above_k", "k=1", "k=31", "k=33", "k=300",
    "k=512", "k=1024"])
def test_decay_equals_rounds_and_plain(name):
    """The soft modes through `nms_lanes` launch the decay design once,
    bit-equal to the round kernel on the same tensors and equal to plain
    (indices and valid counts exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    boxes, scores, md, iou_thr, thr, sigma = _soft_case(name)
    b = torch.from_numpy(boxes).cuda()
    s = torch.from_numpy(scores).cuda()
    kw = dict(iou_threshold=iou_thr, score_threshold=thr,
              soft_nms_sigma=sigma, soft=True)
    assert nms_design(True, b.shape[1], thr) == "decay"
    before = kernel.launches, kernel.launches_by["decay"]
    got = nms_lanes(b, s, md, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_by["decay"]) == (
        before[0] + 1, before[1] + 1)
    rounds = launch_design("rounds", b, s, md, iou_thr, thr, sigma, True)
    torch.cuda.synchronize()
    for label, g, r in zip(("indices", "scores", "valid"), got, rounds):
        assert torch.equal(g, r), label
    w_idx, w_sc, w_valid = batched_nms(b, s, md, **kw)
    assert torch.equal(got[2], w_valid) and torch.equal(got[0], w_idx)
    torch.testing.assert_close(got[1], w_sc, rtol=1e-5, atol=1e-6)
    if name == "all below threshold":
        assert got[2].sum().item() == 0
    if name == "at_threshold":
        assert (got[1][got[1] > -0.5] > thr).all()


@pytest.mark.cuda
def test_soft_routes_to_rounds_under_a_negative_threshold():
    """Under a negative threshold the soft modes go to the cluster design
    (no longer to the round kernel), bit-equal to the round kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    boxes, scores = _lanes(np.random.default_rng(3), 5, 256)
    b = torch.from_numpy(boxes).cuda()
    s = torch.from_numpy(scores - 0.5).cuda()
    for thr in (float("-inf"), -0.25):
        assert nms_design(True, 256, thr) == "cluster"
        before = kernel.launches_by["cluster"], kernel.launches_by["rounds"]
        got = nms_lanes(b, s, 100, 1.0, thr, 0.25, True)
        torch.cuda.synchronize()
        assert (kernel.launches_by["cluster"],
                kernel.launches_by["rounds"]) == (before[0] + 1, before[1])
        want = batched_nms(b, s, 100, 1.0, thr, 0.25, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        rounds = launch_design("rounds", b, s, 100, 1.0, thr, 0.25, True)
        assert all(torch.equal(g, r) for g, r in zip(got, rounds))
    with pytest.raises(ValueError, match="decay"):
        launch_design("decay", b, s, 100, 1.0, -0.25, 0.25, True)


def _long_case(lanes, k, in_order, soft, seed=0):
    """Seeded lanes of k candidates (every score to 1/1024, so that ties
    occur), in top-k's order or not, on the card; and the keywords."""
    rng = np.random.default_rng(seed + 7 * lanes + k)
    boxes, scores = _lanes(rng, lanes, k)
    scores = np.round(scores * 1024) / 1024
    if in_order:
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    kw = (dict(iou_threshold=1.0, score_threshold=0.05, soft_nms_sigma=0.25,
               soft=True) if soft
          else dict(iou_threshold=0.5, score_threshold=0.05))
    return (torch.from_numpy(np.ascontiguousarray(boxes)).cuda(),
            torch.from_numpy(np.ascontiguousarray(scores.astype(np.float32))
                             ).cuda(), kw)


def _hold_long(b, s, md, kw, design):
    """`nms_lanes` launches `design` once, bit-equal to the round kernel
    (where that takes k) and index-exact to plain."""
    soft = kw.get("soft", False)
    assert nms_design(soft, b.shape[1], kw["score_threshold"]) == design
    before = kernel.launches, kernel.launches_by[design]
    got = nms_lanes(b, s, md, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_by[design]) == (
        before[0] + 1, before[1] + 1)
    if b.shape[1] <= 8192:
        rounds = launch_design("rounds", b, s, md, kw["iou_threshold"],
                               kw["score_threshold"],
                               kw.get("soft_nms_sigma", 0.0), soft)
        torch.cuda.synchronize()
        for label, g, r in zip(("indices", "scores", "valid"), got, rounds):
            assert torch.equal(g, r), (design, "rounds", label)
    want = batched_nms(b, s, md, **kw)
    assert torch.equal(got[2], want[2]) and torch.equal(got[0], want[0])
    if soft:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("in_order", [True, False], ids=["in_order",
                                                          "unsorted"])
@pytest.mark.parametrize("lanes", [1, 8, 80, 640])
@pytest.mark.parametrize("k", [1025, 2048, 5000, 8192])
@pytest.mark.parametrize("soft", [False, True], ids=["scan", "compact"])
def test_long_lanes_equal_rounds_and_plain(soft, k, lanes, in_order):
    """Past 1,024 candidates hard mode launches the scan and the soft modes
    the compact design: at every lane count of the exact-parity lane's
    requests, in top-k's order and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    b, s, kw = _long_case(lanes, k, in_order, soft)
    _hold_long(b, s, 100, kw, "compact" if soft else "scan")


def _long_edge(name):
    """(boxes, scores, max_det, keywords, design) on the card."""
    rng = np.random.default_rng(17)
    boxes, scores = _lanes(rng, 3, 3000)
    md = 100
    kw = dict(iou_threshold=0.5, score_threshold=0.05)
    design = "scan"
    if name.startswith("soft"):
        kw = dict(iou_threshold=1.0, score_threshold=0.05,
                  soft_nms_sigma=0.25, soft=True)
        design = "compact"
        name = name[5:]
    if name == "sigma=0":
        kw.update(iou_threshold=0.5, soft_nms_sigma=0.0)
    elif name == "ties":
        scores = np.round(scores * 8) / 8
    elif name == "all_equal":
        scores[:] = 0.5
    elif name == "duplicates":
        boxes[:, 1500:] = boxes[:, :1500]
        scores[:, 1500:] = scores[:, :1500]
    elif name == "one_box":
        boxes[:] = boxes[:, :1]
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        kw["score_threshold"] = float(np.float32(0.3))
    elif name == "threshold_0_zeros":
        scores[:, ::2], scores[:, 1::4] = 0.0, -0.0
        kw["score_threshold"] = 0.0
    elif name == "signed_zeros":
        scores[:, ::2], scores[:, 1::2] = 0.0, -0.0
        kw["score_threshold"] = -1.0
    elif name == "threshold_at_suppressed":
        kw["score_threshold"] = -1e10
    elif name == "negative_iou_threshold":
        kw["iou_threshold"] = -0.5
    elif name == "iou_at_threshold":
        xy = rng.integers(0, 6, (3, 3000, 2)) / 8
        wh = rng.integers(1, 4, (3, 3000, 2)) / 8
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        kw["iou_threshold"] = 0.5 if design == "scan" else 1.0
        if "soft_nms_sigma" in kw:
            kw.update(iou_threshold=0.5, soft_nms_sigma=0.0)
    elif name == "trained_like":
        scores = (scores * 0.06).astype(np.float32)
    elif name == "all_below":
        kw["score_threshold"] = 1.5
    elif name == "max_det_above_k":
        boxes, scores, md = boxes[:, :1100], scores[:, :1100], 1200
    elif name == "k=8193":
        boxes, scores = _lanes(rng, 2, 8193)
    elif name == "k=20000":
        boxes, scores = _lanes(rng, 1, 20000)
    elif name != "unsorted":
        raise ValueError(name)
    return (torch.from_numpy(np.ascontiguousarray(boxes)).cuda(),
            torch.from_numpy(np.ascontiguousarray(scores.astype(np.float32))
                             ).cuda(), md, kw, design)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "unsorted", "ties", "all_equal", "duplicates", "one_box", "at_threshold",
    "signed_zeros", "threshold_at_suppressed", "negative_iou_threshold",
    "iou_at_threshold", "trained_like", "all_below", "max_det_above_k",
    "k=8193", "k=20000", "soft unsorted", "soft sigma=0", "soft ties",
    "soft all_equal", "soft duplicates", "soft one_box", "soft at_threshold",
    "soft threshold_0_zeros", "soft negative_iou_threshold",
    "soft iou_at_threshold", "soft trained_like", "soft all_below",
    "soft max_det_above_k"])
def test_long_designs_on_edges(name):
    """The scan and compact designs on ties, one box, thresholds at a score,
    IoUs at the threshold, more slots than candidates, and (the scan) k past
    the round kernel's 8,192."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    b, s, md, kw, design = _long_edge(name)
    got = _hold_long(b, s, md, kw, design)
    if name.endswith("all_below"):
        assert got[2].sum().item() == 0


@pytest.mark.cuda
def test_long_designs_take_unaligned_boxes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    boxes, scores = _lanes(np.random.default_rng(19), 3, 1500)
    flat = torch.zeros(boxes.size + 1, device="cuda")
    flat[1:] = torch.from_numpy(boxes).cuda().reshape(-1)
    b = flat[1:].view(3, 1500, 4)
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    s = torch.from_numpy(scores).cuda()
    _hold_long(b, s, 50, dict(iou_threshold=0.5, score_threshold=0.1),
               "scan")
    _hold_long(b, s, 50, dict(iou_threshold=1.0, score_threshold=0.1,
                              soft_nms_sigma=0.25, soft=True), "compact")


_CLUSTER_CASES = [
    # lanes, k, score_threshold: past 8,192 at any threshold, and under 0
    # at any k
    (lanes, k, thr) for lanes, k in ((1, 300), (8, 8192), (8, 8193),
                                     (2, 20000), (1, 100000))
    for thr in (0.05, -0.5, float("-inf")) if k > 8192 or thr < 0]


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.25, 0.0], ids=str)
@pytest.mark.parametrize("lanes,k,thr", _CLUSTER_CASES, ids=str)
def test_cluster_design_equals_rounds_and_plain(lanes, k, thr, sigma):
    """The soft lanes past 8,192 candidates and under a negative threshold
    launch the cluster design (its scores spilled past 81,920 candidates),
    bit-equal to the round kernel where that takes k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    b, s, _ = _long_case(lanes, k, False, True, seed=3)
    if thr < 0:
        s = (s - 0.6).contiguous()
    kw = dict(iou_threshold=1.0 if sigma > 0 else 0.5, score_threshold=thr,
              soft_nms_sigma=sigma, soft=True)
    _hold_long(b, s, 100, kw, "cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [float("-inf"), -3e10], ids=str)
@pytest.mark.parametrize("k,md", [(77, 100), (256, 300), (5000, 100),
                                  (16384, 100)], ids=str)
def test_scan_tail_equals_rounds_and_plain(k, md, thr):
    """Hard mode under -1e10 on the scan with its tail: every box twice,
    scores of -1e10 and below, more rounds than candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
    from retinanet_torch.tools.nms_experiments import tail_lanes
    b, s = tail_lanes(4, k)
    _hold_long(b, s, md, dict(iou_threshold=0.5, score_threshold=thr),
               "scan")


@pytest.mark.cuda
def test_cluster_constants_match_the_wrapper():
    """The cluster design's constants in csrc/nms.cu, as the built library
    returns them, are the wrapper's, from which `cluster_plan` and the CPU
    walk of the design are made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds only there")
    from retinanet_torch.ops import nms_kernel
    got = (ctypes.c_int * 4)()
    kernel.build().nms_cluster_constants(got)
    assert list(got) == [nms_kernel.CLUSTER_WARPS, nms_kernel.CLUSTER_MAX_CTAS,
                         nms_kernel.CLUSTER_CTA_TARGET,
                         nms_kernel.CLUSTER_CTA_MAX]
