"""The sorted-sweep form of hard NMS (`ops/nms.py:sweep_nms_plain`, the plain
model of the sweep kernel in `csrc/nms.cu`) against the round form
(`batched_nms`) and against the JAX package, on the CPU; and the wrapper's
choice among the five kernels as a pure function.

Indices, valid counts and scores are compared exactly against `batched_nms`
(both read the same float32 scores and do the same IoU arithmetic); against
JAX the scores to rtol 1e-5, atol 1e-6 as in tests/test_torch_nms.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from retinanet_tpu.ops.nms import nms_select as jax_nms_select  # noqa: E402
from retinanet_torch.ops.nms import batched_nms, sweep_nms_plain  # noqa: E402
from retinanet_torch.ops.nms_kernel import (  # noqa: E402
    DECAY_MAX_CANDIDATES, SWEEP_MAX_CANDIDATES, kernel, nms_design, nms_lanes)
from retinanet_torch.tools import nms_experiments  # noqa: E402
from retinanet_torch.tools.kernel_variants import variant_source  # noqa: E402


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


def _case(name):
    """(boxes (L, k, 4), scores (L, k), max_det, iou_thr, score_thr)."""
    rng = np.random.default_rng(7)
    if name.startswith("k="):
        k = int(name[2:])
        return (*_lanes(rng, 3, k), 20, 0.5, 0.1)
    boxes, scores = _lanes(rng, 4, 96)
    md, iou_thr, thr = 30, 0.5, 0.1
    if name == "sorted":
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    elif name == "ties":
        scores = np.round(scores * 8) / 8          # nine distinct values
    elif name == "all_equal":
        scores[:] = 0.5
    elif name == "duplicates":
        boxes[:, 48:] = boxes[:, :48]              # IoU exactly 1
        scores[:, 48:] = scores[:, :48]
    elif name == "zero_area":
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]      # union clamps at 1e-8
        boxes[:, 1::6] = 0.0
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        thr = float(np.float32(0.3))               # equal is not picked
        assert (scores == np.float32(0.3)).any()
    elif name == "max_det_above_k":
        md = 150
    elif name == "max_det_above_survivors":
        boxes[:] = boxes[:, :1]                    # one survivor a lane
    elif name == "neg_inf_padding":
        scores[:, 40:] = -np.inf
        boxes[:, 40:] = 0.0
    elif name == "signed_zeros":
        scores[:, ::2] = 0.0
        scores[:, 1::2] = -0.0
        thr = -1.0
    elif name == "threshold_at_suppressed":
        thr = -1e10
        scores[:, 5] = -2e10
    elif name == "negative_iou_threshold":
        iou_thr = -0.5                             # IoU 0 suppresses too
    elif name == "trained_like":
        scores = (scores * 0.06).astype(np.float32)  # few clear 0.05
        thr = 0.05
    elif name != "unsorted":
        raise ValueError(name)
    return boxes, scores, md, iou_thr, thr


CASES = ["unsorted", "sorted", "ties", "all_equal", "duplicates", "zero_area",
         "at_threshold", "max_det_above_k", "max_det_above_survivors",
         "neg_inf_padding", "signed_zeros", "threshold_at_suppressed",
         "negative_iou_threshold", "trained_like", "k=1", "k=77", "k=256",
         "k=300"]


@pytest.mark.parametrize("name", CASES)
def test_sweep_equals_rounds(name):
    boxes, scores, md, iou_thr, thr = _case(name)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = sweep_nms_plain(b, s, md, iou_thr, thr)
    want = batched_nms(b, s, md, iou_thr, thr)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for name_, g, w in zip(("indices", "scores", "valid"), got, want):
        assert g.shape == w.shape, name_
        assert torch.equal(g, w), name_
    if name == "max_det_above_survivors":
        assert got[2].tolist() == [1] * boxes.shape[0]
    if name == "at_threshold":
        assert (got[1][got[1] > -0.5] > thr).all()


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), k=st.integers(1, 70),
       levels=st.integers(1, 12), md=st.integers(1, 80),
       iou_thr=st.sampled_from([0.0, 0.3, 0.5, 0.9, 1.0]),
       thr=st.sampled_from([-1e10, -1.0, 0.0, 0.25, 0.5, 2.0]))
def test_sweep_equals_rounds_on_quantised_lanes(seed, k, levels, md, iou_thr,
                                                thr):
    """Scores on a few levels and boxes on a coarse grid: ties in the order,
    duplicated boxes, and IoUs exactly at the threshold all occur."""
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, levels + 1, (2, k)) / levels).astype(np.float32)
    xy = rng.integers(0, 6, (2, k, 2)) / 8
    wh = rng.integers(0, 4, (2, k, 2)) / 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = sweep_nms_plain(b, s, md, iou_thr, thr)
    want = batched_nms(b, s, md, iou_thr, thr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("presorted", [False, True],
                         ids=["unsorted", "sorted"])
def test_sweep_matches_jax(presorted):
    rng = np.random.default_rng(0)
    boxes, scores = _lanes(rng, 11, 150)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    kw = dict(iou_threshold=0.5, score_threshold=0.1)
    idx, sc, valid = sweep_nms_plain(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 30, **kw)
    ref = [jax_nms_select(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 30,
                          **kw) for i in range(boxes.shape[0])]
    np.testing.assert_array_equal(valid.numpy(), [int(r.valid) for r in ref])
    np.testing.assert_array_equal(idx.numpy(),
                                  np.stack([r.indices for r in ref]))
    np.testing.assert_allclose(sc.numpy(), np.stack([r.scores for r in ref]),
                               rtol=1e-5, atol=1e-6)


def test_sweep_refuses_a_threshold_under_the_suppression_score():
    boxes, scores = (torch.from_numpy(x) for x in
                     _lanes(np.random.default_rng(1), 1, 8))
    with pytest.raises(ValueError, match="score_threshold"):
        sweep_nms_plain(boxes, scores, 4, 0.5, float("-inf"))
    with pytest.raises(ValueError, match="score_threshold"):
        sweep_nms_plain(boxes, scores, 4, 0.5, -2e10)


@pytest.mark.parametrize("soft,k,thr,want", [
    (False, 256, 0.05, "sweep"),              # the flagship serving path
    (False, 1, 0.0, "sweep"),
    (False, SWEEP_MAX_CANDIDATES, 0.05, "sweep"),
    (False, 256, -1e10, "sweep"),             # at the suppression score
    (False, SWEEP_MAX_CANDIDATES + 1, 0.05, "scan"),
    (False, 5000, 0.05, "scan"),              # nms_top_k up to 5,000
    (False, 8192, 0.05, "scan"),
    (False, 8193, 0.05, "scan"),              # hard mode has no cap
    (False, 256, float("-inf"), "rounds"),    # suppressed ones get picked
    (False, 256, -2e10, "rounds"),
    (True, 256, 0.05, "decay"),               # PerClassSoftNMS, GlobalSoftNMS
    (True, 1, 0.0, "decay"),                  # exactly 0: +0.0 is not above
    (True, 256, -0.0, "decay"),
    (True, DECAY_MAX_CANDIDATES, 0.05, "decay"),
    (True, DECAY_MAX_CANDIDATES + 1, 0.05, "compact"),
    (True, 5000, 0.05, "compact"),            # nms_top_k up to 5,000
    (True, 8192, 0.05, "compact"),
    (True, 8193, 0.05, "rounds"),             # past compact's 8,192
    (True, 64, -1.0, "rounds"),               # negative scores rise to 0
    (True, 256, float("-inf"), "rounds"),
    (True, 256, -1e-30, "rounds"),
    (True, 256, float("nan"), "rounds"),
], ids=str)
def test_design_choice(soft, k, thr, want):
    assert nms_design(soft, k, thr) == want


def test_wrapper_on_cpu_launches_nothing():
    boxes, scores, md, iou_thr, thr = _case("ties")
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = kernel.launches, dict(kernel.launches_by)
    got = nms_lanes(b, s, md, iou_thr, thr)
    assert (kernel.launches, dict(kernel.launches_by)) == before
    for g, w in zip(got, batched_nms(b, s, md, iou_thr, thr)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(nms_experiments.VARIANTS))
def test_experiment_variants_apply_to_the_source(name):
    """Each ablation of tools/nms_experiments.py is one edit of csrc/nms.cu:
    it must still find its text, once, and change the source."""
    edits = nms_experiments.VARIANTS[name][1]
    assert variant_source(kernel, name, edits) != kernel.source.read_text()
