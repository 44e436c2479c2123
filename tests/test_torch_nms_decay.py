"""The decay form of soft NMS (`ops/nms.py:decay_nms_plain`, the plain model
of the decay kernel in `csrc/nms.cu`) against the round form (`batched_nms`)
and the round form in both soft modes against the JAX package, on the CPU
(the route to the decay design: tests/test_torch_nms_sweep.py,
`test_design_choice`).

Against `batched_nms` indices, scores and valid counts are compared bit for
bit (the same float32 arithmetic on the same tensors); against JAX indices
and valid counts exactly and scores to rtol 1e-5, atol 1e-6, as in
tests/test_torch_nms.py (exp and division may round differently)."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from retinanet_tpu.ops.nms import nms_select as jax_nms_select  # noqa: E402
from retinanet_tpu.ops.pallas.nms_kernel import pallas_nms  # noqa: E402
from retinanet_torch.ops.nms import batched_nms, decay_nms_plain  # noqa: E402
from retinanet_torch.ops.nms_kernel import kernel, nms_lanes  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

SOFT_MODES = {"sigma=0.25": (1.0, 0.25), "sigma=0": (0.5, 0.0)}


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


def _case(name):
    """(boxes (L, k, 4), scores (L, k), max_det, score_thr)."""
    rng = np.random.default_rng(13)
    if name.startswith("k="):
        return (*_lanes(rng, 3, int(name[2:])), 100, 0.05)
    boxes, scores = _lanes(rng, 4, 96)
    md, thr = 30, 0.05
    if name == "ties":
        scores = np.round(scores * 8) / 8          # nine levels, zeros too
    elif name == "every_box_the_same":
        boxes[:] = boxes[:, :1]
    elif name == "all_below_threshold":
        thr = 1.5
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        thr = float(np.float32(0.3))               # equal is not picked
        assert (scores == np.float32(0.3)).any()
    elif name == "threshold_0_zero_scores":
        scores[:, ::2] = 0.0
        scores[:, 1::4] = -0.0
        thr = 0.0
    elif name == "stop_early":
        scores = (scores * 0.06).astype(np.float32)  # few clear 0.05
    elif name == "max_det_above_k":
        md = 150
    elif name != "unsorted":
        raise ValueError(name)
    return boxes, scores, md, thr


CASES = ["unsorted", "ties", "every_box_the_same", "all_below_threshold",
         "at_threshold", "threshold_0_zero_scores", "stop_early",
         "max_det_above_k", "k=1", "k=31", "k=32", "k=33", "k=256",
         "k=1000", "k=1024"]


def _equal(got, want):
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for label, g, w in zip(("indices", "scores", "valid"), got, want):
        assert g.shape == w.shape, label
        assert torch.equal(g, w), label


@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("name", CASES)
def test_decay_equals_rounds(name, mode):
    boxes, scores, md, thr = _case(name)
    iou_thr, sigma = SOFT_MODES[mode]
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    work = {}
    got = decay_nms_plain(b, s, md, iou_thr, thr, sigma, work=work)
    _equal(got, batched_nms(b, s, md, iou_thr, thr, sigma, True))
    assert 0 <= work["decayed"] <= work["alive"]
    assert work["staged"] == int((s > thr).sum())
    valid = got[2]
    if name == "all_below_threshold":
        assert valid.tolist() == [0] * boxes.shape[0]
        assert work["alive"] == 0
    if name == "at_threshold":
        assert (got[1][got[1] > -0.5] > thr).all()
    if name == "stop_early":
        assert (valid < md).all() and (valid > 0).any()
    if name == "max_det_above_k":
        assert (valid <= boxes.shape[1]).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), k=st.integers(1, 70),
       levels=st.integers(1, 12), md=st.integers(1, 80),
       mode=st.sampled_from(sorted(SOFT_MODES)),
       iou_thr=st.sampled_from([None, -0.5, 0.0, 0.5]),
       thr=st.sampled_from([0.0, 0.05, 0.25, 0.5, 2.0]))
def test_decay_equals_rounds_on_quantised_lanes(seed, k, levels, md, mode,
                                                iou_thr, thr):
    """Scores on a few levels and boxes on a coarse grid: ties among the
    maxima, duplicated boxes, pairs with no intersection and IoUs exactly
    at the threshold all occur."""
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, levels + 1, (2, k)) / levels).astype(np.float32)
    xy = rng.integers(0, 6, (2, k, 2)) / 8
    wh = rng.integers(0, 4, (2, k, 2)) / 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    default_iou, sigma = SOFT_MODES[mode]
    iou_thr = default_iou if iou_thr is None else iou_thr
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    _equal(decay_nms_plain(b, s, md, iou_thr, thr, sigma),
           batched_nms(b, s, md, iou_thr, thr, sigma, True))


def test_decay_refuses_a_negative_threshold():
    boxes, scores = (torch.from_numpy(x) for x in
                     _lanes(np.random.default_rng(1), 1, 8))
    for thr in (float("-inf"), -1e-30, float("nan")):
        with pytest.raises(ValueError, match="score_threshold"):
            decay_nms_plain(boxes, scores, 4, 1.0, thr, 0.25)


@functools.lru_cache(maxsize=None)
def _jax_lanes(md, iou_thr, thr, sigma):
    return jax.jit(jax.vmap(functools.partial(
        jax_nms_select, max_detections=md, iou_threshold=iou_thr,
        score_threshold=thr, soft_nms_sigma=sigma, soft=True)))


@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("lanes,k,md", [(8, 256, 100), (5, 77, 30)],
                         ids=["flagship_k", "ragged"])
def test_soft_nms_matches_jax(mode, lanes, k, md):
    """The soft modes at the flagship's settings (threshold 0.05; sigma 0.25
    after the halving with IoU threshold 1.0, or sigma 0 with 0.5):
    `nms_lanes` on the CPU (`batched_nms`) and the decay model against the
    JAX package's XLA `nms_select` and its Pallas kernel in interpret
    mode."""
    iou_thr, sigma = SOFT_MODES[mode]
    boxes, scores = _lanes(np.random.default_rng(lanes * k), lanes, k)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = nms_lanes(b, s, md, iou_thr, 0.05, sigma, True)
    _equal(decay_nms_plain(b, s, md, iou_thr, 0.05, sigma), got)
    ref = _jax_lanes(md, iou_thr, 0.05, sigma)(jnp.asarray(boxes),
                                                jnp.asarray(scores))
    pal = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), md,
                     iou_threshold=iou_thr, score_threshold=0.05,
                     soft_nms_sigma=sigma, soft=True, interpret=True)
    for want_idx, want_sc, want_valid in ((ref.indices, ref.scores,
                                           ref.valid), pal):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want_sc),
                                   rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_launches_nothing_in_soft_mode():
    boxes, scores, md, thr = _case("ties")
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = kernel.launches, dict(kernel.launches_by)
    got = nms_lanes(b, s, md, 1.0, thr, 0.25, True)
    assert (kernel.launches, dict(kernel.launches_by)) == before
    _equal(got, batched_nms(b, s, md, 1.0, thr, 0.25, True))
