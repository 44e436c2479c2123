"""Plain PyTorch NMS (the CPU path of the NMS kernel's wrapper) against the
JAX package's XLA `nms_select` and its Pallas kernel in interpret mode, on
the cases of tests/test_pallas_nms.py. Indices and valid counts exact;
scores to rtol 1e-5, atol 1e-6 (exp and division may round differently)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.ops.nms import nms_select as jax_nms_select  # noqa: E402
from retinanet_tpu.ops.pallas.nms_kernel import pallas_nms  # noqa: E402
from retinanet_torch.ops import nms as torch_nms  # noqa: E402
from retinanet_torch.ops.nms_kernel import nms_lanes  # noqa: E402


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


def _check(got, want_idx, want_sc, want_valid):
    idx, sc, valid = (np.asarray(t) for t in got)
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    np.testing.assert_array_equal(idx, np.asarray(want_idx))
    np.testing.assert_allclose(sc, np.asarray(want_sc), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("soft,sigma", [(False, 0.0), (True, 0.25),
                                        (True, 0.0)])
def test_torch_nms_matches_jax(soft, sigma):
    rng = np.random.default_rng(0)
    boxes, scores = _lanes(rng, 11, 150)
    kw = dict(iou_threshold=1.0 if (soft and sigma > 0) else 0.5,
              score_threshold=0.1, soft_nms_sigma=sigma, soft=soft)
    got = nms_lanes(torch.from_numpy(boxes), torch.from_numpy(scores), 30,
                    **kw)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    ref = [jax_nms_select(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 30,
                          **kw) for i in range(boxes.shape[0])]
    _check(got, np.stack([r.indices for r in ref]),
           np.stack([r.scores for r in ref]), [int(r.valid) for r in ref])
    pal = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), 30,
                     interpret=True, **kw)
    _check(got, *pal)


def test_torch_nms_select_single_lane():
    rng = np.random.default_rng(1)
    boxes, scores = _lanes(rng, 1, 64)
    got = torch_nms.nms_select(torch.from_numpy(boxes[0]),
                               torch.from_numpy(scores[0]), 20,
                               iou_threshold=0.5, score_threshold=0.3)
    ref = jax_nms_select(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 20,
                         iou_threshold=0.5, score_threshold=0.3)
    _check(got, ref.indices, ref.scores, ref.valid)


def test_torch_nms_ragged_lanes_and_candidates():
    """Lane count not a multiple of the Pallas block, k not of 128."""
    rng = np.random.default_rng(2)
    boxes, scores = _lanes(rng, 3, 77)
    got = nms_lanes(torch.from_numpy(boxes), torch.from_numpy(scores), 10,
                    iou_threshold=0.5, score_threshold=0.2)
    assert tuple(got[0].shape) == (3, 10)
    pal = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), 10,
                     iou_threshold=0.5, score_threshold=0.2, interpret=True)
    _check(got, *pal)


def test_torch_nms_all_below_threshold():
    boxes = torch.zeros((2, 64, 4))
    scores = torch.full((2, 64), 0.01)
    idx, sc, valid = nms_lanes(boxes, scores, 5, score_threshold=0.5)
    pal = pallas_nms(jnp.zeros((2, 64, 4)), jnp.full((2, 64), 0.01), 5,
                     score_threshold=0.5, interpret=True)
    _check((idx, sc, valid), *pal)
    np.testing.assert_array_equal(valid.numpy(), [0, 0])
    np.testing.assert_array_equal(sc.numpy(), -1.0)
    np.testing.assert_array_equal(idx.numpy(), 0)


def test_nms_wrapper_checks_inputs():
    boxes = torch.zeros((2, 8, 4))
    scores = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        nms_lanes(boxes[..., :3], scores, 4)
    with pytest.raises(TypeError):
        nms_lanes(boxes.double(), scores, 4)
    with pytest.raises(ValueError):
        nms_lanes(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                  scores, 4)
    with pytest.raises(ValueError):
        nms_lanes(boxes, scores, 0)
