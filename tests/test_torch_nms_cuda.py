"""The CUDA NMS kernel against its plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py`.
Indices and valid counts exact; scores to rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.ops.nms import batched_nms  # noqa: E402
from retinanet_torch.ops.nms_kernel import kernel, nms_lanes  # noqa: E402

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
    before = kernel.launches
    idx, sc, valid = nms_lanes(b, s, md, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
