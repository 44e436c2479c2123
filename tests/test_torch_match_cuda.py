"""The CUDA matching kernel against its plain PyTorch version on the card.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_match_cuda.py`.
All four outputs bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.data.anchors import AnchorGenerator  # noqa: E402
from retinanet_torch.data.label_encoder import (  # noqa: E402
    make_batched_encoder)
from retinanet_torch.ops.match import match_lanes_plain  # noqa: E402
from retinanet_torch.ops.match_kernel import kernel, match_lanes  # noqa: E402

_CASES = [
    # image size, batch, boxes, valid: a count (prefix) or a probability
    (640, 8, 100, 7),       # the flagship encoder's usual load
    (640, 8, 100, 100),     # every box valid
    (640, 4, 100, 0),       # no box valid
    (640, 3, 100, 0.3),     # a mask that is no prefix
    (128, 5, 17, 14),       # anchors no multiple of the tile of 256
    (256, 2, 1, 1),         # a single box
    (256, 2, 2000, 0.5),    # more than 48 KB of shared memory
    (640, 3, 300, 300),     # two chunks of 256 boxes, every one valid
]


def _inputs(size, batch, num_gt, valid_spec, seed):
    rng = np.random.default_rng(seed)
    anchors = AnchorGenerator(
        size, size, 3, 7, [1024.0, 4096.0, 16384.0, 65536.0, 262144.0],
        [0.5, 1.0, 2.0], [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]).boxes
    gt = np.stack([rng.uniform(0.1 * size, 0.9 * size, (batch, num_gt)),
                   rng.uniform(0.1 * size, 0.9 * size, (batch, num_gt)),
                   rng.uniform(0.03 * size, 0.5 * size, (batch, num_gt)),
                   rng.uniform(0.03 * size, 0.5 * size, (batch, num_gt))],
                  -1).astype(np.float32)
    if num_gt >= 4:
        gt[:, num_gt // 2:] = gt[:, :num_gt - num_gt // 2]   # ties
    if isinstance(valid_spec, float):
        valid = rng.uniform(size=(batch, num_gt)) < valid_spec
    else:
        valid = np.zeros((batch, num_gt), bool)
        valid[:, :valid_spec] = True
    return anchors, gt, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=str)
def test_match_kernel_equals_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matching kernel has no CPU mode")
    anchors, gt, valid = _inputs(*case, seed=case[1] * case[2])
    args = [torch.from_numpy(x).cuda() for x in (anchors, gt, valid)]
    before = kernel.launches
    got = match_lanes(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = match_lanes_plain(*args)
    for name, g, w in zip(("max_iou", "argmax_gt", "gt_best_iou",
                           "gt_best_anchor"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=name)


@pytest.mark.cuda
def test_encoder_targets_through_kernel_equal_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matching kernel has no CPU mode")
    from retinanet_torch.core.config import ConfigDict
    gen = AnchorGenerator(
        256, 256, 3, 7, [1024.0, 4096.0, 16384.0, 65536.0, 262144.0],
        [0.5, 1.0, 2.0], [1.0, 2 ** (1 / 3), 2 ** (2 / 3)])
    _, gt, valid = _inputs(256, 4, 20, 9, seed=1)
    valid[2] = False
    classes = np.random.default_rng(2).integers(0, 80, valid.shape)
    enc = ConfigDict({"match_iou": 0.5, "ignore_iou": 0.4,
                      "box_variance": [0.1, 0.1, 0.2, 0.2],
                      "scale_box_targets": True})
    args = [torch.from_numpy(x).cuda() for x in (gt, classes, valid)]
    outs = [make_batched_encoder(gen, enc, use_iou_targets=True,
                                 device="cuda", matcher=m)(*args)
            for m in (match_lanes, match_lanes_plain)]
    for kind in ("class-targets", "box-targets", "iou-targets"):
        for level in outs[0][kind]:
            assert torch.equal(outs[0][kind][level], outs[1][kind][level])
    assert torch.equal(outs[0]["num-positives"], outs[1]["num-positives"])


@pytest.mark.cuda
def test_match_kernel_all_culled_image_and_scratch_left_clean():
    """Boxes that no tile keeps: every valid box gets (0, anchor 0) and every
    anchor (0, lowest valid index). Then the scratch must be zeros again,
    and a second call of another shape on it must be right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matching kernel has no CPU mode")
    from retinanet_torch.ops import match_kernel
    anchors, gt, valid = _inputs(640, 3, 10, 10, seed=4)
    gt[0, :, :2] += 9000.0           # image 0: every box far outside
    valid[0, 0] = False              # lowest valid index 1
    gt[1, 3, :2] -= 9000.0           # image 1: one such box among the others
    args = [torch.from_numpy(x).cuda() for x in (anchors, gt, valid)]
    got = match_lanes(*args)
    torch.cuda.synchronize()
    want = match_lanes_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0][0] == 0).all() and (got[1][0] == 1).all()
    assert got[2][0].tolist() == [-1.0] + [0.0] * 9
    assert (got[3][0] == 0).all()
    assert match_kernel._scratch
    for buf in match_kernel._scratch.values():
        assert not buf.any()
    args = [torch.from_numpy(x).cuda() for x in _inputs(128, 5, 17, 14, 2)]
    for g, w in zip(match_lanes(*args), match_lanes_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_match_kernel_on_two_streams_in_flight():
    """Each stream has scratch of its own: calls queued on two streams at
    once, several deep, all give the plain version's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matching kernel has no CPU mode")
    cases = [[torch.from_numpy(x).cuda() for x in
              _inputs(640, 8, 100, spec, seed=spec)] for spec in (100, 37)]
    want = [match_lanes_plain(*args) for args in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(6):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[i].append(match_lanes(*cases[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for outs in got[i]:
            for g, w in zip(outs, want[i]):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_match_is_one_kernel_launch():
    """The profiler sees one kernel on the card per call and no memset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matching kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    args = [torch.from_numpy(x).cuda() for x in _inputs(640, 8, 100, 7, 1)]
    match_lanes(*args)                       # build, and size the scratch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            match_lanes(*args)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 5, [e.name for e in on_card]
    assert all("match_kernel" in e.name for e in on_card)
