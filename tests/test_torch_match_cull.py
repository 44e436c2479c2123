"""The matching kernel's tile test (`ops/match.py:tile_cull_mask`, the
predicate of `csrc/match.cu` in plain PyTorch) on the CPU.

Two claims, both exact: a (tile, box) pair that the test drops has IoU 0 with
every anchor of the tile; and the four outputs of `match_lanes_plain`,
recomputed from the kept pairs alone the way the kernel does it (an anchor's
best starts at (0, lowest valid index), a box with no IoU above 0 gets
(0, anchor 0)), are bit-equal to the originals."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from retinanet_torch.data.anchors import AnchorGenerator  # noqa: E402
from retinanet_torch.data.box_utils import compute_iou  # noqa: E402
from retinanet_torch.ops.match import (  # noqa: E402
    match_lanes_plain, tile_cull_mask)
from retinanet_torch.ops.match_kernel import TILE, kernel  # noqa: E402
from retinanet_torch.tools import match_experiments  # noqa: E402
from retinanet_torch.tools.kernel_variants import variant_source  # noqa: E402


def _anchors(size, min_level=3, max_level=7):
    return torch.from_numpy(AnchorGenerator(
        size, size, min_level, max_level,
        [1024.0, 4096.0, 16384.0, 65536.0, 262144.0][:max_level - min_level + 1],
        [0.5, 1.0, 2.0], [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]).boxes)


def _boxes(rng, size, batch, num_gt):
    return np.stack([rng.uniform(0.1 * size, 0.9 * size, (batch, num_gt)),
                     rng.uniform(0.1 * size, 0.9 * size, (batch, num_gt)),
                     rng.uniform(0.03 * size, 0.5 * size, (batch, num_gt)),
                     rng.uniform(0.03 * size, 0.5 * size, (batch, num_gt))],
                    -1).astype(np.float32)


def _case(name):
    """(anchors (A, 4), gt_boxes (B, G, 4), gt_valid (B, G))."""
    rng = np.random.default_rng(11)
    if name == "flagship":
        anchors = _anchors(640)
        assert anchors.shape[0] == 76725
        gt = _boxes(rng, 640, 2, 24)
        valid = rng.uniform(size=(2, 24)) < 0.6          # no prefix
        gt[0, 12:] = gt[0, :12]                          # ties over boxes
        gt[1, 0] = (64.0, 64.0, 32.0, 32.0)              # ties over anchors
        gt[1, 1] = (-5000.0, -5000.0, 10.0, 10.0)        # dropped everywhere
        valid[1, :2] = True
        return anchors, gt, valid
    anchors = _anchors(128)
    if name == "ragged":
        anchors = anchors[100:100 + TILE + 77].contiguous()
        gt = _boxes(rng, 128, 3, 17)
        valid = np.zeros((3, 17), bool)
        valid[:, :14] = True
        valid[2] = False                                 # no valid box
        return anchors, gt, valid
    if name == "shuffled_anchors":
        anchors = anchors[torch.from_numpy(rng.permutation(len(anchors)))]
        return anchors, _boxes(rng, 128, 2, 9), np.ones((2, 9), bool)
    if name == "all_outside":
        gt = _boxes(rng, 128, 2, 6)
        gt[..., :2] += 4000.0
        return anchors, gt, np.ones((2, 6), bool)
    if name == "single_box":
        return anchors, _boxes(rng, 128, 2, 1), np.ones((2, 1), bool)
    if name == "degenerate":
        gt = _boxes(rng, 128, 1, 12)
        gt[0, 0, 2:] = 0.0                               # a point
        gt[0, 1, 2] = 0.0                                # a vertical line
        gt[0, 2, 2:] = (-20.0, 30.0)                     # negative width
        gt[0, 3] = (64.0, 64.0, 1e4, 1e4)                # covers everything
        gt[0, 4] = (0.0, 0.0, 16.0, 16.0)                # on the corner
        gt[0, 5] = (-8.0, 64.0, 16.0, 16.0)              # touches the edge
        gt[0, 6] = (1e30, 1e30, 1e30, 1e30)
        return anchors, gt, np.ones((1, 12), bool)
    raise ValueError(name)


CASES = ["flagship", "ragged", "shuffled_anchors", "all_outside",
         "single_box", "degenerate"]


def _tiles_of(num_anchors):
    return torch.arange(num_anchors) // TILE


@pytest.mark.parametrize("name", CASES)
def test_dropped_pairs_have_zero_iou(name):
    anchors, gt, _ = _case(name)
    gt = torch.from_numpy(gt)
    keep = tile_cull_mask(anchors, gt, TILE)             # (B, T, G)
    assert keep.dtype == torch.bool
    assert tuple(keep.shape) == (gt.shape[0], -(-anchors.shape[0] // TILE),
                                 gt.shape[1])
    iou = compute_iou(gt, anchors, pairwise=True)        # (B, G, A)
    kept_pair = keep[:, _tiles_of(anchors.shape[0])].transpose(1, 2)
    assert (iou[~kept_pair] == 0.0).all()
    # and the test does drop: no tile of these anchors spans the image
    if name in ("flagship", "ragged", "all_outside"):
        assert (~keep).any()
    if name == "all_outside":
        assert not keep.any()


def test_nan_corners_keep_the_box():
    anchors = _anchors(128)
    gt = torch.from_numpy(_boxes(np.random.default_rng(3), 128, 1, 4))
    gt[0, 0, 2] = float("nan")           # both x corners NaN
    gt[0, 0, 3] = float("nan")           # and both y corners
    gt[0, 1, 0] = float("nan")           # x corners only
    keep = tile_cull_mask(anchors, gt, TILE)
    assert keep[0, :, 0].all()
    iou = compute_iou(gt, anchors, pairwise=True)
    kept_pair = keep[:, _tiles_of(anchors.shape[0])].transpose(1, 2)
    assert not (iou[~kept_pair] > 0.0).any()


def _match_from_kept(anchors, gt_boxes, gt_valid, keep):
    """The four outputs from the kept (tile, box) pairs only, as the kernel
    forms them."""
    iou = compute_iou(gt_boxes, anchors, pairwise=True)          # (B, G, A)
    kept_pair = (keep[:, _tiles_of(anchors.shape[0])].transpose(1, 2)
                 & gt_valid[..., None])
    any_valid = gt_valid.any(dim=1, keepdim=True)                # (B, 1)
    first_valid = torch.argmax(gt_valid.to(torch.int32), dim=1,
                               keepdim=True)
    # per anchor: only a strictly larger IoU replaces (0, first valid)
    top, arg = torch.where(kept_pair, iou, -1.0).max(dim=1)      # (B, A)
    raised = top > 0.0
    max_iou = torch.where(raised, top, 0.0)
    argmax_gt = torch.where(raised, arg, first_valid)
    max_iou = torch.where(any_valid, max_iou, -1.0)
    argmax_gt = torch.where(any_valid, argmax_gt, 0)
    # per box: the best posted IoU above 0, else (0, anchor 0)
    gt_best_iou, gt_best_anchor = torch.where(kept_pair, iou, 0.0).max(dim=2)
    gt_best_iou = torch.where(gt_valid, gt_best_iou, -1.0)
    gt_best_anchor = torch.where(gt_valid, gt_best_anchor, 0)
    return (max_iou, argmax_gt.to(torch.int32), gt_best_iou,
            gt_best_anchor.to(torch.int32))


@pytest.mark.parametrize("name", CASES)
def test_outputs_from_kept_pairs_are_bit_equal(name):
    anchors, gt, valid = _case(name)
    gt, valid = torch.from_numpy(gt), torch.from_numpy(valid)
    keep = tile_cull_mask(anchors, gt, TILE)
    got = _match_from_kept(anchors, gt, valid, keep)
    want = match_lanes_plain(anchors, gt, valid)
    for label, g, w in zip(("max_iou", "argmax_gt", "gt_best_iou",
                            "gt_best_anchor"), got, want):
        assert g.dtype == w.dtype, label
        assert torch.equal(g, w), label


def test_kept_share_falls_with_the_tile():
    """A smaller tile has a tighter bounding box: it keeps no more pairs."""
    anchors, gt, _ = _case("flagship")
    gt = torch.from_numpy(gt)
    shares = [tile_cull_mask(anchors, gt, t).float().mean().item()
              for t in (4 * TILE, TILE, TILE // 4)]
    assert shares[0] >= shares[1] >= shares[2]
    assert shares[1] < 0.6


@pytest.mark.parametrize("name", sorted(match_experiments.VARIANTS))
def test_experiment_variants_apply_to_the_source(name):
    """Each variant of tools/match_experiments.py is an edit of
    csrc/match.cu: it must still find its text, once, and change it."""
    edits = match_experiments.VARIANTS[name]
    assert variant_source(kernel, name, edits) != kernel.source.read_text()


def test_tile_constant_is_the_kernels():
    source = kernel.source.read_text()
    assert "constexpr int kThreads = 128;" in source
    assert "constexpr int kPerThread = 3; " in source
    assert TILE == 128 * 3
