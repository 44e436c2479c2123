"""The plain matcher of the port against both matching lanes of the JAX
package, on the CPU: the XLA lane (`compute_iou` + max / argmax) and the
Pallas kernel in interpret mode.

The cases are those of tests/test_pallas_matching.py plus boxes that tie
and a validity mask that is no prefix. `max_iou` to rtol 1e-6 / atol 1e-7
(the two frameworks may contract a multiply-add differently); indices
equal. Against the XLA lane all four outputs are compared everywhere;
against the Pallas kernel only where its caller reads them (it differs, on
purpose unread, where no box is valid and in rows it did not sweep)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.data import box_utils as jax_box_utils  # noqa: E402
from retinanet_tpu.data.anchors import AnchorGenerator  # noqa: E402
from retinanet_tpu.ops.pallas.matching_kernel import pallas_match  # noqa: E402
from retinanet_torch.data import box_utils  # noqa: E402
from retinanet_torch.ops.match import match_lanes_plain  # noqa: E402
from retinanet_torch.ops.match_kernel import kernel, match_lanes  # noqa: E402


@pytest.fixture(scope="module")
def anchors():
    return AnchorGenerator(
        64, 64, 3, 5, [1024.0, 4096.0, 16384.0], [0.5, 1.0, 2.0],
        [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]).boxes


def _boxes(rng, n):
    return np.stack([rng.uniform(8, 56, n), rng.uniform(8, 56, n),
                     rng.uniform(4, 40, n), rng.uniform(4, 40, n)],
                    -1).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(1)
    if name == "ties":
        gt = _boxes(rng, 20)
        gt[10:] = gt[:10]                  # every box twice: ties over boxes
        gt[3] = (32.0, 32.0, 16.0, 16.0)   # on a cell corner: ties over anchors
        gt[13] = gt[3]
        return gt, np.ones(20, bool)
    if name == "no_prefix":
        gt = _boxes(rng, 24)
        valid = np.zeros(24, bool)
        valid[[2, 3, 7, 11, 19, 23]] = True
        return gt, valid
    num_gt, num_valid = name
    valid = np.zeros(num_gt, bool)
    valid[:num_valid] = True
    return _boxes(rng, num_gt), valid


CASES = [(17, 14), (100, 7), (100, 0), (100, 100), "ties", "no_prefix"]


def _plain(anchors, gt, valid):
    out = match_lanes_plain(torch.from_numpy(anchors),
                            torch.from_numpy(gt)[None],
                            torch.from_numpy(valid)[None])
    assert [o.dtype for o in out] == [torch.float32, torch.int32,
                                      torch.float32, torch.int32]
    return [o[0].numpy() for o in out]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_xla_lane(anchors, case):
    gt, valid = _case(case)
    iou = jax_box_utils.compute_iou(jnp.asarray(gt), jnp.asarray(anchors),
                                    pairwise=True)
    iou = jnp.where(jnp.asarray(valid)[:, None], iou, -1.0)
    max_iou, arg, gt_iou, gt_arg = _plain(anchors, gt, valid)
    np.testing.assert_allclose(max_iou, np.asarray(jnp.max(iou, axis=0)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(arg, np.asarray(jnp.argmax(iou, axis=0)))
    np.testing.assert_allclose(gt_iou, np.asarray(jnp.max(iou, axis=1)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gt_arg,
                                  np.asarray(jnp.argmax(iou, axis=1)))
    if not valid.any():
        assert (max_iou == -1.0).all() and (arg == 0).all()
    assert (gt_iou[~valid] == -1.0).all() and (gt_arg[~valid] == 0).all()


@pytest.mark.parametrize("case", CASES[:5], ids=str)
def test_plain_matches_pallas_interpret(anchors, case):
    """`pallas_match` assumes the valid boxes are a prefix, so the mask
    that is none stays with the XLA lane above."""
    gt, valid = _case(case)
    p_max, p_arg, p_gt_iou, p_gt_arg = pallas_match(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
        interpret=True)
    max_iou, arg, gt_iou, gt_arg = _plain(anchors, gt, valid)
    np.testing.assert_allclose(max_iou, np.asarray(p_max), rtol=1e-6,
                               atol=1e-7)
    if valid.any():
        np.testing.assert_array_equal(arg, np.asarray(p_arg))
        np.testing.assert_array_equal(gt_arg[valid],
                                      np.asarray(p_gt_arg)[valid])
        np.testing.assert_allclose(gt_iou[valid],
                                   np.asarray(p_gt_iou)[valid], rtol=1e-6,
                                   atol=1e-7)


def test_batched_equals_per_image(anchors):
    rng = np.random.default_rng(3)
    gt = np.stack([_boxes(rng, 12) for _ in range(3)])
    valid = rng.uniform(size=(3, 12)) < 0.5
    valid[1] = False
    batched = match_lanes_plain(torch.from_numpy(anchors),
                                torch.from_numpy(gt),
                                torch.from_numpy(valid))
    for i in range(3):
        single = _plain(anchors, gt[i], valid[i])
        for b, s in zip(batched, single):
            np.testing.assert_array_equal(b[i].numpy(), s)


def test_compute_iou_and_box_conversions_match_jax():
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    np.testing.assert_allclose(
        box_utils.compute_iou(torch.from_numpy(a), torch.from_numpy(b)),
        np.asarray(jax_box_utils.compute_iou(jnp.asarray(a),
                                             jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        box_utils.compute_iou(torch.from_numpy(a[:7]), torch.from_numpy(b),
                              pairwise=False),
        np.asarray(jax_box_utils.compute_iou(
            jnp.asarray(a[:7]), jnp.asarray(b), pairwise=False)),
        rtol=1e-6, atol=1e-7)
    for name in ("swap_xy", "convert_to_xywh", "convert_to_corners"):
        np.testing.assert_array_equal(
            getattr(box_utils, name)(torch.from_numpy(a)).numpy(),
            np.asarray(getattr(jax_box_utils, name)(jnp.asarray(a))))


def test_wrapper_on_cpu_takes_the_plain_version_and_validates(anchors):
    gt, valid = _case((17, 14))
    args = (torch.from_numpy(anchors), torch.from_numpy(gt)[None],
            torch.from_numpy(valid)[None])
    before = kernel.launches
    for got, want in zip(match_lanes(*args), match_lanes_plain(*args)):
        assert torch.equal(got, want)
    assert kernel.launches == before       # no kernel launch on the CPU
    with pytest.raises(ValueError, match=r"\(B, G, 4\)"):
        match_lanes(args[0], args[1][0], args[2])
    with pytest.raises(TypeError, match="bool"):
        match_lanes(args[0], args[1], args[2].to(torch.int32))
    with pytest.raises(TypeError, match="float32"):
        match_lanes(args[0].double(), args[1], args[2])
    with pytest.raises(ValueError, match="contiguous"):
        match_lanes(args[0][::2], args[1], args[2])
