"""The port's batched label encoder against the JAX encoder (XLA matcher
lane), on the CPU with the plain matcher.

Class targets and num-positives equal; box and IoU targets to rtol 1e-5
(log and division round differently in the two frameworks)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data import label_encoder as jax_encoder  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import anchors as torch_anchors  # noqa: E402
from retinanet_torch.data import label_encoder as torch_encoder  # noqa: E402

SIZE = (128, 128)


def _tree(scale_box_targets=False, match_iou=0.5, ignore_iou=0.4):
    return {
        "experiment": {"name": "torch_port_encoder"},
        "input": {"input_shape": list(SIZE), "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 7, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "encoder_params": {"match_iou": match_iou, "ignore_iou": ignore_iou,
                           "scale_box_targets": scale_box_targets,
                           "max_boxes": 12},
    }


def _ground_truth(seed, batch=4, max_boxes=12):
    rng = np.random.default_rng(seed)
    h, w = SIZE
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    classes = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    for i, n in enumerate((5, 0, 12, 3)[:batch]):   # image 1 has no box
        boxes[i, :n] = np.stack([rng.uniform(0.1 * w, 0.9 * w, n),
                                 rng.uniform(0.1 * h, 0.9 * h, n),
                                 rng.uniform(0.05 * w, 0.6 * w, n),
                                 rng.uniform(0.05 * h, 0.6 * h, n)], -1)
        classes[i, :n] = rng.integers(0, 5, n)
        valid[i, :n] = True
    # two boxes that claim the same best anchor (a tiny box inside a cell
    # twice): the lowest index keeps it
    boxes[2, 7] = boxes[2, 6]
    classes[2, 6], classes[2, 7] = 1, 4
    return boxes, classes, valid


def _encode_both(tree, gt, use_iou_targets=False):
    boxes, classes, valid = gt
    jparams = jax_cfg.from_dict(tree)
    jfn = jax_encoder.make_batched_encoder(
        jax_anchors.from_params(jparams), jparams.encoder_params,
        use_iou_targets=use_iou_targets, use_pallas=False)
    jout = jfn(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    tparams = torch_cfg.from_dict(tree)
    tfn = torch_encoder.make_batched_encoder(
        torch_anchors.from_params(tparams), tparams.encoder_params,
        use_iou_targets=use_iou_targets, device="cpu")
    tout = tfn(torch.from_numpy(boxes), torch.from_numpy(classes),
               torch.from_numpy(valid))
    return jout, tout


def _assert_targets(jout, tout, kinds):
    for kind in kinds:
        assert sorted(jout[kind]) == sorted(tout[kind]) == list("34567")
        for level, ref in jout[kind].items():
            got = tout[kind][level].numpy()
            ref = np.asarray(ref)
            assert got.shape == ref.shape and got.dtype == ref.dtype, (
                kind, level)
            if kind == "class-targets":
                np.testing.assert_array_equal(got, ref, err_msg=f"P{level}")
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{kind} P{level}")
    np.testing.assert_array_equal(tout["num-positives"].numpy(),
                                  np.asarray(jout["num-positives"]))


@pytest.mark.parametrize("scale_box_targets", [False, True])
def test_encoder_matches_jax(scale_box_targets):
    jout, tout = _encode_both(_tree(scale_box_targets), _ground_truth(0))
    _assert_targets(jout, tout, ("class-targets", "box-targets"))
    assert "iou-targets" not in tout
    # every kind of anchor occurs: positive, background and ignored
    flat = np.concatenate([v.numpy().ravel()
                           for v in tout["class-targets"].values()])
    assert (flat >= 0).any() and (flat == -1).any() and (flat == -2).any()
    # NHWC pyramid shapes in the (h, w, anchor) order of the anchors
    assert tuple(tout["class-targets"]["3"].shape) == (4, 16, 16, 9)
    assert tuple(tout["box-targets"]["7"].shape) == (4, 1, 1, 36)


def test_empty_image_is_all_background():
    jout, tout = _encode_both(_tree(), _ground_truth(1))
    assert float(tout["num-positives"][1]) == 0.0
    for level in tout["class-targets"]:
        assert (tout["class-targets"][level][1] == -1.0).all()
        assert (tout["box-targets"][level][1] == 0.0).all()
    _assert_targets(jout, tout, ("class-targets", "box-targets"))


def test_iou_targets_match_jax():
    jout, tout = _encode_both(_tree(), _ground_truth(2),
                              use_iou_targets=True)
    _assert_targets(jout, tout,
                    ("class-targets", "box-targets", "iou-targets"))


def test_force_match_and_thresholds_match_jax():
    """match_iou 0.7 leaves many boxes without an anchor above the
    threshold, so their labels come from the force-match alone."""
    gt = _ground_truth(3)
    jout, tout = _encode_both(_tree(match_iou=0.7, ignore_iou=0.3), gt)
    _assert_targets(jout, tout, ("class-targets", "box-targets"))

    boxes, classes, valid = (torch.from_numpy(x) for x in gt)
    tparams = torch_cfg.from_dict(_tree())
    anchors = torch.from_numpy(torch_anchors.from_params(tparams).boxes)
    matches, max_ious = torch_encoder.match_anchors(anchors, boxes, valid,
                                                    0.7, 0.3)
    jparams = jax_cfg.from_dict(_tree())
    janchors = jnp.asarray(jax_anchors.from_params(jparams).boxes)
    for i in range(boxes.shape[0]):
        jm, jiou = jax_encoder.match_anchors(
            janchors, jnp.asarray(gt[0][i]), jnp.asarray(gt[2][i]), 0.7, 0.3,
            use_pallas=False)
        np.testing.assert_array_equal(matches[i].numpy(), np.asarray(jm))
        np.testing.assert_allclose(max_ious[i].numpy(), np.asarray(jiou),
                                   rtol=1e-6, atol=1e-7)
    assert matches.dtype == torch.int32
    # the duplicated box: both claim one anchor, the lower index has it
    assert (matches[2] == 6).any() and not (matches[2] == 7).any()
