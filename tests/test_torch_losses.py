"""The port's losses against the JAX losses (values and gradients with
respect to the predictions, rtol 1e-5 in float32) and against the goldens
of the reference implementation, tests/goldens/loss_goldens.npz."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.losses import losses as jax_losses  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.losses import losses as torch_losses  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "loss_goldens.npz")
NUM_CLASSES = 8
LEVELS = {"3": (8, 8), "4": (4, 4), "5": (2, 2)}


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _tree(label_smoothing=0.0, moving_average=False):
    return {
        "experiment": {"name": "t"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 50},
            "feature_fusion": {"type": "fpn", "min_level": 3, "max_level": 5,
                               "filters": 64, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 64,
                     "num_classes": NUM_CLASSES, "num_anchors": 9},
        },
        "loss": {"focal_loss": {"alpha": 0.25, "gamma": 1.5,
                                "label_smoothing": label_smoothing},
                 "normalizer": {"use_moving_average": moving_average,
                                "momentum": 0.9},
                 "auxillary_loss_weight": 0.5},
    }


def _data(seed, batch=2, with_iou=False):
    rng = np.random.default_rng(seed)
    targets = {"class-targets": {}, "box-targets": {}}
    preds = {"class-predictions": {}, "box-predictions": {}}
    if with_iou:
        targets["iou-targets"], preds["iou-predictions"] = {}, {}
    for level, (h, w) in LEVELS.items():
        cls = rng.choice(np.arange(-2, NUM_CLASSES), (batch, h, w, 9),
                         p=[0.1, 0.6] + [0.3 / NUM_CLASSES] * NUM_CLASSES)
        box = rng.normal(0, 1, (batch, h, w, 36)) * np.repeat(cls >= 0, 4, -1)
        targets["class-targets"][level] = cls.astype(np.float32)
        targets["box-targets"][level] = box.astype(np.float32)
        preds["class-predictions"][level] = rng.normal(
            -2, 2, (batch, h, w, 9 * NUM_CLASSES)).astype(np.float32)
        preds["box-predictions"][level] = rng.normal(
            0, 1, (batch, h, w, 36)).astype(np.float32)
        if with_iou:
            targets["iou-targets"][level] = np.where(
                cls >= 0, rng.uniform(0.5, 1, cls.shape), -1.0
            ).astype(np.float32)
            preds["iou-predictions"][level] = rng.uniform(
                0, 1, cls.shape).astype(np.float32)
    targets["num-positives"] = np.asarray(
        [sum(float((targets["class-targets"][lv][b] >= 0).sum())
             for lv in LEVELS) for b in range(batch)], np.float32)
    return targets, preds


def _to_torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _to_torch(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_focal_matches_reference_goldens(goldens):
    loss = torch_losses.sigmoid_focal_loss(
        torch.from_numpy(goldens["logits"]), torch.from_numpy(goldens["y"]),
        alpha=0.25, gamma=1.5, label_smoothing=0.0)
    total = float((loss * torch.from_numpy(goldens["w"])).sum())
    np.testing.assert_allclose(total, float(goldens["focal_sum"]), rtol=1e-5)


def test_huber_matches_reference_goldens(goldens):
    bt = torch.from_numpy(goldens["bt"])[..., 0]
    bp = torch.from_numpy(goldens["bp"])[..., 0]
    mask = (bt != 0.0).to(torch.float32)
    total = float((torch_losses.huber_loss(bt, bp, delta=0.1) * mask).sum())
    np.testing.assert_allclose(total, float(goldens["huber_sum"]), rtol=1e-5)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_elementwise_losses_match_jax(label_smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (64, NUM_CLASSES)).astype(np.float32)
    y = np.eye(NUM_CLASSES, dtype=np.float32)[rng.integers(0, 8, 64)]
    np.testing.assert_allclose(
        torch_losses.sigmoid_focal_loss(
            torch.from_numpy(logits), torch.from_numpy(y), 0.25, 1.5,
            label_smoothing).numpy(),
        np.asarray(jax_losses.sigmoid_focal_loss(
            jnp.asarray(logits), jnp.asarray(y), 0.25, 1.5,
            label_smoothing)), rtol=1e-5, atol=1e-7)
    a, b = rng.normal(0, 1, (2, 200)).astype(np.float32)
    np.testing.assert_allclose(
        torch_losses.huber_loss(torch.from_numpy(a), torch.from_numpy(b),
                                0.1).numpy(),
        np.asarray(jax_losses.huber_loss(jnp.asarray(a), jnp.asarray(b),
                                         0.1)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("label_smoothing,with_iou",
                         [(0.0, False), (0.1, False), (0.0, True)])
def test_retinanet_loss_values_and_gradients_match_jax(label_smoothing,
                                                       with_iou):
    tree = _tree(label_smoothing)
    jloss = jax_losses.RetinaNetLoss(NUM_CLASSES, jax_cfg.from_dict(tree).loss)
    tloss = torch_losses.RetinaNetLoss(NUM_CLASSES,
                                       torch_cfg.from_dict(tree).loss)
    targets, preds = _data(1, with_iou=with_iou)

    def jtotal(p):
        losses, _ = jloss(_to_jax(targets), p)
        return losses["weighted-loss"], losses

    (_, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        _to_jax(preds))
    tpreds = _to_torch(preds, grad=True)
    tlosses, ema = tloss(_to_torch(targets), tpreds)
    assert ema is None
    tlosses["weighted-loss"].backward()

    assert sorted(tlosses) == sorted(jlosses)
    for key, ref in jlosses.items():
        np.testing.assert_allclose(float(tlosses[key].detach()), float(ref),
                                   rtol=1e-5, err_msg=key)
    for kind, levels in jgrads.items():
        for level, ref in levels.items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                tpreds[kind][level].grad.numpy(), ref, rtol=1e-5,
                atol=1e-5 * float(np.abs(ref).max()),
                err_msg=f"{kind} P{level}")


def test_moving_average_normalizer_matches_jax():
    tree = _tree(moving_average=True)
    jloss = jax_losses.RetinaNetLoss(NUM_CLASSES, jax_cfg.from_dict(tree).loss)
    tloss = torch_losses.RetinaNetLoss(NUM_CLASSES,
                                       torch_cfg.from_dict(tree).loss)
    jema, tema = jnp.float32(0.0), torch.zeros(())
    for seed in (2, 3, 4):   # the state threads through three calls
        targets, preds = _data(seed)
        jlosses, jema = jloss(_to_jax(targets), _to_jax(preds), jema)
        tlosses, tema = tloss(_to_torch(targets), _to_torch(preds), tema)
        np.testing.assert_allclose(float(tema), float(jema), rtol=1e-6)
        for key, ref in jlosses.items():
            np.testing.assert_allclose(float(tlosses[key].detach()), float(ref),
                                       rtol=1e-5, err_msg=key)
        assert float(tlosses["num-anchors-matched"]) == float(tema)
    with pytest.raises(ValueError, match="normalizer_ema"):
        tloss(_to_torch(targets), _to_torch(preds))


def test_class_loss_in_bfloat16_predictions_is_computed_in_float32():
    targets, preds = _data(5)
    t = _to_torch(targets)
    p16 = {k: v.to(torch.bfloat16)
           for k, v in _to_torch(preds)["class-predictions"].items()}
    got = torch_losses.class_loss(t["class-targets"], p16, NUM_CLASSES, 0.25,
                                  1.5, 0.0)
    want = torch_losses.class_loss(
        t["class-targets"], {k: v.float() for k, v in p16.items()},
        NUM_CLASSES, 0.25, 1.5, 0.0)
    assert got.dtype == torch.float32 and float(got) == float(want)
