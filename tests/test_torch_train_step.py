"""The training slice of the port as a whole against the JAX train step, on
the CPU.

Seeded numpy weights (BN statistics and gammas too, so no residual branch
is zero) go into the flax model and, through `retinanet_torch.convert`, into
the port's; the same seeded batch goes through `make_train_step` of both
packages in lockstep. float32 bounds: every loss rtol 1e-4, `gradient-norm`
rtol 1e-3, and after 3 steps every parameter and running statistic within
1e-4 of its leaf's largest magnitude (the two convolutions and reductions
sum in different orders). mixed_bfloat16 bound, one step: 3e-2 of the loss
(the two packages round activations to bf16 at slightly different points).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data import label_encoder as jax_encoder  # noqa: E402
from retinanet_tpu.data import preprocessing as jax_pre  # noqa: E402
from retinanet_tpu.data.synthetic import (  # noqa: E402
    synthetic_train_batch as jax_batch)
from retinanet_tpu.losses.losses import (  # noqa: E402
    RetinaNetLoss as JaxLoss)
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_tpu.optimizers import builder as jax_opt  # noqa: E402
from retinanet_tpu.train import step as jax_step  # noqa: E402
from retinanet_tpu.train.train_state import (  # noqa: E402
    create_train_state as jax_state)
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax, velocity_to_flax)
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data.synthetic import synthetic_train_batch  # noqa: E402
from retinanet_torch.train import step as torch_step  # noqa: E402
from retinanet_torch.train.trainer import build_trainer  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


SIZE = (64, 64)
LOSS_KEYS = ("box-loss", "class-loss", "weighted-loss", "l2-regularization",
             "total-loss", "num-anchors-matched", "iou-prediction-loss",
             "learning-rate")


def _tree(precision="float32", freeze=(), accum=1, remat=False):
    return {
        "experiment": {"name": "torch_port_train"},
        "input": {"input_shape": list(SIZE), "channels": 3},
        "floatx": {"precision": precision},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10, "remat": remat},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5,
                               "use_balanced_features": True},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "training": {
            "train_steps": 100,
            "batch_size": {"train": 4},
            "freeze_variables": list(freeze),
            "grad_accum_steps": accum,
            "use_weight_decay": True,
            "weight_decay_alpha": 1e-4,
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "nesterov": False,
                "clipnorm": 10.0,
                "lr_params": {
                    "schedule_type": "piecewise_constant_decay",
                    "warmup_learning_rate": 0.002, "warmup_steps": 2,
                    "values": [0.02, 0.002], "boundaries": [50]}},
        },
    }


def _random_variables(variables, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(draw(path, leaf), np.float32),
        variables)


def _build_pair(tree, seed=0):
    """(jax state, jitted jax step), (torch state, torch step) on the same
    weights."""
    jparams = jax_cfg.from_dict(tree)
    jmodel = jax_retinanet.build_model(jparams)
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SIZE + (3,), jnp.float32),
                            train=False))
    variables = _random_variables(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, seed)
    t = jparams.training
    freeze = list(t.freeze_variables)
    tx, schedule = jax_opt.build_optimizer(
        t.optimizer, t.train_steps, freeze_variables=freeze)
    jstep = jax.jit(jax_step.make_train_step(
        jmodel, JaxLoss(5, jparams.loss),
        jax_encoder.make_batched_encoder(
            jax_anchors.from_params(jparams), jparams.encoder_params,
            use_pallas=False),
        jax_pre.make_device_normalizer(jparams), tx, schedule,
        use_weight_decay=True, weight_decay_alpha=1e-4,
        compute_dtype=jax_retinanet._compute_dtype(
            jparams.floatx.precision),
        grad_accum_steps=int(t.grad_accum_steps),
        clipnorm=t.optimizer.clipnorm, freeze_keys=freeze))
    jstate = jax_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)

    tstate, tstep = build_trainer(torch_cfg.from_dict(tree), device="cpu")
    load_flax_variables(tstate.model, variables)
    return (jstate, jstep), (tstate, tstep)


def _batch(seed=0, n=4):
    batch = synthetic_train_batch(n, SIZE, 20, 5, seed=seed)
    ref = jax_batch(n, SIZE, 20, 5, seed=seed)
    for key in batch:  # the port's copy draws the same batch
        np.testing.assert_array_equal(batch[key], ref[key])
    return batch


def _assert_metrics(jm, tm, rtol, keys=LOSS_KEYS, grad_rtol=1e-3):
    assert sorted(jm) == sorted(tm)
    for key in keys:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(tm["gradient-norm"]),
                               float(jm["gradient-norm"]), rtol=grad_rtol,
                               err_msg="gradient-norm")


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(jtree, ttree, bound=1e-4, atol=0.0):
    jflat, tflat = _flat(jtree), _flat(ttree)
    assert sorted(jflat) == sorted(tflat)
    for name, ref in jflat.items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        diff = float(np.abs(tflat[name] - ref).max())
        assert diff <= bound * scale + atol, (name, diff, scale)


def test_three_lockstep_steps_f32():
    (jstate, jstep), (tstate, tstep) = _build_pair(_tree())
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    for i in range(3):
        batch = _batch(seed=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        _assert_metrics(jm, tm, rtol=1e-4)
    assert tstate.step == 3 and int(jstate.step) == 3
    assert tstate.optimizer.count == 3
    after = torch_to_flax(tstate.model.state_dict())
    _assert_trees_close(jstate.params, after["params"])
    _assert_trees_close(jstate.batch_stats, after["batch_stats"])
    # the momentum buffers too, in the flax tree's order; a conv bias in
    # front of a BatchNorm has a gradient of exactly 0 in theory and of
    # rounding noise (1e-9) in both packages, hence the absolute term
    _assert_trees_close(jstate.opt_state[1].velocity,   # (clip, keras_sgd)
                        velocity_to_flax(tstate.optimizer, tstate.model),
                        bound=1e-3, atol=1e-7)
    # the weights and statistics moved (a conv bias in front of a BatchNorm
    # and a box-head level without a positive anchor have no gradient)
    still = [k for k, v in tstate.model.state_dict().items()
             if torch.equal(v, before[k])]
    assert not any(k.startswith("backbone.") for k in still), still
    assert len(still) <= 0.15 * len(before), still


def test_one_step_mixed_bfloat16():
    (jstate, jstep), (tstate, tstep) = _build_pair(
        _tree(precision="mixed_bfloat16"), seed=1)
    batch = _batch(seed=3)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tstep(tstate, batch)
    for key in ("box-loss", "class-loss", "total-loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=3e-2, err_msg=key)
    np.testing.assert_allclose(float(tm["gradient-norm"]),
                               float(jm["gradient-norm"]), rtol=1e-1)
    assert float(tm["num-anchors-matched"]) == float(
        jm["num-anchors-matched"])


def test_gradient_accumulation_two_micro_batches():
    (jstate, jstep), (tstate, tstep) = _build_pair(_tree(accum=2), seed=2)
    batch = _batch(seed=5)
    folded = torch_step.fold_micro_batches(batch, 2)
    assert folded["image"].shape == (2, 2) + SIZE + (3,)
    jstate, jm = jstep(jstate, {
        k: jnp.asarray(v)
        for k, v in jax_step.fold_micro_batches(batch, 2).items()})
    tstate, tm = tstep(tstate, folded)
    _assert_metrics(jm, tm, rtol=1e-4)
    after = torch_to_flax(tstate.model.state_dict())
    _assert_trees_close(jstate.params, after["params"])
    _assert_trees_close(jstate.batch_stats, after["batch_stats"])
    assert tstate.step == 1 and tstate.optimizer.count == 1
    with pytest.raises(ValueError, match="grad_accum_steps=2"):
        tstep(tstate, torch_step.fold_micro_batches(batch, 4))


def test_frozen_backbone_one_step():
    (jstate, jstep), (tstate, tstep) = _build_pair(
        _tree(freeze=("backbone",)), seed=3)
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    batch = _batch(seed=7)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tstep(tstate, batch)
    _assert_metrics(jm, tm, rtol=1e-4)
    state = tstate.model.state_dict()
    after = torch_to_flax(state)
    _assert_trees_close(jstate.params, after["params"])
    _assert_trees_close(jstate.batch_stats, after["batch_stats"])
    for name, value in state.items():
        if name.startswith("backbone."):   # weights and statistics stay
            assert torch.equal(value, before[name]), name
    moved = [k for k, v in state.items() if not torch.equal(v, before[k])]
    assert len(moved) >= 0.7 * sum(not k.startswith("backbone.")
                                   for k in state), moved


def test_remat_gives_the_same_step():
    """Checkpointed blocks: the same losses, gradients and running
    statistics (moved once, not twice) as without."""
    results = []
    for remat in (False, True):
        state, step = build_trainer(torch_cfg.from_dict(_tree(remat=remat)),
                                    device="cpu", seed=4)
        state, metrics = step(state, _batch(seed=9))
        results.append((state.model.state_dict(), metrics))
    (plain, pm), (ckpt, cm) = results
    for key in ("total-loss", "gradient-norm"):
        np.testing.assert_allclose(float(cm[key]), float(pm[key]), rtol=1e-6)
    for name in plain:
        torch.testing.assert_close(ckpt[name], plain[name], rtol=1e-5,
                                   atol=1e-7, msg=name)


def test_multi_step_and_eval_forward():
    state, step = build_trainer(torch_cfg.from_dict(_tree()), device="cpu",
                                seed=5)
    batches = [_batch(seed=s) for s in (11, 12)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, last = torch_step.make_multi_step(step)(state, stacked)
    assert state.step == 2
    ref_state, ref_step = build_trainer(torch_cfg.from_dict(_tree()),
                                        device="cpu", seed=5)
    for b in batches:
        ref_state, ref = ref_step(ref_state, b)
    assert float(last["total-loss"]) == float(ref["total-loss"])

    forward = torch_step.make_eval_forward(state.model, torch.float32)
    stats = state.model.backbone.stem_bn.bn.running_mean.clone()
    out = forward(torch.from_numpy(batches[0]["image"]))
    assert state.model.training                     # mode put back
    assert torch.equal(stats, state.model.backbone.stem_bn.bn.running_mean)
    assert sorted(out) == ["box-predictions", "class-predictions"]
    assert not out["class-predictions"]["3"].requires_grad
