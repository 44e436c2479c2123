"""The port's schedules, Keras-style SGD, gradient clip and freeze mask
against the JAX package (optax transformations), on the CPU.

Schedules: rtol 1e-6 (both evaluate in float32). SGD over a changing rate,
10 steps: rtol 1e-6, atol 2e-7: the port's `w += -lr * g` is one fused
multiply-add where the other rounds twice, an ulp or two of the operands
(order 1 here) over the steps, which is more than 1e-6 of a result that cancels towards 0."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_tpu.optimizers import builder as jax_builder  # noqa: E402
from retinanet_tpu.optimizers import schedules as jax_schedules  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.models import retinanet as torch_retinanet  # noqa: E402
from retinanet_torch.optimizers import builder as torch_builder  # noqa: E402
from retinanet_torch.optimizers import registry as torch_registry  # noqa: E402
from retinanet_torch.optimizers import schedules as torch_schedules  # noqa: E402

PIECEWISE = {"schedule_type": "piecewise_constant_decay",
             "warmup_learning_rate": 0.0067, "warmup_steps": 500,
             "values": [0.08, 0.008, 0.0008], "boundaries": [617144, 655712]}
COSINE = {"schedule_type": "cosine_decay", "initial_learning_rate": 0.08,
          "warmup_learning_rate": 0.0067, "warmup_steps": 500, "alpha": 0.01}
INVERSE = {"schedule_type": "inverse_decay", "initial_learning_rate": 0.05,
           "decay_rate": 0.001}


def _around(*points):
    steps = set()
    for p in points:
        steps.update(range(max(0, p - 10), p + 10))
    return sorted(steps)


@pytest.mark.parametrize("lr_params,steps", [
    (PIECEWISE, _around(0, 500, 617143, 617144, 655711, 655712, 674990)),
    (COSINE, _around(0, 500, 337500, 674500, 675000)),
    (INVERSE, _around(0, 1000, 675000)),
], ids=["piecewise", "cosine", "inverse"])
def test_schedules_match_jax(lr_params, steps):
    jfn = jax_schedules.from_params(jax_cfg.ConfigDict(lr_params), 675000)
    tfn = torch_schedules.from_params(torch_cfg.ConfigDict(lr_params),
                                      675000)
    for step in steps:
        got = tfn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jfn(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def test_piecewise_changes_on_the_reference_step_numbers():
    fn = torch_schedules.from_params(torch_cfg.ConfigDict(PIECEWISE), 675000)
    assert fn(0) == pytest.approx(0.0067)
    assert fn(499) < fn(500) == pytest.approx(0.08)
    # boundaries shifted by -1: the rate drops at step 617144
    assert fn(617143) == pytest.approx(0.08)
    assert fn(617144) == pytest.approx(0.008)
    assert fn(655712) == pytest.approx(0.0008)
    with pytest.raises(ValueError, match="len"):
        torch_schedules.piecewise_constant_decay_with_warmup(
            0.1, 5, [10], [0.1])
    with pytest.raises(ValueError, match="Invalid"):
        torch_schedules.from_params(
            torch_cfg.ConfigDict({"schedule_type": "exponential"}), 10)


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((3, 3, 4, 8), (8,), (5, 7), ())]


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)],
                         ids=["plain", "momentum", "nesterov"])
def test_keras_sgd_matches_optax_transformation(momentum, nesterov):
    """A rate that warms up and then drops by 10x inside the 10 steps: the
    velocity must keep the rate of the step that fed it."""
    lr = {"schedule_type": "piecewise_constant_decay",
          "warmup_learning_rate": 0.01, "warmup_steps": 3,
          "values": [0.1, 0.01], "boundaries": [7]}
    jschedule = jax_schedules.from_params(jax_cfg.ConfigDict(lr), 10)
    tschedule = torch_schedules.from_params(torch_cfg.ConfigDict(lr), 10)
    tx = jax_builder.keras_sgd(jschedule, momentum, nesterov)
    jparams = [jnp.asarray(x) for x in _leaves(0)]
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(x.copy()))
               for x in _leaves(0)]
    opt = torch_builder.KerasSGD(tparams, tschedule, momentum, nesterov)
    for step in range(10):
        grads = _leaves(100 + step)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for p, ref in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=2e-7,
                                       err_msg=f"step {step}")
    assert opt.count == 10 == int(jstate.count)
    if momentum == 0.0:
        assert jstate.velocity is None
        assert not any("velocity" in opt.state[p] for p in tparams)
    else:
        for p, ref in zip(tparams, jstate.velocity):
            np.testing.assert_allclose(opt.velocity(p).numpy(),
                                       np.asarray(ref), rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: 0.0)


@pytest.mark.parametrize("threshold", [0.5, 10.0, 1e6])
def test_clip_per_tensor_then_global_matches_jax(threshold):
    grads = _leaves(7) + [np.zeros((4,), np.float32)]    # a zero gradient
    tx = jax_builder.clip_per_tensor_then_global(threshold)
    ref, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = torch_builder.clip_per_tensor_then_global(got, threshold)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-8)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(ref)),
                               rtol=1e-6)
    assert float(norm) <= threshold * (1 + 1e-6)
    np.testing.assert_allclose(
        float(torch_builder.global_norm([torch.from_numpy(g)
                                         for g in grads])),
        float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)


def _model_tree():
    return {
        "experiment": {"name": "t"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 2, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "training": {"train_steps": 10, "optimizer": {
            "name": "sgd", "momentum": 0.9, "clipnorm": 10.0,
            "lr_params": PIECEWISE}},
    }


@pytest.mark.parametrize("keys", [("backbone",), ("bn",), ("head", "fpn-bn"),
                                  ("resnet_initial", "head-bn"),
                                  ("backbone-bn", "fpn")], ids=str)
def test_freeze_mask_on_the_real_tree_matches_jax(keys):
    tree = _model_tree()
    jmodel = jax_retinanet.build_model(jax_cfg.from_dict(tree))
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    jmask = jax_builder.freeze_mask_fn(keys)(variables["params"])
    jflat = {"/".join(str(k.key) for k in path): keep for path, keep
             in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    tmodel = torch_retinanet.build_model(torch_cfg.from_dict(tree),
                                         device="meta")
    trainable = torch_builder.freeze_mask_fn(keys)
    tflat = {torch_retinanet.flax_path(name): trainable(name)
             for name, _ in tmodel.named_parameters()}
    assert tflat == jflat
    assert any(tflat.values()) and not all(tflat.values())
    assert torch_retinanet.FREEZE_VARS_REGEX.keys() == (
        jax_retinanet.FREEZE_VARS_REGEX.keys())
    for key, regex in jax_retinanet.FREEZE_VARS_REGEX.items():
        assert torch_retinanet.FREEZE_VARS_REGEX[key].pattern == regex.pattern
    with pytest.raises(ValueError, match="Unknown freeze_variables"):
        torch_builder.freeze_mask_fn(("neck",))


def test_build_optimizer_freezes_and_rejects_unported_names():
    tree = _model_tree()
    params = torch_cfg.from_dict(tree)
    model = torch_retinanet.build_model(params, device="cpu")
    named = dict(model.named_parameters())
    opt, schedule = torch_builder.build_optimizer(
        params.training.optimizer, 10, named, freeze_variables=("backbone",))
    assert isinstance(opt, torch_builder.KerasSGD)
    assert opt.clipnorm == 10.0 and schedule(0) == pytest.approx(0.0067)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in named.items():
        frozen = name.startswith("backbone.")
        assert p.requires_grad != frozen and (id(p) in held) != frozen

    for name in ("adam", "adamw"):
        params.training.optimizer["name"] = name
        opt, _ = torch_builder.build_optimizer(params.training.optimizer, 10,
                                               named)
        w = named["class_head.prediction.conv.bias"]
        before = w.detach().clone()
        for p in named.values():
            p.grad = torch.ones_like(p)
        opt.step()
        assert opt.count == 1 and not torch.equal(w, before)
        assert opt.inner.param_groups[0]["lr"] == pytest.approx(0.0067)
    # any other name goes to the by-name registry, behind the same freeze;
    # a name that is neither raises ValueError
    params.training.optimizer["name"] = "lamb"
    opt, _ = torch_builder.build_optimizer(
        params.training.optimizer, 10, named, freeze_variables=("backbone",))
    assert isinstance(opt, torch_registry.RegistryOptimizer)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in named.items():
        assert (id(p) in held) != name.startswith("backbone."), name
    params.training.optimizer["name"] = "not_an_optimizer"
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        torch_builder.build_optimizer(params.training.optimizer, 10, named)
