"""Two lockstep float32 train steps of a zoo model against the JAX train
step, on the CPU: EfficientNet (narrow b0) + multi-level attention fusion
+ the auxiliary IoU head (its targets and loss included) here, MobileDet
(cpu, multiplier 0.25) + FPN-P5 in `test_torch_lockstep_mobiledet.py`
(one JAX trace and compile of a train step takes 20-35 s on a CPU, so
one a file).

Seeded numpy weights go into the flax model and, through
`retinanet_torch.convert`, into the port's; the same seeded batches go
through `make_train_step` of both packages. Bounds as in
`test_torch_train_step.py`: every loss rtol 1e-4, `gradient-norm` rtol
1e-3, and after the steps every parameter and running statistic within
1e-4 of its leaf's largest magnitude.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data import label_encoder as jax_encoder  # noqa: E402
from retinanet_tpu.data import preprocessing as jax_pre  # noqa: E402
from retinanet_tpu.losses.losses import (  # noqa: E402
    RetinaNetLoss as JaxLoss)
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_tpu.optimizers import builder as jax_opt  # noqa: E402
from retinanet_tpu.train import step as jax_step  # noqa: E402
from retinanet_tpu.train.train_state import (  # noqa: E402
    create_train_state as jax_state)
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax)
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.train.trainer import build_trainer  # noqa: E402

from test_torch_train_step import (  # noqa: E402
    SIZE, _assert_metrics, _assert_trees_close, _batch, _random_variables,
    _tree)
from test_torch_threads import one_thread  # noqa: E402,F401


MODELS = {
    "efficientnet-mlaf-aux": {
        "backbone": {"type": "efficientnet-b0",
                     "override_params": {"width_coefficient": 0.25,
                                         "depth_coefficient": 0.25}},
        "feature_fusion": {"type": "multi_level_attention", "filters": 16,
                           "min_level": 3, "max_level": 6,
                           "backbone_max_level": 5,
                           "use_channel_attention": True,
                           "use_balanced_features": False},
        "auxillary_head": {"use_auxillary_head": True, "num_convs": 1,
                           "filters": 16},
    },
    "mobiledet-fpn_p5": {
        "conv_2d": {"use_seperable_conv": True},
        "backbone": {"type": "mobiledet_cpu", "multiplier": 0.25},
        "feature_fusion": {"type": "fpn_p5", "filters": 16, "min_level": 3,
                           "max_level": 6, "backbone_max_level": 5,
                           "use_balanced_features": True},
    },
}


def _zoo_tree(name):
    tree = _tree()
    tree["architecture"].update(MODELS[name])
    return tree


def _build_pair(tree, seed):
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
    tx, schedule = jax_opt.build_optimizer(t.optimizer, t.train_steps)
    jstep = jax.jit(jax_step.make_train_step(
        jmodel, JaxLoss(5, jparams.loss),
        jax_encoder.make_batched_encoder(
            jax_anchors.from_params(jparams), jparams.encoder_params,
            use_iou_targets=bool(
                jparams.architecture.auxillary_head.use_auxillary_head),
            use_pallas=False),
        jax_pre.make_device_normalizer(jparams), tx, schedule,
        use_weight_decay=True, weight_decay_alpha=1e-4,
        compute_dtype=jnp.float32, clipnorm=t.optimizer.clipnorm))
    jstate = jax_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)

    tstate, tstep = build_trainer(torch_cfg.from_dict(tree), device="cpu")
    load_flax_variables(tstate.model, variables)
    return (jstate, jstep), (tstate, tstep)


def two_lockstep_steps_f32(name):
    (jstate, jstep), (tstate, tstep) = _build_pair(_zoo_tree(name), seed=11)
    for i in range(2):
        batch = _batch(seed=20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        _assert_metrics(jm, tm, rtol=1e-4)
        if "aux" in name:
            assert float(tm["iou-prediction-loss"]) > 0.0
    after = torch_to_flax(tstate.model.state_dict())
    _assert_trees_close(jstate.params, after["params"])
    _assert_trees_close(jstate.batch_stats, after["batch_stats"])


def test_two_lockstep_steps_f32():
    two_lockstep_steps_f32("efficientnet-mlaf-aux")
