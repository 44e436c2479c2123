"""Training-mode BatchNorm of the port against flax, the frozen switch, and
the weight bridge both ways, on the CPU.

Output and both running statistics after 3 updates: rtol 1e-5 (the
reductions over (N, H, W) sum in different orders). The round trip torch ->
flax -> torch is bit-exact."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models import layers as jax_layers  # noqa: E402
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_torch import convert  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.models import layers as torch_layers  # noqa: E402
from retinanet_torch.models import retinanet as torch_retinanet  # noqa: E402
from retinanet_torch.train.step import set_frozen_batch_norms  # noqa: E402

C = 6


def _pair(dtype="float32", momentum=0.99, seed=0):
    rng = np.random.default_rng(seed)
    variables = {
        "params": {"bn": {
            "scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": rng.normal(0, 0.1, C).astype(np.float32)}},
        "batch_stats": {"bn": {
            "mean": rng.normal(0, 0.5, C).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}}
    jbn = jax_layers.BatchNorm(momentum=momentum, epsilon=1e-3,
                               dtype=getattr(jnp, dtype))
    tbn = torch_layers.BatchNorm(C, 1e-3, getattr(torch, dtype),
                                 momentum=momentum)
    tbn.load_state_dict(convert.flax_to_torch(variables))
    return jbn, jax.tree_util.tree_map(jnp.asarray, variables), tbn


def _input(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # channel means far from 0, so E[x^2] - E[x]^2 has something to cancel
    return (rng.normal(3.0, 2.0, (4, 5, 7, C))
            * rng.uniform(0.1, 3, C)).astype(dtype)


@pytest.mark.parametrize("momentum", [0.99, 0.9])
def test_training_mode_matches_flax_over_three_updates(momentum):
    jbn, variables, tbn = _pair(momentum=momentum)
    tbn.train()
    for step in range(3):
        x = _input(step)
        jy, mutated = jbn.apply(variables, jnp.asarray(x),
                                use_running_average=False,
                                mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": mutated["batch_stats"]}
        ty = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(
            ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
            rtol=1e-5, atol=1e-5)
        for ours, theirs in (("running_mean", "mean"),
                             ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(tbn.bn, ours).numpy(),
                np.asarray(variables["batch_stats"]["bn"][theirs]),
                rtol=1e-5, atol=1e-7, err_msg=f"{ours} after {step + 1}")


def test_running_variance_takes_the_biased_batch_variance():
    _, _, tbn = _pair()
    tbn.train()
    x = torch.from_numpy(_input(9)).permute(0, 3, 1, 2)
    before = tbn.bn.running_var.clone()
    tbn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(tbn.bn.running_var.numpy(),
                               (0.99 * before + 0.01 * biased).numpy(),
                               rtol=1e-5)


def test_gradients_match_flax():
    jbn, variables, tbn = _pair(seed=2)
    tbn.train()
    x = _input(5)
    w = np.random.default_rng(6).normal(0, 1, x.shape).astype(np.float32)

    def loss(params, xj):
        y, _ = jbn.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, xj,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w))

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                               jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (tbn(tx) * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    scale = float(np.abs(np.asarray(jgx)).max())
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jgx), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(tbn.bn.weight.grad.numpy(),
                               np.asarray(jgp["bn"]["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tbn.bn.bias.grad.numpy(),
                               np.asarray(jgp["bn"]["bias"]), rtol=1e-4,
                               atol=1e-4)


def test_mixed_bfloat16_statistics_in_float32_output_in_bfloat16():
    jbn, variables, tbn = _pair(dtype="bfloat16")
    tbn.train()
    x = _input(3)
    jy, mutated = jbn.apply(variables,
                            jnp.asarray(x).astype(jnp.bfloat16),
                            use_running_average=False,
                            mutable=["batch_stats"])
    ty = tbn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert ty.dtype == torch.bfloat16
    assert tbn.bn.running_mean.dtype == torch.float32
    ref = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(
        ty.detach().float().permute(0, 2, 3, 1).numpy(), ref, rtol=0,
        atol=2 ** -7 * float(np.abs(ref).max()))   # one bf16 rounding
    np.testing.assert_allclose(
        tbn.bn.running_var.numpy(),
        np.asarray(mutated["batch_stats"]["bn"]["var"]), rtol=1e-5)


def test_frozen_switch_runs_eval_mode_inside_a_training_model():
    jbn, variables, tbn = _pair(seed=4)
    tbn.train()
    tbn.frozen = True
    x = _input(7)
    stats = {k: v.clone() for k, v in tbn.bn.state_dict().items()}
    ty = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    jy = jbn.apply(variables, jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k, v in tbn.bn.state_dict().items():
        assert torch.equal(v, stats[k]), k


def _model_tree():
    return {
        "experiment": {"name": "t"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "architecture": {
            "conv_2d": {"use_seperable_conv": True},
            "batch_norm": {"momentum": 0.9},
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5,
                               "fusion_mode": "fast_attention"},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
    }


_FROZEN = {
    "backbone": (("backbone",), lambda n: n.startswith("backbone.")),
    "resnet_initial": (("resnet_initial",),
                       lambda n: n == "backbone.stem_bn"),
    "bn": (("bn",), lambda n: True),
    "head-bn+fpn": (("head-bn", "fpn"),
                    lambda n: not n.startswith("backbone.")),
    "none": ((), lambda n: False),
}


@pytest.mark.parametrize("case", sorted(_FROZEN))
def test_frozen_batch_norms_follow_the_freeze_regexes(case):
    keys, expected = _FROZEN[case]
    model = torch_retinanet.build_model(torch_cfg.from_dict(_model_tree()),
                                        device="meta")
    count = set_frozen_batch_norms(model,
                                   torch_retinanet.freeze_regexes(keys))
    bns = {name: m for name, m in model.named_modules()
           if isinstance(m, torch_layers.BatchNorm)}
    assert all(m.momentum == 0.9 for m in bns.values())   # from the config
    for name, m in bns.items():
        assert m.frozen == expected(name), name
    assert count == sum(m.frozen for m in bns.values())


def test_round_trip_torch_flax_torch_is_bit_exact_and_matches_flax_tree():
    tree = _model_tree()
    model = torch_retinanet.build_model(torch_cfg.from_dict(tree),
                                        device="cpu", seed=3)
    with torch.no_grad():     # statistics off their initial 0 and 1
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand_like(buf) + 0.5)
    state = model.state_dict()
    flax_tree = convert.torch_to_flax(state)
    back = convert.flax_to_torch(flax_tree)
    assert sorted(back) == sorted(state)
    for name, value in state.items():
        assert back[name].dtype == value.dtype
        assert torch.equal(back[name], value), name

    jmodel = jax_retinanet.build_model(jax_cfg.from_dict(tree))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    want = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(dict(shapes))[0]}
    got = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
           in jax.tree_util.tree_flatten_with_path(flax_tree)[0]}
    assert got == want
    # and flax -> torch -> flax
    again = convert.torch_to_flax(back)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(flax_tree)[0],
            jax.tree_util.tree_flatten_with_path(again)[0]):
        assert pa == pb and np.array_equal(a, b)
    with pytest.raises(KeyError, match="no flax counterpart"):
        convert.torch_to_flax({"a.b.num_batches_tracked": torch.zeros(())})
    with pytest.raises(ValueError, match="OIHW"):
        convert.torch_to_flax({"a.conv.weight": torch.zeros(3)})
