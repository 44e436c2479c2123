"""The port's by-name optimizer registry (`retinanet_torch/optimizers/
registry.py`) in lockstep with optax, as the JAX package's registry builds
it (`retinanet_tpu/optimizers/builder.py:build_optimizer`).

Each of the 23 factories takes 5 steps on a small tree (a 3x3x16x32 conv
kernel, a 256x160 dense kernel that Adafactor factors, a bias and a BN
scale) under a warmup-then-piecewise schedule, fed the same seeded
gradients on both sides, once with its defaults and once with one
forwarded non-default keyword. After every step each tensor agrees with
optax's within RTOL of its largest magnitude, at float32 (optax runs op by
op, so each XLA operation rounds once, as torch's do; what is left is the
order of reductions and XLA's rsqrt and pow, within an ulp or two)."""

import inspect

import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.optimizers import builder as jax_builder  # noqa: E402
from retinanet_torch.convert import torch_to_flax  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.models.retinanet import flax_path  # noqa: E402
from retinanet_torch.optimizers import builder as torch_builder  # noqa: E402
from retinanet_torch.optimizers import registry  # noqa: E402

import test_torch_train_step as lockstep  # noqa: E402

STEPS = 5
RTOL = 1e-6
LR_PARAMS = {"schedule_type": "piecewise_constant_decay",
             "warmup_learning_rate": 0.0067, "warmup_steps": 2,
             "values": [0.01, 0.002], "boundaries": [4]}

# (port name, flax path, flax shape); the port holds conv kernels OIHW and
# dense kernels (out, in)
TREE = (("conv.conv.weight", ("conv", "conv", "kernel"), (3, 3, 16, 32)),
        ("dense.weight", ("dense", "kernel"), (256, 160)),
        ("conv.conv.bias", ("conv", "conv", "bias"), (32,)),
        ("block.bn.weight", ("block", "bn", "scale"), (32,)))

# one forwarded keyword other than its default, a factory; noisy_sgd's
# lockstep runs at eta = 0 (its noise is JAX's own draws), sign_sgd has
# no keyword
VARIANTS = {
    "adabelief": {"nesterov": True},
    "adadelta": {"weight_decay": 1e-3},
    "adafactor": {"momentum": 0.9},
    "adagrad": {"initial_accumulator_value": 0.5},
    "adamax": {"b1": 0.8},
    "adamaxw": {"weight_decay": 1e-2},
    "adan": {"weight_decay": 1e-2},
    "amsgrad": {"b2": 0.99},
    "fromage": {"min_norm": 1e-3},
    "lamb": {"weight_decay": 1e-2},
    "lars": {"nesterov": True},
    "lion": {"b1": 0.8},
    "nadam": {"nesterov": False},
    "nadamw": {"weight_decay": 1e-2},
    "noisy_sgd": {"eta": 0.0, "gamma": 0.9},
    "novograd": {"weight_decay": 1e-3},
    "optimistic_adam_v2": {"alpha": 0.5},
    "optimistic_gradient_descent": {"beta": 0.5},
    # rho reaches 4.99 at step 5: the rectified branch runs once
    "radam": {"threshold": 4.5},
    "rmsprop": {"momentum": 0.9},
    "scale_by_learning_rate": {"flip_sign": False},
    "yogi": {"eps": 1e-4},
}
DEFAULTS = {"noisy_sgd": {"eta": 0.0}}
CASES = ([(name, DEFAULTS.get(name, {})) for name in registry.SIGNATURES]
         + list(VARIANTS.items()))
IDS = ([f"{name}-defaults" for name in registry.SIGNATURES]
       + [f"{name}-{next(iter(kw))}" for name, kw in VARIANTS.items()])

REFUSED = ("lbfgs", "optimistic_adam", "rprop", "scale_by_rprop", "sm3")


def _opt_tree(name, kwargs):
    return {"name": name, "lr_params": dict(LR_PARAMS), **kwargs}


def _flax_tree(arrays):
    tree = {}
    for (_, path, _), value in zip(TREE, arrays):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


def _to_flax(t):
    t = t.detach().numpy()
    return t.transpose(2, 3, 1, 0) if t.ndim == 4 else (
        t.T if t.ndim == 2 else t)


def _to_port(a):
    # a copy: JAX may read a numpy buffer after this returns (its CPU
    # arrays can alias numpy memory, and dispatch is asynchronous), and the
    # port updates its parameters in place
    return torch.from_numpy(np.array(
        a.transpose(3, 2, 0, 1) if a.ndim == 4 else (
            a.T if a.ndim == 2 else a)))


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    init = [rng.normal(0, 0.2, shape).astype(np.float32)
            for _, _, shape in TREE]
    grads = [[rng.normal(0, 1.0, shape).astype(np.float32)
              for _, _, shape in TREE] for _ in range(STEPS)]
    return init, grads


def _port_params(init):
    return {name: torch.nn.Parameter(_to_port(a))
            for (name, _, _), a in zip(TREE, init)}


def _port_step(opt, named, grads):
    for (name, _, _), g in zip(TREE, grads):
        named[name].grad = _to_port(g)
    opt.step()


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_lockstep_with_optax(name, kwargs):
    init, grads = _draws()
    tx, _ = jax_builder.build_optimizer(
        jax_cfg.ConfigDict(_opt_tree(name, kwargs)), 100)
    params = _flax_tree([jnp.array(a) for a in init])
    state = tx.init(params)

    named = _port_params(init)
    opt, _ = torch_builder.build_optimizer(
        torch_cfg.ConfigDict(_opt_tree(name, kwargs)), 100, named)
    assert isinstance(opt, registry.RegistryOptimizer)

    for step in range(STEPS):
        updates, state = tx.update(
            _flax_tree([jnp.array(g) for g in grads[step]]), state, params)
        params = optax.apply_updates(params, updates)
        _port_step(opt, named, grads[step])
        for port_name, path, _ in TREE:
            want = _leaf(params, path)
            got = _to_flax(named[port_name])
            scale = np.abs(want).max()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=RTOL * scale,
                err_msg=f"{name} {kwargs} step {step + 1} {port_name}")
    assert opt.count == STEPS


def test_keyword_table_equals_optax():
    """The port's copy of each factory's keywords and defaults equals
    optax's own signature (a dtype default by its name)."""
    for name, table in registry.SIGNATURES.items():
        params = dict(inspect.signature(getattr(optax, name)).parameters)
        params.pop("learning_rate")
        defaults = {}
        for key, p in params.items():
            default = p.default
            if key == "dtype_momentum":
                default = np.dtype(default).name
            defaults[key] = default
        assert table == defaults, name


def test_registry_names_are_the_runnable_optax_factories():
    """Every name the registry holds or refuses is an optax factory, and
    each refused one fails in optax's update under a schedule."""
    for name in list(registry.SIGNATURES) + list(registry.REFUSED):
        assert callable(getattr(optax, name)), name
    assert sorted(registry.REFUSED) == sorted(REFUSED)
    assert len(registry.SIGNATURES) == 23
    params = {"w": jnp.ones((4,))}
    for name in REFUSED:
        with pytest.raises(Exception):
            tx = getattr(optax, name)(learning_rate=lambda count: 0.1)
            state = tx.init(params)
            tx.update(params, state, params)


@pytest.mark.parametrize("name", REFUSED + ("not_an_optimizer",))
def test_refused_and_unknown_names_raise(name):
    named = _port_params(_draws()[0])
    with pytest.raises(ValueError, match=name):
        torch_builder.build_optimizer(
            torch_cfg.ConfigDict(_opt_tree(name, {})), 100, named)


@pytest.mark.parametrize("name,key,value", [
    ("lamb", "mask", "conv"), ("lars", "trust_ratio_mask", False),
    ("amsgrad", "mu_dtype", "bfloat16"),
    ("adafactor", "dtype_momentum", "bfloat16"),
    ("noisy_sgd", "key", 3)],
    ids=["mask", "trust_ratio_mask", "mu_dtype", "dtype_momentum",
         "key_and_seed"])
def test_fixed_keywords_take_their_default_only(name, key, value):
    named = _port_params(_draws()[0])
    tree = _opt_tree(name, {key: value})
    if name == "noisy_sgd":
        tree["seed"] = 4
    with pytest.raises(ValueError, match=key if name != "noisy_sgd"
                       else "seed or key"):
        torch_builder.build_optimizer(torch_cfg.ConfigDict(tree), 100,
                                      named)
    # the default itself is accepted
    tree = _opt_tree(name, {key: registry.SIGNATURES[name][key]})
    torch_builder.build_optimizer(torch_cfg.ConfigDict(tree), 100, named)


def test_noisy_sgd_noise_variance():
    """With zero gradients at a constant rate of 1, step t moves each
    weight by a normal draw of variance eta / t^gamma (optax's add_noise):
    held within 5% (the sample variance of 40,960 draws has a relative
    standard error of 0.7%), the mean within 5 standard errors of 0."""
    eta, gamma = 0.04, 0.55
    named = {"dense.weight": torch.nn.Parameter(torch.zeros(160, 256))}
    tree = {"name": "noisy_sgd", "eta": eta, "gamma": gamma,
            "lr_params": {"schedule_type": "piecewise_constant_decay",
                          "warmup_learning_rate": 1.0, "warmup_steps": 0,
                          "values": [1.0], "boundaries": []}}
    opt, _ = torch_builder.build_optimizer(torch_cfg.ConfigDict(tree), 10,
                                           named, seed=7)
    w = named["dense.weight"]
    draws = []
    for t in range(1, 6):
        before = w.detach().clone()
        w.grad = torch.zeros_like(w)
        opt.step()
        moved = (w.detach() - before).double()
        want = eta / t ** gamma
        assert abs(moved.var().item() / want - 1) < 0.05, t
        assert abs(moved.mean().item()) < 5 * (want / moved.numel()) ** 0.5
        draws.append(moved)
    # the run's seed decides the draws
    again = {"dense.weight": torch.nn.Parameter(torch.zeros(160, 256))}
    opt2, _ = torch_builder.build_optimizer(torch_cfg.ConfigDict(tree), 10,
                                            again, seed=7)
    again["dense.weight"].grad = torch.zeros(160, 256)
    opt2.step()
    assert torch.equal(again["dense.weight"].detach().double(), draws[0])


def test_checkpoint_resume_with_lamb_equals_an_unbroken_run():
    init, grads = _draws(1)
    tree = torch_cfg.ConfigDict(_opt_tree("lamb", {"weight_decay": 1e-2}))
    whole = _port_params(init)
    opt, _ = torch_builder.build_optimizer(tree, 100, whole)
    for g in grads:
        _port_step(opt, whole, g)

    first = _port_params(init)
    opt1, _ = torch_builder.build_optimizer(tree, 100, first)
    for g in grads[:2]:
        _port_step(opt1, first, g)
    saved = {"model": {k: v.detach().clone() for k, v in first.items()},
             "optimizer": opt1.state_dict()}
    resumed = _port_params(init)
    opt2, _ = torch_builder.build_optimizer(tree, 100, resumed)
    with torch.no_grad():
        for k, v in resumed.items():
            v.copy_(saved["model"][k])
    opt2.load_state_dict(saved["optimizer"])
    assert opt2.count == 2
    for g in grads[2:]:
        _port_step(opt2, resumed, g)
    for k in whole:
        assert torch.equal(resumed[k], whole[k]), k


def test_lamb_with_clipnorm_and_freeze_two_lockstep_steps():
    """A registry optimizer inside the train step, against the JAX train
    step: `lamb` behind the two-stage clip (`clipnorm`) and a frozen
    backbone, two lockstep float32 steps on the same seeded weights and
    batches. Bounds as `tests/test_torch_train_step.py`'s: every loss rtol
    1e-4, the gradient norm rtol 1e-3, every parameter and running
    statistic within 1e-4 of its leaf's largest magnitude; the frozen
    backbone does not move. A conv bias in front of a BatchNorm has a
    gradient of exactly 0 in theory and of rounding noise (1e-9) in both
    packages; LAMB's normalised update turns that noise into a step of the
    full trust ratio in the noise's direction, so such a leaf (its gradient
    not 0 but under 1e-6 of the largest) is held only to the move LAMB
    allows: at most the rate times the leaf's norm a step."""
    tree = lockstep._tree(freeze=("backbone",))
    tree["training"]["optimizer"] = {
        "name": "lamb", "weight_decay": 1e-3, "clipnorm": 1.0,
        "lr_params": {"schedule_type": "piecewise_constant_decay",
                      "warmup_learning_rate": 0.002, "warmup_steps": 2,
                      "values": [0.02, 0.002], "boundaries": [50]}}
    (jstate, jstep), (tstate, tstep) = lockstep._build_pair(tree, seed=4)
    assert isinstance(tstate.optimizer, registry.RegistryOptimizer)
    assert tstate.optimizer.clipnorm == 1.0
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    noise = set()
    for i in range(2):
        batch = lockstep._batch(seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        lockstep._assert_metrics(jm, tm, rtol=1e-4)
        # the clip bound the norm at the threshold on both sides
        assert float(tm["gradient-norm"]) <= 1.0 + 1e-6
        grads = {flax_path(n): p.grad.abs().max().item()
                 for n, p in tstate.model.named_parameters()
                 if p.grad is not None}
        noise |= {n for n, g in grads.items()
                  if 0 < g < 1e-6 * max(grads.values())}
    assert tstate.step == 2 and tstate.optimizer.count == 2
    assert noise and all(n.endswith("conv/bias") for n in noise), noise
    state = tstate.model.state_dict()
    after = torch_to_flax(state)
    jflat = lockstep._flat(jstate.params)
    tflat = lockstep._flat(after["params"])
    p0 = lockstep._flat(torch_to_flax(before)["params"])
    for name in noise:
        allowed = 2 * 0.02 * np.linalg.norm(p0[name]) * 1.01
        for moved in (tflat[name] - p0[name], jflat[name] - p0[name]):
            assert np.linalg.norm(moved) <= allowed, name
    lockstep._assert_trees_close(
        {k: v for k, v in jflat.items() if k not in noise},
        {k: v for k, v in tflat.items() if k not in noise})
    lockstep._assert_trees_close(jstate.batch_stats, after["batch_stats"])
    for name, value in state.items():
        if name.startswith("backbone."):
            assert torch.equal(value, before[name]), name
    moved = [k for k, v in state.items() if not torch.equal(v, before[k])]
    assert len(moved) >= 0.7 * sum(not k.startswith("backbone.")
                                   for k in state), moved
