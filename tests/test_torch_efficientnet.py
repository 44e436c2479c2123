"""The port's EfficientNet against the JAX package's, on the CPU.

Every variable is drawn with numpy from a seed (`test_torch_model`'s
draw), converted with `retinanet_torch.convert` and run through both
packages (JAX's `model.apply` under `jit`: eager JAX compiles every
primitive for every new shape, ~6x slower on a CPU) on the same images.
float32 bound: rtol = atol = 1e-4 in eval mode (the two convolutions sum
in different orders); in training mode atol is 1e-4 of the endpoint's
largest magnitude (batch statistics over few values carry the
summation-order differences on, growing block by block as rounding does).
mixed_bfloat16 bound: 3e-2 of the largest output (the packages round to
bf16 at different points: `jax.nn.swish` and `sigmoid` run in bf16 where
`F.silu` computes in float32 inside the op; both pools accumulate in
float32). Small shapes: narrow widths through `override_params`, 64x64
and 67x75 images. Counts at full width are in
`test_torch_config_counts.py`.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.models import efficientnet as jax_eff  # noqa: E402
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax)
from retinanet_torch.models import efficientnet as torch_eff  # noqa: E402

from test_torch_model import _random_variables  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


# every block form: depthwise with and without expansion, fused with
# squeeze-excite, conv_type 1 with and without expansion, a k5 stride-2
# depthwise; five stages so that every endpoint '2'..'5' exists
MIXED_BLOCKS = (
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e4_i16_o24_f1_se0.25",
    "r2_k3_s22_e4_i24_o40_c1",
    "r1_k3_s11_e1_i40_o40_c1",
    "r2_k5_s22_e6_i40_o80_se0.25",
    "r1_k3_s22_e6_i80_o112_se0.25",
)

VARIANTS = {
    # b-variant: swish, squeeze-excite, depthwise blocks
    "b0-narrow": ("efficientnet-b0",
                  {"width_coefficient": 0.25, "depth_coefficient": 0.5}),
    # lite: relu6, no SE, the stem keeps 32 while block 0 declares 16
    "lite2-narrow": ("efficientnet-lite2",
                     {"width_coefficient": 0.5, "depth_coefficient": 0.5}),
    "mixed-blocks": ("efficientnet-b0",
                     {"width_coefficient": 0.5, "blocks": MIXED_BLOCKS}),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name, dtype):
    """The flax model and its variables' shapes (traced once a process)."""
    kind, override = VARIANTS[name]
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jmodel = jax_eff.EfficientNet.from_name(kind, dtype=jdtype,
                                            override_params=override)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))


def _pair(name, seed=0, dtype="float32"):
    kind, override = VARIANTS[name]
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    jmodel, variables = _jax_model(name, dtype)
    variables = _random_variables(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, seed)
    tmodel = torch_eff.EfficientNet.from_name(kind, dtype=tdtype,
                                              override_params=override)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


def _apply(jmodel, variables, x, **kw):
    return jax.jit(functools.partial(jmodel.apply, **kw))(variables, x)


def _images(hw, seed=1, n=2):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n,) + tuple(hw) + (3,)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def _compare(jfeats, tfeats, train=False):
    assert sorted(tfeats) == sorted(jfeats) == ["2", "3", "4", "5"]
    for level, ref in jfeats.items():
        ref = np.asarray(ref, np.float32)
        got = _nhwc(tfeats[level])
        assert got.shape == ref.shape, level
        atol = 1e-4 * float(np.abs(ref).max()) if train else 1e-4
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol,
                                   err_msg=f"C{level}")


# one image size each, even and odd (odd sizes pad "SAME" at stride 2
# symmetrically, even ones one row more at the end)
EVAL_SIZES = {"b0-narrow": (64, 64), "lite2-narrow": (67, 75),
              "mixed-blocks": (67, 75)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_eval_forward_matches_jax_f32(name):
    jmodel, variables, tmodel = _pair(name)
    x = _images(EVAL_SIZES[name])
    jfeats = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tfeats = tmodel(_nchw(x))
    _compare(jfeats, tfeats)
    for level, t in tfeats.items():
        assert t.shape[1] == tmodel.out_channels[level]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_forward_matches_jax_f32(name):
    """Batch statistics: the outputs and the moved running statistics."""
    jmodel, variables, tmodel = _pair(name, seed=2)
    x = _images((67, 75), seed=3, n=3)
    jfeats, updates = _apply(jmodel, variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        tfeats = tmodel(_nchw(x))
    _compare(jfeats, tfeats, train=True)
    got = torch_to_flax(tmodel.state_dict())["batch_stats"]
    for path, ref in jax.tree_util.tree_flatten_with_path(
            updates["batch_stats"])[0]:
        node = got
        for part in path:
            node = node[part.key]
        np.testing.assert_allclose(node, np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def test_mixed_bfloat16_matches_jax():
    jmodel, variables, tmodel = _pair("b0-narrow", seed=4, dtype="bf16")
    x = _images((64, 64), seed=5)
    jfeats = _apply(jmodel, variables, jnp.asarray(x).astype(jnp.bfloat16),
                    train=False)
    with torch.no_grad():
        tfeats = tmodel(_nchw(x).to(torch.bfloat16))
    for level, ref in jfeats.items():
        assert tfeats[level].dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        bound = 3e-2 * float(np.abs(ref).max())
        np.testing.assert_allclose(_nhwc(tfeats[level]), ref, rtol=0,
                                   atol=bound, err_msg=f"C{level}")


def test_converter_round_trip_is_bit_exact():
    _, variables, tmodel = _pair("mixed-blocks", seed=6)
    back = torch_to_flax(tmodel.state_dict())
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(np.asarray(a), b), path


def test_drop_connect_arithmetic_on_a_shared_draw(monkeypatch):
    """The same numpy draw handed to both packages' drop-connect."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (6, 5, 4, 3)).astype(np.float32)
    # each survival probability below keeps some images and drops others
    u = np.array([0.05, 0.3, 0.55, 0.8, 0.95, 0.1],
                 np.float32).reshape(6, 1, 1, 1)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(u, dtype))
    for sp in (0.8, 0.5, 0.9333333):
        ref = np.asarray(jax_eff._drop_connect(jnp.asarray(x), None, sp))
        got = torch_eff.drop_connect(_nchw(x), _nchw(u), sp)
        np.testing.assert_array_equal(_nhwc(got), ref)
        kept = np.floor(sp + u[:, 0, 0, 0]) == 1
        assert 0 < kept.sum() < 6
        assert np.all(ref[~kept] == 0)


def test_train_forward_with_drop_connect_matches_jax(monkeypatch):
    """Stochastic depth in a whole backbone: each block's draw taken in
    block order from one numpy stream, in both packages."""
    jmodel, variables, tmodel = _pair("b0-narrow", seed=8)
    x = _images((64, 64), seed=9, n=4)
    rng = np.random.default_rng(10)
    draws = [rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32)
             for _ in range(tmodel.num_blocks)]
    jdraws, tdraws = list(draws), list(draws)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(
                            jdraws.pop(0), dtype))
    monkeypatch.setattr(torch_eff, "_uniform",
                        lambda t, generator: _nchw(tdraws.pop(0)))
    jfeats, _ = _apply(jmodel, variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"],
                       rngs={"dropout": jax.random.PRNGKey(0)})
    tmodel.train()
    with torch.no_grad():
        tfeats = tmodel(_nchw(x), torch.Generator())
    used = len(draws) - len(tdraws)
    assert used == len(draws) - len(jdraws) and used > 0
    _compare(jfeats, tfeats, train=True)
    # without a generator nothing is dropped, as JAX without an rng
    tdraws[:] = draws
    with torch.no_grad():
        plain = tmodel(_nchw(x))
    assert len(tdraws) == len(draws)
    assert not all(torch.equal(plain[k], tfeats[k]) for k in plain)
