"""The port's MobileDet against the JAX package's, on the CPU.

Every variable is drawn with numpy from a seed (`test_torch_model`'s
draw), converted with `retinanet_torch.convert` and run through both
packages (JAX's `model.apply` under `jit`) on the same images, all four
variants at `multiplier` 0.25. float32 bound: rtol = atol = 1e-4 in eval
mode (the two convolutions sum in different orders); in training mode
atol is 1e-4 of the endpoint's largest magnitude (batch statistics over
few values, 27 a channel at the last endpoint, carry the summation-order
differences on; they grow block by block, as rounding does).
mixed_bfloat16 bound: 3e-2 of the largest output (both run relu6, swish6
and sigmoid in bf16 but round the convolutions' sums differently; both
pools accumulate in float32). Counts at full width are in
`test_torch_config_counts.py`.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.models import mobiledet as jax_md  # noqa: E402
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax)
from retinanet_torch.models import mobiledet as torch_md  # noqa: E402

from test_torch_model import _random_variables  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


MULTIPLIER = 0.25
# even sizes pad "SAME" stride-2 convs one row more at the end, odd sizes
# symmetrically
SIZES = {"mobiledet_cpu": (64, 64), "mobiledet_dsp": (67, 75),
         "mobiledet_edge_tpu": (67, 75), "mobiledet_gpu": (64, 64)}


@functools.lru_cache(maxsize=None)
def _jax_model(variant, dtype):
    """The flax model and its variables' shapes (traced once a process)."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jmodel = jax_md.MobileDet(variant=variant, multiplier=MULTIPLIER,
                              dtype=jdtype)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))


def _pair(variant, seed=0, dtype="float32"):
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    jmodel, variables = _jax_model(variant, dtype)
    variables = _random_variables(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, seed)
    tmodel = torch_md.MobileDet(variant, MULTIPLIER, dtype=tdtype)
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
    return t.permute(0, 2, 3, 1).float().numpy()


def _compare(jfeats, tfeats, tmodel, train=False):
    assert sorted(tfeats) == sorted(jfeats) == ["1", "2", "3", "4", "5"]
    for level, ref in jfeats.items():
        ref = np.asarray(ref, np.float32)
        got = _nhwc(tfeats[level])
        assert got.shape == ref.shape, level
        assert got.shape[-1] == tmodel.out_channels[level]
        atol = 1e-4 * float(np.abs(ref).max()) if train else 1e-4
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol,
                                   err_msg=f"endpoint {level}")


@pytest.mark.parametrize("variant", sorted(SIZES))
def test_eval_forward_matches_jax_f32(variant):
    jmodel, variables, tmodel = _pair(variant)
    x = _images(SIZES[variant])
    jfeats = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tfeats = tmodel(_nchw(x))
    _compare(jfeats, tfeats, tmodel)


def test_train_forward_matches_jax_f32():
    """Batch statistics: the outputs and the moved running statistics
    (edge_tpu: Tucker, fused and inverted-bottleneck blocks)."""
    jmodel, variables, tmodel = _pair("mobiledet_edge_tpu", seed=2)
    x = _images((67, 75), seed=3, n=3)
    jfeats, updates = _apply(jmodel, variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        tfeats = tmodel(_nchw(x))
    _compare(jfeats, tfeats, tmodel, train=True)
    got = torch_to_flax(tmodel.state_dict())["batch_stats"]
    for name, ref in updates["batch_stats"].items():
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(got[name]["bn"][leaf],
                                       np.asarray(ref["bn"][leaf]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}/{leaf}")


def test_mixed_bfloat16_matches_jax():
    jmodel, variables, tmodel = _pair("mobiledet_cpu", seed=4, dtype="bf16")
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
                                   atol=bound, err_msg=f"endpoint {level}")


@pytest.mark.parametrize("variant", sorted(SIZES))
def test_names_and_round_trip(variant):
    """One counter names every conv, depthwise conv and BN in flax's
    order, and the weights come back to flax bit for bit."""
    _, variables, tmodel = _pair(variant, seed=6)
    names = [n for n, _ in tmodel.named_children()]
    assert [int(n.rsplit("_", 1)[1]) for n in names] == \
        list(range(1, len(names) + 1))
    assert names[:2] == ["conv_1", "bn_2"]
    back = torch_to_flax(tmodel.state_dict())
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert sorted(str(p) for p, _ in ref) == sorted(str(p) for p, _ in got)
    got = dict((str(p), v) for p, v in got)
    for path, value in ref:
        assert np.array_equal(np.asarray(value), got[str(path)]), path


def test_scale_filters_matches_jax():
    for f in (1, 8, 16, 24, 72, 104, 144, 384):
        for m in (0.25, 0.5, 0.75, 1.0, 1.5):
            assert torch_md.scale_filters(f, m) == jax_md.scale_filters(f, m)


def test_swish6_matches_jax():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    np.testing.assert_array_equal(
        torch_md.swish6(torch.from_numpy(x)).numpy(),
        np.asarray(jax_md.swish6(jnp.asarray(x))))
