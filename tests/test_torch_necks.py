"""The port's FPN-P5 and multi-level attention fusion necks, and the
auxiliary IoU head, against the JAX package's, on the CPU.

Each neck is built by both packages' `build_neck` from the same config
(16 filters, levels 3-7 from backbone levels 3-5), its variables drawn
with numpy from a seed and converted with `retinanet_torch.convert`, and
run on the same seeded backbone features, at sizes 16/8/4 and 12/6/3 (the
stride-2 convs of P6 and P7 pad "SAME" one row more at the end of an even
size, symmetrically on an odd one). JAX's `apply` runs under `jit`.
float32 bound: rtol = atol = 1e-4 (the convolutions sum in different
orders). mixed_bfloat16 bound: 3e-2 of the largest output (`jax.nn.softmax`
over the levels runs in bf16 where torch's computes in float32 inside the
op; both pools accumulate in float32).
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax)
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.export.serving import build_serving_fn  # noqa: E402
from retinanet_torch.models import layers as torch_layers  # noqa: E402
from retinanet_torch.models import retinanet as torch_retinanet  # noqa: E402

from test_torch_model import (  # noqa: E402
    _build_pair, _random_variables, _tree)
from test_torch_threads import one_thread  # noqa: E402,F401


CHANNELS = {"3": 8, "4": 12, "5": 20}
SIZES = {"even": (16, 8, 4), "odd": (12, 6, 3)}
NECKS = {
    "fpn_p5": ({"type": "fpn_p5"}, {}),
    "fpn_p5-bias-separable": (
        {"type": "fpn_p5", "fusion_mode": "fast_attention"},
        {"use_bias_before_bn": True, "use_seperable_conv": True}),
    "mlaf": ({"type": "multi_level_attention"}, {}),
    "mlaf-channel-attention": (
        {"type": "multi_level_attention", "use_channel_attention": True},
        {"use_bias_before_bn": True}),
    "stacked-mlaf": (
        {"type": "stacked_multi_level_attention", "num_repeats": 2,
         "use_channel_attention": True}, {"use_seperable_conv": True}),
}


def _arch(neck, precision="float32"):
    ff, conv_2d = NECKS[neck]
    return {
        "experiment": {"name": "torch_port_necks"},
        "input": {"input_shape": [128, 128], "channels": 3},
        "floatx": {"precision": precision},
        "architecture": {
            "conv_2d": conv_2d,
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"filters": 16, "min_level": 3, "max_level": 7,
                               "backbone_max_level": 5, **ff},
            "head": {"num_classes": 5, "num_anchors": 9},
        },
    }


def _pair(neck, seed=0, precision="float32"):
    jparams = jax_cfg.from_dict(_arch(neck, precision))
    tparams = torch_cfg.from_dict(_arch(neck, precision))
    ja, ta = jparams.architecture, tparams.architecture
    jdtype = jax_retinanet._compute_dtype(precision)
    tdtype = torch_retinanet._compute_dtype(precision)
    jneck = jax_retinanet.build_neck(ja, ja.conv_2d, ja.batch_norm,
                                     jax.nn.relu, jdtype)
    feats = _features("even", seed)
    variables = jax.eval_shape(
        lambda: jneck.init(jax.random.PRNGKey(0), feats, train=False))
    variables = _random_variables(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, seed)
    tneck = torch_retinanet.build_neck(ta, CHANNELS, ta.batch_norm,
                                       torch.nn.functional.relu, tdtype,
                                       device="cpu")
    load_flax_variables(tneck, variables)
    return jneck, variables, tneck.eval()


def _features(size, seed, n=2):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, (n, s, s, c)).astype(np.float32)
            for (k, c), s in zip(CHANNELS.items(), SIZES[size])}


def _apply(jmodule, variables, x, **kw):
    return jax.jit(functools.partial(jmodule.apply, **kw))(variables, x)


def _nchw(feats, dtype=torch.float32):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).to(dtype)
            for k, v in feats.items()}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _compare(jout, tout, rtol=1e-4, atol=1e-4, scale=False):
    assert sorted(tout) == sorted(jout) == ["3", "4", "5", "6", "7"]
    for level, ref in jout.items():
        ref = np.asarray(ref.astype(jnp.float32))
        got = _nhwc(tout[level])
        assert got.shape == ref.shape, level
        bound = atol * float(np.abs(ref).max()) if scale else atol
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=bound,
                                   err_msg=f"P{level}")


# each neck kind at both sizes (the training test runs every neck at the
# odd one)
EVAL_SIZES = {"fpn_p5": "even", "fpn_p5-bias-separable": "odd",
              "mlaf": "even", "mlaf-channel-attention": "odd",
              "stacked-mlaf": "even"}


@pytest.mark.parametrize("neck", sorted(NECKS))
def test_eval_forward_matches_jax_f32(neck):
    jneck, variables, tneck = _pair(neck)
    feats = _features(EVAL_SIZES[neck], seed=1)
    jout = _apply(jneck, variables, {k: jnp.asarray(v)
                                     for k, v in feats.items()},
                  train=False)
    with torch.no_grad():
        tout = tneck(_nchw(feats))
    _compare(jout, tout)
    assert tout["6"].shape[2:] == (2, 2) and tout["7"].shape[2:] == (1, 1)


@pytest.mark.parametrize("neck", sorted(NECKS))
def test_train_forward_matches_jax_f32(neck):
    """Batch statistics; the outputs and the moved running statistics. The
    MLAF projection BN normalizes B values a channel: at B = 3 the
    packages' summation-order differences (~1e-7) come out of it as up to
    2e-4 at P7, at B = 8 under 4e-5, so this runs at B = 8."""
    jneck, variables, tneck = _pair(neck, seed=2)
    feats = _features("odd", seed=3, n=8)
    jout, updates = _apply(jneck, variables,
                           {k: jnp.asarray(v) for k, v in feats.items()},
                           train=True, mutable=["batch_stats"])
    tneck.train()
    with torch.no_grad():
        tout = tneck(_nchw(feats))
    _compare(jout, tout)
    got = torch_to_flax(tneck.state_dict())["batch_stats"]
    ref = jax.tree_util.tree_flatten_with_path(updates["batch_stats"])[0]
    for path, value in ref:
        node = got
        for part in path:
            node = node[part.key]
        np.testing.assert_allclose(node, np.asarray(value), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("neck", ["fpn_p5", "mlaf-channel-attention"])
def test_mixed_bfloat16_matches_jax(neck):
    jneck, variables, tneck = _pair(neck, seed=4, precision="mixed_bfloat16")
    feats = _features("even", seed=5)
    jout = _apply(jneck, variables,
                  {k: jnp.asarray(v).astype(jnp.bfloat16)
                   for k, v in feats.items()}, train=False)
    with torch.no_grad():
        tout = tneck(_nchw(feats, torch.bfloat16))
    for level in tout:
        assert tout[level].dtype == torch.bfloat16
    _compare(jout, tout, rtol=0, atol=3e-2, scale=True)


def test_stacked_round_trip_and_structure():
    _, variables, tneck = _pair("stacked-mlaf", seed=6)
    # the lateral convs only in the first block, P6 / P7 only in the last
    assert hasattr(tneck.mlaf_1, "l3_conv")
    assert not hasattr(tneck.mlaf_2, "l3_conv")
    assert not hasattr(tneck.mlaf_1, "p6_conv")
    assert hasattr(tneck.mlaf_2, "p7_conv")
    back = torch_to_flax(tneck.state_dict())
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(np.asarray(a), b), path


def _aux_tree():
    tree = _tree(depth=10, num_convs=1)
    tree["architecture"]["auxillary_head"] = {
        "use_auxillary_head": True, "num_convs": 2, "filters": 16}
    return tree


def test_auxillary_head_matches_jax():
    """The model's three outputs, the IoU predictions (one an anchor)
    among them, in f32."""
    jmodel, variables, tmodel = _build_pair(_aux_tree(), seed=7)
    x = np.random.default_rng(8).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    jout = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
    assert sorted(tout) == sorted(jout) == [
        "box-predictions", "class-predictions", "iou-predictions"]
    for kind in jout:
        for level, ref in jout[kind].items():
            got = tout[kind][level].numpy()
            assert got.shape == np.shape(ref)
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{kind} P{level}")
    assert tout["iou-predictions"]["3"].shape == (2, 16, 16, 9)
    # prior 0.5: a bias of 0
    fresh = torch_retinanet.build_model(torch_cfg.from_dict(_aux_tree()),
                                        device="cpu")
    assert torch.equal(fresh.auxillary_head.prediction.conv.bias,
                       torch.zeros(9))


def test_serving_ignores_the_iou_predictions():
    params = torch_cfg.from_dict(_aux_tree())
    model = torch_retinanet.build_model(params, device="cpu", seed=3)
    images = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8))
    with torch.no_grad():
        with_aux = build_serving_fn(params, device="cpu", model=model)(
            images)
        model.auxillary_head = None
        without = build_serving_fn(params, device="cpu", model=model)(
            images)
    assert sorted(with_aux) == sorted(without)
    for key in with_aux:
        assert torch.equal(with_aux[key], without[key]), key


def test_conv2d_strides_and_bias():
    """`Conv2D` at stride 2 pads "SAME" as flax does: one more row at the
    end of an even size; `use_bias=False` leaves the bias out."""
    conv = torch_layers.Conv2D(3, 4, 3, strides=2, use_bias=False)
    torch_layers.init_parameters(conv, torch.Generator().manual_seed(0))
    assert conv.conv.bias is None
    x = torch.randn(1, 3, 8, 7, generator=torch.Generator().manual_seed(1))
    y = conv(x)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (1, 1, 0, 1)), conv.conv.weight,
        stride=2)
    assert y.shape == (1, 4, 4, 4)
    assert torch.equal(y, want)
