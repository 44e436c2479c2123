"""The port's model against the JAX model on converted weights, in eval
mode, on the CPU.

Every variable is drawn with numpy from a seed (BN statistics and gammas
too, so no residual branch is zero as it is at init), converted with
`retinanet_torch.convert` and run through both packages on the same images.
float32 bound: rtol = atol = 1e-4 (the two convolutions sum in different
orders). mixed_bfloat16 bound: 3e-2 of the largest output magnitude (both
packages round the activations to bf16 after every conv and BN, at
slightly different points)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models import retinanet as jax_retinanet  # noqa: E402
from retinanet_torch.convert import flax_to_torch, \
    load_flax_variables  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.models import retinanet as torch_retinanet  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


def _tree(depth=10, size=(128, 128), max_level=7, precision="float32",
          fusion="sum", separable=False, num_convs=2):
    return {
        "experiment": {"name": "torch_port_model"},
        "input": {"input_shape": list(size), "channels": 3},
        "floatx": {"precision": precision},
        "architecture": {
            "conv_2d": {"use_seperable_conv": separable},
            "backbone": {"type": "resnet", "depth": depth},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": max_level,
                               "backbone_max_level": 5,
                               "use_balanced_features": True,
                               "fusion_mode": fusion},
            "head": {"num_convs": num_convs, "filters": 16,
                     "num_classes": 5, "num_anchors": 9},
        },
    }


def _random_variables(variables, seed):
    """Replace every leaf with seeded numpy values of a sensible scale."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        if name.endswith("_level_weight"):
            return rng.uniform(0.2, 1.0, shape)
        return rng.normal(0, 0.1, shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(draw(path, leaf), np.float32), variables)


def _build_pair(tree, seed=0):
    jparams = jax_cfg.from_dict(tree)
    jmodel = jax_retinanet.build_model(jparams)
    h, w = jparams.input.input_shape
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3), jnp.float32),
                            train=False))
    variables = _random_variables(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, seed)
    tmodel = torch_retinanet.build_model(torch_cfg.from_dict(tree),
                                         device="cpu")
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _apply(jmodel, variables, images, train=False):
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=train))(
        variables, images)


def _images(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (2,) + tuple(shape) + (3,)).astype(np.float32)


def _nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1).float().numpy()


def _compare_outputs(jout, tout, rtol, atol):
    n = 0
    for kind in ("class-predictions", "box-predictions"):
        assert sorted(jout[kind]) == sorted(tout[kind])
        for level, ref in jout[kind].items():
            got = tout[kind][level].float().numpy()
            ref = np.asarray(ref, np.float32)
            assert got.shape == ref.shape, (kind, level)
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=f"{kind} P{level}")
            n += 1
    return n


@pytest.mark.parametrize("depth", [10, 50])
def test_backbone_and_heads_match_jax_f32(depth):
    tree = _tree(depth=depth)
    jmodel, variables, tmodel = _build_pair(tree)
    x = _images((128, 128))
    jout = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
        feats = tmodel.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _compare_outputs(jout, tout, 1e-4, 1e-4) == 10

    jfeats = _apply(jmodel.backbone,
                    {"params": variables["params"]["backbone"],
                     "batch_stats": variables["batch_stats"]["backbone"]},
                    jnp.asarray(x))
    assert sorted(feats) == ["2", "3", "4", "5"]
    for level in feats:
        np.testing.assert_allclose(_nchw_to_nhwc(feats[level]),
                                   np.asarray(jfeats[level]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"C{level}")


@pytest.mark.parametrize("fusion,separable",
                         [("fast_attention", False),
                          ("fast_channel_attention", True)])
def test_fusion_modes_and_separable_convs_match_jax(fusion, separable):
    tree = _tree(fusion=fusion, separable=separable, num_convs=1)
    jmodel, variables, tmodel = _build_pair(tree, seed=3)
    x = _images((128, 128), seed=4)
    jout = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
    _compare_outputs(jout, tout, 1e-4, 1e-4)


def test_levels_that_do_not_divide_evenly():
    """72x88 images, levels 3..5: C5 is 3x3 against P4's 5x6, so
    BalanceFeatures resizes by non-integer factors both ways (jax's
    half-pixel nearest rule) and the FPN crops its upsampled maps."""
    tree = _tree(max_level=5, size=(64, 64))
    jmodel, variables, tmodel = _build_pair(tree, seed=5)
    x = _images((72, 88), seed=6)
    jout = _apply(jmodel, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
    assert tuple(tout["class-predictions"]["5"].shape) == (2, 3, 3, 45)
    assert tuple(tout["class-predictions"]["4"].shape) == (2, 5, 6, 45)
    _compare_outputs(jout, tout, 1e-4, 1e-4)


def test_mixed_bfloat16_matches_jax():
    tree = _tree(precision="mixed_bfloat16")
    jmodel, variables, tmodel = _build_pair(tree, seed=7)
    x = _images((128, 128), seed=8)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jout = _apply(jmodel, variables, jx, train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x).to(torch.bfloat16))
    for kind in ("class-predictions", "box-predictions"):
        for level, ref in jout[kind].items():
            got = tout[kind][level]
            assert got.dtype == torch.float32   # prediction conv in f32
            ref = np.asarray(ref, np.float32)
            bound = 3e-2 * float(np.abs(ref).max())
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=bound,
                                       err_msg=f"{kind} P{level}")


def test_flagship_parameter_count():
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "configs", "v3-8",
                        "mscoco-retinanet-resnet50-640x640-30x-64.json")
    with open(path) as f:
        params = torch_cfg.from_dict(json.load(f))
    model = torch_retinanet.build_model(params, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 34_389_556
    assert sum(b.numel() for b in model.buffers()) == 78_208


def test_converter_rejects_leftover_leaves():
    tree = _tree()
    _, variables, tmodel = _build_pair(tree)
    extra = dict(variables["params"])
    extra["stray"] = {"kernel": np.zeros((1, 1, 3, 4), np.float32)}
    with pytest.raises(KeyError):
        load_flax_variables(tmodel, {"params": extra,
                                     "batch_stats": variables["batch_stats"]})
    missing = dict(variables["params"])
    del missing["class_head"]
    with pytest.raises(KeyError):
        load_flax_variables(tmodel, {"params": missing,
                                     "batch_stats": variables["batch_stats"]})
    with pytest.raises(KeyError):
        flax_to_torch({"params": {"x": {"weird": np.zeros(3)}}})


def _jax_counts(tree):
    """(parameters, BN statistics) of the JAX model of `tree`, by
    `jax.eval_shape` (nothing is computed)."""
    model = jax_retinanet.build_model(jax_cfg.from_dict(tree))
    v = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 128, 128, 3)),
                                            train=False),
                       jax.random.PRNGKey(0))
    return (sum(p.size for p in jax.tree_util.tree_leaves(v["params"])),
            sum(p.size for p in jax.tree_util.tree_leaves(
                v["batch_stats"])))


def _torch_counts(tree):
    model = torch_retinanet.build_model(torch_cfg.from_dict(tree),
                                        device="meta")
    return (sum(p.numel() for p in model.parameters()),
            sum(b.numel() for b in model.buffers()))


@pytest.mark.parametrize("arch", [
    {"backbone": {"type": "efficientnet-b0"}},
    {"feature_fusion": {"type": "fpn_p5"}},
    {"auxillary_head": {"use_auxillary_head": True}},
], ids=["efficientnet", "fpn_p5", "auxillary_head"])
def test_zoo_options_build(arch):
    """The options that raised before the zoo was ported now build, and
    their counts equal JAX's."""
    tree = _tree()
    for key, value in arch.items():
        tree["architecture"][key] = {**tree["architecture"].get(key, {}),
                                     **value}
    model = torch_retinanet.build_model(torch_cfg.from_dict(tree),
                                        device="meta")
    assert (model.auxillary_head is not None) == ("auxillary_head" in arch)
    assert _torch_counts(tree) == _jax_counts(tree)
