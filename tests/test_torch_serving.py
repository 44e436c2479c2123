"""The whole serving slice against the JAX package: JAX `build_model` +
`make_inference_fn` (exact top-k lane) against the port's
`build_serving_fn(device="cpu")` and `ServingModule`, on the same seeded
weights (converted) and the same seeded uint8-range images.

The class bias is shifted so that a few dozen detections clear the score
threshold, and the test first checks that their scores lie more than 1e-4
apart, so that float32 rounding differences between the packages (~1e-6)
cannot reorder them. Then the detections must be the same: equal valid
counts and classes, boxes and scores within 1e-5."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.models.retinanet import \
    build_model as jax_build_model  # noqa: E402
from retinanet_tpu.ops.postprocess import \
    make_inference_fn as jax_make_inference_fn  # noqa: E402
from retinanet_torch.convert import load_flax_variables  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.export.serving import (ServingModule,  # noqa: E402
                                            build_serving_fn)
from retinanet_torch.models.retinanet import build_model  # noqa: E402

_TREE = {
    "experiment": {"name": "torch_port_serving"},
    "input": {"input_shape": [128, 128], "channels": 3},
    "floatx": {"precision": "float32"},
    "architecture": {
        "backbone": {"type": "resnet", "depth": 10},
        "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                           "max_level": 7, "backbone_max_level": 5,
                           "use_balanced_features": True},
        "head": {"num_convs": 2, "filters": 16, "num_classes": 5,
                 "num_anchors": 9},
    },
    "inference": {"mode": "PerClassHardNMS", "use_approx_top_k": False},
}
_TARGET_CANDIDATES = 40


def _variables(jmodel, seed=0):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name == "kernel":
            value = rng.normal(0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = rng.normal(0, 0.1, shape)
        return np.asarray(value, np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


def _jax_infer(jparams, jmodel, variables, images, **kw):
    fn = jax.jit(jax_make_inference_fn(
        jmodel, jparams, jax_anchors.from_params(jparams),
        jax_normalizer(jparams), compute_dtype=jnp.float32, **kw))
    out = fn(variables["params"], variables["batch_stats"], images)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def served():
    jparams = jax_cfg.from_dict(_TREE)
    jmodel = jax_build_model(jparams)
    variables = _variables(jmodel)
    bias = variables["params"]["class_head"]["prediction"]["conv"]["bias"]
    bias[:] = 0.0
    images = np.random.default_rng(1).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)
    # shift the class bias so that about _TARGET_CANDIDATES logits clear
    # the score threshold
    logits = _jax_infer(jparams, jmodel, variables, images,
                        skip_decoding=True)["class_logits"]
    thr_logit = np.log(0.05 / 0.95)
    top = np.sort(logits.reshape(-1))[::-1]
    bias[:] = thr_logit - 0.5 * (top[_TARGET_CANDIDATES - 1]
                                 + top[_TARGET_CANDIDATES])
    want = _jax_infer(jparams, jmodel, variables, images)

    tparams = torch_cfg.from_dict(_TREE)
    model = build_model(tparams, device="cpu")
    load_flax_variables(model, variables)
    return tparams, model, images, want


def test_fixture_has_separated_detections(served):
    _, _, _, want = served
    n = want["valid_detections"]
    assert 10 <= int(n.sum()) <= 2 * _TARGET_CANDIDATES, n
    for b in range(2):
        s = want["scores"][b][:n[b]]
        assert np.all(np.diff(s) < -1e-4), s


def test_serving_fn_matches_jax(served):
    tparams, model, images, want = served
    serve = build_serving_fn(tparams, device="cpu", model=model)
    got = {k: v.numpy() for k, v in serve(torch.from_numpy(images)).items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["valid_detections"],
                                  want["valid_detections"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)


def test_serving_module_contract(served):
    tparams, model, images, want = served
    out = ServingModule(tparams, model, device="cpu").run_inference(images)
    assert out["boxes"].shape == (2, 100, 4)
    assert out["scores"].shape == (2, 100)
    assert out["classes"].dtype == np.int32
    assert out["valid_detections"].dtype == np.int32
    np.testing.assert_array_equal(out["classes"], want["classes"])
    for b in range(2):
        v = int(out["valid_detections"][b])
        assert np.all(out["classes"][b][v:] == -1)
        assert np.all(np.isfinite(out["boxes"][b]))


def test_unported_serving_lanes_raise(served):
    tparams, model, _, _ = served
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_serving_fn(tparams, device="cpu", model=model,
                         int8_scales={"x": 1.0})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingModule(tparams, model, device="cpu").run_exported(None)
