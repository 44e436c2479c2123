"""The port's own copies of the framework-free modules (config, anchors)
and its device normalizer against the JAX package's, exactly."""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data import preprocessing as jax_pre  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import anchors as torch_anchors  # noqa: E402
from retinanet_torch.data import preprocessing as torch_pre  # noqa: E402

_CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "configs", "*", "*.json")))


@pytest.mark.parametrize("path", _CONFIGS, ids=os.path.basename)
def test_config_and_anchors_match_jax(path):
    want = jax_cfg.Config(path).params
    got = torch_cfg.Config(path).params
    assert got.to_dict() == want.to_dict()
    a_want = jax_anchors.from_params(want)
    a_got = torch_anchors.from_params(got)
    np.testing.assert_array_equal(a_got.boxes, a_want.boxes)
    assert a_got.boundaries == a_want.boundaries
    assert torch_anchors.level_splits(a_got) == jax_anchors.level_splits(
        a_want)


def test_config_validation_matches_jax():
    with open(_CONFIGS[0]) as f:
        tree = json.load(f)
    tree["input"]["input_shape"] = [100, 100]
    with pytest.raises(jax_cfg.ConfigError):
        jax_cfg.from_dict(tree)
    with pytest.raises(torch_cfg.ConfigError):
        torch_cfg.from_dict(tree)


def test_device_normalizer_matches_jax():
    tree = {"experiment": {"name": "n"}, "input": {"input_shape": [32, 32]},
            "architecture": {"backbone": {"type": "resnet", "depth": 10},
                             "feature_fusion": {"min_level": 3,
                                                "max_level": 5},
                             "head": {"num_classes": 3, "num_anchors": 9}},
            "dataloader_params": {"preprocessing": {
                "mean": [123.7, 116.3, 103.5], "stddev": [58.4, 57.1, 57.4],
                "pixel_scale": 255.0}}}
    images = np.random.default_rng(0).integers(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    want = jax_pre.make_device_normalizer(jax_cfg.from_dict(tree))(
        jnp.asarray(images))
    got = torch_pre.make_device_normalizer(torch_cfg.from_dict(tree))(
        torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    dl = tree["dataloader_params"]["preprocessing"]
    np.testing.assert_allclose(
        torch_pre.normalize_image(torch.from_numpy(images).float(),
                                  dl["mean"], dl["stddev"],
                                  dl["pixel_scale"]).numpy(),
        np.asarray(jax_pre.normalize_image(
            jnp.asarray(images, jnp.float32), dl["mean"], dl["stddev"],
            dl["pixel_scale"])), rtol=1e-6, atol=1e-6)
