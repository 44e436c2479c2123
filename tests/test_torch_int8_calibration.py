"""Activation calibration (`export/calibration.py`) against the JAX
package's, on the CPU.

  * The histogram bins a value as `jnp.histogram` does (the float32 edges
    of `jnp.linspace`, `searchsorted` to the right, the last edge in the
    last bin), counts equal on values placed on the edges.
  * The calibration keys are JAX's, conv path for conv path, for the three
    backbone families: ResNet10, EfficientNet-b0 (narrow) and
    MobileDet-cpu (multiplier 0.25), each with an FPN and the heads, on the
    same weights (`test_torch_model._build_pair`) and images.
  * minmax scales within rtol 1e-5 (max |x| of the same float32
    activations, up to the float convs' summation order).
The percentile and entropy modes are in
`test_torch_int8_calibration_modes.py`.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.export.calibration import \
    calibrate_activations as jax_calibrate  # noqa: E402
from retinanet_torch.export.calibration import (  # noqa: E402
    NUM_BINS, abs_histogram, calibrate_activations, histogram_edges)

from test_torch_model import _build_pair  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


_BACKBONES = {
    "resnet10": {"type": "resnet", "depth": 10},
    "efficientnet-b0-narrow": {
        "type": "efficientnet-b0",
        "override_params": {"width_coefficient": 0.25,
                            "depth_coefficient": 0.5}},
    "mobiledet-cpu-0.25": {"type": "mobiledet_cpu", "multiplier": 0.25},
}


def _tree(backbone):
    return {
        "experiment": {"name": "calibration_port"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": backbone,
            "feature_fusion": {"type": "fpn", "filters": 16,
                               "min_level": 3, "max_level": 5,
                               "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
    }


def _setup(name):
    tree = _tree(_BACKBONES[name])
    jmodel, variables, tmodel = _build_pair(tree, seed=0)
    normalize = jax.jit(jax_normalizer(jax_cfg.from_dict(tree)))
    rng = np.random.default_rng(0)
    batches = [np.asarray(normalize(rng.uniform(
        0, 255, (2, 64, 64, 3)).astype(np.float32))) for _ in range(2)]
    return jmodel, variables, tmodel.eval(), batches


def test_histogram_bins_as_jnp_histogram():
    rng = np.random.default_rng(0)
    amax = np.float32(3.7)
    edges = histogram_edges(amax)
    want_edges = np.asarray(jnp.histogram_bin_edges(
        jnp.zeros(3, jnp.float32), NUM_BINS, (0.0, float(amax))))
    np.testing.assert_array_equal(edges, want_edges)
    x = np.concatenate([
        np.abs(rng.normal(0, 1, 20000)).astype(np.float32).clip(0, amax),
        edges, np.nextafter(edges, 0, dtype=np.float32), [0.0, amax]
    ]).astype(np.float32)
    want = np.asarray(jnp.histogram(jnp.asarray(x), bins=NUM_BINS,
                                    range=(0.0, float(amax)))[0])
    got = abs_histogram(torch.from_numpy(x), torch.from_numpy(edges))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name", list(_BACKBONES))
def test_minmax_keys_and_scales_equal_jax(name):
    jmodel, variables, tmodel, batches = _setup(name)
    want = jax_calibrate(jmodel, variables, batches, mode="minmax")
    got = calibrate_activations(tmodel, batches, mode="minmax")
    assert sorted(got) == sorted(want)
    # every conv of the port has a key (the stem, depthwise, squeeze-excite,
    # neck and head convs)
    n_convs = sum(1 for m in tmodel.modules()
                  if type(m).__name__ == "ConvParams")
    assert len(got) == n_convs
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
