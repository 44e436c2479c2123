"""The port's post-processing against the JAX package's exact lane
(`use_approx_top_k=false`) on planted, well-separated logits, as in
tests/test_inference_lanes.py: every NMS mode, with the box decode before
and after the top-k, per-class and global top-k, and the export lanes.
Classes and valid counts exact; boxes and scores to 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.ops.postprocess import \
    make_inference_fn as jax_make_inference_fn  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import anchors as torch_anchors  # noqa: E402
from retinanet_torch.data.preprocessing import \
    make_device_normalizer as torch_normalizer  # noqa: E402
from retinanet_torch.ops import postprocess as torch_pp  # noqa: E402

_MODES = ("CombinedNMS", "GlobalSoftNMS", "GlobalHardNMS",
          "PerClassSoftNMS", "PerClassHardNMS")


def _tree(mode, decode_after, per_class):
    return {
        "experiment": {"name": "torch_port_postprocess"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "inference": {"batch_size": 2, "pre_nms_top_k": 32,
                      "max_detections": 10, "mode": mode,
                      "use_approx_top_k": False,
                      "decode_after_topk": decode_after,
                      "filter_per_class": per_class},
    }


def _planted(num_classes=5, anchors_per_loc=9):
    """~30 distinct positive logits (multiples of 0.25) at scattered
    (position, anchor, class) sites, -10 elsewhere; small nonzero box
    regressions so the decode moves every box."""
    rng = np.random.default_rng(42)
    preds = {"class-predictions": {}, "box-predictions": {}}
    for level, s in {"3": 8, "4": 4, "5": 2}.items():
        cls = np.full((2, s, s, anchors_per_loc * num_classes), -10.0,
                      np.float32)
        n_sites = 10 * s // 8
        for b in range(2):
            flat = rng.choice(s * s * anchors_per_loc * num_classes,
                              size=n_sites, replace=False)
            cls[b].reshape(-1)[flat] = 2.0 + 0.25 * rng.permutation(n_sites)
        preds["class-predictions"][level] = cls
        preds["box-predictions"][level] = rng.normal(
            0.0, 0.1, (2, s, s, anchors_per_loc * 4)).astype(np.float32)
    return preds


class _JaxStub:
    def __init__(self, preds):
        self.preds = jax.tree_util.tree_map(jnp.asarray, preds)

    def apply(self, variables, images, train=False):
        return self.preds


class _TorchStub:
    def __init__(self, preds):
        self.preds = {kind: {lvl: torch.from_numpy(v) for lvl, v in m.items()}
                      for kind, m in preds.items()}

    def __call__(self, images):
        return self.preds


def _run_both(tree, skip_decoding=False, skip_nms=False):
    preds = _planted()
    images = np.zeros((2, 64, 64, 3), np.float32)
    jparams = jax_cfg.from_dict(tree)
    jfn = jax.jit(jax_make_inference_fn(
        _JaxStub(preds), jparams, jax_anchors.from_params(jparams),
        jax_normalizer(jparams), compute_dtype=jnp.float32,
        skip_decoding=skip_decoding, skip_nms=skip_nms))
    want = jax.tree_util.tree_map(np.asarray, jfn({}, {}, images))
    tparams = torch_cfg.from_dict(tree)
    tfn = torch_pp.make_inference_fn(
        _TorchStub(preds), tparams, torch_anchors.from_params(tparams),
        torch_normalizer(tparams), compute_dtype=torch.float32,
        skip_decoding=skip_decoding, skip_nms=skip_nms, device="cpu")
    got = {k: v.numpy() for k, v in tfn(torch.from_numpy(images)).items()}
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("decode_after", [False, True])
@pytest.mark.parametrize("mode", _MODES)
def test_detections_match_jax_exact_lane(mode, decode_after):
    # the Global modes take class-agnostic boxes, so a global top-k (the
    # JAX package raises on per-class boxes there, and so does the port)
    per_class = not mode.startswith("Global")
    got, want = _run_both(_tree(mode, decode_after, per_class))
    assert int(want["valid_detections"].sum()) > 0, "test needs detections"
    np.testing.assert_array_equal(got["valid_detections"],
                                  want["valid_detections"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-6)
    assert got["classes"].dtype == np.int32
    assert got["valid_detections"].dtype == np.int32


@pytest.mark.parametrize("mode", ["PerClassHardNMS", "PerClassSoftNMS"])
def test_global_top_k_matches_jax(mode):
    got, want = _run_both(_tree(mode, decode_after=True, per_class=False))
    np.testing.assert_array_equal(got["valid_detections"],
                                  want["valid_detections"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-6)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6)


@pytest.mark.parametrize("skip_decoding", [False, True])
def test_export_lanes_match_jax(skip_decoding):
    got, want = _run_both(_tree("PerClassHardNMS", False, True),
                          skip_decoding=skip_decoding, skip_nms=True)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_global_modes_refuse_per_class_boxes():
    params = torch_cfg.from_dict(_tree("GlobalHardNMS", False, True))
    fused = torch_pp.fuse_predictions(_TorchStub(_planted()).preds, 3, 5)
    with pytest.raises(ValueError):
        torch_pp.make_postprocess_fn(
            params, torch_anchors.from_params(params), "cpu")(fused)


def test_top_k_breaks_ties_toward_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    values, idx = torch_pp.top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = torch_cfg.from_dict(_tree("PerClassHardNMS", False, True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_pp.make_postprocess_fn(params,
                                     torch_anchors.from_params(params))
