"""Export artifacts (`export/serving.py`) against the JAX package's, on the
CPU.

  * A port-written artifact round-trips: loaded back, its detections equal
    those of the model it was written from.
  * Artifacts are interchangeable: the port serves a JAX-written artifact
    (`export_artifact(..., serialize_stablehlo=False)`) and JAX's
    `load_artifact` serves a port-written one, both at
    `test_torch_serving.py`'s bounds: valid counts and classes equal,
    boxes and scores within atol 1e-5 (float32 rounding; the class bias is
    shifted so that the detections' scores lie more than 1e-4 apart).
  * The 'tf_tensorrt' and 'onnx' modes give JAX's keys and values (the
    decoded top-k at 1e-5; the raw fused maps at rtol = atol = 1e-4, the
    model's bound in `test_torch_model.py`).
  * `prepare_image` is bit-equal to JAX's.
  * `run_exported` (the `torch.export` graph) is bit-equal to
    `run_inference`, pads a batch of 1 to the frozen batch of 2 and raises
    for 3; a missing graph raises FileNotFoundError at load for both
    lanes.
  * `Executor(run_mode="export")` builds and restores; its `run()` raises.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.export import serving as jax_serving  # noqa: E402
from retinanet_torch.convert import load_flax_variables  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.export import serving  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402

from test_torch_model import _build_pair  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


_TREE = {
    "experiment": {"name": "export_port"},
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
    "inference": {"batch_size": 2, "pre_nms_top_k": 200,
                  "max_detections": 10, "mode": "PerClassHardNMS",
                  "use_approx_top_k": False},
}
_TARGET_CANDIDATES = 12
ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """JAX and port models on the same seeded weights, the class bias
    shifted so that about _TARGET_CANDIDATES scores clear the threshold,
    and raw images."""
    jmodel, variables, tmodel = _build_pair(_TREE, seed=0)
    jparams = jax_cfg.from_dict(_TREE)
    images = np.random.default_rng(1).uniform(
        0, 255, (2, 64, 64, 3)).astype(np.float32)
    tparams = torch_cfg.from_dict(_TREE)
    tmodel.eval()
    bias = variables["params"]["class_head"]["prediction"]["conv"]["bias"]
    bias[:] = 0.0
    load_flax_variables(tmodel, variables)
    fused = serving.build_serving_fn(tparams, "onnx", device="cpu",
                                     model=tmodel)(torch.from_numpy(images))
    top = np.sort(fused["class_logits"].numpy().reshape(-1))[::-1]
    bias[:] = np.log(0.05 / 0.95) - 0.5 * (top[_TARGET_CANDIDATES - 1]
                                           + top[_TARGET_CANDIDATES])
    load_flax_variables(tmodel, variables)
    return jparams, variables, tparams, tmodel, images


def _assert_same_detections(got, want):
    np.testing.assert_array_equal(got["valid_detections"],
                                  want["valid_detections"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=ATOL)


def test_artifacts_are_interchangeable(pair, tmp_path):
    jparams, variables, tparams, tmodel, images = pair
    # the port writes, JAX serves
    written = serving.export_artifact(tparams, tmodel, str(tmp_path / "pt"),
                                      serialize_graph=False)
    assert set(written) == {"config", "weights"}
    jax_module = jax_serving.load_artifact(str(tmp_path / "pt"))
    want = jax.tree_util.tree_map(np.asarray,
                                  jax_module.run_inference(images))
    n = want["valid_detections"]
    assert 4 <= int(n.sum()) <= 3 * _TARGET_CANDIDATES, n
    for b in range(2):
        assert np.all(np.diff(want["scores"][b][:n[b]]) < -1e-4)
    _assert_same_detections(
        serving.ServingModule(tparams, tmodel, "cpu").run_inference(images),
        want)
    # JAX writes, the port serves
    jax_serving.export_artifact(jparams, variables["params"],
                                variables["batch_stats"],
                                str(tmp_path / "jax"),
                                serialize_stablehlo=False)
    module = serving.load_artifact(str(tmp_path / "jax"), device="cpu")
    _assert_same_detections(module.run_inference(images), want)
    # and the port's artifact round-trips in the port: same weights, same
    # detections
    back = serving.load_artifact(str(tmp_path / "pt"), device="cpu")
    for name, value in tmodel.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], value), name
    got = back.run_inference(images)
    same = serving.ServingModule(tparams, tmodel, "cpu").run_inference(
        images)
    for key in got:
        np.testing.assert_array_equal(got[key], same[key])


@pytest.mark.parametrize("mode", ["tf_tensorrt", "onnx"])
def test_export_modes_give_jax_keys_and_values(pair, mode):
    jparams, variables, tparams, tmodel, images = pair
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_serving.build_serving_fn(jparams, mode))(
            variables["params"], variables["batch_stats"], images))
    got = serving.build_serving_fn(tparams, mode, device="cpu",
                                   model=tmodel)(torch.from_numpy(images))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    if mode == "onnx":
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
        return
    # the decoded pre-NMS top-k: scores (B, k, C) in descending order; two
    # candidates closer than the packages' score difference may come in
    # either order, so the boxes are compared where both neighbours are
    # more than twice that difference away
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL)
    s = want["scores"]
    err = np.abs(got["scores"] - s).max()
    gap = np.full(s.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], s[:, :-1] - s[:, 1:])
    gap[:, :-1] = np.minimum(gap[:, :-1], s[:, :-1] - s[:, 1:])
    apart = gap > 2 * err
    assert apart.mean() > 0.9, (apart.mean(), err)
    np.testing.assert_allclose(got["boxes"][apart], want["boxes"][apart],
                               rtol=0, atol=ATOL)


def test_prepare_image_is_bit_equal(pair, tmp_path):
    jparams, variables, tparams, tmodel, _ = pair
    jax_serving.export_artifact(jparams, variables["params"],
                                variables["batch_stats"], str(tmp_path),
                                serialize_stablehlo=False)
    jax_module = jax_serving.load_artifact(str(tmp_path))
    module = serving.load_artifact(str(tmp_path), device="cpu")
    rng = np.random.default_rng(2)
    for shape in ((128, 96, 3), (37, 90, 3), (64, 64, 3), (200, 31, 3)):
        image = rng.integers(0, 256, shape).astype(np.uint8)
        got, got_scale = module.prepare_image(image)
        want, want_scale = jax_module.prepare_image(image)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_scale, want_scale)


def test_frozen_graph_equals_the_rebuilt_function(pair, tmp_path):
    _, _, tparams, tmodel, images = pair
    written = serving.export_artifact(tparams, tmodel, str(tmp_path))
    assert written["graph"].endswith("serving_default.pt2")
    module = serving.load_artifact(str(tmp_path), use_exported=True,
                                   device="cpu")
    want = module.run_inference(images)
    got = module.run_exported(images)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    one = module.run_exported(images[:1])       # padded to the frozen 2
    for key in want:
        assert one[key].shape[0] == 1
        np.testing.assert_array_equal(one[key], want[key][:1])
    with pytest.raises(ValueError, match="exceeds the frozen"):
        module.run_exported(np.concatenate([images, images[:1]]))


def test_missing_graph_raises_for_both_lanes(pair, tmp_path):
    _, _, tparams, tmodel, _ = pair
    serving.export_artifact(tparams, tmodel, str(tmp_path),
                            serialize_graph=False)
    with pytest.raises(FileNotFoundError, match="serving_default.pt2"):
        serving.load_artifact(str(tmp_path), use_exported=True,
                              device="cpu")
    (tmp_path / "activation_scales.json").write_text(
        '{"scales": {"backbone/stem/conv": 0.01}}')
    with pytest.raises(FileNotFoundError, match="int8"):
        serving.load_artifact(str(tmp_path), use_exported=True,
                              use_int8_activations=True, device="cpu")
    (tmp_path / "activation_scales.json").unlink()
    with pytest.raises(FileNotFoundError, match="int8_activations"):
        serving.load_artifact(str(tmp_path), use_int8_activations=True,
                              device="cpu")


def test_executor_export_mode_builds_and_run_raises(tmp_path):
    tree = dict(_TREE, training={
        "train_steps": 2, "save_every": 2,
        "batch_size": {"train": 2, "val": 2},
        "optimizer": {"name": "sgd", "momentum": 0.9,
                      "lr_params": {
                          "schedule_type": "piecewise_constant_decay",
                          "warmup_learning_rate": 0.001, "warmup_steps": 1,
                          "values": [0.01, 0.001], "boundaries": [1]}}},
        experiment={"name": "export_port", "model_dir": str(tmp_path)})
    ex = Executor(torch_cfg.from_dict(tree), run_mode="export",
                  device="cpu")
    try:
        assert ex.latest_checkpoint_step() is None
        assert sum(p.numel() for p in ex.model.parameters()) > 0
        with pytest.raises(ValueError, match="not supported for mode"):
            ex.run()
    finally:
        ex.close()
