"""The export CLI and `evaluate_artifact` of the port, on the CPU, against
the JAX package.

  * `python -m retinanet_torch.export --int8 --int8_activations
    --calibration_mode minmax --device cpu`, in process, on a tiny config
    with no checkpoint and no val records, writes the artifact, the int8
    weights, the scales (calibrated on synthetic scenes, which the
    provenance says), the quality report and both frozen graphs; the
    int8 graph serves.
  * `evaluate_artifact` on JPEGs written by `host_codec.encode_jpeg`, with
    a COCO annotations file written here (pseudo ground truth: the
    artifact's own detections on the first images, so that AP is no
    trivial 0), gives the COCO stats of JAX's `evaluate` on the same
    artifact and images, to 1e-12; through the frozen graph the same.
  * The port's examples run on the artifact.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from retinanet_tpu.export.evaluate_artifact import \
    evaluate as jax_evaluate  # noqa: E402
from retinanet_torch.data import host_codec  # noqa: E402
from retinanet_torch.examples import inference_demo  # noqa: E402
from retinanet_torch.examples import multi_device_inference  # noqa: E402
from retinanet_torch.export.__main__ import main as export_main  # noqa: E402
from retinanet_torch.export.evaluate_artifact import evaluate  # noqa: E402
from retinanet_torch.export.serving import load_artifact  # noqa: E402
from retinanet_torch.utils.image_utils import (  # noqa: E402
    read_image, rescale_boxes)
from test_torch_threads import one_thread  # noqa: E402,F401


_FILES = ("config.json", "params.msgpack", "serving_default.pt2",
          "params_int8.msgpack", "activation_scales.json",
          "int8_activation_report.json", "serving_int8.pt2")
_SIZES = ((80, 60), (64, 64), (50, 90), (120, 100))


def _tree(model_dir):
    return {
        "experiment": {"name": "export_cli", "model_dir": str(model_dir)},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16,
                               "min_level": 3, "max_level": 5,
                               "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {
            "train_steps": 2, "save_every": 2,
            "batch_size": {"train": 2, "val": 2},
            "optimizer": {"name": "sgd", "momentum": 0.9, "lr_params": {
                "schedule_type": "piecewise_constant_decay",
                "warmup_learning_rate": 0.001, "warmup_steps": 1,
                "values": [0.01, 0.001], "boundaries": [1]}}},
        "dataloader_params": {"tfrecords": {
            "train": str(model_dir / "none-train*"),
            "val": str(model_dir / "none-val*")}},
        # seeded weights keep the class prior (scores near 0.01)
        "inference": {"batch_size": 1, "pre_nms_top_k": 200,
                      "max_detections": 10, "score_threshold": 0.005,
                      "use_approx_top_k": False},
    }


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_cli")
    config = root / "config.json"
    config.write_text(json.dumps(_tree(root / "models")))
    out = root / "artifact"
    written = export_main([
        "--config_path", str(config), "--export_dir", str(out), "--int8",
        "--int8_activations", "--calibration_mode", "minmax",
        "--calibration_batches", "2", "--device", "cpu"])
    return root, out, written


def test_cli_writes_every_file(artifact):
    _, out, written = artifact
    assert sorted(os.listdir(out)) == sorted(_FILES)
    assert all(os.path.exists(p) for p in written.values())
    scales = json.loads((out / "activation_scales.json").read_text())
    assert scales["mode"] == "minmax"
    assert scales["calibration"]["source"] == "synthetic"
    assert scales["calibration"]["used_batches"] == 2
    assert len(scales["scales"]) == 23
    report = json.loads((out / "int8_activation_report.json").read_text())
    assert report["num_calibrated_convs"] == 23
    q = load_artifact(str(out), use_exported=True, use_int8_activations=True,
                      device="cpu")
    image = np.random.default_rng(0).uniform(
        0, 255, (1, 64, 64, 3)).astype(np.float32)
    frozen = q.run_exported(image)
    for key, value in q.run_inference(image).items():
        np.testing.assert_array_equal(frozen[key], value)


def _write_images(root, module):
    """JPEGs through the port's encoder, and annotations whose boxes are
    the artifact's own detections (score >= 0.1) on the images, in pixels,
    categories named so that remapping maps class c to id c + 1."""
    image_dir = root / "images"
    image_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(3)
    images, anns = [], []
    for i, (h, w) in enumerate(_SIZES):
        rgb = (rng.uniform(0, 1, (h, w, 3))
               * np.linspace(40, 255, w)[None, :, None]).astype(np.uint8)
        path = image_dir / f"{i}.jpg"
        path.write_bytes(host_codec.encode_jpeg(rgb))
        images.append({"id": i + 1, "file_name": f"{i}.jpg", "height": h,
                       "width": w})
        batch, scale = module.prepare_image(read_image(str(path)))
        det = module.run_inference(batch)
        n = int(det["valid_detections"][0])
        boxes = rescale_boxes(det["boxes"][0][:n], (64, 64), scale,
                              clip_hw=(h, w))
        for box, cls in zip(boxes[:3], det["classes"][0][:3]):
            x1, y1, x2, y2 = (float(v) for v in box)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(cls) + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
    ann = root / "annotations.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in range(1, 6)]}))
    return image_dir, ann


def test_evaluate_artifact_equals_jax_evaluate(artifact):
    root, out, _ = artifact
    module = load_artifact(str(out), device="cpu")
    image_dir, ann = _write_images(root, module)
    want = jax_evaluate(str(out), str(image_dir), str(ann))
    got = evaluate(str(out), str(image_dir), str(ann), device="cpu")
    assert want["AP-IoU=0.50"] > 0.1, want
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, (key, got, want)
    frozen = evaluate(str(out), str(image_dir), str(ann), use_exported=True,
                      device="cpu")
    assert frozen == got
    predictions = json.loads((out / "predictions.json").read_text())
    assert predictions and {"image_id", "category_id", "bbox",
                            "score"} <= set(predictions[0])


def test_examples_run_on_the_artifact(artifact):
    root, out, _ = artifact
    module = load_artifact(str(out), device="cpu")
    image_dir, _ = _write_images(root, module)
    written = inference_demo.main([
        "--artifact_dir", str(out), "--input", str(image_dir), "--output",
        str(root / "drawn"), "--score_threshold", "0.0", "--device", "cpu"])
    assert len(written) == len(_SIZES)
    drawn = read_image(written[0])
    assert drawn.shape == (_SIZES[0][0], _SIZES[0][1], 3)
    assert not np.array_equal(drawn, read_image(str(image_dir / "0.jpg")))
    results = multi_device_inference.main([
        "--artifact_dir", str(out), "--image_dir", str(image_dir),
        "--batch_size", "3", "--device", "cpu"])
    assert [r["valid_detections"].shape[0] for r in results] == [3, 1]
