"""The port's numpy COCOeval and `COCOEvaluator` against the JAX package's
on the CPU: the twelve summary numbers equal to 1e-12 (against both the
JAX numpy matcher and its C++ one) on random detections and annotations
with crowd boxes, all three area ranges and more detections than maxDets;
`accumulate_results` gives the same prediction dicts, with rescaling, the
class-id remap and sentinel slots."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_tpu.eval import coco as jax_coco  # noqa: E402
from retinanet_tpu.eval.coco_evaluator import (  # noqa: E402
    COCOEvaluator as JaxEvaluator)
from retinanet_torch.eval import coco  # noqa: E402
from retinanet_torch.eval.coco_evaluator import COCOEvaluator  # noqa: E402


def _dataset(seed, n_images=6, n_cats=4):
    """Annotations and detections with small (<32²), medium and large
    boxes, crowd regions, and up to 140 detections an image."""
    rng = np.random.default_rng(seed)
    images = [{"id": i * 3 + 1, "height": 480, "width": 640}
              for i in range(n_images)]
    cats = [{"id": c * 2 + 1, "name": f"cat{(7 * c) % n_cats}_{c}"}
            for c in range(n_cats)]
    anns, dets = [], []
    for img in images:
        for _ in range(int(rng.integers(0, 9))):
            side = float(rng.choice([12.0, 50.0, 150.0]) * rng.uniform(0.6,
                                                                       1.4))
            box = [float(rng.uniform(0, 400)), float(rng.uniform(0, 300)),
                   side * float(rng.uniform(0.5, 2.0)), side]
            crowd = int(rng.uniform() < 0.1)
            ann = {"id": len(anns) + 1, "image_id": img["id"],
                   "category_id": int(rng.choice([c["id"] for c in cats])),
                   "bbox": box, "iscrowd": crowd}
            if rng.uniform() < 0.5:
                ann["area"] = box[2] * box[3]
            anns.append(ann)
            # detections near the ground truth, and some elsewhere
            for _ in range(int(rng.integers(0, 4))):
                jitter = rng.normal(0, 0.15 * side, 4)
                dets.append({"image_id": img["id"],
                             "category_id": ann["category_id"],
                             "bbox": [box[0] + jitter[0], box[1] + jitter[1],
                                      max(box[2] + jitter[2], 1.0),
                                      max(box[3] + jitter[3], 1.0)],
                             "score": float(rng.uniform())})
        for _ in range(int(rng.integers(0, 140))):
            dets.append({"image_id": img["id"],
                         "category_id": int(rng.choice(
                             [c["id"] for c in cats])),
                         "bbox": [float(v) for v in rng.uniform(
                             [0, 0, 2, 2], [600, 440, 200, 200])],
                         "score": float(rng.uniform())})
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("seed", range(4))
def test_cocoeval_summaries_equal_jax(seed):
    gt, dets = _dataset(seed)
    ours = coco.COCOEval(coco.COCOIndex(json.loads(json.dumps(gt))), dets)
    ours.evaluate()
    ours.accumulate()
    for use_native in (False, None):   # the JAX numpy and C++ matchers
        theirs = jax_coco.COCOEval(
            jax_coco.COCOIndex(json.loads(json.dumps(gt))), dets)
        theirs.evaluate(use_native=use_native)
        theirs.accumulate()
        np.testing.assert_allclose(ours.stats, theirs.stats, rtol=0,
                                   atol=1e-12)
        assert ours.summarize() == pytest.approx(theirs.summarize(),
                                                 abs=1e-12)
    np.testing.assert_allclose(ours.eval["precision"],
                               theirs.eval["precision"], rtol=0, atol=1e-12)
    assert (ours.stats > 0).any() and (ours.stats != -1).any()


def test_cocoeval_perfect_detections_score_one():
    gt, _ = _dataset(1)
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
             "bbox": a["bbox"], "score": 0.9}
            for a in gt["annotations"] if not a["iscrowd"]]
    ev = coco.COCOEval(coco.COCOIndex(gt), dets)
    ev.evaluate()
    ev.accumulate()
    assert ev.summarize()["AP-IoU=0.50"] == pytest.approx(1.0)


def test_remote_annotations_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        coco.COCOIndex("gs://bucket/annotations.json")


def _results(seed, batch=4, max_det=10, sentinels=(2,)):
    rng = np.random.default_rng(seed)
    ids = np.arange(batch, dtype=np.int64) * 3 + 1
    ids[list(sentinels)] = -1
    corners = np.sort(rng.uniform(0, 1, (batch, max_det, 2, 2)), axis=2)
    boxes = np.concatenate([corners[:, :, 0], corners[:, :, 1]], -1)
    return {"image_id": ids,
            "detections": {
                "boxes": boxes.astype(np.float32),
                "scores": rng.uniform(0, 1, (batch, max_det)).astype(
                    np.float32),
                "classes": rng.integers(0, 4, (batch, max_det)).astype(
                    np.int32),
                "valid_detections": rng.integers(
                    0, max_det + 1, batch).astype(np.int32)},
            "resize_scale": rng.uniform(0.5, 2.0, (batch, 2)).astype(
                np.float32)}


@pytest.mark.parametrize("remap", [False, True], ids=["ids", "remap"])
def test_evaluator_accumulates_same_predictions(tmp_path, remap):
    gt, _ = _dataset(5)
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(gt))
    kw = dict(input_shape=(96, 128), annotation_file_path=str(ann),
              remap_class_ids=remap)
    ours = COCOEvaluator(prediction_file_path=str(tmp_path / "ours.json"),
                         **kw)
    theirs = JaxEvaluator(prediction_file_path=str(tmp_path / "jax.json"),
                          **kw)
    for seed in range(3):
        results = _results(seed)
        ours.accumulate_results(results)
        theirs.accumulate_results(results)
        assert ours.processed_detections == theirs.processed_detections
    assert ours.processed_detections
    assert not any(d["image_id"] < 0 for d in ours.processed_detections)
    # detections on images of the dataset score something
    assert ours.evaluate() == theirs.evaluate()
    assert json.loads((tmp_path / "ours.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
