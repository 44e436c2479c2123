"""The port's C++ COCO matcher (`eval/native.py`,
`csrc/host/cocoeval_native.cpp`) against its spec, the numpy matcher
(`COCOEval.evaluate(use_native=False)`): `dt_matched`, `dt_ignore` and
`num_gt` bit-equal, on detections built to sit on the IoU thresholds
(0.5, 0.75, 0.95 exactly, and every threshold to within a few ulps on
either side), crowd and ignored gts, all area ranges and detections that
carry their own "area". The summaries equal the JAX package's `COCOeval`
on its own C++ path to 1e-12."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_tpu.eval import coco as jax_coco  # noqa: E402
from retinanet_torch.eval import coco  # noqa: E402


def _on_thresholds(rng, img_id, cat_id, anns, dets, own_area):
    """A gt and detections whose IoU with it is each threshold: exactly for
    0.5, 0.75 and 0.95 (a box cut to that share of the gt's height), and
    for every threshold from a shift along x, w (1 - t) / (1 + t), whose
    rounding lands on either side."""
    side = float(rng.choice([20.0, 60.0, 150.0]))
    x, y = (float(v) for v in rng.uniform(0, 300, 2))
    w = side * float(rng.choice([1.0, 1.3, 0.77]))
    anns.append({"id": len(anns) + 1, "image_id": img_id,
                 "category_id": cat_id, "bbox": [x, y, w, side],
                 "iscrowd": 0})
    for share in (0.5, 0.75, 0.95):
        dets.append({"image_id": img_id, "category_id": cat_id,
                     "bbox": [x, y, w, side * share],
                     "score": float(rng.uniform())})
    for t in coco.IOU_THRS:
        s = w * (1 - t) / (1 + t)
        for ulps in (-2, 0, 2):
            shift = float(np.nextafter(s, np.inf if ulps > 0 else -np.inf)
                          ) if ulps else s
            det = {"image_id": img_id, "category_id": cat_id,
                   "bbox": [x + shift, y, w, side],
                   "score": float(rng.uniform())}
            if own_area and rng.uniform() < 0.3:
                det["area"] = float(rng.choice([10.0, 2000.0, 20000.0]))
            dets.append(det)


def _dataset(seed, own_area, n_images=8, n_cats=3):
    rng = np.random.default_rng(seed)
    images = [{"id": i * 5 + 2, "height": 480, "width": 640}
              for i in range(n_images)]
    cats = [{"id": c * 3 + 1, "name": f"c{c}"} for c in range(n_cats)]
    anns, dets = [], []
    for img in images:
        for _ in range(int(rng.integers(0, 3))):
            _on_thresholds(rng, img["id"], int(rng.choice(
                [c["id"] for c in cats])), anns, dets, own_area)
        for _ in range(int(rng.integers(0, 8))):
            side = float(rng.choice([12.0, 50.0, 150.0])
                         * rng.uniform(0.6, 1.4))
            box = [float(rng.uniform(0, 400)), float(rng.uniform(0, 300)),
                   side * float(rng.uniform(0.5, 2.0)), side]
            ann = {"id": len(anns) + 1, "image_id": img["id"],
                   "category_id": int(rng.choice([c["id"] for c in cats])),
                   "bbox": box, "iscrowd": int(rng.uniform() < 0.15)}
            if rng.uniform() < 0.15:
                ann["ignore"] = 1
            if rng.uniform() < 0.5:
                ann["area"] = box[2] * box[3] * float(rng.uniform(0.5, 1.5))
            anns.append(ann)
            for _ in range(int(rng.integers(0, 4))):
                jitter = rng.normal(0, 0.15 * side, 4)
                dets.append({"image_id": img["id"],
                             "category_id": ann["category_id"],
                             "bbox": [box[0] + jitter[0], box[1] + jitter[1],
                                      max(box[2] + jitter[2], 1.0),
                                      max(box[3] + jitter[3], 1.0)],
                             "score": float(rng.choice([0.5, rng.uniform()]))})
        for _ in range(int(rng.integers(0, 120))):
            dets.append({"image_id": img["id"],
                         "category_id": int(rng.choice(
                             [c["id"] for c in cats])),
                         "bbox": [float(v) for v in rng.uniform(
                             [0, 0, 2, 2], [600, 440, 200, 200])],
                         "score": float(rng.uniform())})
    return {"images": images, "annotations": anns, "categories": cats}, dets


def _evaluated(gt, dets, use_native):
    ev = coco.COCOEval(coco.COCOIndex(json.loads(json.dumps(gt))), dets)
    ev.evaluate(use_native=use_native)
    return ev


@pytest.mark.parametrize("seed", range(4))
def test_native_arrays_bit_equal_numpy(seed):
    gt, dets = _dataset(seed, own_area=True)
    spec = _evaluated(gt, dets, use_native=False)._packed
    native = _evaluated(gt, dets, use_native=None)._packed
    for key in ("dt_matched", "dt_ignore", "num_gt"):
        assert native[key].dtype == spec[key].dtype, key
        np.testing.assert_array_equal(native[key], spec[key], err_msg=key)
    # the thresholds are met on both sides: matches appear and disappear
    # from one threshold to the next
    per_thr = spec["dt_matched"][0].sum(axis=1)
    assert per_thr[0] > per_thr[-1] > 0
    assert spec["dt_ignore"].any() and spec["num_gt"].any()


def test_exact_threshold_ious_match():
    """IoU exactly 0.5, 0.75 and 0.95 in float64 is a match at that
    threshold (`iou >= best`), in both matchers."""
    gt = {"images": [{"id": 1, "height": 100, "width": 100}],
          "categories": [{"id": 1, "name": "a"}],
          "annotations": [{"id": i + 1, "image_id": 1, "category_id": 1,
                           "bbox": [0.0, 20.0 * i, 10.0, 10.0],
                           "iscrowd": 0} for i in range(3)]}
    dets = [{"image_id": 1, "category_id": 1,
             "bbox": [0.0, 20.0 * i, 10.0, 10.0 * share], "score": 0.9}
            for i, share in enumerate((0.5, 0.75, 0.95))]
    want = {0.5: [1, 1, 1], 0.75: [0, 1, 1], 0.95: [0, 0, 1]}
    for use_native in (False, True):
        p = _evaluated(gt, dets, use_native)._packed
        for thr, matched in want.items():
            t = int(np.flatnonzero(np.isclose(coco.IOU_THRS, thr))[0])
            assert p["dt_matched"][0, t].tolist() == matched, (use_native,
                                                               thr)


# (gt, detection) pairs whose IoU lies within an ulp or two of a threshold,
# found by a search against a build of the matcher with
# -ffp-contract=fast: there g++ fuses a product and a sum of the IoU into
# one FMA and decides these three on the other side of their threshold
FMA_SENSITIVE = [
    ([0.30934412623863095, 44.727587512990155, 69.93513497749133,
      146.7818566632494],
     [1.2179485031772002, 45.50323820419863, 68.80835006003618,
      141.72623673700755]),
    ([64.91553408107859, 96.43899206268443, 167.9690167523398,
      188.44169190678406],
     [66.54103490523921, 106.01297820921697, 146.02965086978776,
      162.56475405611508]),
    ([87.22026988561812, 7.817683909312867, 156.8195213932132,
      127.92105674495173],
     [87.96092445881168, 33.81435513398409, 153.71322627019003,
      91.35429375294719]),
]


def test_ious_that_a_fused_multiply_add_would_move():
    gt = {"images": [{"id": i + 1, "height": 1000, "width": 1000}
                     for i in range(len(FMA_SENSITIVE))],
          "categories": [{"id": 1, "name": "a"}],
          "annotations": [{"id": i + 1, "image_id": i + 1,
                           "category_id": 1, "bbox": g, "iscrowd": 0}
                          for i, (g, _) in enumerate(FMA_SENSITIVE)]}
    dets = [{"image_id": i + 1, "category_id": 1, "bbox": d, "score": 0.5}
            for i, (_, d) in enumerate(FMA_SENSITIVE)]
    spec = _evaluated(gt, dets, use_native=False)._packed
    native = _evaluated(gt, dets, use_native=True)._packed
    np.testing.assert_array_equal(native["dt_matched"], spec["dt_matched"])
    for g, d in FMA_SENSITIVE:
        iou = coco.box_iou_xywh(np.array([d]), np.array([g]),
                                np.zeros(1))[0, 0]
        assert np.abs(coco.IOU_THRS - iou).min() < 1e-12


def test_ignored_gts_sort_stably_after_the_others():
    """Equal IoUs against an ignored gt listed first and a kept gt listed
    second: the kept one is matched (numpy's mergesort order), and a crowd
    gt may be matched again."""
    box = [10.0, 10.0, 40.0, 40.0]
    gt = {"images": [{"id": 1, "height": 100, "width": 100}],
          "categories": [{"id": 1, "name": "a"}],
          "annotations": [
              {"id": 1, "image_id": 1, "category_id": 1, "bbox": box,
               "iscrowd": 0, "ignore": 1},
              {"id": 2, "image_id": 1, "category_id": 1, "bbox": box,
               "iscrowd": 0},
              {"id": 3, "image_id": 1, "category_id": 1,
               "bbox": [50.0, 50.0, 40.0, 40.0], "iscrowd": 1}]}
    dets = [{"image_id": 1, "category_id": 1, "bbox": box, "score": 0.9},
            {"image_id": 1, "category_id": 1, "bbox": box, "score": 0.8},
            {"image_id": 1, "category_id": 1,
             "bbox": [55.0, 55.0, 20.0, 20.0], "score": 0.7},
            {"image_id": 1, "category_id": 1,
             "bbox": [60.0, 60.0, 20.0, 20.0], "score": 0.6}]
    spec = _evaluated(gt, dets, use_native=False)._packed
    native = _evaluated(gt, dets, use_native=True)._packed
    for key in ("dt_matched", "dt_ignore", "num_gt"):
        np.testing.assert_array_equal(native[key], spec[key], err_msg=key)
    assert native["dt_matched"][0, 0].tolist() == [1, 1, 1, 1]
    assert native["dt_ignore"][0, 0].tolist() == [0, 1, 1, 1]


def test_no_groups():
    gt = {"images": [{"id": 1, "height": 10, "width": 10}],
          "categories": [{"id": 1, "name": "a"}], "annotations": []}
    for use_native in (False, True):
        p = _evaluated(gt, [], use_native)._packed
        assert p["dt_matched"].shape == (4, 10, 0)
        assert p["num_gt"].shape == (4, 0)


@pytest.mark.parametrize("seed", range(3))
def test_summaries_equal_jax_native(seed):
    """Against the JAX package's C++ path, which takes a detection's area
    from its box: the detections here carry no area of their own."""
    gt, dets = _dataset(seed + 10, own_area=False)
    ours = _evaluated(gt, dets, use_native=None)
    ours.accumulate()
    theirs = jax_coco.COCOEval(
        jax_coco.COCOIndex(json.loads(json.dumps(gt))), dets)
    theirs.evaluate(use_native=True)
    theirs.accumulate()
    np.testing.assert_allclose(ours.stats, theirs.stats, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.eval["precision"],
                               theirs.eval["precision"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.eval["recall"], theirs.eval["recall"],
                               rtol=0, atol=1e-12)
    assert (ours.stats > 0).any()
