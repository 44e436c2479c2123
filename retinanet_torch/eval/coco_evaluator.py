"""COCO evaluation callback (the port's own copy of
`retinanet_tpu/eval/coco_evaluator.py`).

  * accumulate_results skips the sentinel slots (image_id == -1), slices
    the valid detections, rescales boxes from normalized model space back
    to original image pixels by each axis's resize scale, truncates them to
    int xywh, and collects COCO-format prediction dicts;
  * evaluate() writes the predictions JSON and runs the numpy bbox COCOeval
    (`eval/coco.py`), returning the five headline metrics;
  * optional remap of contiguous training class ids back to the original
    COCO category ids through the alphabetically sorted class names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from retinanet_torch.eval.coco import COCOEval, COCOIndex


class COCOEvaluator:
    def __init__(self,
                 input_shape,
                 annotation_file_path: str,
                 prediction_file_path: str = "predictions.json",
                 remap_class_ids: bool = False):
        self._input_shape = np.asarray(input_shape, np.float32)  # (h, w)
        self.annotation_file_path = annotation_file_path
        self.prediction_file_path = os.path.normpath(prediction_file_path)
        self._remap_class_ids = remap_class_ids

        self._coco = COCOIndex(annotation_file_path)

        sorted_classes = sorted(
            info["name"] for info in self._coco.cats.values())
        self._class_name_to_orig_id = {
            info["name"]: info["id"] for info in self._coco.cats.values()}
        self._sorted_id_to_name = dict(enumerate(sorted_classes))

        self._processed_detections: List[dict] = []

    @property
    def processed_detections(self) -> List[dict]:
        """COCO-result dicts accumulated so far (what evaluate() scores and
        writes to prediction_file_path)."""
        return self._processed_detections

    def _maybe_remap(self, class_id: int) -> int:
        if self._remap_class_ids:
            return self._class_name_to_orig_id[
                self._sorted_id_to_name[class_id]]
        return class_id

    def accumulate_results(self, results: Dict) -> None:
        """results: {image_id (B,), detections dict, resize_scale (B, 2)}.
        Padded eval samples carry image_id == -1 and are skipped."""
        image_ids = np.asarray(results["image_id"])
        det = {k: np.asarray(v) for k, v in results["detections"].items()}
        resize_scales = np.asarray(results["resize_scale"])

        for i in range(len(image_ids)):
            if int(image_ids[i]) < 0:
                continue  # padded slot from the static-shape val batch
            n = int(det["valid_detections"][i])
            boxes = det["boxes"][i][:n].astype(np.float64)
            classes = det["classes"][i][:n]
            scores = det["scores"][i][:n]

            # normalized (x1,y1,x2,y2) -> original-image pixels
            h, w = self._input_shape
            sy, sx = resize_scales[i]
            boxes = boxes * np.array([w, h, w, h]) / np.array(
                [sx, sy, sx, sy])

            boxes = boxes.astype(np.int32)  # reference truncates to int
            boxes[:, 2:] = boxes[:, 2:] - boxes[:, :2]  # corners -> xywh
            for box, cid, score in zip(boxes, classes, scores):
                self._processed_detections.append({
                    "image_id": int(image_ids[i]),
                    "category_id": self._maybe_remap(int(cid)),
                    "bbox": [int(v) for v in box],
                    "score": float(score),
                })

    def evaluate(self) -> Dict[str, float]:
        with open(self.prediction_file_path, "w") as f:
            json.dump(self._processed_detections, f)

        evaluator = COCOEval(self._coco, self._processed_detections)
        evaluator.evaluate()
        evaluator.accumulate()
        summary = evaluator.summarize()
        # "AR-(all)" is AR@maxDets=100 (pycocotools' stats[8])
        return {
            "AP-IoU=0.50:0.95": summary["AP-IoU=0.50:0.95"],
            "AP-IoU=0.50": summary["AP-IoU=0.50"],
            "AP-IoU=0.75": summary["AP-IoU=0.75"],
            "AR-(all)-IoU=0.50:0.95": summary["AR-(all)-IoU=0.50:0.95"],
            "AR-(L)-IoU=0.50:0.95": summary["AR-(L)-IoU=0.50:0.95"],
        }
