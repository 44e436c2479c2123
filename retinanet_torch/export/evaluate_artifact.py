"""Evaluate an exported serving artifact against COCO annotations
(counterpart of `retinanet_tpu/export/evaluate_artifact.py`).

Loads the artifact, runs each image through read -> `prepare_image` ->
forward with a timing breakdown (the first forward, which pays the
start-up, kept apart), rescales the boxes to the original image's pixels
and scores COCO bbox AP; the detections go to `predictions.json` in the
artifact directory.

    python -m retinanet_torch.export.evaluate_artifact --artifact_dir D \
        --image_dir IMAGES --annotation_file ANNOTATIONS.json \
        [--use_exported] [--use_int8_activations] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from retinanet_torch.__main__ import _add_bool, _setup_logging

log = logging.getLogger("retinanet_torch.export.evaluate_artifact")


def evaluate(artifact_dir: str,
             image_dir: str,
             annotation_file: str,
             limit: Optional[int] = None,
             remap_class_ids: bool = True,
             use_exported: bool = False,
             use_int8_activations: bool = False,
             device=None) -> Dict[str, float]:
    from retinanet_torch.eval.coco import COCOIndex
    from retinanet_torch.eval.coco_evaluator import COCOEvaluator
    from retinanet_torch.export.serving import load_artifact
    from retinanet_torch.utils.image_utils import read_image

    module = load_artifact(artifact_dir, use_exported=use_exported,
                           use_int8_activations=use_int8_activations,
                           device=device)
    params = module.params
    evaluator = COCOEvaluator(
        input_shape=params.input.input_shape,
        annotation_file_path=annotation_file,
        prediction_file_path=os.path.join(artifact_dir, "predictions.json"),
        remap_class_ids=remap_class_ids)

    items = list(COCOIndex(annotation_file).imgs.values())
    if limit:
        items = items[:limit]

    timings = {"read": 0.0, "preprocess": 0.0, "forward": 0.0}
    run = module.run_exported if use_exported else module.run_inference
    n = 0
    first_forward = None
    for info in items:
        path = os.path.join(image_dir, info["file_name"])
        if not os.path.exists(path):
            continue
        t0 = time.perf_counter()
        image = read_image(path)
        t1 = time.perf_counter()
        batched, resize_scale = module.prepare_image(image)
        t2 = time.perf_counter()
        det = run(batched)  # numpy: the card is done when it returns
        t3 = time.perf_counter()
        timings["read"] += t1 - t0
        timings["preprocess"] += t2 - t1
        if first_forward is None:
            # the first call pays the start-up (cuDNN's choice of kernels,
            # the kernels' build): kept apart from the steady state
            first_forward = t3 - t2
        else:
            timings["forward"] += t3 - t2
        n += 1
        evaluator.accumulate_results({
            "image_id": np.asarray([info["id"]]),
            "detections": det,
            "resize_scale": resize_scale[None],
        })
    if n:
        log.info("first forward: %.2f ms", first_forward * 1000)
        for k, v in timings.items():
            warm_n = n - 1 if k == "forward" else n
            if warm_n == 0:
                log.info("%s: n/a (single image — warm timing needs >=2)", k)
            else:
                log.info("%s: %.2f ms/image", k, v / warm_n * 1000)
    scores = evaluator.evaluate()
    log.info("Evaluation: %s", scores)
    return scores


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.export.evaluate_artifact",
        description="COCO-evaluate a serving artifact on a folder of "
                    "images.")
    parser.add_argument("--artifact_dir", required=True,
                        help="Exported artifact directory")
    parser.add_argument("--image_dir", required=True,
                        help="Directory of evaluation images")
    parser.add_argument("--annotation_file", required=True,
                        help="COCO annotations json")
    parser.add_argument("--limit", type=int, default=None,
                        help="Max images to evaluate")
    _add_bool(parser, "remap_class_ids", True,
              "Map contiguous ids back to COCO category ids")
    _add_bool(parser, "use_int8_activations", False,
              "Serve through the artifact's int8-activation lane")
    _add_bool(parser, "use_exported", False,
              "Run through the frozen torch.export graph")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    _setup_logging(False, "")
    return evaluate(args.artifact_dir, args.image_dir, args.annotation_file,
                    args.limit, args.remap_class_ids, args.use_exported,
                    args.use_int8_activations, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
