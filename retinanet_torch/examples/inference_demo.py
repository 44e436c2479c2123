"""Single-image or folder inference with an exported artifact (counterpart
of the root `examples/inference_demo.py`): each image goes through
`prepare_image` and the serving function, and its detections are drawn on
it and written as a PNG.

    python -m retinanet_torch.examples.inference_demo --artifact_dir export/ \
        --input image.jpg --output out.png [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

log = logging.getLogger("retinanet_torch.examples.inference_demo")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.examples.inference_demo",
        description="Draw an artifact's detections on images.")
    parser.add_argument("--artifact_dir", required=True,
                        help="Exported serving artifact")
    parser.add_argument("--input", required=True,
                        help="Image file (JPEG or PNG) or directory")
    parser.add_argument("--output", default="detections",
                        help="Output PNG file, or directory for a folder")
    parser.add_argument("--score_threshold", type=float, default=0.3,
                        help="Visualization threshold")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the paths written."""
    args = build_parser().parse_args(argv)
    from retinanet_torch.__main__ import _setup_logging
    from retinanet_torch.export.serving import load_artifact
    from retinanet_torch.utils.image_utils import (draw_detections,
                                                   read_image, rescale_boxes,
                                                   write_png)
    _setup_logging(False, "")
    module = load_artifact(args.artifact_dir, device=args.device)
    params = module.params

    paths = ([os.path.join(args.input, f)
              for f in sorted(os.listdir(args.input))]
             if os.path.isdir(args.input) else [args.input])
    out_is_dir = os.path.isdir(args.input)
    if out_is_dir:
        os.makedirs(args.output, exist_ok=True)

    written = []
    for path in paths:
        image = read_image(path)
        batched, resize_scale = module.prepare_image(image)
        det = module.run_inference(batched)
        n = int(det["valid_detections"][0])
        boxes = rescale_boxes(det["boxes"][0][:n], params.input.input_shape,
                              resize_scale, clip_hw=image.shape[:2])
        rendered = draw_detections(
            image, boxes, det["scores"][0][:n], det["classes"][0][:n],
            score_threshold=args.score_threshold)
        out_path = (os.path.join(args.output, os.path.splitext(
            os.path.basename(path))[0] + ".png")
            if out_is_dir else args.output)
        write_png(out_path, rendered)
        written.append(out_path)
        log.info("%s: %d detections -> %s", path, n, out_path)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
