"""A parsed dataset's JSON -> COCO-format annotations, for evaluating on a
custom dataset (the port's own copy of
`retinanet_tpu/tools/coco_converter.py`, the same flags and the same
JSON): boxes arrive normalized to [0, 1], are optionally rescaled to an
image resized to a largest side, and leave as COCO xywh.

    python -m retinanet_torch.tools.coco_converter \
        --parsed_dataset_json ... --label_map ... --output_dir ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from retinanet_torch.tools.parser import log


class COCOConverter:
    def __init__(self,
                 parsed_dataset_json: str,
                 label_map: str,
                 output_dir: str = "./dataset",
                 resize_max_side: int = 0,
                 only_val: bool = True):
        with open(parsed_dataset_json) as f:
            self.parsed_dataset = json.load(f)
        with open(label_map) as f:
            self.label_map: Dict[str, str] = json.load(f)
        self.output_dir = output_dir
        self.resize_max_side = resize_max_side
        self._only_val = only_val

    def _convert_split(self, split: str, categories) -> None:
        out = {"info": {}, "licenses": [{"id": 1, "name": "", "url": ""}],
               "categories": categories, "images": [], "annotations": []}
        for sample in self.parsed_dataset["dataset"][split]:
            out["images"].append({
                "id": int(sample["image_id"]),
                "license": 1,
                "width": sample["image_width"],
                "height": sample["image_height"],
                "file_name": os.path.basename(sample["image"]),
            })
            labels = sample["label"]
            for box, class_id in zip(labels["boxes"], labels["classes"]):
                for coordinate in box:
                    if coordinate < 0 or coordinate > 1:
                        raise AssertionError(f"Invalid box {box}")
                x1, y1, x2, y2 = box
                h, w = sample["image_height"], sample["image_width"]
                if self.resize_max_side and max(h, w) > self.resize_max_side:
                    scale = self.resize_max_side / max(h, w)
                    h, w = int(h * scale), int(w * scale)
                x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
                out["annotations"].append({
                    "id": len(out["annotations"]),
                    "image_id": int(sample["image_id"]),
                    "iscrowd": 0,
                    "category_id": class_id,
                    "segmentation": [1],
                    "area": float((x2 - x1) * (y2 - y1)),
                    "bbox": [float(x1), float(y1),
                             float(x2 - x1), float(y2 - y1)],
                })
        path = os.path.join(self.output_dir, f"instances_{split}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=4)
        log.info("Converted %d samples / %d annotations from %s -> %s",
                 len(self.parsed_dataset["dataset"][split]),
                 len(out["annotations"]), split, path)

    def convert(self) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        categories = [
            {"supercategory": int(cid), "id": int(cid), "name": name}
            for cid, name in self.label_map.items()]
        if not self._only_val:
            self._convert_split("train", categories)
        self._convert_split("val", categories)


def build_parser() -> argparse.ArgumentParser:
    from retinanet_torch.__main__ import _add_bool
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.tools.coco_converter",
        description="Parsed dataset JSON -> COCO-format annotations.")
    parser.add_argument("--parsed_dataset_json", required=True,
                        help="Path to the parsed dataset json")
    parser.add_argument("--label_map", required=True,
                        help="Path to the parsed label map")
    parser.add_argument("--output_dir", default="./converted_dataset",
                        help="Output directory")
    parser.add_argument("--resize_max_side", type=int, default=0,
                        help="Resize max side to this value")
    _add_bool(parser, "only_val", False, "Only convert the val split")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    from retinanet_torch.__main__ import _setup_logging
    args = build_parser().parse_args(argv)
    _setup_logging(False, "")
    COCOConverter(args.parsed_dataset_json, args.label_map, args.output_dir,
                  args.resize_max_side, args.only_val).convert()


if __name__ == "__main__":
    main(sys.argv[1:])
