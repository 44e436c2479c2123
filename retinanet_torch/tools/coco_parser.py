"""COCO instances-json parser (the port's own copy of
`retinanet_tpu/tools/coco_parser.py`): `instances_{train,val}2017.json`
into samples {image path, image_id, image_height / width, label {boxes as
corners, classes}}, skipping crowd instances, invalid boxes and images
left without a box, with an optional contiguous class-id remap."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from retinanet_torch.tools.parser import Parser, log


class CocoParser(Parser):
    def __init__(self,
                 download_path: str,
                 remap_class_ids: bool = False,
                 only_mappings: bool = False,
                 only_val: bool = False,
                 skip_crowd: bool = True,
                 train_annotations_path: str =
                 "annotations/instances_train2017.json",
                 val_annotations_path: str =
                 "annotations/instances_val2017.json",
                 name: str = "COCO",
                 year: str = "2017"):
        super().__init__(download_path, name=name,
                         remap_class_ids=remap_class_ids)
        self._year = year
        self._only_mappings = only_mappings
        self._only_val = only_val
        self._skip_crowd = skip_crowd
        self.train_annotations_path = os.path.join(
            download_path, train_annotations_path)
        self.val_annotations_path = os.path.join(
            download_path, val_annotations_path)
        self._crowd_instances = {"train": 0, "val": 0}
        self._skipped_samples = {"train": 0, "val": 0}
        self._skipped_annotations = {"train": 0, "val": 0}
        self._build_dataset()
        if remap_class_ids:
            self._remap()

    @staticmethod
    def _is_box_valid(box, image_height, image_width) -> bool:
        x, y, width, height = box
        if width <= 0 or height <= 0:
            return False
        if x + width > image_width or y + height > image_height:
            return False
        return True

    def _build_split(self, annotations_path: str, split: str) -> None:
        log.info("Parsing %s split from %s", split, annotations_path)
        with open(annotations_path) as f:
            data = json.load(f)

        if not self._class_id_to_class_name:
            self._class_id_to_class_name = {
                c["id"]: c["name"] for c in data["categories"]}
            self._class_name_to_class_id = {
                c["name"]: c["id"] for c in data["categories"]}
        self._classes = set(self._class_name_to_class_id)
        if self._only_mappings:
            return

        imgs = {img["id"]: img for img in data["images"]}
        img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in data["annotations"]:
            img_to_anns[ann["image_id"]].append(ann)

        subdir = f"{split}{self._year}"
        for image_id, anns in img_to_anns.items():
            info = imgs[image_id]
            boxes, classes = [], []
            for obj in anns:
                if self._skip_crowd and obj.get("iscrowd", 0):
                    self._crowd_instances[split] += 1
                    continue
                if not self._is_box_valid(obj["bbox"], info["height"],
                                          info["width"]):
                    self._skipped_annotations[split] += 1
                    continue
                boxes.append(obj["bbox"])
                classes.append(obj["category_id"])
            if not classes:
                self._skipped_samples[split] += 1
                continue
            xywh = np.asarray(boxes, np.float64)
            corners = np.concatenate(
                [xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], axis=-1)
            self._data[split].append({
                "image": os.path.join(self._download_path, subdir,
                                      info["file_name"]),
                "image_id": image_id,
                "image_height": info["height"],
                "image_width": info["width"],
                "label": {"boxes": corners, "classes": classes},
            })

    def _build_dataset(self) -> None:
        if not self._only_val:
            self._build_split(self.train_annotations_path, "train")
        self._build_split(self.val_annotations_path, "val")
        for split in ("train", "val"):
            if self._data[split]:
                log.info("%s: %d samples (%d empty skipped, %d bad anns, "
                         "%d crowd)", split, len(self._data[split]),
                         self._skipped_samples[split],
                         self._skipped_annotations[split],
                         self._crowd_instances[split])
