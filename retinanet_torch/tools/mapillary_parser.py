"""Mapillary Traffic Sign dataset parser (the port's own copy of
`retinanet_tpu/tools/mapillary_parser.py`): per-image annotation JSONs and
split lists into the common sample format, boxes kept normalized to [0,
1]; optionally every class collapsed into `traffic_sign`, and ambiguous
instances skipped. A box is valid when its width and height are
positive."""

from __future__ import annotations

import json
import os
from typing import Dict, List

from retinanet_torch.tools.parser import Parser, log


class MapillaryParser(Parser):
    def __init__(self,
                 download_path: str,
                 image_ext: str = ".jpg",
                 discard_classes: bool = False,
                 only_val: bool = False,
                 skip_ambiguous: bool = False,
                 name: str = "Mapillary Traffic Sign"):
        super().__init__(download_path, name=name)
        self._image_ext = image_ext
        self._only_val = only_val
        self._skip_ambiguous = skip_ambiguous
        self._discard_classes = discard_classes
        self._annotation_dir = os.path.join(download_path, "annotations")
        self._splits_dir = os.path.join(download_path, "splits")
        self._images_dir = os.path.join(download_path, "images")
        self._ambiguous_instances = {"train": 0, "val": 0}
        self._skipped_samples = {"train": 0, "val": 0}
        self._skipped_annotations = {"train": 0, "val": 0}
        self._splits = self._load_splits()
        self._build_dataset()

    def _load_splits(self) -> Dict[str, List[str]]:
        splits = {}
        for split in ("train", "val"):
            path = os.path.join(self._splits_dir, split + ".txt")
            with open(path) as f:
                splits[split] = [line.strip() for line in f]
        return splits

    def _build_split(self, split: str) -> None:
        for idx, image_name in enumerate(sorted(self._splits[split])):
            ann_path = os.path.join(self._annotation_dir,
                                    image_name + ".json")
            with open(ann_path) as f:
                ann = json.load(f)
            h, w = ann["height"], ann["width"]
            boxes, classes = [], []
            for obj in ann["objects"]:
                box = [obj["bbox"]["xmin"] / w, obj["bbox"]["ymin"] / h,
                       obj["bbox"]["xmax"] / w, obj["bbox"]["ymax"] / h]
                class_name = obj["label"]
                if (class_name not in self._classes
                        and not self._discard_classes):
                    self._class_name_to_class_id[class_name] = \
                        len(self._classes) + 1
                    self._classes.add(class_name)
                if self._skip_ambiguous and obj["properties"]["ambiguous"]:
                    self._ambiguous_instances[split] += 1
                    continue
                if box[2] - box[0] <= 0 or box[3] - box[1] <= 0:
                    self._skipped_annotations[split] += 1
                    continue
                boxes.append(box)
                classes.append(1 if self._discard_classes
                               else self.get_class_id(class_name))
            if not classes:
                self._skipped_samples[split] += 1
                continue
            self._data[split].append({
                "image": os.path.join(self._images_dir,
                                      image_name + self._image_ext),
                "image_id": int(idx),
                "image_height": h,
                "image_width": w,
                "label": {"boxes": boxes, "classes": classes},
            })

    def _build_dataset(self) -> None:
        if self._discard_classes:
            self._class_name_to_class_id["traffic_sign"] = 1
            self._classes.add("traffic_sign")
            log.warning("Mapping all classes to `traffic_sign`")
        if not self._only_val:
            self._build_split("train")
        self._build_split("val")
        self._class_id_to_class_name = {
            v: k for k, v in self._class_name_to_class_id.items()}
        for split in ("train", "val"):
            log.info("%s: %d samples (%d empty, %d bad anns, %d ambiguous)",
                     split, len(self._data[split]),
                     self._skipped_samples[split],
                     self._skipped_annotations[split],
                     self._ambiguous_instances[split])
