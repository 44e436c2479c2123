"""Dataset parser base class (the port's own copy of
`retinanet_tpu/tools/parser.py`): label-map and remapping-info dumps, and
the alphabetical remapping of class ids to contiguous ids."""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from typing import Dict, List, Set

log = logging.getLogger("retinanet_torch.tools")


class Parser(ABC):
    def __init__(self, download_path: str, name: str = "Parser",
                 remap_class_ids: bool = False):
        self._name = "_".join(name.lower().split())
        self._download_path = download_path
        self._remap_class_ids = remap_class_ids
        self._data: Dict[str, List[dict]] = {"train": [], "val": []}
        self._classes: Set[str] = set()
        self._class_name_to_class_id: Dict[str, int] = {}
        self._class_id_to_class_name: Dict[int, str] = {}
        self._remapping_info: Dict = {}

    def get_class_id(self, class_name: str) -> int:
        return self._class_name_to_class_id[class_name]

    def get_class_name(self, class_id: int) -> str:
        return self._class_id_to_class_name[class_id]

    def dump_label_map(self) -> None:
        """`<name>_label_map.json` in the working directory."""
        with open(self._name + "_label_map.json", "w") as f:
            json.dump(self._class_id_to_class_name, f, indent=4)

    def dump_remapping_info(self) -> None:
        """`<name>_remapping_info.json` in the working directory."""
        with open(self._name + "_remapping_info.json", "w") as f:
            json.dump(self._remapping_info, f, indent=4)

    def dump_parsed_dataset(self) -> None:
        self.dump_label_map()
        self.dump_remapping_info()

    def _remap(self) -> None:
        """Alphabetically sorted class names -> contiguous ids."""
        orig_ids = list(self._class_id_to_class_name.keys())
        sorted_classes = sorted(self._classes)
        name_to_id = {n: i for i, n in enumerate(sorted_classes)}
        id_to_name = dict(enumerate(sorted_classes))
        orig_to_new = {
            old: name_to_id[name]
            for old, name in self._class_id_to_class_name.items()}
        new_to_orig = {v: k for k, v in orig_to_new.items()}

        for samples in self._data.values():
            for sample in samples:
                sample["label"]["classes"] = [
                    orig_to_new[c] for c in sample["label"]["classes"]]

        self._class_name_to_class_id = name_to_id
        self._class_id_to_class_name = id_to_name
        self._remapping_info = {
            "sorted_classes": sorted_classes,
            "class_name_to_class_id": name_to_id,
            "class_id_to_class_name": id_to_name,
            "orig_class_id_to_remapped_class_id": orig_to_new,
            "remapped_class_id_to_orig_class_id": new_to_orig,
        }
        if orig_ids:
            log.info("Remapped %d classes from ids [%s-%s] to [0-%d]",
                     len(self._classes), min(orig_ids), max(orig_ids),
                     len(sorted_classes) - 1)

    @abstractmethod
    def _build_dataset(self) -> None:
        ...

    @property
    def name(self) -> str:
        return self._name

    @property
    def dataset(self) -> Dict[str, List[dict]]:
        return self._data

    @property
    def classes(self) -> Set[str]:
        return self._classes
