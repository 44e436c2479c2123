"""Sharded tfrecord writer for detection datasets (the port's own copy of
`retinanet_tpu/tools/tfrecord_writer.py`): N samples over `n_shards`
files named `{prefix}-0001.tfrecord`, ..., each of n // n_shards samples,
the last one also taking the remainder; boxes as normalized corners, the
schema of `data/tfrecord.py:make_detection_example`."""

from __future__ import annotations

import os
from typing import List

import numpy as np

from retinanet_torch.data import tfrecord
from retinanet_torch.tools.parser import log


class TFrecordWriter:
    def __init__(self, n_samples: int, n_shards: int,
                 output_dir: str = "", prefix: str = ""):
        self.n_samples = n_samples
        self.n_shards = n_shards
        self._step_size = max(n_samples // n_shards, 1)
        self.prefix = prefix
        self.output_dir = output_dir
        self._buffer: List = []
        self._file_count = 1
        self._remainder = n_samples - self._step_size * n_shards
        log.info("writing %d samples in each tfrecord", self._step_size)
        if self._remainder > 0:
            log.warning("writing %d remaining samples in last tfrecord",
                        self._remainder)

    def _path(self) -> str:
        fname = f"{self.prefix}-{self._file_count:04.0f}.tfrecord"
        return os.path.join(self.output_dir, fname)

    def _write(self) -> None:
        if not self._buffer:
            log.warning("no samples to be written")
            return
        path = self._path()
        log.info("writing %d samples in %s", len(self._buffer), path)
        with tfrecord.RecordWriter(path) as writer:
            for image, boxes, classes, image_id in self._buffer:
                writer.write(tfrecord.make_detection_example(
                    image, int(image_id), np.asarray(boxes, np.float32),
                    np.asarray(classes, np.int64)))

    def push(self, image: bytes, boxes, classes, image_id: int) -> None:
        self._buffer.append([image, boxes, classes, image_id])
        max_size = self._step_size
        if self._file_count == self.n_shards:
            max_size += max(self._remainder, 0)
        if len(self._buffer) == max_size:
            self._write()
            self._buffer = []
            self._file_count += 1

    def flush_last(self) -> None:
        if self._buffer:
            self._write()
            self._buffer = []
