"""Host input pipeline: tfrecords -> fixed-shape numpy batches (counterpart
of `retinanet_tpu/data/pipeline.py`; for the same files and seed it yields
the same batches in the same order).

  * file list globbed and shuffled with seed 1337
  * multi-host sharding of the file list by process index
  * train: infinite repeat (file order reshuffled each epoch), sample
    shuffle buffer, per-sample augmentation on the host with a per-sample
    seed, fixed-shape padded ground truth, drop-remainder batching
  * val: one epoch, resize-with-pad, the final partial batch padded with
    image_id == -1 sentinels; `val_shard_*` lets a host decode only its
    slice of every global batch
  * records indexed and parsed by the C++ reader
    (`data/host_codec.py:read_records`, `parse_detection_example`), as the
    JAX package reads them
  * parallel parse and decode on a thread pool (the native code releases
    the GIL) behind a sliding submission window. Threads only: no process
    is forked after the card is initialised.
  * `stage_seconds`: the seconds spent in each stage, summed over the
    threads that run it: read (the producer), parse, decode and preprocess
    (the workers), collate (the producer); `stage_samples` counts the
    samples the workers finished

Label encoding (anchor matching) is not done here: it runs on the card
inside the train step.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from retinanet_torch.data import host_codec, tfrecord
from retinanet_torch.data.preprocessing import HostPreprocessor

_RUN_MODES = ("train", "val")
_FILE_SHUFFLE_SEED = 1337
STAGES = ("read", "parse", "decode", "preprocess", "collate")


class InputPipeline:
    """Iterable over fixed-shape numpy batches. `batch_size` is the
    per-process batch (global batch / process_count under multi-host)."""

    def __init__(self,
                 run_mode: str,
                 params,
                 is_multi_host: bool = False,
                 process_index: int = 0,
                 process_count: int = 1,
                 batch_size: Optional[int] = None,
                 max_boxes: Optional[int] = None,
                 num_workers: int = 16,
                 prefetch: int = 4,
                 seed: int = 1337,
                 val_shard_index: int = 0,
                 val_shard_count: int = 1):
        if run_mode not in _RUN_MODES:
            raise ValueError(f"run_mode must be one of {_RUN_MODES}")
        if val_shard_count > 1 and run_mode != "val":
            raise ValueError("val_shard_* only applies to run_mode='val'")
        # every host walks the same record stream but decodes only its
        # contiguous batch_size slice of each global batch of
        # batch_size * val_shard_count samples; all emit the same number of
        # (sentinel-padded) batches
        self.val_shard_index = int(val_shard_index)
        self.val_shard_count = int(val_shard_count)
        self.run_mode = run_mode
        self.params = params
        self.max_boxes = int(
            max_boxes if max_boxes is not None
            else params.encoder_params.get("max_boxes", 100))
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed

        pattern = (params.dataloader_params.tfrecords.train
                   if run_mode == "train"
                   else params.dataloader_params.tfrecords.val)
        files = tfrecord.list_files(pattern)
        rng = np.random.default_rng(_FILE_SHUFFLE_SEED)
        files = list(np.array(files)[rng.permutation(len(files))])
        if is_multi_host:
            files = files[process_index::process_count]
            if not files:
                raise ValueError(
                    f"Host {process_index}/{process_count} got no tfrecords")
        self.files = files

        if batch_size is None:
            batch_size = (params.training.batch_size.train
                          if run_mode == "train"
                          else params.training.batch_size.val)
            if is_multi_host:
                batch_size //= process_count
        self.batch_size = int(batch_size)

        self.shuffle_buffer = int(
            params.dataloader_params.get("shuffle_buffer_size", 1024))
        self.preprocessor = HostPreprocessor(params, max_boxes=self.max_boxes)
        if run_mode == "val":
            # no augmentation on the val path
            self.preprocessor.use_augmentation = False
            self.preprocessor.horizontal_flip = False
            self.preprocessor.jitter = None
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.stage_samples = 0
        self._stage_lock = threading.Lock()

    def _add_seconds(self, samples: int = 0, **seconds: float) -> None:
        with self._stage_lock:
            self.stage_samples += samples
            for stage, value in seconds.items():
                self.stage_seconds[stage] += value

    # -- sample streams ------------------------------------------------------

    def _record_stream(self, epochs: Optional[int]) -> Iterator[bytes]:
        epoch = 0
        rng = np.random.default_rng(self.seed)
        while epochs is None or epoch < epochs:
            files = list(self.files)
            if self.run_mode == "train":
                files = list(np.array(files)[rng.permutation(len(files))])
            for path in files:
                records = host_codec.read_records(path)
                while True:
                    start = time.perf_counter()
                    record = next(records, None)
                    self._add_seconds(read=time.perf_counter() - start)
                    if record is None:
                        break
                    yield record
            epoch += 1

    def _shuffled(self, stream: Iterator[bytes]) -> Iterator[bytes]:
        if self.run_mode != "train" or self.shuffle_buffer <= 1:
            yield from stream
            return
        rng = np.random.default_rng(self.seed + 1)
        buf: List[bytes] = []
        for item in stream:
            buf.append(item)
            if len(buf) >= self.shuffle_buffer:
                idx = rng.integers(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    # -- per-sample work (runs in worker threads) ----------------------------

    def _parse_decode(self, record: bytes) -> tuple:
        """(sample, image, perf_counter at start, after parse, after
        decode)."""
        t0 = time.perf_counter()
        sample = host_codec.parse_detection_example(record)
        t1 = time.perf_counter()
        image = host_codec.decode_jpeg(sample["image"])
        return sample, image, t0, t1, time.perf_counter()

    def _process_train(self, record: bytes, sample_seed: int) -> Dict:
        sample, image, t0, t1, t2 = self._parse_decode(record)
        rng = np.random.default_rng(sample_seed)
        out = self.preprocessor(
            image, sample["boxes"], sample["classes"], rng)
        self._add_seconds(1, parse=t1 - t0, decode=t2 - t1,
                          preprocess=time.perf_counter() - t2)
        return out

    def _process_val(self, record: bytes) -> Dict:
        sample, image, t0, t1, t2 = self._parse_decode(record)
        out, resize_scale = self.preprocessor.resize_with_pad(image)
        self._add_seconds(1, parse=t1 - t0, decode=t2 - t1,
                          preprocess=time.perf_counter() - t2)
        return {"image": out, "image_id": np.int64(sample["image_id"]),
                "resize_scale": resize_scale}

    # -- batching -------------------------------------------------------------

    def _collate(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _sentinel_val(self) -> Dict:
        """A padding sample: ignored by eval (image_id == -1 sentinel)."""
        th, tw = self.preprocessor.target_h, self.preprocessor.target_w
        return {"image": np.zeros((th, tw, 3), np.uint8),
                "image_id": np.int64(-1),
                "resize_scale": np.ones(2, np.float32)}

    def _val_slots(self, stream: Iterator[bytes]) -> Iterator[Optional[bytes]]:
        """This host's contiguous batch_size slice of each global batch of
        batch_size * val_shard_count records (None = sentinel slot,
        including the final batch's padding)."""
        global_bs = self.batch_size * self.val_shard_count
        lo = self.val_shard_index * self.batch_size
        chunk: List[bytes] = []
        for rec in stream:
            chunk.append(rec)
            if len(chunk) == global_bs:
                mine = chunk[lo:lo + self.batch_size]
                yield from mine
                yield from [None] * (self.batch_size - len(mine))
                chunk = []
        if chunk:
            mine = chunk[lo:lo + self.batch_size]
            yield from mine
            yield from [None] * (self.batch_size - len(mine))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        is_train = self.run_mode == "train"
        stream = self._shuffled(self._record_stream(None if is_train else 1))
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stopped early never drains the queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # sliding submission window: ~2x workers of samples in flight,
            # so the pool never drains while a batch is collected
            depth = max(self.num_workers * 2, self.batch_size + 1)
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    window: collections.deque = collections.deque()
                    batch: List = []
                    counter = self.seed * 1_000_003

                    def drain_one() -> bool:
                        nonlocal batch
                        batch.append(window.popleft().result())
                        if len(batch) == self.batch_size:
                            full, batch = batch, []
                            start = time.perf_counter()
                            out = self._collate(full)
                            self._add_seconds(
                                collate=time.perf_counter() - start)
                            return put(out)
                        return True

                    items = stream if is_train else self._val_slots(stream)
                    for record in items:
                        if stop.is_set():
                            return
                        counter += 1
                        if is_train:
                            window.append(pool.submit(
                                self._process_train, record, counter))
                        elif record is None:
                            window.append(pool.submit(self._sentinel_val))
                        else:
                            window.append(pool.submit(
                                self._process_val, record))
                        while len(window) >= depth:
                            if not drain_one():
                                return
                    while window:
                        if not drain_one():
                            return
                    # val slots always fill whole batches; train drops the
                    # remainder of its infinite stream
            except Exception as e:  # surfaces at the consumer
                put(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, name="input-pipeline",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
