"""Device prefetch: the next batches are staged on the card while the
current step runs (counterpart of `retinanet_tpu/data/prefetch.py`).

A producer thread calls `make_batch()` `depth` batches ahead. With a CUDA
`device`, each batch (a dict of numpy arrays or tensors) is pinned into
page-locked host memory and copied to the card on a side stream; the copy
records an event. `next()` makes the consumer's current stream wait on
that event and marks each device tensor as used by that stream
(`record_stream`), so the caching allocator does not hand its memory to
another tensor before the consumer's work on it is done. The pinned source
stays referenced until the copy has been consumed, and PyTorch's pinned
allocator keeps a freed pinned block until the copy that read it is done.

With `device` None the producer's items pass through unchanged; with a CPU
device each array becomes a tensor. Items are yielded in production order;
a producer exception re-raises at the consumer's `next()`. `close()` is
idempotent, unblocks a producer waiting on a full queue and joins it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


class DevicePrefetcher:
    """Iterator over `make_batch()` results, produced `depth` ahead.
    `make_batch` raises StopIteration at the end of the stream. `keys`,
    when given, names the entries of a batch that go to the device; the
    others pass through (metadata the host keeps)."""

    _END = ("end", None)

    def __init__(self, make_batch: Callable[[], Any], depth: int = 2,
                 device=None, keys: Optional[Sequence[str]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._make_batch = make_batch
        self._device = None if device is None else torch.device(device)
        if self._device is not None and self._device.type == "cuda" \
                and self._device.index is None:
            # the producer thread selects the device by its index
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._keys = None if keys is None else tuple(keys)
        self._stream = None
        # seconds the producer spent staging (pinning and issuing copies)
        self.stage_seconds = 0.0
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch", daemon=True)
        self._thread.start()

    def _stage(self, batch):
        """Host batch -> (batch with device tensors, copy-done event, the
        pinned sources)."""
        if self._device is None:
            return batch, None, ()
        keys = self._keys if self._keys is not None else tuple(batch)
        out = dict(batch)
        if self._stream is None:
            for k in keys:
                out[k] = torch.as_tensor(batch[k]).to(self._device)
            return out, None, ()
        pinned = []
        with torch.cuda.stream(self._stream):
            for k in keys:
                host = torch.as_tensor(np.ascontiguousarray(batch[k]))
                pinned.append(host.pin_memory())
                out[k] = pinned[-1].to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done, pinned

    def _put(self, item) -> bool:
        """Blocks until the queue takes `item`; False once closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        # every failure, the device selection's too, ends the stream with
        # an error that the consumer's next() raises
        try:
            if self._stream is not None:
                torch.cuda.set_device(self._device)
            while not self._closed.is_set():
                try:
                    batch = self._make_batch()
                except StopIteration:
                    break
                t0 = time.perf_counter()
                staged = self._stage(batch)
                self.stage_seconds += time.perf_counter() - t0
                if not self._put(("ok", staged)):
                    return
            self._put(self._END)
        except BaseException as e:  # surface at the consumer
            self._put(("err", e))

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._closed.is_set():
            raise StopIteration
        kind, value = self._q.get()
        if kind == "ok":
            batch, done, _ = value
            if done is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(done)
                keys = self._keys if self._keys is not None else tuple(batch)
                for k in keys:
                    batch[k].record_stream(consumer)
            return batch
        self._closed.set()
        if kind == "end":
            raise StopIteration
        raise value

    def close(self) -> None:
        """Stop the producer and release staged batches (idempotent)."""
        self._closed.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc: Any) -> Optional[bool]:
        self.close()
        return None
