"""Timing on the card (counterpart of `retinanet_tpu/utils/benchmark.py`)."""

from __future__ import annotations

import time
from typing import Callable

import torch


def device_time_ms(fn: Callable[[], object], reps: int = 30,
                   warmup: int = 2) -> float:
    """Device time of one call of `fn`: CUDA events around a run of `reps`
    calls, over the count. The card first spins for about as long as the
    host needs to enqueue the run, so that a call whose launches cost the
    host more than they cost the card is not timed at the host's pace.
    Successive calls find the 50 MB L2 cache warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(host * reps * 2.5e9, 5e8)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
