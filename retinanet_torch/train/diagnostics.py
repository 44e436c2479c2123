"""Training diagnostics and observability (counterpart of
`retinanet_tpu/train/diagnostics.py`): the throughput meter, the ETA
format, the Discord webhook, the loss-inflection detector that triggers
the checkpoint-rewind recovery, and the metrics sink.

The metrics sink writes JSONL, and TensorBoard event files through
`train/event_file.py` (written by hand: no TensorFlow), scalars and
per-weight histograms, as the JAX package writes them through `tf.summary`.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import urllib.error
import urllib.request
from typing import Dict, List, Optional

import numpy as np
import torch

from retinanet_torch.train import event_file


class AverageMeter:
    """Throughput meter: the first `warmup` samples are taken as they are,
    then an exponential moving average with `momentum`."""

    def __init__(self, momentum: float = 0.997, warmup: int = 10):
        self.momentum = momentum
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._value: Optional[float] = None

    def accumulate(self, value: float) -> None:
        self._count += 1
        if self._count <= self.warmup:
            self._value = float(value)
            return
        self._value = (self.momentum * self._value
                       + (1.0 - self.momentum) * float(value))

    @property
    def averaged_value(self) -> float:
        return 0.0 if self._value is None else self._value


def format_eta(seconds: float) -> str:
    """Seconds -> 'D days, H:MM:SS'."""
    return str(datetime.timedelta(seconds=int(seconds)))


class DiscordLogger:
    """Webhook notifier, enabled when the DISCORD_WEB_HOOK environment
    variable (or `webhook_url`) is set and `enabled` is left True (the
    chief)."""

    def __init__(self, webhook_url: Optional[str] = None,
                 username: str = "retinanet_torch", enabled: bool = True):
        self.webhook_url = (webhook_url or os.environ.get("DISCORD_WEB_HOOK")
                            if enabled else None)
        self.username = username

    @property
    def enabled(self) -> bool:
        return bool(self.webhook_url)

    def log(self, message: str) -> None:
        if not self.enabled:
            return
        body = json.dumps({"username": self.username,
                           "content": str(message)[:1900]}).encode()
        request = urllib.request.Request(
            self.webhook_url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(request, timeout=5):
                pass
        except (urllib.error.URLError, OSError, ValueError):
            # observability must never stop training
            logging.getLogger(__name__).warning(
                "Discord webhook post failed", exc_info=True)


class InflectionDetector:
    """Flags anomalous curvature in a scalar loss stream: after
    `skip_steps` warmup values, the second numerical gradient of the whole
    history, then the rounded absolute first difference of that curvature;
    anomalous when its second-to-last entry exceeds `threshold`."""

    def __init__(self, name: str, threshold: float, skip_steps: int = 45):
        if skip_steps < 2:
            raise ValueError("`skip_steps` should be greater than 2")
        self.name = name
        self.threshold = float(threshold)
        self._skip_steps = skip_steps
        self.reset()

    def reset(self) -> None:
        self._data: List[float] = []

    @property
    def data(self) -> List[float]:
        return self._data

    def is_value_anomalous(self, value: float) -> bool:
        self._data.append(float(value))
        if len(self._data) <= self._skip_steps:
            return False
        grads = np.gradient(np.gradient(self._data))
        diffs = np.round(np.abs(np.diff(grads)), 3)
        return bool(diffs[-2] > self.threshold)


class MetricsLogger:
    """Metrics sink: one JSON line a call, `{"step": ..., **scalars}`, in
    `log_dir/<name>_metrics.jsonl`, line-buffered; with `use_tensorboard`,
    also TensorBoard events (the same scalars at float32, and histograms)
    in one event file under `tensorboard_dir`, or `log_dir/<name>` when it
    is empty. Disabled (the processes other than the chief), it opens
    nothing and drops everything. An I/O error raises."""

    def __init__(self, log_dir: str, name: str = "train",
                 use_tensorboard: bool = True, enabled: bool = True,
                 tensorboard_dir: str = ""):
        self._jsonl = None
        self._events: Optional[event_file.EventFileWriter] = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"),
                           "a", buffering=1)
        if use_tensorboard:
            self._events = event_file.EventFileWriter(
                tensorboard_dir or os.path.join(log_dir, name))

    @property
    def has_tensorboard(self) -> bool:
        return self._events is not None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if self._jsonl is None:
            return
        clean = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), **clean}) + "\n")
        if self._events is not None:
            self._events.add_scalars(step, clean)
            self._events.flush()

    def log_histograms(self, step: int,
                       tensors: Dict[str, torch.Tensor]) -> None:
        """Value histograms of `tensors` (TensorBoard only: a histogram has
        no JSONL line). The buckets are computed on the tensors' device and
        fetched in one copy."""
        if self._events is None:
            return
        buckets = event_file.histogram_buckets(list(tensors.values()))
        self._events.add_histograms(step, dict(zip(tensors, buckets)))
        self._events.flush()

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._events is not None:
            self._events.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._events is not None:
            self._events.close()
            self._events = None
