"""Training diagnostics and observability (counterpart of
`retinanet_tpu/train/diagnostics.py`): the throughput meter, the ETA
format, the Discord webhook, the loss-inflection detector that triggers
the checkpoint-rewind recovery, and the metrics sink.

The metrics sink writes JSONL only: TensorBoard is not ported (ROADMAP
Queue 1 #11), so there are no histograms, as in the JAX package when
TensorFlow is absent.
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
    """Scalar metrics sink: one JSON line a call, `{"step": ..., **scalars}`,
    in `log_dir/<name>_metrics.jsonl`, line-buffered. Disabled (the
    processes other than the chief), it opens nothing and drops every
    line."""

    def __init__(self, log_dir: str, name: str = "train",
                 enabled: bool = True):
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir,
                                            f"{name}_metrics.jsonl"),
                               "a", buffering=1)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if self._jsonl is None:
            return
        clean = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), **clean}) + "\n")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
