"""`training.strategy` on one card (counterpart of the single-device part of
`retinanet_tpu/parallel/mesh.py`: `resolve_strategy`; one process has
no per-process batch to work out).

The port runs on one device: the global batch runs whole on it, so with
`use_sync: true` BatchNorm over that batch computes what the JAX package
computes across its replicas. Data parallelism over several cards and
spatial partitioning are ROADMAP Queue 1 #4 and raise.
"""

from __future__ import annotations

import logging

import torch

_TYPES = ("tpu", "gpu", "multi_gpu", "cpu")
MULTI_DEVICE_ITEM = "ROADMAP Queue 1 #4 (torch.distributed)"


def resolve_strategy(training_params, device: torch.device) -> str:
    """Validate `training.strategy` and `training.spatial_partition` for a
    run on the one `device`; returns the strategy's name. "tpu", "gpu" and
    "cpu" resolve to that device with a log line; "multi_gpu" and a spatial
    partition raise; an unknown type raises ValueError."""
    strategy = training_params.get("strategy", {})
    stype = str(strategy.get("type", "tpu")).lower()
    name = str(strategy.get("name", ""))
    if stype not in _TYPES:
        raise ValueError(
            f"Unsupported training.strategy.type: {stype!r} "
            "(expected tpu / gpu / multi_gpu / cpu)")
    if stype == "multi_gpu":
        raise NotImplementedError(
            f"training.strategy.type='multi_gpu': the port runs on one "
            f"device; several cards are {MULTI_DEVICE_ITEM}")
    spatial = int(training_params.get("spatial_partition", 1))
    if spatial > 1:
        raise NotImplementedError(
            f"training.spatial_partition={spatial}: spatial partitioning is "
            f"{MULTI_DEVICE_ITEM}")
    logging.getLogger(__name__).info(
        "strategy %s(name=%r) resolved to the one device %s", stype, name,
        device)
    return name

