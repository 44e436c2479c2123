"""`training.strategy` (counterpart of `retinanet_tpu/parallel/mesh.py`:
`resolve_strategy`).

One process runs the global batch whole on its device, so with
`use_sync: true` BatchNorm over that batch computes what the JAX package
computes across its replicas. "multi_gpu" is data parallelism over the
processes of a `torch.distributed` group (`parallel/distributed.py`): each
takes its share of the global batch, and BatchNorm, the loss normalizer and
the gradients are summed over the group. Spatial partitioning raises.
"""

from __future__ import annotations

import logging

import torch

from retinanet_torch.parallel import distributed

_TYPES = ("tpu", "gpu", "multi_gpu", "cpu")
SPATIAL_ITEM = "ROADMAP Queue 1 #16 (spatial partitioning)"


def resolve_strategy(training_params, device: torch.device) -> str:
    """Validate `training.strategy` and `training.spatial_partition` for a
    run of this process on `device`; returns the strategy's name. "tpu",
    "gpu" and "cpu" resolve to the process's device with a log line;
    "multi_gpu" resolves when a process group is up and raises when none
    is; a spatial partition raises; an unknown type raises ValueError."""
    strategy = training_params.get("strategy", {})
    stype = str(strategy.get("type", "tpu")).lower()
    name = str(strategy.get("name", ""))
    if stype not in _TYPES:
        raise ValueError(
            f"Unsupported training.strategy.type: {stype!r} "
            "(expected tpu / gpu / multi_gpu / cpu)")
    if stype == "multi_gpu" and not distributed.is_initialized():
        raise RuntimeError(
            "training.strategy.type='multi_gpu' needs a torch.distributed "
            "process group, and there is no process group: launch with "
            "torchrun and --is_multi_host")
    spatial = int(training_params.get("spatial_partition", 1))
    if spatial > 1:
        raise NotImplementedError(
            f"training.spatial_partition={spatial}: spatial partitioning is "
            f"{SPATIAL_ITEM}")
    logging.getLogger(__name__).info(
        "strategy %s(name=%r) resolved to %s in process %d of %d", stype,
        name, device, distributed.process_index(),
        distributed.process_count())
    return name
