"""`training.strategy` (counterpart of `retinanet_tpu/parallel/mesh.py`:
`resolve_strategy`).

One process runs the global batch whole on its device, so with
`use_sync: true` BatchNorm over that batch computes what the JAX package
computes across its replicas. "multi_gpu" is data parallelism over the
processes of a `torch.distributed` group (`parallel/distributed.py`): each
takes its share of the global batch, and BatchNorm, the loss normalizer and
the gradients are summed over the group. `training.spatial_partition` S > 1
puts the processes on a (world / S, S) grid whose S processes of a data
index hold the same images, a band of rows each (`parallel/spatial.py`).
"""

from __future__ import annotations

import logging

import torch

from retinanet_torch.parallel import distributed

_TYPES = ("tpu", "gpu", "multi_gpu", "cpu")


def resolve_strategy(training_params, device: torch.device) -> str:
    """Validate `training.strategy` and `training.spatial_partition` for a
    run of this process on `device`; returns the strategy's name. "tpu",
    "gpu" and "cpu" resolve to the process's device with a log line;
    "multi_gpu" resolves when a process group is up and raises when none
    is; an unknown type raises ValueError. Then makes the process grid of
    `spatial_partition` (`distributed.make_grid`), which raises ValueError
    when it does not divide the world (one process included) and logs
    this process's place on it."""
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
    grid = distributed.make_grid(
        int(training_params.get("spatial_partition", 1)))
    logging.getLogger(__name__).info(
        "strategy %s(name=%r) resolved to %s in process %d of %d (data "
        "index %d of %d, spatial index %d of %d)", stype, name, device,
        distributed.process_index(), distributed.process_count(),
        grid.data_index, grid.data_count, grid.spatial_index,
        grid.spatial_count)
    return name
