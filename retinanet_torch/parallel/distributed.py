"""Data parallelism and the (data, spatial) grid over processes with
`torch.distributed` (counterpart of `retinanet_tpu/parallel/mesh.py`).

The JAX package shards one global batch over a device mesh, and GSPMD
inserts the collectives that make the sharded step compute what one device
would. Here each process drives one card (or the CPU) with its share of the
global batch, and those collectives are written out where they belong:
  * `models/layers.py` BatchNorm: (sum x, sum x^2, count) before the
    variance, (sum dy, sum dy * x_hat) before the input gradient;
  * `losses/losses.py`: the positives behind the loss normalizer;
  * `train/step.py`: the gradients, once a step after the last
    micro-batch, and the logged losses;
  * `train/executor.py`: the preemption flag, the evaluation's gathers and
    the chief's checkpoint listing.

Two groups. The default group carries tensors on the process's device:
NCCL for CUDA, gloo for the CPU, or gloo on CUDA tensors when the caller
names it (several ranks on one card, which NCCL refuses). A second gloo
group, made at initialisation, carries host objects, so that they travel
the same way under NCCL and never touch the card (gloo has no CUDA
all_gather).

The grid (`make_grid`, counterpart of `create_mesh(spatial=S)`) puts the
processes on a (data, spatial) grid: process r is data index r // S and
spatial index r % S, so that each spatial group is S consecutive ranks. The
S processes of one data index hold the same images, each a band of their
rows (`parallel/spatial.py`); the D = world / S data indices split the
global batch as data parallelism does. Without `make_grid` the grid is S = 1
and every process is a data index of its own.

Without a process group, or at world size 1, every helper here is a no-op
and its callers run the one-process path unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = ("nccl", "gloo")


class _Process:
    """What this process learned when it joined the group: the host group
    and its card's index (`LOCAL_RANK`). One per process, as the default
    group is."""
    host_group = None
    local_rank = 0
    device_set = False
    grid: Optional["Grid"] = None


_PROCESS = _Process()


def initialize_distributed(backend: Optional[str] = None, device=None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           local_rank: Optional[int] = None) -> None:
    """Join the process group. Unset arguments come from torchrun's
    environment: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, and `MASTER_ADDR` /
    `MASTER_PORT` through the default `init_method` "env://"; a
    "tcp://host:port" or "file:///path" init method works too.

    `backend` None means NCCL for a CUDA `device` (None is the card) and
    gloo for the CPU; "gloo" with a CUDA device runs gloo on CUDA tensors.
    A backend that this torch lacks raises: nothing falls back to another
    backend or to the CPU."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    device_type = "cuda" if device is None else torch.device(device).type
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only; the CPU takes "
                         "gloo")
    available = dist.is_available() and (
        dist.is_nccl_available() if backend == "nccl"
        else dist.is_gloo_available())
    if not available:
        raise RuntimeError(f"torch.distributed backend {backend!r} is not "
                           f"available in torch {torch.__version__}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the processes on the CPU")
    rank = _from_env("RANK", rank)
    world_size = _from_env("WORLD_SIZE", world_size)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _PROCESS.host_group = dist.new_group(backend="gloo")
    _PROCESS.local_rank = int(local_rank)
    _PROCESS.device_set = False


def _from_env(name: str, value: Optional[int]) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set and there is no process "
                           "group to join: launch with torchrun, or pass "
                           f"{name.lower()}")
    return int(os.environ[name])


def shutdown() -> None:
    """Leave the process group (both groups); a no-op without one."""
    if is_initialized():
        dist.destroy_process_group()
    _PROCESS.host_group = None
    _PROCESS.device_set = False
    _PROCESS.grid = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_chief() -> bool:
    return process_index() == 0


def default_device() -> torch.device:
    """This process's card, `cuda:LOCAL_RANK`; `torch.cuda.set_device` is
    called the first time. A bare "cuda" would put every rank on card 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    device = torch.device("cuda", _PROCESS.local_rank)
    if not _PROCESS.device_set:
        torch.cuda.set_device(device)
        _PROCESS.device_set = True
    return device


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the (data, spatial) grid, and the groups it
    sums over. `data_group` and `spatial_group` are None where the sum is
    over the whole default group (S = 1 for the data sum) or over this
    process alone (a group of one)."""
    data_index: int
    data_count: int
    spatial_index: int
    spatial_count: int
    data_group: Any = None
    spatial_group: Any = None

    def sum_over_data_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` in place over the processes of this spatial index
        (every data index once); returns it."""
        if self.data_count > 1:
            dist.all_reduce(tensor, group=self.data_group)
        return tensor

    def sum_over_spatial_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` in place over this process's spatial group (the
        processes that hold the same images); returns it."""
        if self.spatial_count > 1:
            dist.all_reduce(tensor, group=self.spatial_group)
        return tensor


def make_grid(spatial: int) -> Grid:
    """Put the processes on a (world / spatial, spatial) grid and make it
    this process's grid. Every process calls it, with the same `spatial`:
    each group is made by every process, in the same order. A world that
    `spatial` does not divide raises ValueError, one process included."""
    spatial = int(spatial)
    world, rank = process_count(), process_index()
    if spatial < 1 or world % spatial:
        raise ValueError(
            f"{world} processes not divisible by spatial={spatial}: spatial "
            "partitioning puts each image on `spatial` processes")
    data_count = world // spatial
    data_group = spatial_group = None
    if spatial > 1:
        for d in range(data_count):
            group = dist.new_group(list(range(d * spatial,
                                              (d + 1) * spatial)))
            if d == rank // spatial:
                spatial_group = group
        if data_count > 1:
            for s in range(spatial):
                group = dist.new_group(list(range(s, world, spatial)))
                if s == rank % spatial:
                    data_group = group
    grid = Grid(rank // spatial, data_count, rank % spatial, spatial,
                data_group, spatial_group)
    _PROCESS.grid = grid
    logging.getLogger(__name__).info(
        "process %d of %d: data index %d of %d, spatial index %d of %d",
        rank, world, grid.data_index, data_count, grid.spatial_index,
        spatial)
    return grid


def grid() -> Grid:
    """This process's grid: the one `make_grid` made, else S = 1 (each
    process its own data index)."""
    if _PROCESS.grid is not None:
        return _PROCESS.grid
    return Grid(process_index(), process_count(), 0, 1)


def data_index() -> int:
    return grid().data_index


def data_count() -> int:
    return grid().data_count


def local_batch_size(global_batch_size: int,
                     count: Optional[int] = None) -> int:
    """The per-process batch: the global batch over `count` (the grid's
    data count by default: the processes of a spatial group share their
    images)."""
    count = data_count() if count is None else int(count)
    if global_batch_size % count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by process "
            f"count {count}")
    return global_batch_size // count


def process_slice(x: np.ndarray, process_index: int,
                  process_count: int) -> np.ndarray:
    """This process's contiguous slice of a batch that every process holds
    in full. The slices of all processes are the batch, each row once.
    Under a spatial grid pass the data index and count."""
    b = x.shape[0]
    if b % process_count:
        raise ValueError(
            f"batch {b} not divisible by process count {process_count}")
    per = b // process_count
    return x[process_index * per:(process_index + 1) * per]


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the processes, in place, through the default group;
    returns it. Untouched in one process."""
    if process_count() > 1:
        dist.all_reduce(tensor)
    return tensor


def all_reduce_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the gradients over the processes in one flat bucket: one
    collective for the whole model."""
    grads = [p.grad for p in params if p.grad is not None]
    if process_count() <= 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def any_process(flag: bool) -> bool:
    """True on every process when `flag` is True on any (an all-reduce MAX
    over the host group)."""
    if process_count() <= 1:
        return bool(flag)
    value = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=_PROCESS.host_group)
    return bool(value.item())


def gather_to_chief(obj: Any) -> Optional[List[Any]]:
    """Every process's `obj`, in process order, on the chief; None on the
    others. Through the host group (pickled)."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count() if is_chief() else None
    dist.gather_object(obj, out, dst=0, group=_PROCESS.host_group)
    return out


def broadcast_from_chief(obj: Any) -> Any:
    """The chief's `obj` on every process, through the host group."""
    if process_count() <= 1:
        return obj
    box = [obj if is_chief() else None]
    dist.broadcast_object_list(box, src=0, group=_PROCESS.host_group)
    return box[0]
