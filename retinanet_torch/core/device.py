"""Device choice and device constants shared by the port's modules."""

from __future__ import annotations

import functools

import torch

from retinanet_torch.parallel import distributed


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card: under a process group this process's
    card, `cuda:LOCAL_RANK`. There is no silent CPU path: without a card the
    caller has to ask for the CPU by name."""
    if device is None:
        if distributed.is_initialized():
            return distributed.default_device()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant vector on `device`, copied there once. A tensor
    built from a Python list on every call would be a synchronous
    host-to-device copy, which stalls the host until the card is idle.
    Callers must not write to it.

    While `torch.export` traces, the tensor is built afresh and not cached:
    made under the tracer it is a fake tensor, which an eager call must
    never get back from the cache."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_constant(values, dtype, device)


@functools.lru_cache(maxsize=64)
def _cached_constant(values: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
