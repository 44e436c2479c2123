"""Top-k selection over rows: the CUDA kernel of `csrc/topk.cu`, its build,
its binding and its wrapper.

Replaces no Pallas kernel: it replaces two XLA paths of the JAX package,
`approx_max_k_packed` / `lax.approx_max_k` (the default serving lane,
`retinanet_tpu/ops/postprocess.py:54`) and `lax.top_k` (the exact lane, the
`skip_nms` export lane, the top-k over the NMS survivors). No stock
PyTorch call computes them with the JAX package's keys and tie rule:
`torch.topk` on CUDA promises no order among ties, and a stable
`torch.sort` of the float32 transpose is what the port ran before. The
semantics and the plain version are in `ops/topk.py`.

Bound on an H100: one read of the rows, B * N * C * itemsize bytes, and
the k outputs written; at the flagship's batch 8 (76,725 anchors, 80
classes, bf16) 98.2 MB, 0.0293 ms at 3.35 TB/s.

Build: `ops/cuda_build.py` compiles `csrc/topk.cu` with `nvcc` on first use
and loads it with ctypes. Importing this module needs no `nvcc`.
`select_top_k` reaches the kernel through the custom op
`torch.ops.retinanet_torch.top_k_rows`, which dispatches by the tensor's
device (the kernel for CUDA, `top_k_rows_plain` for the CPU) and has a
fake implementation for its output shapes, so that `torch.export` can
capture a serving graph with the selection in it. `kernel.launches` counts
every launch, `kernel.launches_by[mode]` those of one mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.topk import check_rows, packed_layout, \
    top_k_rows_plain

MAX_K = 8192    # the final sort's keys in shared memory, 8 bytes each
_MODE_CODE = {"packed": 0, "bf16": 1, "f32": 2}


def declare(lib: ctypes.CDLL) -> None:
    lib.topk_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_rows_launch.restype = ctypes.c_int
    lib.topk_error_string.argtypes = [ctypes.c_int]
    lib.topk_error_string.restype = ctypes.c_char_p


# the built library, and the counts of kernel launches
kernel = CudaLibrary("topk", declare)


def launch(x: torch.Tensor, k: int, mode: str,
           library: Optional[CudaLibrary] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on a checked contiguous CUDA tensor x (B, N, C): values
    and int32 indices (B, C, k). `library` is another build of
    `csrc/topk.cu` for measurements."""
    library = library or kernel
    check_rows(x, k, mode)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous CUDA tensor")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K}")
    b, n, c = x.shape
    if n >= 2 ** 31 or b * c >= 2 ** 31:
        raise ValueError(f"too many rows or too long a row for the kernel: "
                         f"{tuple(x.shape)}")
    values = torch.empty((b, c, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, c, k), dtype=torch.int32, device=x.device)
    if b * c == 0:
        return values, idx
    lib = library.build()
    drop = packed_layout(n)[1] if mode == "packed" else 0
    err = lib.topk_rows_launch(
        x.data_ptr(), b, n, c, k, _MODE_CODE[mode], drop, values.data_ptr(),
        idx.data_ptr(), device_index(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"top-k kernel ({mode}) launch failed: "
                           + lib.topk_error_string(err).decode())
    library.launches += 1
    library.launches_by[mode] += 1
    return values, idx


@torch.library.custom_op("retinanet_torch::top_k_rows", mutates_args=(),
                         device_types="cpu")
def _top_k_rows_op(x: torch.Tensor, k: int, mode: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return top_k_rows_plain(x, k, mode)


@_top_k_rows_op.register_kernel("cuda")
def _top_k_rows_cuda(x, k, mode):
    return launch(x, k, mode)


@_top_k_rows_op.register_fake
def _top_k_rows_fake(x, k, mode):
    b, _, c = x.shape
    return (x.new_empty((b, c, k)),
            x.new_empty((b, c, k), dtype=torch.int32))
