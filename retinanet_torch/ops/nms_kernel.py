"""Greedy NMS over lanes: the CUDA kernel `csrc/nms.cu`, its build, its
binding and its wrapper.

Replaces the Pallas TPU kernel `retinanet_tpu/ops/pallas/nms_kernel.py:36`
(`_nms_kernel`, entry `pallas_nms` at :105). The plain version is
`ops/nms.py:batched_nms`; the wrapper takes it only for tensors on the CPU.
On a CUDA tensor it launches the kernel or raises.

Bound on an H100 at the flagship shape (PerClassHardNMS, batch 8: L = 640
lanes, k = 256 candidates, 100 rounds): ~3.8 MB in and out, 1.1 us at
3.35 TB/s; ~20 f32 operations per candidate per round, 3.3e8, 4.9 us at
67 TFLOP/s. So the work is compute-bound at about 5 us, but what limits the
kernel is the chain of 100 dependent rounds, each a reduction across the
lane. The design keeps each lane's candidates in one CTA's shared memory
for the whole loop, needs one barrier a round, and stops a lane at its
first round below the score threshold.

Build: `ops/cuda_build.py` compiles `csrc/nms.cu` with `nvcc` on first use
and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.nms import batched_nms

MAX_CANDIDATES = 8192  # five f32 planes: 160 KB of shared memory


def _declare(lib: ctypes.CDLL) -> None:
    lib.nms_lanes_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.nms_lanes_launch.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p


# the built library, and the count of kernel launches
kernel = CudaLibrary("nms", _declare)


def _mode(soft: bool, soft_nms_sigma: float) -> int:
    """`Mode` in csrc/nms.cu: hard, soft Gaussian decay, soft with sigma 0
    (keep IoU <= threshold)."""
    if not soft:
        return 0
    return 1 if soft_nms_sigma > 0.0 else 2


def nms_lanes(boxes: torch.Tensor, scores: torch.Tensor,
              max_detections: int, iou_threshold: float = 0.5,
              score_threshold: float = float("-inf"),
              soft_nms_sigma: float = 0.0, soft: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over L lanes of k candidates.

    boxes (L, k, 4) and scores (L, k), float32 and contiguous, on one
    device. Returns (indices (L, md) int32, empty slots 0; scores (L, md)
    float32, empty slots -1; valid (L,) int32)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (L, k, 4), got {tuple(boxes.shape)}")
    if tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"scores {tuple(scores.shape)} do not match boxes "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"float32 required, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on "
                         f"{scores.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    lanes, k = scores.shape
    if k < 1 or max_detections < 1:
        raise ValueError(f"need k >= 1 and max_detections >= 1, got k={k}, "
                         f"max_detections={max_detections}")
    if boxes.device.type == "cpu":
        return batched_nms(boxes, scores, max_detections, iou_threshold,
                           score_threshold, soft_nms_sigma, soft)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if k > MAX_CANDIDATES:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_CANDIDATES}")

    idx = torch.empty((lanes, max_detections), dtype=torch.int32,
                      device=boxes.device)
    out_scores = torch.empty((lanes, max_detections), dtype=torch.float32,
                             device=boxes.device)
    valid = torch.empty((lanes,), dtype=torch.int32, device=boxes.device)
    if lanes == 0:
        return idx, out_scores, valid
    lib = kernel.build()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.nms_lanes_launch(
        boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
        float(iou_threshold), float(score_threshold),
        float(2.0 * soft_nms_sigma), _mode(soft, soft_nms_sigma),
        idx.data_ptr(), out_scores.data_ptr(), valid.data_ptr(),
        device_index(boxes.device), stream)
    if err != 0:
        raise RuntimeError("NMS kernel launch failed: "
                           + lib.nms_error_string(err).decode())
    kernel.launches += 1
    return idx, out_scores, valid
