"""Greedy NMS over lanes: the CUDA kernels of `csrc/nms.cu`, their build,
their binding and their wrapper.

Replaces the Pallas TPU kernel `retinanet_tpu/ops/pallas/nms_kernel.py:36`
(`_nms_kernel`, entry `pallas_nms` at :105). The plain version is
`ops/nms.py:batched_nms`; the wrapper takes it only for tensors on the CPU.
On a CUDA tensor it launches a kernel or raises.

Bound on an H100 at the flagship shape (PerClassHardNMS, batch 8: L = 640
lanes, k = 256 candidates, 100 rounds): ~3.8 MB in and out, 1.1 us at
3.35 TB/s; ~20 f32 operations per candidate per round, 3.3e8, 4.9 us at
67 TFLOP/s. So the work is compute-bound at about 5 us, but what limits a
kernel is the chain of 100 dependent rounds. Two hand-written designs make
a round short, and `nms_design` picks one from the mode and the shape:

* "sweep" (`nms_sweep_kernel`): hard mode, k <= 1024 and
  score_threshold >= -1e10. One warp a lane; the candidates are ordered
  once (score descending, lower index first), each thread keeps an alive
  bit per candidate, and a round is one warp reduction and the IoU of the
  pick against the later candidates still alive: no arg-max, no barrier.
  `ops/nms.py:sweep_nms_plain` is the same algorithm in plain PyTorch.
* "rounds" (`nms_lanes_kernel`): everything else. Soft modes, because
  decayed scores change the order from round to round; k up to 8192 (the
  global modes pass pre_nms_top_k = 5000); and hard mode with a threshold
  under -1e10, where the plain version goes on picking suppressed
  candidates. One CTA a lane, candidates in shared memory, an arg-max
  across the CTA and one barrier a round.

This is a choice between two kernels, not a fallback: nothing is caught.
`kernel.launches` counts every launch, `kernel.launches_by[design]` those of
one design.

Build: `ops/cuda_build.py` compiles `csrc/nms.cu` with `nvcc` on first use
and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.nms import SUPPRESSED, batched_nms

MAX_CANDIDATES = 8192  # rounds: five f32 planes, 160 KB of shared memory
SWEEP_MAX_CANDIDATES = 1024  # sweep: 32 alive bits a thread


def declare(lib: ctypes.CDLL) -> None:
    lib.nms_rounds_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.nms_rounds_launch.restype = ctypes.c_int
    lib.nms_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.nms_sweep_launch.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p


# the built library, and the counts of kernel launches
kernel = CudaLibrary("nms", declare)


def _mode(soft: bool, soft_nms_sigma: float) -> int:
    """`Mode` in csrc/nms.cu: hard, soft Gaussian decay, soft with sigma 0
    (keep IoU <= threshold)."""
    if not soft:
        return 0
    return 1 if soft_nms_sigma > 0.0 else 2


def nms_design(soft: bool, k: int, score_threshold: float) -> str:
    """Which kernel `nms_lanes` launches on the card: "sweep" or "rounds".

    The sweep assumes that a suppressed candidate (score -1e10) can never be
    picked, which holds exactly when the threshold is at or above -1e10."""
    if (not soft and k <= SWEEP_MAX_CANDIDATES
            and score_threshold >= SUPPRESSED):
        return "sweep"
    return "rounds"


def launch_design(design: str, boxes: torch.Tensor, scores: torch.Tensor,
                  max_detections: int, iou_threshold: float,
                  score_threshold: float, soft_nms_sigma: float = 0.0,
                  soft: bool = False,
                  library: Optional[CudaLibrary] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches one design on checked CUDA tensors. `nms_lanes` is the
    public entry; measurements call this to time "rounds" on inputs that
    `nms_design` gives to "sweep", or another build of `csrc/nms.cu`
    (`library`). The sweep computes hard mode only."""
    library = library or kernel
    lanes, k = scores.shape
    idx = torch.empty((lanes, max_detections), dtype=torch.int32,
                      device=boxes.device)
    out_scores = torch.empty((lanes, max_detections), dtype=torch.float32,
                             device=boxes.device)
    valid = torch.empty((lanes,), dtype=torch.int32, device=boxes.device)
    if lanes == 0:
        return idx, out_scores, valid
    lib = library.build()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    outputs = (idx.data_ptr(), out_scores.data_ptr(), valid.data_ptr(),
               device_index(boxes.device), stream)
    if design == "sweep":
        if soft or k > SWEEP_MAX_CANDIDATES:
            raise ValueError(f"the sweep takes hard mode and k <= "
                             f"{SWEEP_MAX_CANDIDATES}, got soft={soft}, k={k}")
        if boxes.data_ptr() % 16:
            boxes = boxes.clone()  # the kernel loads a box as one float4
        err = lib.nms_sweep_launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold), *outputs)
    elif design == "rounds":
        err = lib.nms_rounds_launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold),
            float(2.0 * soft_nms_sigma), _mode(soft, soft_nms_sigma),
            *outputs)
    else:
        raise ValueError(f"no NMS design {design!r}")
    if err != 0:
        raise RuntimeError(f"NMS kernel ({design}) launch failed: "
                           + lib.nms_error_string(err).decode())
    library.launches += 1
    library.launches_by[design] += 1
    return idx, out_scores, valid


def nms_lanes(boxes: torch.Tensor, scores: torch.Tensor,
              max_detections: int, iou_threshold: float = 0.5,
              score_threshold: float = float("-inf"),
              soft_nms_sigma: float = 0.0, soft: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over L lanes of k candidates.

    boxes (L, k, 4) and scores (L, k), float32 and contiguous, on one
    device. Returns (indices (L, md) int32, empty slots 0; scores (L, md)
    float32, empty slots -1; valid (L,) int32). On the card one kernel
    launch, of the design that `nms_design` names. NaN scores and
    non-finite boxes are outside the contract of the kernels and of the
    plain version alike."""
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

    return launch_design(nms_design(soft, k, score_threshold), boxes, scores,
                         max_detections, iou_threshold, score_threshold,
                         soft_nms_sigma, soft)
