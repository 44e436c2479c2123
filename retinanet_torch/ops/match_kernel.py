"""Anchor <-> ground-truth matching lanes: the CUDA kernel `csrc/match.cu`,
its binding and its wrapper.

Replaces the Pallas TPU kernel
`retinanet_tpu/ops/pallas/matching_kernel.py:41` (`_match_kernel`, entry
`pallas_match` at :144, vmapped over the batch by the label encoder). The
batch is a grid dimension here. The plain version is
`ops/match.py:match_lanes_plain`; the wrapper takes it only for tensors on
the CPU. On a CUDA tensor it launches the kernel or raises.

Where the two lanes of the JAX package differ and no caller reads the
result, the kernel follows the XLA lane: with no valid box `argmax_gt` is 0
(the Pallas kernel gives `num_gt - 1`), and an invalid box gets
`gt_best_iou` -1 and `gt_best_anchor` 0 (the Pallas kernel leaves -2 in rows
it did not sweep). Valid boxes need not be a prefix of the row.

Bound on an H100 at the flagship shape (A = 76,725, B = 8, G = 100): 6.2 MB
in and out, 1.8 us at 3.35 TB/s; about 25 f32 operations per (anchor, valid
box) pair against 67 TFLOP/s, which passes the bytes only when most of the
100 boxes are valid. The design reads the anchors and boxes once, keeps the
(B, G, A) IoU tensor in registers, and folds the per-box reduction across
anchor tiles with one 64-bit atomicMax per (CTA, box).

Build: `ops/cuda_build.py` compiles `csrc/match.cu` with `nvcc` on first
use and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.match import match_lanes_plain

# 32 B of shared memory a box (index, four corners, area, 64-bit key): 7,000
# boxes fill the 227 KB a block can have on an H100. No TPU tile of 128.
MAX_GT = 7000


def _declare(lib: ctypes.CDLL) -> None:
    lib.match_lanes_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.match_lanes_launch.restype = ctypes.c_int
    lib.match_error_string.argtypes = [ctypes.c_int]
    lib.match_error_string.restype = ctypes.c_char_p


# the built library, and the count of kernel launches
kernel = CudaLibrary("match", _declare)


def match_lanes(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """anchors (A, 4) and gt_boxes (B, G, 4) float32 in centre format,
    gt_valid (B, G) bool; contiguous, on one device. Returns
    (max_iou (B, A) float32, argmax_gt (B, A) int32, gt_best_iou (B, G)
    float32, gt_best_anchor (B, G) int32) as `match_lanes_plain` does."""
    if anchors.dim() != 2 or anchors.shape[-1] != 4:
        raise ValueError(
            f"anchors must be (A, 4), got {tuple(anchors.shape)}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(
            f"gt_boxes must be (B, G, 4), got {tuple(gt_boxes.shape)}")
    if tuple(gt_valid.shape) != tuple(gt_boxes.shape[:2]):
        raise ValueError(f"gt_valid {tuple(gt_valid.shape)} does not match "
                         f"gt_boxes {tuple(gt_boxes.shape)}")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"float32 required, got {anchors.dtype}, "
                        f"{gt_boxes.dtype}")
    if gt_valid.dtype != torch.bool:
        raise TypeError(f"gt_valid must be bool, got {gt_valid.dtype}")
    if not (anchors.device == gt_boxes.device == gt_valid.device):
        raise ValueError(f"anchors on {anchors.device}, gt_boxes on "
                         f"{gt_boxes.device}, gt_valid on {gt_valid.device}")
    if not (anchors.is_contiguous() and gt_boxes.is_contiguous()
            and gt_valid.is_contiguous()):
        raise ValueError("anchors, gt_boxes and gt_valid must be contiguous")
    batch, num_gt = gt_valid.shape
    num_anchors = anchors.shape[0]
    if num_anchors < 1 or num_gt < 1:
        raise ValueError(f"need A >= 1 and G >= 1, got A={num_anchors}, "
                         f"G={num_gt}")
    if anchors.device.type == "cpu":
        return match_lanes_plain(anchors, gt_boxes, gt_valid)
    if anchors.device.type != "cuda":
        raise ValueError(f"no matching kernel for device {anchors.device}")
    if num_gt > MAX_GT:
        raise ValueError(f"G={num_gt} exceeds the kernel's {MAX_GT}")
    if batch > 65535:
        raise ValueError(f"B={batch} exceeds the grid's 65535")

    dev = anchors.device
    max_iou = torch.empty((batch, num_anchors), dtype=torch.float32,
                          device=dev)
    argmax_gt = torch.empty((batch, num_anchors), dtype=torch.int32,
                            device=dev)
    gt_best_iou = torch.empty((batch, num_gt), dtype=torch.float32,
                              device=dev)
    gt_best_anchor = torch.empty((batch, num_gt), dtype=torch.int32,
                                 device=dev)
    if batch == 0:
        return max_iou, argmax_gt, gt_best_iou, gt_best_anchor
    keys = torch.zeros((batch, num_gt), dtype=torch.int64, device=dev)
    lib = kernel.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.match_lanes_launch(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(), batch,
        num_anchors, num_gt, max_iou.data_ptr(), argmax_gt.data_ptr(),
        keys.data_ptr(), gt_best_iou.data_ptr(), gt_best_anchor.data_ptr(),
        device_index(dev), stream)
    if err != 0:
        raise RuntimeError("matching kernel launch failed: "
                           + lib.match_error_string(err).decode())
    kernel.launches += 1
    return max_iou, argmax_gt, gt_best_iou, gt_best_anchor
