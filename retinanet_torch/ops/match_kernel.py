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
100 boxes are valid. The design is one launch: a CTA per (image, tile of
`TILE` anchors, three a thread) keeps only the valid boxes that may touch
its tile's bounding box (`ops/match.py:tile_cull_mask` is that test in plain
PyTorch), reads a kept box once for its three anchors, keeps the
(B, G, A) IoU tensor in registers, divides only where a warp saw an
intersection, folds the per-box reduction across the tiles with one 64-bit
atomicMax per (CTA, box), and lets the last CTA of an image decode the keys.

Scratch. The keys and one ticket per image live in a buffer of zeros that
is kept per (device, stream) and never memset between calls: the last CTA
of an image puts its keys and its ticket back to 0. Kernels on one stream
run one after the other, so calls on one stream can share a buffer; calls
on two streams get one each. A call that raises does so before the kernel
runs (input checks, the build, a refused launch), so the buffer is still
all zeros. A buffer too small is replaced by a new `torch.zeros`.

Build: `ops/cuda_build.py` compiles `csrc/match.cu` with `nvcc` on first
use and loads it with ctypes. Importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.match import match_lanes_plain

# 32 B of shared memory a box (64-bit key, four corners, area, index): 7,000
# boxes fill the 227 KB a block can have on an H100. No TPU tile of 128.
MAX_GT = 7000
TILE = 384  # anchors of a CTA: `kTile` in csrc/match.cu


def declare(lib: ctypes.CDLL) -> None:
    lib.match_lanes_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.match_lanes_launch.restype = ctypes.c_int
    lib.match_error_string.argtypes = [ctypes.c_int]
    lib.match_error_string.restype = ctypes.c_char_p


# the built library, and the count of kernel launches
kernel = CudaLibrary("match", declare)

# (device index, stream handle) -> int64 zeros: keys, then a ticket an image
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _zeros_scratch(device: torch.device, stream: int,
                   words: int) -> torch.Tensor:
    slot = (device_index(device), stream)
    buf = _scratch.get(slot)
    if buf is None or buf.numel() < words:
        buf = torch.zeros((words,), dtype=torch.int64, device=device)
        _scratch[slot] = buf
    return buf


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The kernel loads an anchor or a box as one float4."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def match_lanes(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """anchors (A, 4) and gt_boxes (B, G, 4) float32 in centre format,
    gt_valid (B, G) bool; contiguous, on one device. Returns
    (max_iou (B, A) float32, argmax_gt (B, A) int32, gt_best_iou (B, G)
    float32, gt_best_anchor (B, G) int32) as `match_lanes_plain` does. On
    the card one kernel launch; anchors and boxes must be finite."""
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

    return launch(anchors, gt_boxes, gt_valid)


def launch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_valid: torch.Tensor, library: Optional[CudaLibrary] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Launches the kernel on checked CUDA tensors. `match_lanes` is the
    public entry; measurements call this with another build of
    `csrc/match.cu` (`library`)."""
    library = library or kernel
    batch, num_gt = gt_valid.shape
    num_anchors = anchors.shape[0]
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
    lib = library.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _zeros_scratch(dev, stream, batch * num_gt + batch)
    err = lib.match_lanes_launch(
        _aligned16(anchors).data_ptr(), _aligned16(gt_boxes).data_ptr(),
        gt_valid.data_ptr(), batch, num_anchors, num_gt, max_iou.data_ptr(),
        argmax_gt.data_ptr(), gt_best_iou.data_ptr(),
        gt_best_anchor.data_ptr(), scratch.data_ptr(), device_index(dev),
        stream)
    if err != 0:
        raise RuntimeError("matching kernel launch failed: "
                           + lib.match_error_string(err).decode())
    library.launches += 1
    return max_iou, argmax_gt, gt_best_iou, gt_best_anchor
