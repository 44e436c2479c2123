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
kernel is the chain of 100 dependent rounds. Five hand-written designs
make a round short, and `nms_design` picks one from the mode, the shape
and the threshold; every (mode, k, threshold) has one, and k no cap:

* "sweep" (`nms_sweep_kernel`): hard mode, k <= 1024 and
  score_threshold >= -1e10. One warp a lane; the candidates are ordered
  once (score descending, lower index first), each thread keeps an alive
  bit per candidate, and a round is one warp reduction and the IoU of the
  pick against the later candidates still alive: no arg-max, no barrier.
  `ops/nms.py:sweep_nms_plain` is the same algorithm in plain PyTorch.
* "decay" (`nms_decay_kernel`): the soft modes, k <= 1024 and
  score_threshold >= 0. Decayed scores change the order from round to
  round, so each round takes an arg-max, but every scale lies in [0, 1]:
  a score not above the threshold never rises above it again and leaves
  for good. One warp a lane; the candidates above the threshold are staged
  once in index order, thread t owns positions t, t + 32, ... (scores in
  registers), and a round is two warp reductions (the largest score's bits,
  then the lowest position holding it), a broadcast read of the pick's box
  and the decay of the thread's own positions: no barrier. It computes the
  round kernel's arithmetic, so the two give the same bits.
  `ops/nms.py:decay_nms_plain` is the same algorithm in plain PyTorch.
* "scan" (`nms_scan_kernel`): hard mode, k > 1024 (the exact-parity
  override `nms_top_k` up to pre_nms_top_k = 5000, and any k past it), and
  hard mode at every k under a threshold below -1e10. Hard NMS keeps a
  candidate iff no pick before it in the fixed order has IoU > threshold,
  so a lane needs only the IoUs of the candidates it visits against its
  picks, and stops after max_det picks. A CTA of `SCAN_WARPS` warps a
  lane: one vote finds the lane in order (top-k's output), else a bitonic
  sort of the candidates above the threshold ranks it in scratch; then
  chunks of 32 * SCAN_WARPS ranks, each candidate tested by its own thread
  against the picks in shared memory, the chunk's survivors resolved in
  order by warp 0 with ballots. Under a threshold below -1e10 the ordered
  pass takes the candidates above -1e10 and a tail follows: the lowest
  index at -1e10, then while a lower index is suppressed by the last pick
  (and so lifted to -1e10) that one, else the last pick again.
  `ops/nms.py:scan_nms_plain` is the same algorithm in plain PyTorch.
* "compact" (`nms_compact_kernel`): the soft modes, 1024 < k <= 8192 and
  score_threshold >= 0. The decay design's reasoning over a CTA of
  `COMPACT_WARPS` warps a lane, each thread's slots in shared memory: a
  candidate at or under the threshold is gone, and once a quarter of a
  thread's slots are gone they leave (the rest keep their order); the
  pick is the (largest score bits, lowest index) over the warps' partials
  with one barrier a round, and each warp's intersecting pairs are queued
  and scaled 32 at a time, bit-equal to the round kernel.
  `ops/nms.py:compact_nms_plain` is the same algorithm in plain PyTorch.
* "cluster" (`nms_cluster_kernel`): the soft modes everywhere else: k >
  8192, and every k under a negative threshold, where a decayed negative
  score (a picked -1e10 too) rises towards 0 and may be picked again. A
  lane on a thread-block cluster of up to `CLUSTER_MAX_CTAS` CTAs of
  `CLUSTER_WARPS` warps (`cluster_plan`), its candidates spread over the
  CTAs' shared memory (20 B a candidate), or past `CLUSTER_CTA_MAX` a CTA
  their scores in a scratch of the wrapper's and their boxes read from the
  input. A round: each warp's (largest orderable score, lowest index) and
  its box to double-buffered partials, one cluster barrier, every warp
  reducing the cluster's partials through distributed shared memory, then
  each thread decaying its slots (a candidate at or under a threshold >= 0
  passed over; each warp's intersecting pairs queued and scaled 32 at a
  time, `CLUSTER_QUEUE`) and finding its next best.
  `ops/nms.py:cluster_nms_plain` is the same algorithm in plain PyTorch.

PR 1's round kernel (`nms_lanes_kernel`, one CTA a lane, k up to
`MAX_CANDIDATES`, any mode and threshold) is on no path: `nms_design` never
names it. It stays the yardstick the designs are held to bit for bit,
reached only through `launch_design("rounds", ...)`.

This is a choice among five kernels, not a fallback: nothing is caught.
`kernel.launches` counts every launch, `kernel.launches_by[design]` those of
one design.

Build: `ops/cuda_build.py` compiles `csrc/nms.cu` with `nvcc` on first use
and loads it with ctypes. Importing this module needs no `nvcc`.

`nms_lanes` reaches its implementations through the custom op
`torch.ops.retinanet_torch.nms_lanes`, which dispatches by the tensors'
device: the kernel for CUDA, `batched_nms` for the CPU. A ctypes call on
`data_ptr()` cannot be traced; the op, with its fake implementation for the
output shapes, is what lets `torch.export` capture a serving graph with NMS
in it. Importing this module (or `retinanet_torch.ops`) registers the op,
which loading such a graph needs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.nms import SUPPRESSED, batched_nms

MAX_CANDIDATES = 8192  # rounds: five f32 planes, 160 KB of shared memory
SWEEP_MAX_CANDIDATES = 1024  # sweep: 32 alive bits a thread
DECAY_MAX_CANDIDATES = 1024  # decay: 32 scores a thread
COMPACT_MAX_CANDIDATES = 8192  # compact: 26 B a candidate on chip
# csrc/nms.cu's kScanWarps, kCompactWarps, CompactCta::kQueue and kCluster*
SCAN_WARPS = 4  # a scan chunk: 32 * SCAN_WARPS ranks
COMPACT_WARPS = 16  # a compact lane's threads: 32 * COMPACT_WARPS
COMPACT_QUEUE = 64  # pairs a compact warp queues before it scales them
CLUSTER_WARPS = 16  # a cluster CTA's threads: 32 * CLUSTER_WARPS
CLUSTER_MAX_CTAS = 8  # the portable cluster size
CLUSTER_CTA_TARGET = 8192  # candidates a CTA `cluster_plan` aims at
CLUSTER_CTA_MAX = 10240  # a CTA's candidates on chip, 20 B each: 200 KB
CLUSTER_QUEUE = 64  # pairs a cluster warp queues before it scales them


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
    lib.nms_decay_launch.argtypes = lib.nms_rounds_launch.argtypes
    lib.nms_decay_launch.restype = ctypes.c_int
    lib.nms_compact_launch.argtypes = lib.nms_rounds_launch.argtypes
    lib.nms_compact_launch.restype = ctypes.c_int
    lib.nms_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.nms_scan_launch.restype = ctypes.c_int
    lib.nms_cluster_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.nms_cluster_launch.restype = ctypes.c_int
    lib.nms_cluster_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nms_cluster_constants.restype = None
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
    """Which kernel `nms_lanes` launches on the card: "sweep", "scan",
    "decay", "compact" or "cluster"; never "rounds".

    The sweep assumes that a suppressed candidate (score -1e10) can never
    be picked, which holds exactly when the threshold is at or above
    -1e10; the scan takes every other hard lane (its tail picks the
    candidates at -1e10). The decay and compact designs assume that a
    score at or under the threshold never rises above it, which holds
    exactly when the threshold is at or above 0 (every scale lies in
    [0, 1]); the cluster design takes every other soft lane."""
    if not soft:
        if score_threshold >= SUPPRESSED and k <= SWEEP_MAX_CANDIDATES:
            return "sweep"
        return "scan"
    if score_threshold >= 0.0:
        if k <= DECAY_MAX_CANDIDATES:
            return "decay"
        if k <= COMPACT_MAX_CANDIDATES:
            return "compact"
    return "cluster"


class ClusterPlan(NamedTuple):
    ctas: int      # a lane's cluster
    per_cta: int   # candidates a CTA, a multiple of its threads
    on_chip: bool  # each CTA's candidates in shared memory, else spilled


def cluster_plan(k: int, ctas: Optional[int] = None) -> ClusterPlan:
    """The cluster design's numbers for lanes of k candidates: by default
    the fewest CTAs, a power of two up to CLUSTER_MAX_CTAS, that hold at
    most CLUSTER_CTA_TARGET candidates each, and two for a lane of more
    than half that (one CTA's round over its 10 to 16 slots a thread
    measured slower than two CTAs' barrier); `ctas` forces the cluster's
    size (the experiment tool's variants)."""
    threads = 32 * CLUSTER_WARPS
    if ctas is None:
        ctas = 1 if 2 * k <= CLUSTER_CTA_TARGET else 2
        while ctas < CLUSTER_MAX_CTAS and ctas * CLUSTER_CTA_TARGET < k:
            ctas *= 2
    if not 1 <= ctas <= CLUSTER_MAX_CTAS:
        raise ValueError(f"a cluster holds 1 to {CLUSTER_MAX_CTAS} CTAs, "
                         f"got {ctas}")
    per_cta = -(-(-(-k // ctas)) // threads) * threads
    return ClusterPlan(ctas, per_cta, per_cta <= CLUSTER_CTA_MAX)


# design -> (takes the soft modes, takes hard mode, most k, least
# score_threshold); None: no limit
_DOMAINS = {
    "sweep": (False, True, SWEEP_MAX_CANDIDATES, SUPPRESSED),
    "scan": (False, True, None, None),
    "decay": (True, False, DECAY_MAX_CANDIDATES, 0.0),
    "compact": (True, False, COMPACT_MAX_CANDIDATES, 0.0),
    "cluster": (True, False, None, None),
    "rounds": (True, True, MAX_CANDIDATES, None),
}


def design_takes(design: str, soft: bool, k: int,
                 score_threshold: float) -> bool:
    """Whether `design` takes lanes of k candidates in this mode at this
    threshold (`_DOMAINS`); raises for a name that is no design."""
    if design not in _DOMAINS:
        raise ValueError(f"no NMS design {design!r}")
    takes_soft, takes_hard, most_k, least_thr = _DOMAINS[design]
    return bool((takes_soft if soft else takes_hard)
                and (most_k is None or k <= most_k)
                and (least_thr is None or score_threshold >= least_thr))


def launch_design(design: str, boxes: torch.Tensor, scores: torch.Tensor,
                  max_detections: int, iou_threshold: float,
                  score_threshold: float, soft_nms_sigma: float = 0.0,
                  soft: bool = False,
                  library: Optional[CudaLibrary] = None,
                  ctas: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches one design on checked CUDA tensors. `nms_lanes` is the
    public entry; measurements call this to time "rounds" (the yardstick,
    on no path) on inputs that `nms_design` gives to another design, a
    design on any k it takes (the scan, compact and cluster designs below
    their routes' k too), another build of `csrc/nms.cu` (`library`), or
    the cluster design on clusters of `ctas` CTAs. Each design takes the
    modes, k and thresholds of `_DOMAINS`, and raises on others."""
    library = library or kernel
    lanes, k = scores.shape
    if not design_takes(design, soft, k, score_threshold):
        raise ValueError(
            f"the {design} design does not take soft={soft}, k={k}, "
            f"score_threshold={score_threshold}")
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
    if design != "rounds" and boxes.data_ptr() % 16:
        boxes = boxes.clone()  # the kernels load a box as one float4
    if design == "sweep":
        err = lib.nms_sweep_launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold), *outputs)
    elif design == "scan":
        # a lane's sort keys, read only where the lane is not in order
        sort_cap = 1 << (k - 1).bit_length()
        keys = torch.empty((lanes, sort_cap), dtype=torch.int64,
                           device=boxes.device)
        err = lib.nms_scan_launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold), sort_cap,
            keys.data_ptr(), *outputs)
    elif design == "cluster":
        plan = cluster_plan(k, ctas)
        # the scores of lanes past what the CTAs hold on chip
        spill = (None if plan.on_chip else
                 torch.empty((lanes, k), dtype=torch.float32,
                             device=boxes.device))
        err = lib.nms_cluster_launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold),
            float(2.0 * soft_nms_sigma), _mode(soft, soft_nms_sigma),
            plan.ctas, plan.per_cta,
            None if spill is None else spill.data_ptr(), *outputs)
    else:
        launch = {"decay": lib.nms_decay_launch,
                  "compact": lib.nms_compact_launch,
                  "rounds": lib.nms_rounds_launch}[design]
        err = launch(
            boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
            float(iou_threshold), float(score_threshold),
            float(2.0 * soft_nms_sigma), _mode(soft, soft_nms_sigma),
            *outputs)
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
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    return torch.ops.retinanet_torch.nms_lanes(
        boxes, scores, int(max_detections), float(iou_threshold),
        float(score_threshold), float(soft_nms_sigma), bool(soft))


@torch.library.custom_op("retinanet_torch::nms_lanes", mutates_args=(),
                         device_types="cpu")
def _nms_lanes_op(boxes: torch.Tensor, scores: torch.Tensor,
                  max_detections: int, iou_threshold: float,
                  score_threshold: float, soft_nms_sigma: float,
                  soft: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return batched_nms(boxes, scores, max_detections, iou_threshold,
                       score_threshold, soft_nms_sigma, soft)


@_nms_lanes_op.register_kernel("cuda")
def _nms_lanes_cuda(boxes, scores, max_detections, iou_threshold,
                    score_threshold, soft_nms_sigma, soft):
    return launch_design(
        nms_design(soft, scores.shape[1], score_threshold), boxes, scores,
        max_detections, iou_threshold, score_threshold, soft_nms_sigma, soft)


@_nms_lanes_op.register_fake
def _nms_lanes_fake(boxes, scores, max_detections, iou_threshold,
                    score_threshold, soft_nms_sigma, soft):
    lanes = boxes.shape[0]
    return (boxes.new_empty((lanes, max_detections), dtype=torch.int32),
            boxes.new_empty((lanes, max_detections)),
            boxes.new_empty((lanes,), dtype=torch.int32))
