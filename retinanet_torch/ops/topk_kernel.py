"""Top-k selection over rows: the CUDA kernels of `csrc/topk.cu`, their
build, their binding and their wrapper.

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

Two designs, picked by `topk_design` from the shape alone, both exact:

* "row": short rows (the top-k over the NMS survivors, 8,000 float32 keys
  a request, k = 100), where latency and not bytes bounds the work. One
  CTA of 1024 threads a row reads it once into registers (`row_plan`; a
  row of more than 16,384 keys, only when C > 320, in tiles read again
  each pass), 16-byte loads when the row is contiguous, in place at
  stride C otherwise. A radix select of 11 bits a pass (three for f32 keys, two
  for 16-bit) over a shared histogram, the one thread whose bins reach k
  picking the digit (three barriers a pass; the passes stop once the bin
  found holds exactly the winners still needed), the winners into shared
  memory by a scan (ties at the k-th place ranked in index order), then
  for k <= 128 each winner's place by counting the winners above it, the
  CTA's bitonic sort above. `tests/test_torch_topk.py:_kernel_walk` walks
  the design from the numbers below.
* "slab": every long row (the per-class and global lanes). A cooperative
  kernel reads each image's (N, C) slab whole with 16-byte loads, all CTAs
  sharing every row: a histogram level (the next `hist_bits` of the unique
  key, per class in shared memory) and a level that writes each row's
  candidates, at or above the digit found, into its buffer of
  `capacity` keys; a row whose candidates would not fit reads the slab
  again for the next digit. A second kernel, a CTA a row, finishes the
  radix select inside the candidates and sorts the k. Two launches a
  selection; the scratch is one `torch.empty` that the kernel zeroes.
  `slab_plan` gives the numbers; `tests/test_torch_topk_slab.py` walks the
  design in numpy from them.

Both designs take every k <= N, in every mode: the k winners are sorted by
the CTA's bitonic network in shared memory up to SORT_ON_CHIP_MAX of them.
Past it the select launch writes them unsorted into a scratch of (rows, k)
64-bit keys and the radix sort of `csrc/topk.cu` sorts them and writes the
outputs (`radix_plan`: an LSD sort of the V + I bits the keys hold, 8-bit
digits, 32-bit keys when they fit; one read for every digit's histogram,
then a stable scatter a pass, a row's tiles in order on one CTA or split
over several when the rows cannot fill the card; a pass whose digit is the
same for a whole row skipped for it). `kernel.launches_by_sort["radix"]`
counts those sorts. The bitonic network through global memory
(`sort="bitonic"`: a scratch of `sort_width(k)` keys a row, the passes of
stride under SORT_BLOCK a block at a time in shared memory) is on no path:
the yardstick of `tools/topk_experiments.py --design wide`.

A failed build or launch raises; neither design gives way to the other or
to the plain version, nor one sort to the other.

Build: `ops/cuda_build.py` compiles `csrc/topk.cu` with `nvcc` on first use
and loads it with ctypes. Importing this module needs no `nvcc`.
`select_top_k` reaches the kernels through the custom op
`torch.ops.retinanet_torch.top_k_rows`, which dispatches by the tensor's
device (the kernels for CUDA, `top_k_rows_plain` for the CPU) and has a
fake implementation for its output shapes, so that `torch.export` can
capture a serving graph with the selection in it. `kernel.launches` counts
every selection, `kernel.launches_by[mode]` those of one mode and
`kernel.launches_by_design[design]` those of one design and
`kernel.launches_by_sort[sort]` the selections past SORT_ON_CHIP_MAX by
their sort.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.topk import check_rows, packed_layout, \
    top_k_rows_plain

# csrc/topk.cu's kSortOnChipMax and kSortBlock, as `topk_sort_constants`
# returns them: up to SORT_ON_CHIP_MAX winners are sorted in shared memory
# (the next power of two of them, 8 bytes each); past it by the radix sort
# (or, asked, in a scratch of (rows, next power of two >= k) keys,
# SORT_BLOCK keys of it at a time on chip)
SORT_ON_CHIP_MAX = 8192
SORT_BLOCK = 16384
_MODE_CODE = {"packed": 0, "bf16": 1, "f32": 2}
DESIGNS = ("row", "slab")
# the sorts of more winners than SORT_ON_CHIP_MAX: csrc/topk.cu's
# kSortRadix and kSortBitonic
SORTS = {"radix": 1, "bitonic": 2}

# The radix sort: csrc/topk.cu's kRadixThreads, kRadixItems, kRadixBits,
# kRadixMaxPasses, kRadixTargetCtas and kRadixPrepareCtas, as
# `topk_radix_constants` returns them.
RADIX_THREADS = 256         # a CTA, one bin a thread
RADIX_ITEMS = 16            # keys a thread holds in a tile
RADIX_TILE = RADIX_THREADS * RADIX_ITEMS
RADIX_BITS = 8              # a digit's most bits
RADIX_BINS = 1 << RADIX_BITS
RADIX_MAX_PASSES = 8
RADIX_TARGET_CTAS = 512     # a pass's CTAs aimed at: rows x segments
RADIX_PREPARE_CTAS = 2048   # the prepare's, which keeps no order

# The row design: csrc/topk.cu's kRowThreads, kRowItems, kRowDigitBits,
# kRankSortMax and kRankLanes, as `topk_row_constants` returns them.
ROW_THREADS = 1024
ROW_ITEMS = 16              # the most keys a thread holds
ROW_DIGIT_BITS = 11
ROW_RANK_SORT_MAX = 128     # k ranked by counting, no barrier
ROW_RANK_LANES = ROW_THREADS // ROW_RANK_SORT_MAX   # lanes a winner
ROW_TILE = ROW_THREADS * ROW_ITEMS                  # a CTA's keys at once

# The slab design. Those that csrc/topk.cu also has (kSlab*, kFinalBits,
# kChunkAnchors) carry the same values there.
SLAB_MIN_ROW = 16384        # shorter rows take "row"
SLAB_MAX_CLASSES = 320      # C x 256 16-bit counters in the budget
SLAB_HIST_BYTES = 160 * 1024
SLAB_CAPACITY = 16384       # a row's candidate buffer: max(this, 2 k)
SLAB_FINAL_BITS = 11        # the final kernel's digit
SLAB_MAX_LEVELS = 16
SLAB_ROW_STATE_BYTES = 32
SLAB_STAMPS = 4 + 2 * SLAB_MAX_LEVELS
SLAB_CHUNK_ANCHORS = 65528  # a chunk's anchors: 16-bit counters suffice
SLAB_THREADS = 512          # the cooperative kernel's CTA


def sort_width(k: int) -> int:
    """The keys the final sort of k winners runs over: the next power of
    two >= k."""
    return 1 << max(0, int(k - 1).bit_length())


class RadixPlan(NamedTuple):
    key_bits: int       # V + I: the bits the compact keys hold
    key_bytes: int      # 4 when they fit 32 bits, else 8
    digits: Tuple[Tuple[int, int], ...]   # (shift, bits), lowest first
    tiles: int          # of RADIX_TILE keys, a row
    segments: int       # CTAs a row
    seg_tiles: int      # tiles a segment
    prep_segments: int  # the prepare kernel's CTAs a row
    scratch_bytes: int  # histograms (rows x passes x bins) and counts
    #                     (rows x segments x bins when segments > 1)


def radix_plan(rows: int, k: int, key_bits: int,
               segments: Optional[int] = None) -> RadixPlan:
    """The radix sort's numbers for rows of k keys of key_bits bits: the
    digits as even as they come in ceil(key_bits / RADIX_BITS) passes, and
    the CTAs a row, enough for RADIX_TARGET_CTAS CTAs a pass (one a row
    once rows reach it), by shape alone; the prepare kernel's own CTAs a
    row, enough for RADIX_PREPARE_CTAS. `segments` forces the CTAs a row
    of the passes (clamped to the tiles), for measurements.
    csrc/topk.cu:radix_plan."""
    passes = -(-key_bits // RADIX_BITS)
    base, extra = divmod(key_bits, passes)
    digits, at = [], 0
    for i in range(passes):
        bits = base + (i < extra)
        digits.append((at, bits))
        at += bits
    tiles = -(-k // RADIX_TILE)
    s = segments if segments else -(-RADIX_TARGET_CTAS // rows)
    s = max(1, min(s, tiles))
    seg_tiles = -(-tiles // s)
    s = -(-tiles // seg_tiles)
    prep = min(-(-RADIX_PREPARE_CTAS // rows), tiles)
    prep = -(-tiles // -(-tiles // prep))
    words = rows * passes * RADIX_BINS + (rows * s * RADIX_BINS
                                          if s > 1 else 0)
    return RadixPlan(key_bits, 4 if key_bits <= 32 else 8, tuple(digits),
                     tiles, s, seg_tiles, prep, 4 * words)


def radix_layout(n: int, mode: str, design: str) -> Tuple[int, int, int]:
    """(vshift, vbits, ibits) of the winners a design's select kernel
    writes for the radix sort: the value key of vbits bits at bit vshift
    (the slab design's unique key e = value key << I | (2^I - 1 - index);
    the row design's value key << 32 | ~index), the index part in the low
    I = ibits bits."""
    drop = packed_layout(n)[1] if mode == "packed" else 0
    vbits = 32 if mode == "f32" else 16 - drop
    ibits = max(int(n - 1).bit_length(), 1)
    return (ibits if design == "slab" else 32), vbits, ibits


def topk_design(b: int, n: int, c: int, k: int) -> str:
    """The design that selects k of each of the B x C rows of N elements:
    "slab" for rows of at least SLAB_MIN_ROW elements and at most
    SLAB_MAX_CLASSES rows an image, else "row". By shape alone."""
    del b, k
    return "slab" if n >= SLAB_MIN_ROW and c <= SLAB_MAX_CLASSES else "row"


class RowPlan(NamedTuple):
    tiles: int          # reads of the row in each pass (1: resident)
    items: int          # keys a thread holds, consecutive
    vector: int         # keys a 16-byte load brings, when C = 1
    digits: Tuple[Tuple[int, int], ...]   # (shift, bits) of each pass
    rank_sort: bool     # each winner's place by counting


def row_plan(n: int, k: int, mode: str) -> RowPlan:
    """The row design's numbers for rows of n keys and k winners."""
    vector = 4 if mode == "f32" else 8
    first = min(n, ROW_TILE)
    items = -(-(-(-first // ROW_THREADS)) // vector) * vector
    drop = packed_layout(n)[1] if mode == "packed" else 0
    top, digits = (32 if mode == "f32" else 16 - drop), []
    while top > 0:
        shift = max(top - ROW_DIGIT_BITS, 0)
        digits.append((shift, top - shift))
        top = shift
    return RowPlan(-(-n // ROW_TILE), items, vector, tuple(digits),
                   k <= ROW_RANK_SORT_MAX)


class SlabPlan(NamedTuple):
    key_bits: int       # V: bits of the value key
    idx_bits: int       # I: bits of the index part of the unique key
    hist_bits: int      # D: bits of a slab level's digit
    capacity: int       # a row's candidate buffer, min(capacity, n) >= k
    levels: int         # the most levels (reads of the slab)
    scratch_bytes: int
    offsets: Tuple[int, int, int, int, int]   # buf, ghist, rows, active,
    #                                           stamps


def _up16(v: int) -> int:
    return (v + 15) // 16 * 16


def slab_plan(b: int, n: int, c: int, k: int, mode: str,
              capacity: Optional[int] = None) -> SlabPlan:
    """The slab design's numbers for x (b, n, c) and k. `capacity` (at
    least k) replaces the default buffer of max(SLAB_CAPACITY, 2 k) keys a
    row, as the tests do to make rows overflow."""
    if c > SLAB_MAX_CLASSES:
        raise ValueError(f"the slab design takes at most "
                         f"{SLAB_MAX_CLASSES} classes, got {c}")
    drop = packed_layout(n)[1] if mode == "packed" else 0
    key_bits = 32 if mode == "f32" else 16 - drop
    idx_bits = max(int(n - 1).bit_length(), 1)
    hist_bits = min(16, key_bits,
                    (SLAB_HIST_BYTES // (2 * c)).bit_length() - 1)
    cap = max(SLAB_CAPACITY, 2 * k) if capacity is None else int(capacity)
    if cap < k:
        raise ValueError(f"capacity {cap} is below k={k}")
    cap = min(cap, n)
    levels = -(-(key_bits + idx_bits) // hist_bits) + 1
    rows = b * c
    buf = 0
    ghist = _up16(buf + rows * cap * 8)
    states = _up16(ghist + (rows << hist_bits) * 4)
    active = _up16(states + rows * SLAB_ROW_STATE_BYTES)
    stamps = _up16(active + 2 * SLAB_MAX_LEVELS * 4)
    total = _up16(stamps + SLAB_STAMPS * 8)
    return SlabPlan(key_bits, idx_bits, hist_bits, cap, levels, total,
                    (buf, ghist, states, active, stamps))


def declare(lib: ctypes.CDLL) -> None:
    lib.topk_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_rows_launch.restype = ctypes.c_int
    lib.topk_rows_wide_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.topk_rows_wide_launch.restype = ctypes.c_int
    lib.topk_slab_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.topk_slab_scratch_bytes.restype = ctypes.c_longlong
    lib.topk_slab_launch.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_slab_launch.restype = ctypes.c_int
    lib.topk_slab_wide_launch.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.topk_slab_wide_launch.restype = ctypes.c_int
    lib.topk_radix_sort_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_radix_sort_launch.restype = ctypes.c_int
    lib.topk_radix_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.topk_radix_plan.restype = None
    lib.topk_error_string.argtypes = [ctypes.c_int]
    lib.topk_error_string.restype = ctypes.c_char_p


class TopkLibrary(CudaLibrary):
    """`csrc/topk.cu` built, with its counts: a selection adds one to
    `launches`, to `launches_by[mode]` and to `launches_by_design[design]`
    (the slab design's selection is two kernel launches), and one past
    SORT_ON_CHIP_MAX winners to `launches_by_sort[sort]` (a radix sort is a
    memset and 2 + passes launches, 2 + 2 x passes with segments)."""

    def __init__(self, name: str = "topk", source=None):
        super().__init__(name, declare, source)
        self.launches_by_design: collections.Counter = collections.Counter()
        self.launches_by_sort: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        super().reset_counts()
        self.launches_by_design.clear()
        self.launches_by_sort.clear()


# the built library, and the counts of kernel launches
kernel = TopkLibrary()


def launch(x: torch.Tensor, k: int, mode: str, design: Optional[str] = None,
           capacity: Optional[int] = None,
           library: Optional[CudaLibrary] = None,
           sort: Optional[str] = None, segments: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One selection on a checked contiguous CUDA tensor x (B, N, C):
    values and int32 indices (B, C, k). `design` forces "row" or "slab"
    (default `topk_design`); `capacity` sets the slab design's candidate
    buffer; `library` is another build of `csrc/topk.cu` for
    measurements. `sort` forces how the winners are sorted, for
    measurements: "radix" (the default past SORT_ON_CHIP_MAX; any k > 1)
    or "bitonic" (the network through global memory, k > SORT_ON_CHIP_MAX
    only); `segments` the radix sort's CTAs a row."""
    return _launch(x, k, mode, design, capacity, library, sort,
                   segments)[:2]


def slab_trace(x: torch.Tensor, k: int, mode: str,
               capacity: Optional[int] = None,
               library: Optional[CudaLibrary] = None) -> dict:
    """One slab selection, then what its scratch recorded: the device ns
    of each phase of the cooperative kernel (the zeroing, then each level's
    read of the slab and its choice) and of the final kernel, and the rows
    deep or ready after each level's choice, and of those the rows still
    deep, and the candidates written in all."""
    _, _, scratch, plan = _launch(x, k, mode, "slab", capacity, library,
                                  None, None)
    torch.cuda.synchronize(x.device)
    _, _, states_at, active_at, stamps_at = plan.offsets
    b, _, c = x.shape
    states = scratch[states_at:states_at + b * c * SLAB_ROW_STATE_BYTES].view(
        torch.int32).view(b * c, SLAB_ROW_STATE_BYTES // 4)
    written = int(states[:, 6].sum())      # RowState.cnt
    counts = scratch[active_at:active_at + 2 * SLAB_MAX_LEVELS * 4].view(
        torch.int32).tolist()
    active, deep = counts[:SLAB_MAX_LEVELS], counts[SLAB_MAX_LEVELS:]
    stamps = scratch[stamps_at:stamps_at + SLAB_STAMPS * 8].view(
        torch.int64).tolist()
    levels = next((i + 1 for i, a in enumerate(active) if a == 0),
                  plan.levels)
    phases = {"zero": stamps[1] - stamps[0]}
    prev = stamps[1]
    for level in range(levels):
        pass_end, choose_end = stamps[2 + 2 * level], stamps[3 + 2 * level]
        phases[f"level {level} read"] = pass_end - prev
        phases[f"level {level} choice"] = choose_end - pass_end
        prev = choose_end
    phases["final"] = stamps[-1] - stamps[-2]
    return {"phase_ns": phases, "levels": levels,
            "rows_active": active[:levels], "rows_deep": deep[:levels],
            "candidates": written, "plan": plan._asdict()}


def _launch(x, k, mode, design, capacity, library, sort, segments):
    library = library or kernel
    check_rows(x, k, mode)
    sort = sort or ("radix" if k > SORT_ON_CHIP_MAX else None)
    if sort is not None and sort not in SORTS:
        raise ValueError(f"sort must be one of {tuple(SORTS)}, got {sort!r}")
    if (sort == "bitonic" and k <= SORT_ON_CHIP_MAX) or (
            sort == "radix" and k < 2):
        raise ValueError(f"the {sort} sort does not take k={k}")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous CUDA tensor")
    b, n, c = x.shape
    if n >= 2 ** 31 or b * c >= 2 ** 31:
        raise ValueError(f"too many rows or too long a row for the kernel: "
                         f"{tuple(x.shape)}")
    design = design or topk_design(b, n, c, k)
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    values = torch.empty((b, c, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, c, k), dtype=torch.int32, device=x.device)
    scratch = plan = None
    if b * c == 0:
        return values, idx, scratch, plan
    lib = library.build()
    drop = packed_layout(n)[1] if mode == "packed" else 0
    device = device_index(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the winners past the shared memory's sort: k a row for the radix
    # sort, the next power of two for the bitonic network
    sort_keys = (None if sort is None else torch.empty(
        (b * c, k if sort == "radix" else sort_width(k)), dtype=torch.int64,
        device=x.device))
    if design == "row" and sort_keys is None:
        err = lib.topk_rows_launch(
            x.data_ptr(), b, n, c, k, _MODE_CODE[mode], drop,
            values.data_ptr(), idx.data_ptr(), device, stream)
    elif design == "row":
        err = lib.topk_rows_wide_launch(
            x.data_ptr(), b, n, c, k, _MODE_CODE[mode], drop,
            values.data_ptr(), idx.data_ptr(), sort_keys.data_ptr(),
            SORTS[sort], device, stream)
    else:
        if n * c >= 2 ** 31:
            raise ValueError(f"an image of {n} x {c} elements is too large "
                             "for the slab design")
        plan = slab_plan(b, n, c, k, mode, capacity)
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                              device=x.device)
        common = (x.data_ptr(), b, n, c, k, _MODE_CODE[mode], drop,
                  plan.hist_bits, plan.capacity, plan.levels,
                  scratch.data_ptr(), plan.scratch_bytes, values.data_ptr(),
                  idx.data_ptr())
        err = (lib.topk_slab_launch(*common, device, stream)
               if sort_keys is None else lib.topk_slab_wide_launch(
                   *common, sort_keys.data_ptr(), SORTS[sort], device,
                   stream))
    if err == 0 and sort == "radix":
        vshift, vbits, ibits = radix_layout(n, mode, design)
        rplan = radix_plan(b * c, k, vbits + ibits, segments)
        alt = torch.empty_like(sort_keys)
        hist = torch.empty(rplan.scratch_bytes, dtype=torch.uint8,
                           device=x.device)
        err = lib.topk_radix_sort_launch(
            sort_keys.data_ptr(), alt.data_ptr(), hist.data_ptr(),
            rplan.scratch_bytes, b * c, k, vshift, vbits, ibits,
            _MODE_CODE[mode], drop, segments or 0, values.data_ptr(),
            idx.data_ptr(), device, stream)
    if err != 0:
        raise RuntimeError(f"top-k kernel ({design}, {mode}, sort {sort}) "
                           "launch failed: "
                           + lib.topk_error_string(err).decode())
    library.launches += 1
    library.launches_by[mode] += 1
    if isinstance(library, TopkLibrary):
        library.launches_by_design[design] += 1
        if sort is not None:
            library.launches_by_sort[sort] += 1
    return values, idx, scratch, plan


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
