"""NMS kernel experiments on the card: what a round of the round kernel
spends its time on, the sweep kernel's own choices, the sweep against a
suppression bit matrix, the soft modes' kernels, and the designs past
1,024 candidates.

    python -m retinanet_torch.tools.nms_experiments [--batch 8]
    python -m retinanet_torch.tools.nms_experiments --soft
    python -m retinanet_torch.tools.nms_experiments --long

The hard-mode inputs are the ones the flagship serving path hands to
`nms_lanes` (PerClassHardNMS: batch x 80 lanes of 256 candidates, seeded
random weights with the class-head prediction bias at 0, so every lane runs
all 100 rounds), and a "trained-like" copy of them in which few scores
clear the threshold.

`--soft` times every design that takes the soft modes (Gaussian decay,
sigma 0.25 after the halving, IoU threshold 1.0, score threshold 0.05,
k = 256, 100 detections) on the seeded lanes of `chip_smoke.py`'s NMS
phase cut to L = 640, 80, 8 and 1, on the real inputs of a zero-bias
flagship request in PerClassSoftNMS (batch 8 and 1: L = 640 and 80) and
in GlobalSoftNMS with `filter_per_class` false (L = 8 and 1), and on a
trained-like copy of the PerClassSoftNMS batch-8 inputs. The designs are
timed in turns (decay, rounds, rounds, decay).

`--long` times the exact-parity lane (`inference.nms_top_k` 5000, every
config's pre_nms_top_k): the scan (hard) and compact (soft) designs beside
the round kernel in turns (new, rounds, rounds, new) and plain, on the
real inputs of a zero-bias flagship request in PerClassHardNMS,
GlobalHardNMS, PerClassSoftNMS and GlobalSoftNMS at batch 8 and 1 (L =
640, 80, 8, 1; k = 5,000), on seeded lanes at the same L and k (not in
order: the scan ranks them), and on a trained-like copy of each real
input (five candidates a lane clear the threshold); then the scan and
compact variants and cuts on the batch-8 and batch-1 inputs.

It runs on the card only and prints device times
(`utils/benchmark.py:device_time_ms`, L2 warm) beside the card's name and
power limit.

Each variant of `csrc/nms.cu` is the source with one edit, written into the
build directory and compiled beside the others; the package's own build is
the first row. A variant's answer is compared with `batched_nms` and
reported, not required: a fast reciprocal may flip an IoU at the threshold,
and a "cut" stops the decay design after a step (the differences of the
cuts' times are the steps' times).
`tools/nms_bitmatrix.cu` is the alternative design; the package never calls
it.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from retinanet_torch.ops import nms_kernel
from retinanet_torch.ops.cuda_build import CudaLibrary, device_index
from retinanet_torch.ops.nms import batched_nms
from retinanet_torch.tools.kernel_variants import (Edits, build_all,
                                                   card_line,
                                                   variant_library)
from retinanet_torch.utils.benchmark import device_time_ms

_REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = (_REPO / "configs" / "v3-8"
            / "mscoco-retinanet-resnet50-640x640-30x-64.json")

# the soft modes: the designs that take them, the lanes of the seeded
# loads, the modes and batches whose real inputs are captured
SOFT_DESIGNS = ("decay", "rounds")
SOFT_LANES = (640, 80, 8, 1)
SOFT_MODES = ("PerClassSoftNMS", "GlobalSoftNMS")
SOFT_BATCHES = (8, 1)
# the exact-parity lane: `inference.nms_top_k` at every config's
# pre_nms_top_k, in the four NMS modes of a serving request
LONG_K = 5000
LONG_MODES = ("PerClassHardNMS", "GlobalHardNMS", "PerClassSoftNMS",
              "GlobalSoftNMS")

# name -> (design it changes, [(text in csrc/nms.cu, its replacement)])
VARIANTS: Dict[str, Tuple[str, Edits]] = {
    "rounds: fast division": ("rounds", [
        ("const float iou = __fdiv_rn(inter, uni);",
         "const float iou = __fdividef(inter, uni);")]),
    "rounds: partials scanned, no second shuffle reduction": ("rounds", [
        ("    v = wl < nwarps ? part_v[buf][wl] : -INFINITY;\n"
         "    bi = wl < nwarps ? part_i[buf][wl] : INT_MAX;\n"
         "    warp_argmax(v, bi);\n",
         "    v = part_v[buf][0];\n    bi = part_i[buf][0];\n"
         "    for (int w = 1; w < nwarps; ++w) {\n"
         "      take_better(v, bi, part_v[buf][w], part_i[buf][w]);\n"
         "    }\n")]),
    "rounds: 128 threads a lane": ("rounds", [
        ("constexpr int kMaxThreads = 256;",
         "constexpr int kMaxThreads = 128;")]),
    "rounds: 64 threads a lane": ("rounds", [
        ("constexpr int kMaxThreads = 256;",
         "constexpr int kMaxThreads = 64;")]),
    "rounds: 32 threads a lane": ("rounds", [
        ("constexpr int kMaxThreads = 256;",
         "constexpr int kMaxThreads = 32;")]),
    "sweep: candidates read from shared memory": ("sweep", [
        ("static constexpr bool kInRegs = CPT <= 8;",
         "static constexpr bool kInRegs = false;")]),
    "sweep: IEEE division for every pair": ("sweep", [
        ("  if (!(fabsf(__fsub_rn(q, thr)) >= margin)) q = "
         "__fdiv_rn(inter, uni);",
         "  q = __fdiv_rn(inter, uni);")]),
    "sweep: one stage, every slot computed in every round": ("sweep", [
        ("      for (int i = stage * kPer; i < WIDTH; ++i) {",
         "      for (int i = 0; i < WIDTH; ++i) {")]),
    "sweep: full width whatever n": ("sweep", [
        ("  const int slots = (n + 31) >> 5;",
         "  const int slots = CPT;")]),
    "sweep: one lane a CTA": ("sweep", [
        ("__launch_bounds__(32 * (32 / CPT))", "__launch_bounds__(32)"),
        ("constexpr int kWarps = 32 / CPT;", "constexpr int kWarps = 1;")]),
    "sweep: 16 candidates a thread at k <= 256": ("sweep", [
        ("  if (k <= 256) {\n    err = launch_sweep<8>(",
         "  if (k <= 256) {\n    err = launch_sweep<16>(")]),
    "decay: every slot whatever n": ("decay", [
        ("  const int width = (n + 31) / 32;", "  const int width = CPT;")]),
    "scan: one warp a lane": ("scan", [
        ("constexpr int kScanWarps = 4;", "constexpr int kScanWarps = 1;")]),
    "scan: two warps a lane": ("scan", [
        ("constexpr int kScanWarps = 4;", "constexpr int kScanWarps = 2;")]),
    "scan: eight warps a lane": ("scan", [
        ("constexpr int kScanWarps = 4;", "constexpr int kScanWarps = 8;")]),
    "compact: one warp a lane, no barrier": ("compact", [
        ("constexpr int kCompactWarps = 16;",
         "constexpr int kCompactWarps = 1;")]),
    "compact: four warps a lane": ("compact", [
        ("constexpr int kCompactWarps = 16;",
         "constexpr int kCompactWarps = 4;")]),
    "compact: eight warps a lane": ("compact", [
        ("constexpr int kCompactWarps = 16;",
         "constexpr int kCompactWarps = 8;")]),
    "compact: 32 warps a lane (k <= 7,000 fits)": ("compact", [
        ("constexpr int kCompactWarps = 16;",
         "constexpr int kCompactWarps = 32;")]),
    "compact: a queue of 128 pairs": ("compact", [
        ("static constexpr int kQueue = 64;",
         "static constexpr int kQueue = 128;")]),
    # cuts: each computes something else and is timed only; the differences
    # are the steps' times
    "decay cut: no scales (the queue's pairs keep their scores)": ("decay", [
        ("        l.qi[q] = gaussian_scale(l.qi[q], l.qu[q], iou_thr, "
         "two_sigma);", "        l.qi[q] = 1.0f;")]),
    "decay cut: no queue (only the pick leaves)": ("decay", [
        ("    if (GAUSSIAN && queued > 0) {",
         "    if (false) {")]),
    "decay cut: the arg-max and the pick alone": ("decay", [
        ("#pragma unroll\n    for (int i = 0; i < WIDTH; ++i) {\n"
         "      const int p = 32 * i + wl;\n      const float cx1",
         "#pragma unroll\n    for (int i = 0; i < 0; ++i) {\n"
         "      const int p = 32 * i + wl;\n      const float cx1")]),
    "scan cut: every lane sorted": ("scan", [
        ("  in_order = __syncthreads_and(in_order);",
         "  in_order = __syncthreads_and(false);")]),
    "scan cut: the vote and the sort alone": ("scan", [
        ("  for (int base = 0; base < n && picks < max_det; "
         "base += kThreads) {",
         "  for (int base = 0; base < 0; base += kThreads) {")]),
    "compact cut: the staging and the first best alone": ("compact", [
        ("  for (; picks < max_det; ++picks) {\n    // the pick: the largest",
         "  for (; picks < 0; ++picks) {\n    // the pick: the largest")]),
    "compact cut: no scales (the queue's pairs keep their scores)": (
        "compact", [
            ("              __fmul_rn(sc[a], gaussian_scale(qi[q], qu[q], "
             "iou_thr,\n                                              "
             "two_sigma)),",
             "              sc[a],"),
            ("            __fmul_rn(sc[a],\n                      "
             "gaussian_scale(qi[q], qu[q], iou_thr, two_sigma)),",
             "            sc[a],")]),
    "compact cut: the arg-max and the pick alone": ("compact", [
        ("    const int width = __reduce_max_sync(kFull, "
         "static_cast<unsigned>(m));",
         "    const int width = 0;")]),
    "compact cut: no best pass (each round the same best)": ("compact", [
        ("    best = 0.0f;\n    best_at = tid;\n    int gone = 0;\n"
         "    for (int i = 0; i < m; ++i) {",
         "    int gone = 0;\n    for (int i = 0; i < 0; ++i) {")]),
    "compact cut: the reductions and the barrier alone": ("compact", [
        ("    const int width = __reduce_max_sync(kFull, "
         "static_cast<unsigned>(m));",
         "    const int width = 0;"),
        ("    best = 0.0f;\n    best_at = tid;\n    int gone = 0;\n"
         "    for (int i = 0; i < m; ++i) {",
         "    int gone = 0;\n    for (int i = 0; i < 0; ++i) {")]),
    "compact: each area from its box": ("compact", [
        ("      const float ca = area[a];",
         "      const float ca = box_area(c.x, c.y, c.z, c.w);")]),
}


def _declare_bitmatrix(lib: ctypes.CDLL) -> None:
    lib.nms_bitmatrix_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.nms_bitmatrix_launch.restype = ctypes.c_int


bitmatrix = CudaLibrary("nms_bitmatrix", _declare_bitmatrix,
                        source=Path(__file__).with_name("nms_bitmatrix.cu"))


def nms_bitmatrix(boxes, scores, max_detections, iou_threshold,
                  score_threshold):
    """`nms_lanes` in hard mode, k <= 256, through the bit-matrix kernel."""
    lanes, k = scores.shape
    idx = torch.empty((lanes, max_detections), dtype=torch.int32,
                      device=boxes.device)
    out_scores = torch.empty((lanes, max_detections), dtype=torch.float32,
                             device=boxes.device)
    valid = torch.empty((lanes,), dtype=torch.int32, device=boxes.device)
    lib = bitmatrix.build()
    err = lib.nms_bitmatrix_launch(
        boxes.data_ptr(), scores.data_ptr(), lanes, k, max_detections,
        float(iou_threshold), float(score_threshold), idx.data_ptr(),
        out_scores.data_ptr(), valid.data_ptr(), device_index(boxes.device),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bit-matrix kernel launch failed: error {err}")
    bitmatrix.launches += 1
    return idx, out_scores, valid


def flagship_params(mode: str = "PerClassHardNMS",
                    nms_top_k: Optional[int] = None):
    """The flagship config with `inference.mode` set (a global mode needs
    `filter_per_class` false) and, if given, `inference.nms_top_k`."""
    from retinanet_torch.core.config import Config
    params = Config(str(FLAGSHIP)).params
    params.inference.mode = mode
    if mode.startswith("Global"):
        params.inference.filter_per_class = False
    if nms_top_k is not None:
        params.inference.nms_top_k = nms_top_k
    return params


def serving_nms_inputs(batches, mode: str = "PerClassHardNMS",
                       nms_top_k: Optional[int] = None) -> dict:
    """What the flagship serving path in `mode` (with `nms_top_k`, if
    given) gives `nms_lanes` for seeded random images, one model for all
    `batches`: batch -> (boxes, scores, max_det, iou_thr, score_thr,
    sigma, soft)."""
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import postprocess
    from retinanet_torch.profile_serving import zero_class_prior
    params = flagship_params(mode, nms_top_k)
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    post = postprocess.make_postprocess_fn(params, from_params(params),
                                           "cuda")
    h, w = params.input.input_shape
    rng = np.random.default_rng(0)
    captured = {}
    for batch in batches:
        images = torch.from_numpy(rng.integers(
            0, 256, (batch, h, w, 3)).astype(np.uint8))
        calls = []

        def recording(*args):
            calls.append(args)
            return nms_kernel.nms_lanes(*args)

        postprocess.nms_lanes = recording
        try:
            with torch.inference_mode():
                post(fused_fn(images))
        finally:
            postprocess.nms_lanes = nms_kernel.nms_lanes
        boxes, scores, *rest = calls[0]
        captured[batch] = (boxes.clone(), scores.clone(), *rest)
    return captured


def seeded_lanes(n: int, k: int):
    """`chip_smoke.py:lanes` on the NMS phase's generator (seed 0)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.8, (n, k, 2))
    wh = rng.uniform(0.02, 0.3, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (n, k)).astype(np.float32)
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda())


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _soft_equal(got, want) -> bool:
    """Indices and valid counts exact, scores to rtol 1e-5, atol 1e-6."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-6))


def soft_loads() -> dict:
    """name -> (boxes, scores, max_det, iou_thr, score_thr, sigma)."""
    loads = {}
    boxes, scores = seeded_lanes(640, 256)
    for n in SOFT_LANES:
        loads[f"seeded L={n}"] = (boxes[:n].contiguous(),
                                  scores[:n].contiguous(), 100, 1.0, 0.05,
                                  0.25)
    for mode in SOFT_MODES:
        for batch, args in serving_nms_inputs(SOFT_BATCHES, mode).items():
            b, s, md, iou_thr, thr, sigma, soft = args
            if not soft:
                raise RuntimeError(f"{mode} did not call soft NMS")
            loads[f"{mode} batch {batch} L={b.shape[0]}"] = (
                b, s, md, iou_thr, thr, sigma)
            if mode == SOFT_MODES[0] and batch == SOFT_BATCHES[0]:
                # five candidates a lane clear the threshold (the sixth
                # sits on it)
                ranked = torch.sort(s, dim=1, descending=True).values
                trained = (s * (thr / ranked[:, 5:6])).contiguous()
                loads[f"trained-like L={b.shape[0]}"] = (
                    b, trained, md, iou_thr, thr, sigma)
    return loads


def main_soft(args, card: str) -> int:
    libraries = {name: (design, variant_library(
        nms_kernel.kernel, nms_kernel.declare, name, edits))
        for name, (design, edits) in VARIANTS.items()
        if design in SOFT_DESIGNS}
    build_all([nms_kernel.kernel] + [lib for _, lib in libraries.values()])
    for line in nms_kernel.kernel.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] nms: {line.strip()}")

    failed = 0
    for load, (b, s, md, iou_thr, thr, sigma) in soft_loads().items():
        kw = dict(iou_threshold=iou_thr, score_threshold=thr,
                  soft_nms_sigma=sigma, soft=True)
        want = batched_nms(b, s, md, **kw)
        rounds = torch.clamp(want[2].long() + 1, max=md).sum().item()
        print(f"[load] {load}: L={b.shape[0]} k={b.shape[1]} md={md} "
              f"sigma={sigma} iou_threshold={iou_thr} score_threshold={thr} "
              f"rounds {rounds}, valid {want[2].sum().item()}")
        rest = (md, iou_thr, thr, sigma, True)
        runs = {d: (lambda d=d: nms_kernel.launch_design(d, b, s, *rest))
                for d in SOFT_DESIGNS}
        reference = runs["rounds"]()
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            same = _equal(got, reference)
            ok = _soft_equal(got, want)
            failed += not (same and ok)
            print(f"[check] {load} | {name}: equal to plain {ok}, bit-equal "
                  f"to rounds {same}")
        times = {name: [] for name in runs}
        for name in [*runs, *reversed(runs)]:
            times[name].append(device_time_ms(runs[name], reps=args.reps))
        for name, ms in times.items():
            print(f"[time] {load} | {name}: "
                  + " / ".join(f"{t:.4f}" for t in ms) + " ms")
        for name, (design, lib) in libraries.items():
            fn = lambda d=design, lib=lib: nms_kernel.launch_design(  # noqa
                d, b, s, *rest, library=lib)
            got = fn()
            torch.cuda.synchronize()
            ms = device_time_ms(fn, reps=args.reps)
            print(f"[time] {load} | {name}: {ms:.4f} ms, equal to plain: "
                  f"{_soft_equal(got, want)}, bit-equal to rounds: "
                  f"{_equal(got, reference)}")
        ms = device_time_ms(lambda: batched_nms(b, s, md, **kw), reps=3)
        print(f"[time] {load} | plain: {ms:.4f} ms")
    print(f"[card] {card}")
    return 1 if failed else 0


def trained_like(scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """The scores scaled so that five candidates a lane clear the threshold
    (the sixth sits on it)."""
    ranked = torch.sort(scores, dim=1, descending=True).values
    return (scores * (threshold / ranked[:, 5:6])).contiguous()


def long_loads() -> dict:
    """The exact-parity lane's loads: name -> (boxes, scores, max_det,
    iou_thr, score_thr, sigma, soft)."""
    loads = {}
    for mode in LONG_MODES:
        for batch, args in serving_nms_inputs(SOFT_BATCHES, mode,
                                              LONG_K).items():
            b, s, md, iou_thr, thr, sigma, soft = args
            name = f"{mode} batch {batch} L={b.shape[0]}"
            loads[f"real {name}"] = args
            loads[f"trained-like {name}"] = (b, trained_like(s, thr), md,
                                             iou_thr, thr, sigma, soft)
    boxes, scores = seeded_lanes(max(SOFT_LANES), LONG_K)
    for n in SOFT_LANES:
        b, s = boxes[:n].contiguous(), scores[:n].contiguous()
        loads[f"seeded hard L={n}"] = (b, s, 100, 0.5, 0.05, 0.0, False)
        loads[f"seeded soft L={n}"] = (b, s, 100, 1.0, 0.05, 0.25, True)
    return loads


def main_long(args, card: str) -> int:
    libraries = {name: (design, variant_library(
        nms_kernel.kernel, nms_kernel.declare, name, edits))
        for name, (design, edits) in VARIANTS.items()
        if design in ("scan", "compact")}
    build_all([nms_kernel.kernel] + [lib for _, lib in libraries.values()])
    for line in nms_kernel.kernel.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] nms: {line.strip()}")

    failed = 0
    for load, (b, s, md, iou_thr, thr, sigma, soft) in long_loads().items():
        kw = dict(iou_threshold=iou_thr, score_threshold=thr,
                  soft_nms_sigma=sigma, soft=soft)
        design = nms_kernel.nms_design(soft, b.shape[1], thr)
        want = batched_nms(b, s, md, **kw)
        print(f"[load] {load}: L={b.shape[0]} k={b.shape[1]} md={md} "
              f"soft={soft} sigma={sigma} iou_threshold={iou_thr} "
              f"score_threshold={thr}, lanes in order "
              f"{int((s[:, :-1] >= s[:, 1:]).all(dim=1).sum())}, valid "
              f"{want[2].sum().item()}, design {design}")
        rest = (md, iou_thr, thr, sigma, soft)
        runs = {d: (lambda d=d: nms_kernel.launch_design(d, b, s, *rest))
                for d in (design, "rounds")}
        reference = runs["rounds"]()
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            same = _equal(got, reference)
            ok = _soft_equal(got, want) if soft else _equal(got, want)
            failed += not (same and ok)
            print(f"[check] {load} | {name}: equal to plain {ok}, bit-equal "
                  f"to rounds {same}")
        times = {name: [] for name in runs}
        for name in [*runs, *reversed(runs)]:
            times[name].append(device_time_ms(runs[name], reps=args.reps))
        for name, ms in times.items():
            print(f"[time] {load} | {name}: "
                  + " / ".join(f"{t:.4f}" for t in ms) + " ms")
        if load.startswith("real") and "batch" in load:
            for name, (d, lib) in libraries.items():
                if d != design:
                    continue
                fn = lambda d=d, lib=lib: nms_kernel.launch_design(  # noqa
                    d, b, s, *rest, library=lib)
                got = fn()
                torch.cuda.synchronize()
                ms = device_time_ms(fn, reps=args.reps)
                print(f"[time] {load} | {name}: {ms:.4f} ms, bit-equal to "
                      f"rounds: {_equal(got, reference)}")
        ms = device_time_ms(lambda: batched_nms(b, s, md, **kw), reps=3)
        print(f"[time] {load} | plain: {ms:.4f} ms")
    print(f"[card] {card}")
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--soft", action="store_true",
                        help="the soft modes' designs and loads")
    parser.add_argument("--long", action="store_true",
                        help="the designs past 1,024 candidates on the "
                        "exact-parity lane's loads")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_experiments: no CUDA device; this tool runs on the card "
              "only", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    if args.soft:
        return main_soft(args, card)
    if args.long:
        return main_long(args, card)

    libraries = {name: (design, variant_library(
        nms_kernel.kernel, nms_kernel.declare, name, edits))
        for name, (design, edits) in VARIANTS.items()
        if design in ("rounds", "sweep")}
    build_all([nms_kernel.kernel, bitmatrix]
              + [lib for _, lib in libraries.values()])
    for lib in (nms_kernel.kernel, bitmatrix):
        for line in lib.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {lib.name}: {line.strip()}")

    boxes, scores, md, iou_thr, thr, _, _ = serving_nms_inputs(
        [args.batch])[args.batch]
    # five candidates a lane clear the threshold (the sixth sits on it)
    trained = (scores * (thr / scores[:, 5:6])).contiguous()
    unsorted = torch.argsort(torch.rand_like(scores), dim=1)
    loads = {
        "serving inputs": (boxes, scores),
        "the same, candidates shuffled": (
            torch.gather(boxes, 1, unsorted[..., None].expand(-1, -1, 4)
                         ).contiguous(),
            torch.gather(scores, 1, unsorted).contiguous()),
        "trained-like": (boxes, trained),
    }
    for load, (b, s) in loads.items():
        want = batched_nms(b, s, md, iou_thr, thr)
        rounds = torch.clamp(want[2].long() + 1, max=md).sum().item()
        print(f"[load] {load}: L={b.shape[0]} k={b.shape[1]} md={md} "
              f"score_threshold={thr} rounds {rounds}")

        def row(name, fn):
            got = fn()
            torch.cuda.synchronize()
            ms = device_time_ms(fn, reps=args.reps)
            print(f"[time] {load} | {name}: {ms:.4f} ms, equal to plain: "
                  f"{_equal(got, want)}")

        for design in ("rounds", "sweep"):
            row(f"{design}: as built", lambda d=design: nms_kernel.
                launch_design(d, b, s, md, iou_thr, thr))
        for name, (design, lib) in libraries.items():
            row(name, lambda d=design, lib=lib: nms_kernel.launch_design(
                d, b, s, md, iou_thr, thr, library=lib))
        row("bit matrix", lambda: nms_bitmatrix(b, s, md, iou_thr, thr))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
