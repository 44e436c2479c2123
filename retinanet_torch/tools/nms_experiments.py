"""NMS kernel experiments on the card: what a round of the round kernel
spends its time on, the sweep kernel's own choices, and the sweep against a
suppression bit matrix.

    python -m retinanet_torch.tools.nms_experiments [--batch 8]

The inputs are the ones the flagship serving path hands to `nms_lanes`
(PerClassHardNMS: batch x 80 lanes of 256 candidates, seeded random
weights with the class-head prediction bias at 0, so every lane runs all
100 rounds), and a "trained-like" copy of them in which few scores clear the
threshold. It runs on the card only and prints device times
(`utils/benchmark.py:device_time_ms`) beside the card's name and power
limit.

Each variant of `csrc/nms.cu` is the source with one edit, written into the
build directory and compiled beside the others; the package's own build is
the first row. A variant's answer is compared with `batched_nms` and
reported, not required: a fast reciprocal may flip an IoU at the threshold.
`tools/nms_bitmatrix.cu` is the alternative design; the package never calls
it.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from typing import Dict, Tuple

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


def serving_nms_inputs(batch: int):
    """What the flagship serving path gives `nms_lanes` for `batch` seeded
    random images: (boxes, scores, max_det, iou_thr, score_thr)."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import postprocess
    params = Config(str(FLAGSHIP)).params
    model = build_model(params, device="cuda", seed=0)
    with torch.no_grad():
        model.class_head.prediction.conv.bias.zero_()
    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    post = postprocess.make_postprocess_fn(params, from_params(params),
                                           "cuda")
    h, w = params.input.input_shape
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, h, w, 3)).astype(np.uint8))
    captured = []

    def recording(*args):
        captured.append(args)
        return nms_kernel.nms_lanes(*args)

    postprocess.nms_lanes = recording
    try:
        with torch.inference_mode():
            post(fused_fn(images))
    finally:
        postprocess.nms_lanes = nms_kernel.nms_lanes
    boxes, scores, md, iou_thr, thr, sigma, soft = captured[0]
    if soft or sigma:
        raise RuntimeError("the flagship serving path is hard NMS")
    return boxes.clone(), scores.clone(), md, iou_thr, thr


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_experiments: no CUDA device; this tool runs on the card "
              "only", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")

    libraries = {name: (design, variant_library(
        nms_kernel.kernel, nms_kernel.declare, name, edits))
        for name, (design, edits) in VARIANTS.items()}
    build_all([nms_kernel.kernel, bitmatrix]
              + [lib for _, lib in libraries.values()])
    for lib in (nms_kernel.kernel, bitmatrix):
        for line in lib.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {lib.name}: {line.strip()}")

    boxes, scores, md, iou_thr, thr = serving_nms_inputs(args.batch)
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
