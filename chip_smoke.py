#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one CUDA card.

    python3 chip_smoke.py

Runs on the card only (exits non-zero without one) and imports nothing of
JAX. Phases, each fatal on failure:
  1. card: name, power limit; TF32 off for the float32 comparisons;
  2. build: the NMS kernel from retinanet_torch/csrc/ with nvcc;
  3. kernel: the NMS kernel against its plain PyTorch version on the card,
     at the flagship shape and the edge cases; indices and valid counts
     equal, scores to rtol 1e-5 / atol 1e-6;
  4. serving: the flagship config (ResNet50-FPN, 640x640, mixed_bfloat16,
     80 classes, PerClassHardNMS) at full width with seeded random weights,
     answering batch-8 and batch-1 requests through `build_serving_fn`;
     the NMS kernel must launch once per request, and its detections must
     equal those of the plain NMS on the same fused predictions.
The line before the last is one JSON object describing each kernel
(launches on the serving run, error, times, bound); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FLAGSHIP = (REPO / "configs" / "v3-8"
            / "mscoco-retinanet-resnet50-640x640-30x-64.json")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
NMS_OPS_PER_CANDIDATE_ROUND = 20
BATCHES = {8: 6, 1: 4}          # batch size -> requests on the serving run


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def lanes(rng, n, k):
    xy = rng.uniform(0, 0.8, (n, k, 2))
    wh = rng.uniform(0.02, 0.3, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (n, k)).astype(np.float32)
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nms_bound_ms(boxes, md, valid) -> tuple:
    """Least time for this call: each input read once and each output
    written once, against the f32 operations these inputs need (a lane runs
    its selecting rounds plus the one that finds it frozen)."""
    lanes_, k = boxes.shape[0], boxes.shape[1]
    nbytes = lanes_ * k * 20 + lanes_ * md * 8 + lanes_ * 4
    rounds = torch.clamp(valid.long() + 1, max=md).sum().item()
    ops = NMS_OPS_PER_CANDIDATE_ROUND * k * rounds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_nms(args, kw):
    """Kernel against plain on the same card tensors; returns max |err|."""
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import nms_lanes
    idx, sc, valid = nms_lanes(*args, **kw)
    w_idx, w_sc, w_valid = batched_nms(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(valid, w_valid), "valid counts differ")
    check(torch.equal(idx, w_idx), "indices differ")
    check(torch.allclose(sc, w_sc, rtol=1e-5, atol=1e-6), "scores differ")
    return (sc - w_sc).abs().max().item(), valid


def phase_kernel() -> float:
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import nms_lanes
    rng = np.random.default_rng(0)
    cases = [
        ("flagship hard L=640 k=256", 640, 256, 100,
         dict(iou_threshold=0.5, score_threshold=0.05)),
        ("flagship soft sigma=0.25", 640, 256, 100,
         dict(iou_threshold=1.0, score_threshold=0.05, soft_nms_sigma=0.25,
              soft=True)),
        ("global L=8 k=256", 8, 256, 100,
         dict(iou_threshold=0.5, score_threshold=0.05)),
        ("ragged L=3 k=77", 3, 77, 10,
         dict(iou_threshold=0.5, score_threshold=0.2)),
        ("all below threshold", 2, 64, 5,
         dict(iou_threshold=0.5, score_threshold=1.5)),
    ]
    worst = 0.0
    for name, n, k, md, kw in cases:
        boxes, scores = lanes(rng, n, k)
        err, valid = compare_nms((boxes, scores, md), kw)
        worst = max(worst, err)
        print(f"[kernel] {name}: equal indices and valid counts "
              f"(valid sum {valid.sum().item()}), max |score err| {err:.3g}")
        if name.startswith("all below"):
            check(valid.sum().item() == 0, "lanes below threshold selected")
        if name.startswith("flagship hard"):
            kernel_ms = time_ms(lambda: nms_lanes(boxes, scores, md, **kw),
                                reps=50)
            plain_ms = time_ms(lambda: batched_nms(boxes, scores, md, **kw),
                               reps=5)
            bound, by = nms_bound_ms(boxes, md, valid)
            print(f"[kernel] {name}: kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({by})")
    return worst


def phase_serving(worst_err: float) -> dict:
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import postprocess
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import kernel, nms_lanes

    params = Config(str(FLAGSHIP)).params
    model = build_model(params, device="cuda", seed=0)
    with torch.no_grad():
        model.class_head.prediction.conv.bias.zero_()
    print("[serving] flagship config, seeded random weights; class-head "
          "prediction bias set to 0 instead of the -log(99) prior, so that "
          "scores sit near 0.5 and clear the 0.05 threshold (with the prior "
          "every score is ~0.01 and NMS would stop in round 0)")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] parameters {n_params}")
    serve = build_serving_fn(params, device="cuda", model=model)
    h, w = params.input.input_shape
    rng = np.random.default_rng(0)
    requests = [(bs, torch.from_numpy(rng.integers(
        0, 256, (bs, h, w, 3)).astype(np.uint8)))
        for bs, count in BATCHES.items() for _ in range(count)]

    # the main path: every count at 0 just before, read just after
    kernel.launches = 0
    outputs, times = [], {bs: [] for bs in BATCHES}
    for bs, images in requests:
        start = time.perf_counter()
        det = serve(images)
        torch.cuda.synchronize()
        times[bs].append((time.perf_counter() - start) * 1e3)
        outputs.append(det)
    launches = kernel.launches
    check(launches == len(requests),
          f"NMS kernel launched {launches} times for {len(requests)} "
          "requests")
    print(f"[serving] {len(requests)} requests, NMS kernel launches "
          f"{launches}")

    md = int(params.inference.max_detections)
    for (bs, _), det in zip(requests, outputs):
        check(tuple(det["boxes"].shape) == (bs, md, 4), "boxes shape")
        check(tuple(det["scores"].shape) == (bs, md), "scores shape")
        check(tuple(det["classes"].shape) == (bs, md), "classes shape")
        check(tuple(det["valid_detections"].shape) == (bs,), "valid shape")
        check(det["classes"].dtype == torch.int32, "classes dtype")
        check(det["valid_detections"].dtype == torch.int32, "valid dtype")
        check(det["boxes"].dtype == torch.float32, "boxes dtype")
        check(bool(torch.isfinite(det["boxes"]).all()
                   and torch.isfinite(det["scores"]).all()), "non-finite")
    for bs in BATCHES:
        steady = times[bs][1:]
        print(f"[serving] batch {bs}: median {statistics.median(steady):.3f}"
              f" ms per request over {len(steady)} requests after the first"
              f" ({times[bs][0]:.1f} ms)")
    print("[serving] valid_detections batch 8: "
          f"{outputs[0]['valid_detections'].tolist()}, batch 1: "
          f"{outputs[BATCHES[8]]['valid_detections'].tolist()}")

    # the same fused predictions through the kernel lane and the plain lane
    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    post = postprocess.make_postprocess_fn(params, from_params(params),
                                           "cuda")
    captured = {}

    def recording(*args):
        captured.setdefault(args[0].shape[0], args)
        return nms_lanes(*args)

    try:
        for i, (bs, images) in enumerate(
                [requests[0], requests[BATCHES[8]]]):
            with torch.inference_mode():
                fused = fused_fn(images)
                postprocess.nms_lanes = recording
                det_k = post(fused)
                postprocess.nms_lanes = batched_nms  # the plain NMS lane
                det_p = post(fused)
            for key in det_k:
                check(torch.equal(det_k[key], det_p[key]),
                      f"batch {bs}: kernel and plain NMS lanes differ in "
                      f"{key}")
            same = all(torch.equal(det_k[key], outputs[0 if i == 0 else
                                                      BATCHES[8]][key])
                       for key in det_k)
            print(f"[serving] batch {bs}: detections through the kernel "
                  "equal those through the plain NMS; equal to the serving "
                  f"run's output: {same}")
    finally:
        postprocess.nms_lanes = nms_lanes

    # the kernel at the inputs the serving path gave it at batch 8
    args = captured[8 * int(params.architecture.head.num_classes)]
    kw = dict(zip(("iou_threshold", "score_threshold", "soft_nms_sigma",
                   "soft"), args[3:]))
    with torch.inference_mode():
        err, valid = compare_nms(args[:3], kw)
        ms = time_ms(lambda: nms_lanes(*args), reps=50)
        plain_ms = time_ms(lambda: batched_nms(*args), reps=5)
    bound, by = nms_bound_ms(args[0], args[2], valid)
    print(f"[kernel] serving inputs at batch 8 (L={args[0].shape[0]}, "
          f"k={args[0].shape[1]}, md={args[2]}, rounds "
          f"{torch.clamp(valid.long() + 1, max=args[2]).sum().item()}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.5f} ms ({by})")
    return {"name": "nms_lanes", "route": "cuda",
            "source": "retinanet_torch/csrc/nms.cu",
            "replaces": "retinanet_tpu/ops/pallas/nms_kernel.py:36",
            "launches": launches, "max_abs_err": max(worst_err, err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from retinanet_torch.ops.nms_kernel import kernel

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    kernel.build()
    print(f"[build] NMS kernel built in {kernel.build_seconds:.2f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    worst = phase_kernel()
    record = phase_serving(worst)
    print(json.dumps({"kernels": [record]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
