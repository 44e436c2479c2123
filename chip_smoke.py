#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one CUDA card.

    python3 chip_smoke.py

Runs on the card only (exits non-zero without one) and imports nothing of
JAX. Phases, each fatal on failure:
  1. card: name, power limit; TF32 off for the float32 comparisons;
  2. build: every kernel of retinanet_torch/csrc/ with nvcc, one compiler
     per source, all started together;
  3. NMS kernel against its plain PyTorch version on the card, at the
     flagship shape and the edge cases; indices and valid counts equal,
     scores to rtol 1e-5 / atol 1e-6;
  4. matching kernel against its plain version on the card, all four
     outputs bit-equal: the flagship anchors with 8 images of 100 boxes
     (0, 1, 7 and 100 valid, a mask that is no prefix, duplicated boxes and
     boxes centred between anchors so that both argmaxes meet ties, a box
     that overlaps nothing), and a small ragged case;
  5. serving: the flagship config (ResNet50-FPN, 640x640, mixed_bfloat16,
     80 classes, PerClassHardNMS) at full width with seeded random weights,
     answering batch-8 and batch-1 requests through `build_serving_fn`;
     the NMS kernel must launch once per request, and its detections must
     equal those of the plain NMS on the same fused predictions;
  6. training: the same config through `build_trainer`, full width and
     depth, steps at batch 8 on one repeated seeded batch; the matching
     kernel must launch once per step, every metric must be finite, the
     loss must fall, the BatchNorm statistics must move, and the targets
     through the kernel must equal those through the plain matcher. Batch
     16 is tried and reported;
  7. the Triton channel-statistics probe against its plain version.
The output ends with one JSON object describing each kernel (launches on
its main-path run, error, times, bound), the card's line again, and
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import concurrent.futures
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
MATCH_OPS_PER_PAIR = 25         # f32 operations per (anchor, valid box)
BATCHES = {8: 4, 1: 3}          # batch size -> requests on the serving run
TRAIN_BATCH = 8                 # what one core of the config's v3-8 gets
TRAIN_STEPS = 8


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
    """Device time of one call, at the card's pace and not the host's."""
    from retinanet_torch.utils.benchmark import device_time_ms
    return device_time_ms(fn, reps, warmup)


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


def phase_nms_kernel() -> float:
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


def phase_serving(params, worst_err: float) -> dict:
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import postprocess
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import kernel, nms_lanes

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


def match_bound_ms(num_anchors, gt_valid) -> tuple:
    """Least time for this call: anchors, boxes and flags read once, the
    four outputs written once, against the f32 operations of the (anchor,
    valid box) pairs these inputs hold."""
    batch, num_gt = gt_valid.shape
    nbytes = (num_anchors * 16 + batch * num_gt * 17
              + batch * num_anchors * 8 + batch * num_gt * 8)
    ops = MATCH_OPS_PER_PAIR * num_anchors * int(gt_valid.sum().item())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_match(anchors, gt_boxes, gt_valid) -> float:
    """Kernel against plain on the same card tensors, bit for bit; returns
    max |IoU error| (0 when it passes)."""
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import match_lanes
    got = match_lanes(anchors, gt_boxes, gt_valid)
    want = match_lanes_plain(anchors, gt_boxes, gt_valid)
    torch.cuda.synchronize()
    names = ("max_iou", "argmax_gt", "gt_best_iou", "gt_best_anchor")
    for name, g, w in zip(names, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"match {name}: {g.dtype} {tuple(g.shape)} against "
              f"{w.dtype} {tuple(w.shape)}")
        check(torch.equal(g, w),
              f"match {name} differs in {(g != w).sum().item()} places")
    return max((got[0] - want[0]).abs().max().item(),
               (got[2] - want[2]).abs().max().item())


def match_cases(anchor_gen, rng):
    """(name, gt_boxes (B, G, 4), gt_valid (B, G)) on the flagship anchors:
    image by image 0, 1, 7 and 100 valid boxes, a mask that is no prefix,
    each box twice (ties over the boxes), boxes centred on cell corners
    (ties over the anchors), and a box that overlaps no anchor."""
    h, w = anchor_gen.image_height, anchor_gen.image_width
    g = 100

    def boxes(n):
        return np.stack([rng.uniform(0.1 * w, 0.9 * w, n),
                         rng.uniform(0.1 * h, 0.9 * h, n),
                         rng.uniform(0.03 * w, 0.5 * w, n),
                         rng.uniform(0.03 * h, 0.5 * h, n)], -1)

    gt = np.stack([boxes(g) for _ in range(8)]).astype(np.float32)
    valid = np.zeros((8, g), bool)
    for image, count in enumerate((0, 1, 7, 100)):
        valid[image, :count] = True
    valid[4] = rng.uniform(size=g) < 0.3          # no prefix
    valid[4, 0] = False
    gt[5, 50:] = gt[5, :50]                        # every box twice
    valid[5] = True
    gt[6, :, 0] = 64.0 * rng.integers(1, 9, g)     # centred between anchors
    gt[6, :, 1] = 64.0 * rng.integers(1, 9, g)
    gt[6, :, 2:] = 32.0 * rng.integers(1, 9, (g, 1))
    valid[6, ::2] = True
    gt[7, 3] = (-5000.0, -5000.0, 10.0, 10.0)      # overlaps no anchor
    valid[7, :12] = True
    yield "flagship A=76725 B=8 G=100", gt, valid
    yield "flagship all 100 valid", gt, np.ones((8, g), bool)


def phase_match_kernel(params) -> float:
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import match_lanes
    rng = np.random.default_rng(0)
    anchor_gen = from_params(params)
    anchors = torch.from_numpy(anchor_gen.boxes).cuda()
    check(anchors.shape[0] == 76725, f"{anchors.shape[0]} flagship anchors")
    worst = 0.0
    for name, gt, valid in match_cases(anchor_gen, rng):
        gt, valid = torch.from_numpy(gt).cuda(), torch.from_numpy(valid).cuda()
        worst = max(worst, compare_match(anchors, gt, valid))
        ms = time_ms(lambda: match_lanes(anchors, gt, valid), reps=50)
        plain_ms = time_ms(lambda: match_lanes_plain(anchors, gt, valid),
                           reps=5)
        bound, by = match_bound_ms(anchors.shape[0], valid)
        print(f"[match] {name} ({int(valid.sum())} valid boxes): all four "
              f"outputs bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound:.5f} ms ({by})")
    # ragged: A no multiple of the tile of 256, G = 17, 14 valid
    small = anchors[1000:1000 + 3 * 256 + 77].contiguous()
    gt = np.stack([rng.uniform(100, 500, (3, 17)),
                   rng.uniform(100, 500, (3, 17)),
                   rng.uniform(20, 200, (3, 17)),
                   rng.uniform(20, 200, (3, 17))], -1).astype(np.float32)
    valid = np.zeros((3, 17), bool)
    valid[:, :14] = True
    worst = max(worst, compare_match(small, torch.from_numpy(gt).cuda(),
                                     torch.from_numpy(valid).cuda()))
    print(f"[match] ragged A={small.shape[0]} B=3 G=17: all four outputs "
          "bit-equal")
    return worst


def phase_training(params, worst_err: float) -> dict:
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.label_encoder import make_batched_encoder
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import kernel, match_lanes
    from retinanet_torch.train.trainer import build_trainer

    h, w = params.input.input_shape
    num_classes = int(params.architecture.head.num_classes)
    max_boxes = int(params.encoder_params.max_boxes)
    # PyTorch's default, which a caller of build_trainer gets: the float32
    # prediction convs and their gradients may run in TF32
    torch.backends.cudnn.allow_tf32 = True
    state, step = build_trainer(params, device="cuda", seed=0)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[training] flagship config through build_trainer, seeded random "
          f"weights, {n_params} parameters, {params.floatx.precision}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        TRAIN_BATCH, (h, w), max_boxes, num_classes, seed=0).items()}
    check(tuple(batch["boxes"].shape) == (TRAIN_BATCH, max_boxes, 4),
          "batch shape")

    # step 0's targets through the kernel and through the plain matcher
    anchors = from_params(params)
    by_kernel, by_plain = (
        make_batched_encoder(anchors, params.encoder_params, device="cuda",
                             matcher=matcher)(
            batch["boxes"], batch["classes"], batch["valid"])
        for matcher in (match_lanes, match_lanes_plain))
    for kind in ("class-targets", "box-targets"):
        for level in by_kernel[kind]:
            check(torch.equal(by_kernel[kind][level], by_plain[kind][level]),
                  f"{kind} P{level}: kernel and plain lanes differ")
    check(torch.equal(by_kernel["num-positives"], by_plain["num-positives"]),
          "num-positives: kernel and plain lanes differ")
    print("[training] step-0 targets through the matching kernel equal "
          "those through the plain matcher; positives per image "
          f"{by_kernel['num-positives'].tolist()}")

    stats_before = state.model.backbone.stem_bn.bn.running_mean.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count at 0 just before, read just after
    kernel.launches = 0
    history, times, splits = [], [], []
    for _ in range(TRAIN_STEPS):
        marks = []
        start = time.perf_counter()
        state, metrics = step(state, batch, marks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        splits.append({name: before[1].elapsed_time(event) for before,
                       (name, event) in zip(marks, marks[1:])})
    launches = kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == TRAIN_STEPS, f"matching kernel launched {launches} "
          f"times in {TRAIN_STEPS} steps")
    check(state.step == TRAIN_STEPS, f"step is {state.step}")
    for i, metrics in enumerate(history):
        for key, value in metrics.items():
            check(np.isfinite(value), f"step {i}: {key} is {value}")
    first, last = history[0], history[-1]
    check(last["total-loss"] < first["total-loss"],
          f"total-loss {first['total-loss']} -> {last['total-loss']} on a "
          "repeated batch")
    check(not torch.equal(stats_before,
                          state.model.backbone.stem_bn.bn.running_mean),
          "BatchNorm running statistics did not move")
    print(f"[training] {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, matching "
          f"kernel launches {launches}, step {state.step}")
    print("[training] total-loss "
          + " ".join(f"{m['total-loss']:.4f}" for m in history))
    print(f"[training] step 0: {json.dumps(first)}")
    print(f"[training] step {TRAIN_STEPS - 1}: {json.dumps(last)}")
    print(f"[training] batch {TRAIN_BATCH}: median "
          f"{statistics.median(times[1:]):.3f} ms per step over "
          f"{len(times) - 1} steps after the first ({times[0]:.1f} ms), "
          f"{TRAIN_BATCH / statistics.median(times[1:]) * 1e3:.2f} images/s,"
          f" peak memory {peak_gb:.2f} GB")
    print("[training] split, device ms, median after the first step: "
          + ", ".join(f"{name} {statistics.median(s[name] for s in splits[1:]):.3f}"
                      for name in splits[0]))

    # the kernel at the inputs the train step gave it
    args = (torch.from_numpy(anchors.boxes).cuda(), batch["boxes"],
            batch["valid"])
    err = compare_match(*args)
    ms = time_ms(lambda: match_lanes(*args), reps=50)
    plain_ms = time_ms(lambda: match_lanes_plain(*args), reps=5)
    bound, by = match_bound_ms(args[0].shape[0], args[2])
    print(f"[match] training inputs at batch {TRAIN_BATCH} "
          f"({int(args[2].sum())} valid boxes): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({by})")

    # batch 16, reported and no condition
    big = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        16, (h, w), max_boxes, num_classes, seed=1).items()}
    torch.cuda.reset_peak_memory_stats()
    try:
        big_times = []
        for _ in range(3):
            start = time.perf_counter()
            state, metrics = step(state, big)
            torch.cuda.synchronize()
            big_times.append((time.perf_counter() - start) * 1e3)
        print(f"[training] batch 16: {min(big_times[1:]):.3f} ms per step "
              f"(best of {len(big_times) - 1} after the first), peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"total-loss {float(metrics['total-loss']):.4f}")
    except torch.cuda.OutOfMemoryError:
        print("[training] batch 16: does not fit in the card's memory")
    torch.backends.cudnn.allow_tf32 = False
    return {"name": "match_lanes", "route": "cuda",
            "source": "retinanet_torch/csrc/match.cu",
            "replaces": "retinanet_tpu/ops/pallas/matching_kernel.py:41",
            "launches": launches, "max_abs_err": max(worst_err, err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def phase_channel_stats() -> dict:
    """The bandwidth probe's Triton kernel: its own entry point is its main
    path (nothing in the model calls it)."""
    from retinanet_torch.tools import membw_experiments as probe
    probe.kernel.launches = 0
    check(probe.main() == 0, "membw_experiments.main() failed")
    launches = probe.kernel.launches
    check(launches > 0, "the probe never launched its Triton kernel")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((819200, probe.LANES), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    got, want = probe.channel_stats(x), probe.channel_stats_plain(x)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("sum", "sumsq"), got, want):
        check(g.shape == w.shape == (probe.LANES,) and g.dtype == w.dtype,
              f"channel_stats {name}: shape or dtype")
        # f32 summation order over 819,200 rows
        check(torch.allclose(g, w, rtol=1e-3, atol=1e-2),
              f"channel_stats {name} differs")
        err = max(err, (g - w).abs().max().item())
    ms = time_ms(lambda: probe.channel_stats(x), reps=50)
    plain_ms = time_ms(lambda: probe.channel_stats_plain(x), reps=10)
    nbytes = x.numel() * 2 + 2 * probe.LANES * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * x.numel() / F32_FLOP_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    print(f"[channel_stats] N=819200: kernel {ms:.4f} ms "
          f"({x.numel() * 2 / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({by}), max |err| {err:.3g}, launches in "
          f"the probe's run {launches}")
    return {"name": "channel_stats", "route": "triton",
            "source": "retinanet_torch/tools/membw_experiments.py",
            "replaces": "tools/membw_experiments.py:45",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from retinanet_torch.core.config import Config
    from retinanet_torch.ops import match_kernel, nms_kernel

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    kernels = (nms_kernel.kernel, match_kernel.kernel)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for future in [pool.submit(k.build) for k in kernels]:
            future.result()
    print(f"[build] {len(kernels)} kernels built side by side in "
          f"{time.perf_counter() - start:.2f} s")
    for k in kernels:
        print(f"[build] {k.source.name} built in {k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.source.name}: {line.strip()}")
    params = Config(str(FLAGSHIP)).params

    worst = phase_nms_kernel()
    match_err = phase_match_kernel(params)
    records = [phase_serving(params, worst),
               phase_training(params, match_err),
               phase_channel_stats()]
    print(json.dumps({"kernels": records}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
