#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one CUDA card.

    python3 chip_smoke.py

Runs on the card only (exits non-zero without one) and imports nothing of
JAX. Phases, each fatal on failure:
  1. card: name, power limit; TF32 off for the float32 comparisons;
  2. build: every kernel of retinanet_torch/csrc/ with nvcc, one compiler
     per source, all started together;
  3. both NMS kernels against the plain PyTorch version on the card: hard
     mode through the sweep kernel (the flagship shape, sorted and unsorted
     input, tied and all-equal scores, duplicated boxes, IoUs exactly at the
     threshold, k = 300 and 1000, more slots than survivors, a trained-like
     load), soft mode and a
     threshold of -inf through the round kernel; indices and valid counts
     equal, the sweep's scores exactly equal, the round kernel's to rtol
     1e-5 / atol 1e-6 (the soft decay's exp);
  4. matching kernel against its plain version on the card, all four
     outputs bit-equal: the flagship anchors with 8 images of 100 boxes
     (0, 1, 7 and 100 valid, a mask that is no prefix, duplicated boxes and
     boxes centred between anchors so that both argmaxes meet ties, a box
     that overlaps nothing), an image whose boxes all lie outside, one box
     an image, and a small ragged case; the share of (tile, box) pairs that
     the kernel's tile test keeps is printed per load; one call is one
     kernel on the card (profiler count);
  5. serving: the flagship config (ResNet50-FPN, 640x640, mixed_bfloat16,
     80 classes, PerClassHardNMS) at full width with seeded random weights,
     answering batch-8 and batch-1 requests through `build_serving_fn`;
     the sweep kernel must launch once per request, and its detections must
     equal those of the plain NMS on the same fused predictions; the round
     kernel is timed on the same tensors;
  6. training: the same config through `build_trainer`, full width and
     depth, steps at batch 8 on one repeated seeded batch; the matching
     kernel must launch once per step, every metric must be finite, the
     loss must fall, the BatchNorm statistics must move, and the targets
     through the kernel must equal those through the plain matcher. Batch
     16 is tried and reported;
  7. the Triton channel-statistics probe against its plain version;
  8. executor: the flagship train_val run through the CLI, at full width,
     on a synthetic COCO-schema dataset that the port writes (2 shards x 32
     images, 240-640 px, 1-7 boxes, 80 classes, annotations JSON), with a
     config derived from the flagship that changes only the paths, the
     step counts and the train batch (each change printed beside the
     flagship's value): (a) `python -m retinanet_torch` as a subprocess
     trains 24 steps, checkpoints at 8, 16 and 24, evaluates COCO at 12 and
     24 and exits 0; (b) `--run_evaluation` in process launches the NMS
     sweep kernel once per val batch and the matching kernel never; (c) a
     resume to 28 steps launches the matching kernel once per step. The
     JPEG route is printed and its pixels are held to libjpeg's on the
     JPEGs of tests/goldens/jpeg_decode_goldens.npz (exact, or nvJPEG's
     stated bound). The executor's images/s, the eval legs, and the host
     pipeline's own rate, alone and beside the train step looping on the
     card, are printed;
  9. overfit: the port's `tools/overfit_check.py` (ResNet18, 128x128, 16
     images, 300 steps through the Executor) must reach AP@0.5 >= 0.3;
 10. zoo: (a) each architecture a config under configs/ uses (EfficientNet
     b2 768, b3 896, lite2 and lite3 512; MobileDet cpu and edge_tpu 448,
     gpu 512) at its config's width and input size, batch 8: its parameter
     count, the median of 3 requests through `build_serving_fn` and of 4
     steps through `build_trainer` on one repeated seeded batch, images/s,
     peak memory; the loss must be finite and fall, the detections through
     the NMS kernel must equal the plain NMS's, the targets through the
     matching kernel the plain matcher's, and both kernels are held to
     their plain versions and timed at its shapes; (b) the flagship with
     its neck swapped to fpn_p5, multi_level_attention or
     stacked_multi_level_attention, or the auxiliary IoU head on: one
     request and two steps each; (c) `python -m retinanet_torch` in
     train_val on the EfficientNet-B2 config (paths, 8 steps, batch 8, 32
     synthetic scenes up to 768 px) must end in a COCO eval record;
 11. data parallelism and the configs' own batches: (a) two ranks on the
     one card over gloo (`parallel/distributed.py`; NCCL refuses two ranks
     on one device), the flagship at full width, global batch 16, 8 a
     rank, 2 steps, once in float32 with TF32 off (the CPU test's
     arithmetic) and once in its own mixed bfloat16: in each, the losses
     and the parameters bit-equal across the ranks, and held to one
     process at batch 16 (float32: losses rtol 1e-5, every tensor within
     1e-5 of its largest magnitude plus 1e-9; bfloat16: 2^-8 in place of
     1e-5; beyond the first step's losses, plus 10x the one process's own
     move under two reorderings of its batch), the matching kernel
     launched in each step of each rank, each rank's peak printed; then
     the NMS kernel in each rank's slice of an 8-image inference gathered
     to the chief, and the gradients' all-reduce timed; (b) `python -m retinanet_torch --is_multi_host` in
     process as rank 0 of a world of one on NCCL, with torchrun's
     environment: train_val, 4 steps and one COCO evaluation; (c) the
     flagship at its own batch of 64, K = 1: step ms, images/s, peak;
     (d) `v3-32/…-1280x1280-3x-256` at its own batch of 256 in
     HIGH_RES_ACCUM micro-batches (the smallest K that fits,
     `tools/accum_sweep.py`): 2 steps; then a batch-8 request whose
     detections through the NMS kernel equal the plain NMS's, and the
     matching kernel bit-equal to its plain version at its 306,900
     anchors. Each prints its seconds;
 12. export and int8 serving: (a) `python -m retinanet_torch.export` in
     process on the flagship (a checkpoint of its seeded weights with the
     class prior at 0) with --int8 --int8_activations, calibrated on 4
     synthetic batches (no val records): all seven files of the artifact;
     (b) the artifact loaded back: the frozen graph (`run_exported`)
     equal to the rebuilt serving function at the frozen batch, the NMS
     kernel inside the graph index-exact against `batched_nms`; (c) the
     int8-activation lane (frozen graph equal to the rebuilt function),
     then 4 requests each at batch 1 and 8 as the main path, the int8
     kernel's counts at 0 before them: every dense call but the stem
     launched on the "wgmma" design, the stem on "mma_sync"
     (`ops/int8_conv_kernel.py:int8_design`); every int8 conv call of one
     batch-8 request bit-equal to `ops/int8_conv.py` and timed beside its
     bounds, cuDNN bf16 at its shape and `torch._int_mm` for a 1x1 conv,
     printed a shape a line with its design; float, weight-only and int8
     request ms; the device busy ms of a request and the int8 conv's
     kernels in it by name (profiler); the host us that encoding a wgmma
     call's three tensor maps takes; detection_agreement_ap of int8
     against float; (d) `evaluate_artifact` through the frozen int8 graph
     on the JPEGs of tests/goldens/jpeg_decode_goldens.npz; (e)
     EfficientNet-lite2 512 (all three designs, depthwise beside cuDNN's
     bf16 depthwise) calibrated on synthetic scenes, every int8 conv call
     of a batch-8 request bit-equal to the plain version and timed.
The output ends with a JSON line of the zoo's numbers, one JSON object
describing each kernel (launches on its main-path run, on the executor's
paths and on the zoo's, error, times, bound, and the zoo shapes' times), the
card's line again, and {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# phase 8: the flagship config with only these changed (besides the paths)
EXECUTOR_CHANGES = (
    (("training", "train_steps"), 24),
    (("training", "save_every"), 8),
    (("training", "validation_freq"), 12),
    (("training", "validation_samples"), 32),
    (("training", "steps_per_execution"), 4),
    (("training", "batch_size", "train"), 8),
)
EXECUTOR_SHARDS, EXECUTOR_IMAGES_PER_SHARD = 2, 32
RESUME_STEPS = 28
CLI_TIMEOUT_S = 420             # phase 8 (a); the whole script has 1200 s
PIPELINE_SECONDS = 3.0
JPEG_GOLDENS = REPO / "tests" / "goldens" / "jpeg_decode_goldens.npz"
# phase 10: every architecture a config uses, at the config's width and
# input size with only the batch changed
ZOO = (
    ("efficientnet-b2 768",
     "v3-8/mscoco-retinanet-efficientnet-b2-768x768-30x-64.json"),
    ("efficientnet-b3 896",
     "v3-32/mscoco-retinanet-efficientnet-b3-896x896-30x-256.json"),
    ("efficientnet-lite2 512",
     "v3-32/mscoco-retinanet-efficientnet-lite2-512x512-30x-256.json"),
    ("efficientnet-lite3 512",
     "v3-32/mscoco-retinanet-efficientnet-lite3-512x512-30x-256.json"),
    ("mobiledet-cpu 448",
     "v3-8/mscoco-retinanet-mobiledet-cpu-448x448-30x-64.json"),
    ("mobiledet-edge_tpu 448",
     "v3-8/mscoco-retinanet-mobiledet-edge-tpu-448x448-30x-64.json"),
    ("mobiledet-gpu 512",
     "v3-8/mscoco-retinanet-mobiledet-gpu-512x512-30x-64.json"),
)
ZOO_BATCH = 8
ZOO_REQUESTS = 3                # timed, after one more that is not
ZOO_STEPS = 4                   # timed, after one more that is not
# the flagship with one part swapped: one request and two steps each
SWAPS = (
    ("neck fpn_p5", {"feature_fusion": {"type": "fpn_p5"}}),
    ("neck multi_level_attention",
     {"feature_fusion": {"type": "multi_level_attention"}}),
    ("neck stacked_multi_level_attention",
     {"feature_fusion": {"type": "stacked_multi_level_attention",
                         "use_channel_attention": True}}),
    ("auxiliary IoU head", {"auxillary_head": {"use_auxillary_head": True}}),
)
# phase 10 (c): the EfficientNet-B2 config through the CLI, changed only in
# these (besides the paths)
ZOO_CLI_CONFIG = REPO / "configs" / ZOO[0][1]
ZOO_CLI_CHANGES = (
    (("training", "train_steps"), 8),
    (("training", "save_every"), 8),
    (("training", "validation_freq"), 8),
    (("training", "validation_samples"), 16),
    (("training", "steps_per_execution"), 4),
    (("training", "batch_size", "train"), 8),
)
ZOO_CLI_MAX_SIDE = 768
# phase 11: data parallelism over processes and the configs' own batches
DP_WORLD = 2
DP_BATCH = 16                   # global, DP_BATCH / DP_WORLD a rank
DP_STEPS = 2
DP_RTOL = 1e-5                  # tests/test_torch_distributed.py's bounds
DP_ATOL = 1e-9                  # rounding noise of a bias before a BN
# A float32 step at full width moves by more than those bounds when the
# same batch comes in another order (its gradient sums cancel, and the
# BatchNorm backward amplifies what is left). Beyond the first step's
# losses, which hold the CPU test's bound, the two ranks are held to it plus
# DP_ORDER_FACTOR times the largest move of one process over two reorderings
# of its batch, measured in the same run.
DP_ORDERS = ("halves swapped", "reversed")
DP_ORDER_FACTOR = 10.0
# float32 first (the CPU test's arithmetic), then the configs' own mixed
# bfloat16, where synced BatchNorm takes bfloat16 activations; there each
# loss and tensor is held to one bfloat16 rounding of its magnitude in place
# of DP_RTOL, by the same rule
DP_PRECISIONS = {"float32": DP_RTOL, "mixed_bfloat16": 2.0 ** -8}
DP_EVAL_BATCH = 8
MULTI_HOST_CHANGES = (
    (("training", "train_steps"), 4),
    (("training", "save_every"), 4),
    (("training", "validation_freq"), -1),
    (("training", "validation_samples"), 16),
    (("training", "steps_per_execution"), 1),
    (("training", "batch_size", "train"), 8),
)
FLAGSHIP_ACCUM = 1              # the flagship's batch of 64 fits whole
HIGH_RES = (REPO / "configs" / "v3-32"
            / "mscoco-retinanet-resnet50-1280x1280-3x-256.json")
HIGH_RES_ACCUM = 16             # tools/accum_sweep.py's smallest K
HIGH_RES_ANCHORS = 306900
OWN_BATCH_STEPS = 2             # timed, after one that is not
# phase 12: export and int8 serving
EXPORT_CALIBRATION_BATCHES = 4  # synthetic batches of 2 (no val records)
ARTIFACT_FILES = ("config.json", "params.msgpack", "serving_default.pt2",
                  "params_int8.msgpack", "activation_scales.json",
                  "int8_activation_report.json", "serving_int8.pt2")
INT8_BATCHES = (1, 8)
INT8_REQUESTS = 3               # timed, after one that is not
INT8_OPS_PER_S = 1979e12        # H100 SXM, dense int8 tensor cores
# the kernel's times at these convs of a batch-8 flagship request
INT8_SHAPES = (
    ("stem 7x7/2, C=3", "backbone/stem/conv"),
    ("3x3 bottleneck", "backbone/group3/block1/conv2/conv"),
    ("1x1/2 projection", "backbone/group2/block0/proj/conv"),
    ("head 3x3 at P3", "class_head/conv0/conv"),
)
# the int8 conv's CUDA kernels, by name in a profiler trace
INT8_KERNEL_NAMES = ("int8_conv_", "quantize_words_kernel",
                     "quantize_bytes_kernel")
INT8_DEPTHWISE = ("efficientnet-lite2 512", REPO / "configs" / "v3-32"
                  / "mscoco-retinanet-efficientnet-lite2-512x512-30x-256"
                    ".json")
COCO_KEYS = ("AP-IoU=0.50:0.95", "AP-IoU=0.50", "AP-IoU=0.75",
             "AR-(all)-IoU=0.50:0.95", "AR-(L)-IoU=0.50:0.95")


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


# kernel name -> traces taken again by `kernels_on_card`; the kernels line
# reports it, so that a trace that keeps coming back empty shows across runs
PROFILER_RETRIES = {}


def kernels_on_card(kernel: str, fn) -> list:
    """Names of what one call of `fn` ran on the card (kernels, memsets,
    copies), by the profiler. A trace with no device event at all is the
    profiler's miss (once in 56 traces of the same calls on the card), not
    the call's: it is taken again, three times at most, and each retry is
    counted under `kernel` in PROFILER_RETRIES."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    tries = 3
    PROFILER_RETRIES.setdefault(kernel, 0)
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        if attempt + 1 < tries:
            PROFILER_RETRIES[kernel] += 1
        print(f"[profiler] trace {attempt + 1} of {tries} recorded no "
              "device event")
    return names


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


def compare_nms(args, kw, design):
    """`nms_lanes` against plain on the same card tensors; it must launch
    `design`. Returns max |score err| and the valid counts."""
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import kernel, nms_lanes
    before = kernel.launches_by[design]
    idx, sc, valid = nms_lanes(*args, **kw)
    check(kernel.launches_by[design] == before + 1,
          f"nms_lanes did not launch the {design} kernel")
    w_idx, w_sc, w_valid = batched_nms(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(valid, w_valid), "valid counts differ")
    check(torch.equal(idx, w_idx), "indices differ")
    if design == "sweep":
        check(torch.equal(sc, w_sc), "sweep scores differ")
    else:
        check(torch.allclose(sc, w_sc, rtol=1e-5, atol=1e-6),
              "scores differ")
    return (sc - w_sc).abs().max().item(), valid


def time_nms(args, kw) -> dict:
    """Device ms of the sweep, of the round kernel on the same tensors, and
    of plain, in turns; hard mode."""
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import launch_design
    boxes, scores, md = args
    rest = (md, kw["iou_threshold"], kw["score_threshold"])
    for design in ("sweep", "rounds"):
        got = launch_design(design, boxes, scores, *rest)
        want = batched_nms(*args, **kw)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{design} kernel differs from plain")
    times = {"sweep": [], "rounds": []}
    for design in ("sweep", "rounds", "rounds", "sweep"):
        times[design].append(time_ms(
            lambda: launch_design(design, boxes, scores, *rest), reps=50))
    out = {d: statistics.mean(t) for d, t in times.items()}
    out["plain"] = time_ms(lambda: batched_nms(*args, **kw), reps=5)
    return out


def nms_cases(rng):
    """(name, boxes, scores, max_det, keywords, design expected)."""
    hard = dict(iou_threshold=0.5, score_threshold=0.05)
    soft = dict(iou_threshold=1.0, score_threshold=0.05, soft_nms_sigma=0.25,
                soft=True)

    def in_order(boxes, scores):
        scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
        return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)
                             ).contiguous(), scores.contiguous())

    boxes, scores = lanes(rng, 640, 256)
    yield ("flagship hard L=640 k=256, unsorted", boxes, scores, 100, hard,
           "sweep")
    yield ("flagship hard, in top-k order", *in_order(boxes, scores), 100,
           hard, "sweep")
    yield "flagship soft sigma=0.25", boxes, scores, 100, soft, "rounds"
    yield ("hard, threshold -inf", boxes[:64], scores[:64], 100,
           dict(iou_threshold=0.5, score_threshold=float("-inf")), "rounds")
    yield ("tied scores (nine levels)", boxes[:64],
           torch.round(scores[:64] * 8) / 8, 100, hard, "sweep")
    yield ("all scores equal", boxes[:64], torch.full_like(scores[:64], 0.5),
           100, hard, "sweep")
    twice = torch.cat([boxes[:64, :128], boxes[:64, :128]], 1).contiguous()
    yield ("every box twice", twice,
           torch.cat([scores[:64, :128], scores[:64, :128]], 1).contiguous(),
           100, hard, "sweep")
    yield ("more slots than survivors",
           boxes[:64, :1].expand(64, 256, 4).contiguous(), scores[:64], 100,
           hard, "sweep")
    grid = torch.round(boxes[:64] * 8) / 8   # many IoUs exactly 1/2
    yield "corners on a grid of eighths", grid, scores[:64], 100, hard, "sweep"
    trained = in_order(boxes, scores * 0.052)
    yield "trained-like (few clear 0.05)", *trained, 100, hard, "sweep"
    yield "global L=8 k=256", *lanes(rng, 8, 256), 100, hard, "sweep"
    yield "k=300 L=80", *lanes(rng, 80, 300), 100, hard, "sweep"
    yield "k=1000 L=16", *lanes(rng, 16, 1000), 100, hard, "sweep"
    yield "k=5000 L=2", *lanes(rng, 2, 5000), 100, hard, "rounds"
    yield ("ragged L=3 k=77", *lanes(rng, 3, 77), 10,
           dict(iou_threshold=0.5, score_threshold=0.2), "sweep")
    yield ("all below threshold", *lanes(rng, 2, 64), 5,
           dict(iou_threshold=0.5, score_threshold=1.5), "sweep")


def phase_nms_kernel() -> float:
    from retinanet_torch.ops.nms_kernel import nms_lanes
    rng = np.random.default_rng(0)
    worst = 0.0
    for name, boxes, scores, md, kw, design in nms_cases(rng):
        err, valid = compare_nms((boxes, scores, md), kw, design)
        worst = max(worst, err)
        print(f"[kernel] {name}: {design} kernel, equal indices and valid "
              f"counts (valid sum {valid.sum().item()}), max |score err| "
              f"{err:.3g}")
        if name.startswith("all below"):
            check(valid.sum().item() == 0, "lanes below threshold selected")
        if name.startswith("more slots"):
            check(valid.tolist() == [1] * 64, "one survivor a lane expected")
        if name.startswith(("flagship hard", "trained-like")):
            ms = time_nms((boxes, scores, md), kw)
            bound, by = nms_bound_ms(boxes, md, valid)
            print(f"[kernel] {name}: sweep {ms['sweep']:.4f} ms, round "
                  f"kernel {ms['rounds']:.4f} ms, plain {ms['plain']:.4f} "
                  f"ms, bound {bound:.5f} ms ({by})")
    names = kernels_on_card("nms_lanes",
                            lambda: nms_lanes(boxes, scores, md, **kw))
    check(len(names) == 1 and "nms_sweep_kernel" in names[0],
          f"one nms_lanes call ran {names} on the card")
    print(f"[kernel] one nms_lanes call is one kernel on the card: {names}")
    return worst


def nms_lanes_agree(params, model, batches) -> tuple:
    """Each batch of images through the model once, its fused predictions
    through the post-processing twice: with the NMS kernel and with the
    plain NMS. The detections must be equal. Returns the kernel lane's
    detections and the kernel's inputs by lane count."""
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.ops import postprocess
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import nms_lanes

    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    post = postprocess.make_postprocess_fn(params, from_params(params),
                                           "cuda")
    captured, dets = {}, []

    def recording(*args):
        captured.setdefault(args[0].shape[0], args)
        return nms_lanes(*args)

    try:
        for images in batches:
            with torch.inference_mode():
                fused = fused_fn(images)
                postprocess.nms_lanes = recording
                det_k = post(fused)
                postprocess.nms_lanes = batched_nms  # the plain NMS lane
                det_p = post(fused)
            for key in det_k:
                check(torch.equal(det_k[key], det_p[key]),
                      f"batch {images.shape[0]}: kernel and plain NMS lanes "
                      f"differ in {key}")
            dets.append(det_k)
    finally:
        postprocess.nms_lanes = nms_lanes
    return dets, captured


def check_detections(det, bs: int, md: int) -> None:
    check(tuple(det["boxes"].shape) == (bs, md, 4), "boxes shape")
    check(tuple(det["scores"].shape) == (bs, md), "scores shape")
    check(tuple(det["classes"].shape) == (bs, md), "classes shape")
    check(tuple(det["valid_detections"].shape) == (bs,), "valid shape")
    check(det["classes"].dtype == torch.int32, "classes dtype")
    check(det["valid_detections"].dtype == torch.int32, "valid dtype")
    check(det["boxes"].dtype == torch.float32, "boxes dtype")
    check(bool(torch.isfinite(det["boxes"]).all()
               and torch.isfinite(det["scores"]).all()), "non-finite")


def phase_serving(params, worst_err: float) -> dict:
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.nms_kernel import kernel
    from retinanet_torch.profile_serving import zero_class_prior

    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
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
    kernel.reset_counts()
    outputs, times = [], {bs: [] for bs in BATCHES}
    for bs, images in requests:
        start = time.perf_counter()
        det = serve(images)
        torch.cuda.synchronize()
        times[bs].append((time.perf_counter() - start) * 1e3)
        outputs.append(det)
    launches = kernel.launches
    check(launches == len(requests)
          and kernel.launches_by["sweep"] == len(requests),
          f"NMS kernels launched {launches} times, the sweep "
          f"{kernel.launches_by['sweep']} times, for {len(requests)} "
          "requests")
    print(f"[serving] {len(requests)} requests, NMS kernel launches "
          f"{launches}, by design {dict(kernel.launches_by)}")

    md = int(params.inference.max_detections)
    for (bs, _), det in zip(requests, outputs):
        check_detections(det, bs, md)
    for bs in BATCHES:
        steady = times[bs][1:]
        print(f"[serving] batch {bs}: median {statistics.median(steady):.3f}"
              f" ms per request over {len(steady)} requests after the first"
              f" ({times[bs][0]:.1f} ms)")
    print("[serving] valid_detections batch 8: "
          f"{outputs[0]['valid_detections'].tolist()}, batch 1: "
          f"{outputs[BATCHES[8]]['valid_detections'].tolist()}")

    # the same fused predictions through the kernel lane and the plain lane
    dets, captured = nms_lanes_agree(
        params, model, [requests[0][1], requests[BATCHES[8]][1]])
    for i, det_k in enumerate(dets):
        same = all(torch.equal(det_k[key], outputs[0 if i == 0 else
                                                  BATCHES[8]][key])
                   for key in det_k)
        print(f"[serving] batch {det_k['valid_detections'].shape[0]}: "
              "detections through the kernel equal those through the plain "
              f"NMS; equal to the serving run's output: {same}")

    # the kernel at the inputs the serving path gave it at batch 8
    args = captured[8 * int(params.architecture.head.num_classes)]
    kw = dict(zip(("iou_threshold", "score_threshold", "soft_nms_sigma",
                   "soft"), args[3:]))
    with torch.inference_mode():
        err, valid = compare_nms(args[:3], kw, "sweep")
        ms = time_nms(args[:3], kw)
    bound, by = nms_bound_ms(args[0], args[2], valid)
    print(f"[kernel] serving inputs at batch 8 (L={args[0].shape[0]}, "
          f"k={args[0].shape[1]}, md={args[2]}, rounds "
          f"{torch.clamp(valid.long() + 1, max=args[2]).sum().item()}): "
          f"sweep {ms['sweep']:.4f} ms, round kernel {ms['rounds']:.4f} ms, "
          f"plain {ms['plain']:.4f} ms, bound {bound:.5f} ms ({by})")
    return {"name": "nms_lanes", "route": "cuda",
            "source": "retinanet_torch/csrc/nms.cu",
            "replaces": "retinanet_tpu/ops/pallas/nms_kernel.py:36",
            "launches": launches, "max_abs_err": max(worst_err, err),
            "ms": ms["sweep"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": None, "design": "sweep",
            "rounds_ms": ms["rounds"]}


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


def kept_share(anchors, gt_boxes, gt_valid) -> float:
    """The share of (tile of anchors, valid box) pairs that the matching
    kernel's tile test keeps."""
    from retinanet_torch.ops.match import tile_cull_mask
    from retinanet_torch.ops.match_kernel import TILE
    keep = tile_cull_mask(anchors, gt_boxes, TILE) & gt_valid[:, None, :]
    pairs = keep.shape[1] * int(gt_valid.sum().item())
    return keep.sum().item() / pairs if pairs else 0.0


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
    outside = gt.copy()
    outside[0, :, :2] += 9000.0                    # image 0: all outside
    outside[1, :, :2] -= 9000.0
    yield "images 0 and 1 with every box outside", outside, valid[::-1].copy()
    yield "one box an image, G=1", gt[:, 17:18].copy(), np.ones((8, 1), bool)


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
        print(f"[match] {name} ({int(valid.sum())} valid boxes, "
              f"{kept_share(anchors, gt, valid):.4f} of the (tile, box) "
              f"pairs kept): all four outputs bit-equal; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by})")
    names = kernels_on_card("match_lanes",
                            lambda: match_lanes(anchors, gt, valid))
    check(len(names) == 1 and "match_kernel" in names[0],
          f"one match_lanes call ran {names} on the card")
    print(f"[match] one match_lanes call is one kernel on the card: {names}")
    # ragged: A no multiple of the tile or of 256, G = 17, 14 valid
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


def targets_agree(params, batch) -> dict:
    """The batch's targets through the matching kernel and through the
    plain matcher must be equal; returns the kernel's."""
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.label_encoder import make_batched_encoder
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import match_lanes
    anchors = from_params(params)
    use_iou = bool(params.architecture.auxillary_head.use_auxillary_head)
    by_kernel, by_plain = (
        make_batched_encoder(anchors, params.encoder_params, device="cuda",
                             matcher=matcher, use_iou_targets=use_iou)(
            batch["boxes"], batch["classes"], batch["valid"])
        for matcher in (match_lanes, match_lanes_plain))
    kinds = ("class-targets", "box-targets") + (("iou-targets",)
                                                if use_iou else ())
    for kind in kinds:
        for level in by_kernel[kind]:
            check(torch.equal(by_kernel[kind][level], by_plain[kind][level]),
                  f"{kind} P{level}: kernel and plain lanes differ")
    check(torch.equal(by_kernel["num-positives"], by_plain["num-positives"]),
          "num-positives: kernel and plain lanes differ")
    return by_kernel


def phase_training(params, worst_err: float) -> dict:
    from retinanet_torch.data.anchors import from_params
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
    by_kernel = targets_agree(params, batch)
    print("[training] step-0 targets through the matching kernel equal "
          "those through the plain matcher; positives per image "
          f"{by_kernel['num-positives'].tolist()}")

    stats_before = state.model.backbone.stem_bn.bn.running_mean.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count at 0 just before, read just after
    kernel.reset_counts()
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
    args = (torch.from_numpy(from_params(params).boxes).cuda(),
            batch["boxes"], batch["valid"])
    err = compare_match(*args)
    ms = time_ms(lambda: match_lanes(*args), reps=50)
    plain_ms = time_ms(lambda: match_lanes_plain(*args), reps=5)
    bound, by = match_bound_ms(args[0].shape[0], args[2])
    print(f"[match] training inputs at batch {TRAIN_BATCH} "
          f"({int(args[2].sum())} valid boxes, {kept_share(*args):.4f} of "
          f"the (tile, box) pairs kept): kernel {ms:.4f} ms, plain "
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
    step_images_per_s = TRAIN_BATCH / statistics.median(times[1:]) * 1e3
    return {"name": "match_lanes", "route": "cuda",
            "source": "retinanet_torch/csrc/match.cu",
            "replaces": "retinanet_tpu/ops/pallas/matching_kernel.py:41",
            "launches": launches, "max_abs_err": max(worst_err, err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}, step_images_per_s


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


def derived_config(workdir: Path, pattern: str, ann: str,
                   train_steps: int, base: Path = FLAGSHIP,
                   step_changes=EXECUTOR_CHANGES) -> tuple:
    """The config at `base` (the flagship) with the dataset's paths, a
    model_dir under `workdir` and `step_changes` (train_steps overridden);
    returns (path, [(key, the base's value, value)])."""
    tree = json.loads(base.read_text())
    changes = [(("dataloader_params", "tfrecords", "train"), pattern),
               (("dataloader_params", "tfrecords", "val"), pattern),
               (("training", "annotation_file_path"), ann),
               (("experiment", "model_dir"), str(workdir / "models"))]
    changes += [(key, train_steps if key[-1] == "train_steps" else value)
                for key, value in step_changes]
    done = []
    for key, value in changes:
        node = tree
        for part in key[:-1]:
            node = node[part]
        done.append((".".join(key), node[key[-1]], value))
        node[key[-1]] = value
    path = workdir / f"config-{train_steps}.json"
    path.write_text(json.dumps(tree, indent=2))
    return path, done


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def check_eval_record(record: dict, step: int) -> None:
    check(record["step"] == step, f"evaluation at step {record['step']}, "
          f"{step} expected")
    for key in COCO_KEYS:
        value = record.get(f"evaluation/{key}")
        check(value is not None and -1.0 <= value <= 1.0,
              f"evaluation/{key} at step {step} is {value}")


def check_jpeg_decode(route: str) -> None:
    """The route's pixels against libjpeg's on the JPEGs of
    tests/goldens/jpeg_decode_goldens.npz: exact on the libjpeg route,
    within the stated bound on nvJPEG's."""
    from retinanet_torch.data import host_codec
    goldens = np.load(JPEG_GOLDENS)
    n = len([k for k in goldens.files if k.startswith("jpeg")])
    worst_max, worst_mean = 0, 0.0
    for i in range(n):
        pixels = goldens[f"pixels{i}"]
        got = host_codec.decode_jpeg(goldens[f"jpeg{i}"].tobytes())
        check(got.shape == pixels.shape, f"JPEG {i}: shape {got.shape}")
        err = np.abs(got.astype(np.int16) - pixels.astype(np.int16))
        print(f"[executor] JPEG {i} {pixels.shape} through {route}: max "
              f"|err| {err.max()}, mean |err| {err.mean():.4f} levels "
              "against libjpeg")
        worst_max = max(worst_max, int(err.max()))
        worst_mean = max(worst_mean, float(err.mean()))
    if route == "libjpeg":
        bound_max, bound_mean = 0, 0.0
    else:
        bound_max = host_codec.NVJPEG_MAX_ABS_ERR
        bound_mean = host_codec.NVJPEG_MEAN_ABS_ERR
    check(worst_max <= bound_max and worst_mean <= bound_mean,
          f"{route} decode: max |err| {worst_max} (bound {bound_max}), mean "
          f"{worst_mean:.4f} (bound {bound_mean})")


def pipeline_rate(params) -> tuple:
    """images/s of InputPipeline("train") over the batches after the first
    until PIPELINE_SECONDS have passed, and that window's start and end
    (perf_counter)."""
    from retinanet_torch.data.pipeline import InputPipeline
    it = iter(InputPipeline("train", params))
    next(it)
    start = end = time.perf_counter()
    batches = 0
    while end - start < PIPELINE_SECONDS:
        next(it)
        batches += 1
        end = time.perf_counter()
    it.close()
    return (batches * int(params.training.batch_size.train) / (end - start),
            start, end)


def pipeline_beside_step(params) -> tuple:
    """The pipeline's images/s while a thread runs the bare train step on
    one in-memory batch in a loop, and the images/s of the steps that
    ended inside the pipeline's window."""
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.train.trainer import build_trainer
    bs = int(params.training.batch_size.train)
    state, step = build_trainer(params, device="cuda", seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        bs, tuple(params.input.input_shape),
        int(params.encoder_params.max_boxes),
        int(params.architecture.head.num_classes), seed=0).items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    stop = threading.Event()
    ends = []

    def loop():
        nonlocal state
        while not stop.is_set():
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

    thread = threading.Thread(target=loop, name="train-step")
    thread.start()
    try:
        rate, start, end = pipeline_rate(params)
    finally:
        stop.set()
        thread.join()
    del state, batch
    torch.cuda.empty_cache()
    steps = sum(start < t <= end for t in ends)
    return rate, steps, steps * bs / (end - start)


def phase_executor(workdir: Path, step_images_per_s: float) -> dict:
    """The flagship train_val run from tfrecords through the CLI. Returns
    the kernels' launches on the in-process paths."""
    from retinanet_torch.__main__ import main as cli_main
    from retinanet_torch.core.config import Config
    from retinanet_torch.data import host_codec
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    from retinanet_torch.ops import match_kernel, nms_kernel

    route = host_codec.jpeg_route()
    print(f"[executor] JPEG route: {route}")
    check_jpeg_decode(route)
    start = time.perf_counter()
    pattern, ann = write_synthetic_tfrecords(
        str(workdir / "data"), "train", num_shards=EXECUTOR_SHARDS,
        samples_per_shard=EXECUTOR_IMAGES_PER_SHARD, num_classes=80, seed=0,
        write_annotations=True)
    n_images = EXECUTOR_SHARDS * EXECUTOR_IMAGES_PER_SHARD
    print(f"[executor] wrote {n_images} synthetic images in "
          f"{EXECUTOR_SHARDS} tfrecord shards in "
          f"{time.perf_counter() - start:.2f} s")
    steps = dict(EXECUTOR_CHANGES)[("training", "train_steps")]
    config, changes = derived_config(workdir, pattern, ann, steps)
    for key, old, new in changes:
        print(f"[executor] config {key}: {old!r} -> {new!r}")
    params = Config(str(config)).params
    model_dir = workdir / "models" / params.experiment.name
    val_batch = int(params.training.batch_size.val)
    train_batch = int(params.training.batch_size.train)

    # the host pipeline with no train step beside it (on the nvJPEG route
    # the decode itself runs on the card), then beside the bare train step
    # looping on the card, as it runs in training
    pipe_rate = pipeline_rate(params)[0]
    print(f"[executor] host pipeline alone: train batches of {train_batch} "
          f"at {params.input.input_shape} with augmentation for "
          f"{PIPELINE_SECONDS} s, {pipe_rate:.1f} images/s "
          f"({os.cpu_count()} CPUs)")
    beside_rate, beside_steps, step_beside_rate = pipeline_beside_step(
        params)
    print(f"[executor] host pipeline beside the train step: "
          f"{beside_rate:.1f} images/s; the step beside the pipeline: "
          f"{beside_steps} steps in the window, {step_beside_rate:.2f} "
          f"images/s (alone in phase 6: {step_images_per_s:.2f})")

    # (a) the entry point a user runs
    start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "retinanet_torch", "--config_path",
             str(config)], cwd=str(REPO), env=env, capture_output=True,
            text=True, timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tail = e.stderr or b""
        if isinstance(tail, bytes):
            tail = tail.decode(errors="replace")
        check(False, f"python -m retinanet_torch did not end within "
              f"{CLI_TIMEOUT_S} s:\n{tail[-4000:]}")
    seconds = time.perf_counter() - start
    for line in proc.stderr.splitlines():
        if "imgs/s" in line or "Evaluat" in line or "Error" in line:
            print(f"[executor] | {line[:400]}")
    check(proc.returncode == 0, f"python -m retinanet_torch exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    ckpts = sorted(int(p.stem) for p in (model_dir / "checkpoints").glob(
        "*.pt"))
    check(ckpts == [8, 16, 24], f"checkpoints at {ckpts}")
    records = read_jsonl(model_dir / "logs" / "train_metrics.jsonl")
    for record in records:
        for key, value in record.items():
            check(math.isfinite(value), f"step {record['step']}: {key} is "
                  f"{value}")
    evals = [r for r in records if any(k.startswith("evaluation/")
                                       for k in r)]
    check(len(evals) == 2, f"{len(evals)} evaluation records")
    check_eval_record(evals[0], 12)
    check_eval_record(evals[1], 24)
    train_records = [r for r in records if "total-loss" in r]
    check([r["step"] for r in train_records] == list(range(4, 25, 4)),
          f"train records at {[r['step'] for r in train_records]}")
    # the first outer step carries the start-up; each logged rate is that
    # of its own outer step of 4 steps
    rates = [r["images-per-second"] for r in train_records]
    rate = statistics.median(rates[1:])
    print(f"[executor] (a) python -m retinanet_torch: exit 0 in "
          f"{seconds:.1f} s; checkpoints {ckpts}; evaluations at 12 and 24: "
          + json.dumps({k: round(evals[-1][f"evaluation/{k}"], 5)
                        for k in COCO_KEYS}))
    print(f"[executor] images/s logged by the executor at batch "
          f"{train_batch}: median {rate:.2f} over the outer steps after "
          f"the first ({', '.join(f'{x:.2f}' for x in rates)}); the bare step "
          f"in phase 6 on one repeated in-memory batch: "
          f"{step_images_per_s:.2f}; the pipeline alone: {pipe_rate:.1f}")
    print("[executor] total-loss " + " ".join(
        f"{r['total-loss']:.4f}" for r in train_records))

    # (b) evaluation alone, in process
    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    scores = cli_main(["--config_path", str(config), "--run_evaluation"])
    sweeps = nms_kernel.kernel.launches_by["sweep"]
    eval_matches = match_kernel.kernel.launches
    n_val = int(params.training.validation_samples) // val_batch
    check(sweeps == n_val and nms_kernel.kernel.launches == n_val,
          f"NMS sweep kernel launched {sweeps} times "
          f"({nms_kernel.kernel.launches} in all) for {n_val} val batches")
    check(eval_matches == 0, f"matching kernel launched {eval_matches} "
          "times in an evaluation")
    check((model_dir / "predictions.json").exists(), "no predictions.json")
    check(all(-1.0 <= scores[k] <= 1.0 for k in COCO_KEYS), f"{scores}")
    timing = {k[len("eval-timing/"):]: v for k, v in read_jsonl(
        model_dir / "logs" / "train_metrics.jsonl")[-1].items()
        if k.startswith("eval-timing/")}
    print(f"[executor] (b) --run_evaluation: NMS sweep launches {sweeps} for"
          f" {n_val} val batches of {val_batch}, matching launches "
          f"{eval_matches}; predictions.json written; "
          + json.dumps({k: round(v, 5) for k, v in scores.items()}))
    print("[executor] eval legs, s: " + json.dumps(
        {k: round(v, 4) for k, v in timing.items()}))

    # (c) resume from step 24 to 28
    config28, _ = derived_config(workdir, pattern, ann, RESUME_STEPS)
    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    done = cli_main(["--config_path", str(config28)])
    resume_matches = match_kernel.kernel.launches
    check(done is True, "the resumed run did not finish")
    check(resume_matches == RESUME_STEPS - steps,
          f"matching kernel launched {resume_matches} times in "
          f"{RESUME_STEPS - steps} resumed steps")
    ckpts = sorted(int(p.stem) for p in (model_dir / "checkpoints").glob(
        "*.pt"))
    check(ckpts[-1] == RESUME_STEPS, f"checkpoints after the resume {ckpts}")
    last = [r for r in read_jsonl(model_dir / "logs" / "train_metrics.jsonl")
            if "total-loss" in r][-1]
    check(last["step"] == RESUME_STEPS, f"last train record {last['step']}")
    print(f"[executor] (c) resume: restored step {steps}, "
          f"{RESUME_STEPS - steps} steps, matching launches {resume_matches},"
          f" ended at step {last['step']}, total-loss "
          f"{last['total-loss']:.4f}")
    return {"nms_lanes": {"executor_eval": sweeps},
            "match_lanes": {"executor_eval": eval_matches,
                            "executor_resume": resume_matches}}


def phase_overfit(workdir: Path) -> dict:
    """The learning check through the port's Executor."""
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.tools import overfit_check
    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    start = time.perf_counter()
    scores = overfit_check.run(str(workdir), device="cuda")
    ap50 = scores["AP-IoU=0.50"]
    print(f"[overfit] AP@0.5 {ap50:.4f} after 300 steps (target "
          f"{overfit_check.TARGET_AP}), AP {scores['AP-IoU=0.50:0.95']:.4f}, "
          f"{time.perf_counter() - start:.1f} s; matching launches "
          f"{match_kernel.kernel.launches}, NMS launches "
          f"{nms_kernel.kernel.launches}")
    check(ap50 >= overfit_check.TARGET_AP,
          f"overfit AP@0.5 {ap50:.4f} < {overfit_check.TARGET_AP}")
    return {"nms_lanes": {"overfit": nms_kernel.kernel.launches},
            "match_lanes": {"overfit": match_kernel.kernel.launches}}


def zoo_architecture(label: str, path: Path) -> dict:
    """One architecture at its config's width and input size, batch
    ZOO_BATCH: requests through `build_serving_fn` and steps through
    `build_trainer`, each kernel's launches counted from 0 around them;
    NMS and matching held to their plain versions and timed at its
    shapes."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import match_lanes
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.train.trainer import build_trainer

    params = Config(str(path)).params
    h, w = (int(v) for v in params.input.input_shape)
    num_classes = int(params.architecture.head.num_classes)
    md = int(params.inference.max_detections)
    out = {"name": label, "config": str(path.relative_to(REPO)),
           "input": [h, w], "batch": ZOO_BATCH}

    # serving
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    serve = build_serving_fn(params, device="cuda", model=model)
    rng = np.random.default_rng(0)
    requests = [torch.from_numpy(rng.integers(
        0, 256, (ZOO_BATCH, h, w, 3)).astype(np.uint8))
        for _ in range(ZOO_REQUESTS + 1)]
    nms_kernel.kernel.reset_counts()
    times = []
    for images in requests:
        start = time.perf_counter()
        det = serve(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        check_detections(det, ZOO_BATCH, md)
    nms_launches = nms_kernel.kernel.launches_by["sweep"]
    check(nms_launches == len(requests) == nms_kernel.kernel.launches,
          f"{label}: NMS sweep launched {nms_launches} times for "
          f"{len(requests)} requests")
    out["request_ms"] = statistics.median(times[1:])
    first_request_ms = times[0]
    _, captured = nms_lanes_agree(params, model, requests[:1])
    args = captured[ZOO_BATCH * num_classes]
    kw = dict(zip(("iou_threshold", "score_threshold", "soft_nms_sigma",
                   "soft"), args[3:]))
    with torch.inference_mode():
        err, valid = compare_nms(args[:3], kw, "sweep")
        ms = time_nms(args[:3], kw)
    bound, by = nms_bound_ms(args[0], args[2], valid)
    out["nms"] = {"lanes": int(args[0].shape[0]), "k": int(args[0].shape[1]),
                  "launches": nms_launches, "max_abs_err": err,
                  "ms": ms["sweep"], "plain_ms": ms["plain"],
                  "bound_ms": bound, "bound_by": by}
    del model, serve
    torch.cuda.empty_cache()

    # training
    state, step = build_trainer(params, device="cuda", seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        ZOO_BATCH, (h, w), int(params.encoder_params.max_boxes), num_classes,
        seed=0).items()}
    targets_agree(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    match_kernel.kernel.reset_counts()
    losses, times = [], []
    for _ in range(ZOO_STEPS + 1):
        start = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        for key, value in metrics.items():
            check(math.isfinite(float(value)), f"{label}: {key} is {value}")
        losses.append(float(metrics["total-loss"]))
    match_launches = match_kernel.kernel.launches
    check(match_launches == ZOO_STEPS + 1,
          f"{label}: matching launched {match_launches} times in "
          f"{ZOO_STEPS + 1} steps")
    check(losses[-1] < losses[0], f"{label}: total-loss {losses} on a "
          "repeated batch")
    out["step_ms"] = statistics.median(times[1:])
    out["images_per_s"] = ZOO_BATCH / out["step_ms"] * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["total_loss"] = losses
    anchors = torch.from_numpy(from_params(params).boxes).cuda()
    err = compare_match(anchors, batch["boxes"], batch["valid"])
    ms = time_ms(lambda: match_lanes(anchors, batch["boxes"],
                                     batch["valid"]), reps=50)
    plain_ms = time_ms(lambda: match_lanes_plain(
        anchors, batch["boxes"], batch["valid"]), reps=5)
    bound, by = match_bound_ms(anchors.shape[0], batch["valid"])
    out["match"] = {"anchors": int(anchors.shape[0]),
                    "valid_boxes": int(batch["valid"].sum()),
                    "launches": match_launches, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by}
    del state, step, batch
    torch.cuda.empty_cache()
    print(f"[zoo] {label} ({out['config']}), {out['parameters']} "
          f"parameters, batch {ZOO_BATCH}: request {out['request_ms']:.3f} "
          f"ms (median of {ZOO_REQUESTS} after a first of "
          f"{first_request_ms:.1f}); step {out['step_ms']:.3f} ms (median "
          f"of {ZOO_STEPS} after a first of {times[0]:.1f}), "
          f"{out['images_per_s']:.2f} images/s, peak {out['peak_gb']:.2f} "
          "GB; total-loss " + " ".join(f"{x:.4f}" for x in losses))
    n, m = out["nms"], out["match"]
    print(f"[zoo] {label}: NMS sweep L={n['lanes']} k={n['k']} "
          f"{n['ms']:.4f} ms (plain {n['plain_ms']:.3f}, bound "
          f"{n['bound_ms']:.5f} {n['bound_by']}), detections equal to the "
          f"plain NMS's; matching A={m['anchors']} ({m['valid_boxes']} "
          f"valid boxes) {m['ms']:.4f} ms (plain {m['plain_ms']:.3f}, bound "
          f"{m['bound_ms']:.5f} {m['bound_by']}), targets and outputs "
          "bit-equal to the plain matcher's")
    return out


def zoo_swap(label: str, arch_changes: dict) -> dict:
    """The flagship with one part of its architecture swapped: one request
    and two train steps at batch ZOO_BATCH, launches counted from 0."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.train.trainer import build_trainer

    tree = json.loads(FLAGSHIP.read_text())
    for key, value in arch_changes.items():
        tree["architecture"][key] = {**tree["architecture"].get(key, {}),
                                     **value}
    params = from_dict(tree)
    h, w = (int(v) for v in params.input.input_shape)
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    n_params = sum(p.numel() for p in model.parameters())
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (ZOO_BATCH, h, w, 3)).astype(np.uint8))
    nms_kernel.kernel.reset_counts()
    start = time.perf_counter()
    det = build_serving_fn(params, device="cuda", model=model)(images)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - start) * 1e3
    check_detections(det, ZOO_BATCH, int(params.inference.max_detections))
    nms_launches = nms_kernel.kernel.launches
    check(nms_launches == 1, f"{label}: NMS launched {nms_launches} times")
    del model
    state, step = build_trainer(params, device="cuda", seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        ZOO_BATCH, (h, w), int(params.encoder_params.max_boxes),
        int(params.architecture.head.num_classes), seed=0).items()}
    match_kernel.kernel.reset_counts()
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        for key, value in metrics.items():
            check(math.isfinite(float(value)), f"{label}: {key} is {value}")
        losses.append(float(metrics["total-loss"]))
    match_launches = match_kernel.kernel.launches
    check(match_launches == 2, f"{label}: matching launched "
          f"{match_launches} times in 2 steps")
    iou = float(metrics["iou-prediction-loss"])
    if "auxillary_head" in arch_changes:
        check(iou > 0.0, f"{label}: iou-prediction-loss {iou}")
    del state, step, batch
    torch.cuda.empty_cache()
    print(f"[zoo] flagship with {label}: {n_params} parameters; one request "
          f"at batch {ZOO_BATCH} ({request_ms:.1f} ms, the first), NMS "
          f"launches {nms_launches}; two steps, matching launches "
          f"{match_launches}, total-loss {losses[0]:.4f} {losses[1]:.4f}, "
          f"iou-prediction-loss {iou:.4f}")
    return {"nms_lanes": nms_launches, "match_lanes": match_launches}


def zoo_cli(workdir: Path) -> None:
    """`python -m retinanet_torch` in train_val on the EfficientNet-B2
    config: synthetic scenes up to ZOO_CLI_MAX_SIDE px, ZOO_CLI_CHANGES; it
    must end in a COCO eval record."""
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    pattern, ann = write_synthetic_tfrecords(
        str(workdir / "data"), "train", num_shards=2, samples_per_shard=16,
        num_classes=80, seed=0, write_annotations=True,
        max_side=ZOO_CLI_MAX_SIDE)
    steps = dict(ZOO_CLI_CHANGES)[("training", "train_steps")]
    config, changes = derived_config(workdir, pattern, ann, steps,
                                     base=ZOO_CLI_CONFIG,
                                     step_changes=ZOO_CLI_CHANGES)
    for key, old, new in changes:
        print(f"[zoo] CLI config {key}: {old!r} -> {new!r}")
    name = json.loads(config.read_text())["experiment"]["name"]
    model_dir = workdir / "models" / name
    start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "retinanet_torch", "--config_path",
             str(config)], cwd=str(REPO), env=env, capture_output=True,
            text=True, timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        check(False, f"the EfficientNet-B2 CLI run did not end within "
              f"{CLI_TIMEOUT_S} s")
    seconds = time.perf_counter() - start
    check(proc.returncode == 0, f"python -m retinanet_torch exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    records = read_jsonl(model_dir / "logs" / "train_metrics.jsonl")
    for record in records:
        for key, value in record.items():
            check(math.isfinite(value), f"step {record['step']}: {key} is "
                  f"{value}")
    evals = [r for r in records if any(k.startswith("evaluation/")
                                       for k in r)]
    check(len(evals) == 1, f"{len(evals)} evaluation records")
    check_eval_record(evals[0], steps)
    ckpts = sorted(int(p.stem) for p in (model_dir / "checkpoints").glob(
        "*.pt"))
    check(ckpts == [steps], f"checkpoints at {ckpts}")
    rates = [r["images-per-second"] for r in records
             if "images-per-second" in r]
    print(f"[zoo] (c) python -m retinanet_torch, EfficientNet-B2 768 "
          f"train_val: exit 0 in {seconds:.1f} s; checkpoint {ckpts}; "
          f"images/s logged {', '.join(f'{x:.2f}' for x in rates)}; "
          f"evaluation at {steps}: "
          + json.dumps({k: round(evals[0][f"evaluation/{k}"], 5)
                        for k in COCO_KEYS}))


def phase_zoo(workdir: Path) -> tuple:
    """(a) every config architecture, (b) the flagship's swaps, (c) the
    CLI on EfficientNet-B2. Returns the per-architecture records and each
    kernel's launches on the zoo paths."""
    archs = []
    launches = {"nms_lanes": {}, "match_lanes": {}}
    for label, rel in ZOO:
        start = time.perf_counter()
        rec = zoo_architecture(label, REPO / "configs" / rel)
        archs.append(rec)
        launches["nms_lanes"][f"zoo {label}"] = rec["nms"]["launches"]
        launches["match_lanes"][f"zoo {label}"] = rec["match"]["launches"]
        print(f"[zoo] {label} took {time.perf_counter() - start:.1f} s")
    for label, changes in SWAPS:
        for name, count in zoo_swap(label, changes).items():
            launches[name][f"flagship with {label}"] = count
    start = time.perf_counter()
    zoo_cli(workdir)
    print(f"[zoo] (c) took {time.perf_counter() - start:.1f} s")
    return archs, launches


def dp_tree(precision: str) -> dict:
    """The flagship with floatx `precision`, its only change (none for its
    own mixed_bfloat16)."""
    tree = json.loads(FLAGSHIP.read_text())
    tree["floatx"]["precision"] = precision
    return tree


def dp_batches(order: str = "") -> list:
    """The seeded global batches, in their order or in one of DP_ORDERS
    (the same steps in exact arithmetic)."""
    from retinanet_torch.data.synthetic import synthetic_train_batch
    rows = np.arange(DP_BATCH)
    if order == DP_ORDERS[0]:
        rows = np.roll(rows, DP_BATCH // 2)
    elif order == DP_ORDERS[1]:
        rows = rows[::-1]
    return [{k: v[rows] for k, v in synthetic_train_batch(
        DP_BATCH, (640, 640), 100, 80, seed=i).items()}
        for i in range(DP_STEPS)]


def dp_steps(params, batches, device) -> tuple:
    """DP_STEPS steps from the seeded weights: (losses per step, the
    state_dict on the host, the trainer's state)."""
    from retinanet_torch.train.trainer import build_trainer
    state, step = build_trainer(params, device=device, seed=0)
    history = []
    for batch in batches:
        state, metrics = step(state, {k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()})
        history.append({k: float(v) for k, v in metrics.items()})
    return history, {k: v.cpu() for k, v in
                     state.model.state_dict().items()}, state


def dp_rank(out_dir: str) -> None:
    """One rank of phase 11 (a), in a process of its own on card 0: the
    steps in each of DP_PRECISIONS, then (float32) the gradients'
    all-reduce timed and a sharded inference gathered to the chief."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.preprocessing import make_device_normalizer
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.ops.postprocess import make_inference_fn
    from retinanet_torch.parallel import distributed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = distributed.process_index(), distributed.process_count()
    batches = [{k: distributed.process_slice(v, rank, world)
                for k, v in b.items()} for b in dp_batches()]
    runs = {}
    # float32 last: its trained state serves the timing and the inference
    for precision in reversed(DP_PRECISIONS):
        match_kernel.kernel.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        history, weights, state = dp_steps(
            from_dict(dp_tree(precision)), batches, torch.device("cuda", 0))
        runs[precision] = {
            "history": history, "weights": weights,
            "match_launches": match_kernel.kernel.launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if precision != "float32":
            del state
            torch.cuda.empty_cache()
    params = from_dict(dp_tree("float32"))
    nms_kernel.kernel.reset_counts()
    trainable = [p for p in state.model.parameters() if p.requires_grad]
    reduce_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        start = time.perf_counter()
        distributed.all_reduce_gradients(trainable)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - start) * 1e3)
    state.model.eval()
    infer = make_inference_fn(state.model, params, from_params(params),
                              make_device_normalizer(params),
                              compute_dtype=torch.float32, device="cuda:0")
    images = np.random.default_rng(5).integers(
        0, 256, (DP_EVAL_BATCH, 640, 640, 3)).astype(np.uint8)
    det = infer(torch.from_numpy(distributed.process_slice(images, rank,
                                                           world)))
    parts = distributed.gather_to_chief(
        {k: v.cpu().numpy() for k, v in det.items()})
    torch.save({"runs": runs,
                "nms_launches": nms_kernel.kernel.launches,
                "gathered_images": (None if parts is None else sum(
                    len(p["valid_detections"]) for p in parts)),
                "grad_bytes": sum(4 * p.numel() for p in trainable),
                "reduce_ms": statistics.median(reduce_ms[1:])},
               f"{out_dir}/rank{rank}.pt")


def phase_data_parallel(workdir: Path) -> dict:
    """(a): two ranks against one process at the same global batch, in each
    of DP_PRECISIONS."""
    from retinanet_torch.tools.multiprocess_smoke import run_group
    workdir.mkdir(parents=True)
    start = time.perf_counter()
    run_group(dp_rank, DP_WORLD, workdir, args=(str(workdir),),
              device="cuda:0", backend="gloo", timeout=600)
    print(f"[dp] {DP_WORLD} ranks on card 0 over gloo: "
          f"{time.perf_counter() - start:.1f} s")
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    for r, res in enumerate(ranks):
        check(res["nms_launches"] == 1,
              f"rank {r}: NMS kernel launched {res['nms_launches']} times")
    check(ranks[0]["gathered_images"] == DP_EVAL_BATCH,
          f"the chief gathered {ranks[0]['gathered_images']} images")
    for precision, rtol in DP_PRECISIONS.items():
        dp_hold_to_one_process(precision, rtol,
                               [res["runs"][precision] for res in ranks])
    print(f"[dp] each rank: NMS launches {ranks[0]['nms_launches']}, "
          f"{ranks[1]['nms_launches']}; the chief gathered "
          f"{ranks[0]['gathered_images']} images")
    print(f"[dp] gradient all-reduce: {ranks[0]['grad_bytes']} bytes "
          f"(float32), {ranks[0]['reduce_ms']:.3f} / "
          f"{ranks[1]['reduce_ms']:.3f} ms (host clock, median of 3, rank 0 "
          "/ 1; gloo through the host)")
    return {"nms_lanes": {f"data parallel rank {r}": res["nms_launches"]
                          for r, res in enumerate(ranks)},
            "match_lanes": {
                f"data parallel rank {r} {precision}":
                    res["runs"][precision]["match_launches"]
                for r, res in enumerate(ranks)
                for precision in DP_PRECISIONS}}


def dp_hold_to_one_process(precision: str, rtol: float, runs: list) -> None:
    """The ranks' runs in `precision`: bit-equal to each other, each kernel
    launched, and held to one process at the same global batch."""
    from retinanet_torch.core.config import from_dict
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    refs = []
    for order in ("",) + DP_ORDERS:
        history, weights, state = dp_steps(
            from_dict(dp_tree(precision)), dp_batches(order),
            torch.device("cuda"))
        refs.append((history, weights))
        del state
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    (ref_history, ref_weights), others = refs[0], refs[1:]
    for r, run in enumerate(runs):
        check(run["history"] == runs[0]["history"],
              f"{precision}: rank {r}'s losses differ from rank 0's")
        check(all(torch.equal(run["weights"][k], runs[0]["weights"][k])
                  for k in ref_weights),
              f"{precision}: rank {r}'s parameters differ")
        check(run["match_launches"] == DP_STEPS,
              f"{precision}: rank {r}: matching kernel launched "
              f"{run['match_launches']} times in {DP_STEPS} steps")
    # each difference from one process against `rtol`, and (after the
    # first step's losses) against it plus DP_ORDER_FACTOR times the one
    # process's own move under a reordering
    within, total, ratios = 0, 0, []
    worst = (0.0, "")

    def hold(name, err, bound, move, first_losses):
        nonlocal within, total, worst
        within += err <= bound
        total += 1
        check(err <= bound + (0.0 if first_losses
                              else DP_ORDER_FACTOR * move),
              f"{precision} {name}: {err} from one process, bound {bound}, "
              f"the one process's move under a reordering {move}")
        if move > 0:
            ratios.append(err / move)
        worst = max(worst, (err / (bound + move), name))

    for i, (got, want) in enumerate(zip(runs[0]["history"], ref_history)):
        for key, value in want.items():
            check(math.isfinite(got[key]), f"{key} is {got[key]}")
            move = max(abs(h[i][key] - value) for h, _ in others)
            hold(f"step {i} {key}", abs(got[key] - value),
                 rtol * abs(value) + 1e-7, move, i == 0)
    for name, want in ref_weights.items():
        move = max(float((w[name] - want).abs().max()) for _, w in others)
        hold(name, float((runs[0]["weights"][name] - want).abs().max()),
             rtol * float(want.abs().max()) + DP_ATOL, move, False)
    print(f"[dp] flagship {precision}, global batch {DP_BATCH} "
          f"({DP_BATCH // DP_WORLD} a rank), {DP_STEPS} steps: losses and "
          f"parameters bit-equal across the ranks; against one process at "
          f"batch {DP_BATCH}: {within} of {total} losses and tensors within "
          f"{rtol:.3g} of their magnitude alone, all within it plus "
          f"{DP_ORDER_FACTOR:g} x the one process's largest move under two "
          f"reorderings of its batch; difference / move: median "
          f"{statistics.median(ratios):.3g}, largest {max(ratios):.3g}; "
          f"largest difference {worst[0]:.3g} x (bound + move), "
          f"{worst[1]}; total-loss "
          + " ".join(f"{h['total-loss']:.6f}" for h in runs[0]["history"])
          + " (one process: " + " ".join(
              f"{h['total-loss']:.6f}" for h in ref_history) + "; reordered: "
          + "; ".join(" ".join(f"{h['total-loss']:.6f}" for h in hist)
                      for hist, _ in others) + ")")
    print(f"[dp] {precision}: matching launches "
          + ", ".join(str(run["match_launches"]) for run in runs)
          + "; peak allocated a rank "
          + ", ".join(f"{run['peak_gb']:.2f}" for run in runs) + " GB")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_multi_host_cli(workdir: Path) -> dict:
    """(b): the CLI with --is_multi_host as rank 0 of a world of one on
    NCCL, in process, with torchrun's environment."""
    from retinanet_torch.__main__ import main as cli_main
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.parallel import distributed
    pattern, ann = write_synthetic_tfrecords(
        str(workdir / "data"), "train", num_shards=2, samples_per_shard=8,
        num_classes=80, seed=0, write_annotations=True)
    steps = dict(MULTI_HOST_CHANGES)[("training", "train_steps")]
    config, changes = derived_config(workdir, pattern, ann, steps,
                                     step_changes=MULTI_HOST_CHANGES)
    for key, old, new in changes:
        print(f"[multi-host] config {key}: {old!r} -> {new!r}")
    params = Config(str(config)).params
    model_dir = workdir / "models" / params.experiment.name
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    try:
        done = cli_main(["--config_path", str(config), "--is_multi_host"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(done is True, "the --is_multi_host run did not finish")
    check(not distributed.is_initialized(), "the process group outlived "
          "the CLI")
    n_val = int(params.training.validation_samples) // int(
        params.training.batch_size.val)
    check(match_kernel.kernel.launches == steps,
          f"matching kernel launched {match_kernel.kernel.launches} times "
          f"in {steps} steps")
    check(nms_kernel.kernel.launches == n_val,
          f"NMS kernel launched {nms_kernel.kernel.launches} times for "
          f"{n_val} val batches")
    ckpts = sorted(int(p.stem) for p in (model_dir / "checkpoints").glob(
        "*.pt"))
    check(ckpts == [steps], f"checkpoints at {ckpts}")
    records = read_jsonl(model_dir / "logs" / "train_metrics.jsonl")
    evals = [r for r in records if any(k.startswith("evaluation/")
                                       for k in r)]
    check(len(evals) == 1, f"{len(evals)} evaluation records")
    check_eval_record(evals[0], steps)
    print(f"[multi-host] python -m retinanet_torch --is_multi_host, NCCL, "
          f"world 1: {steps} steps, matching launches "
          f"{match_kernel.kernel.launches}, NMS launches "
          f"{nms_kernel.kernel.launches}, checkpoint {ckpts}; evaluation: "
          + json.dumps({k: round(evals[0][f"evaluation/{k}"], 5)
                        for k in COCO_KEYS}))
    return {"nms_lanes": {"multi-host CLI": nms_kernel.kernel.launches},
            "match_lanes": {"multi-host CLI": match_kernel.kernel.launches}}


def own_batch(label: str, path: Path, accum: int) -> tuple:
    """The config at its own train batch in `accum` micro-batches: one
    step and then OWN_BATCH_STEPS timed ones; the matching kernel must
    launch in every micro-batch. Returns (record, its launches)."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.ops import match_kernel
    from retinanet_torch.profile_training import measure_step
    params = Config(str(path)).params
    batch = int(params.training.batch_size.train)
    match_kernel.kernel.reset_counts()
    out = measure_step(params, batch, accum, steps=OWN_BATCH_STEPS,
                       warmup=1)
    launches = match_kernel.kernel.launches
    check(launches == (OWN_BATCH_STEPS + 1) * accum,
          f"{label}: matching launched {launches} times in "
          f"{OWN_BATCH_STEPS + 1} steps of {accum} micro-batches")
    for key, value in out["metrics"].items():
        check(math.isfinite(value), f"{label}: {key} is {value}")
    record = {"config": str(path.relative_to(REPO)), "batch": batch,
              "grad_accum_steps": accum, "micro_batch": batch // accum,
              "step_ms": out["step_ms"], "images_per_s": out["images_per_s"],
              "peak_gb": out["peak_gb"],
              "total_loss": out["metrics"]["total-loss"]}
    del out
    torch.cuda.empty_cache()
    print(f"[own batch] {label}: batch {batch} in {accum} micro-batches of "
          f"{batch // accum}: step {record['step_ms']:.1f} ms (host clock, "
          f"median of {OWN_BATCH_STEPS} after one), "
          f"{record['images_per_s']:.2f} images/s, peak "
          f"{record['peak_gb']:.2f} GB, matching launches {launches}, "
          f"total-loss {record['total_loss']:.4f}")
    return record, launches


def phase_high_res_kernels() -> dict:
    """(d), after the steps: a batch-8 request and the kernels held to
    their plain versions at 1280x1280."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import nms_kernel
    from retinanet_torch.ops.match import match_lanes_plain
    from retinanet_torch.ops.match_kernel import match_lanes
    from retinanet_torch.profile_serving import zero_class_prior
    params = Config(str(HIGH_RES)).params
    h, w = (int(v) for v in params.input.input_shape)
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, h, w, 3)).astype(np.uint8))
    nms_kernel.kernel.reset_counts()
    det = build_serving_fn(params, device="cuda", model=model)(images)
    torch.cuda.synchronize()
    nms_launches = nms_kernel.kernel.launches_by["sweep"]
    check(nms_launches == 1 == nms_kernel.kernel.launches,
          f"1280x1280: NMS launched {nms_kernel.kernel.launches} times for "
          "one request")
    check_detections(det, 8, int(params.inference.max_detections))
    _, captured = nms_lanes_agree(params, model, [images])
    args = captured[8 * int(params.architecture.head.num_classes)]
    kw = dict(zip(("iou_threshold", "score_threshold", "soft_nms_sigma",
                   "soft"), args[3:]))
    with torch.inference_mode():
        nms_err, valid = compare_nms(args[:3], kw, "sweep")
        nms_ms = time_nms(args[:3], kw)
    nms_bound, nms_by = nms_bound_ms(args[0], args[2], valid)
    del model
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        8, (h, w), int(params.encoder_params.max_boxes), 80,
        seed=0).items()}
    targets_agree(params, batch)
    anchors = torch.from_numpy(from_params(params).boxes).cuda()
    check(anchors.shape[0] == HIGH_RES_ANCHORS,
          f"{anchors.shape[0]} anchors at 1280x1280")
    match_err = compare_match(anchors, batch["boxes"], batch["valid"])
    match_ms = time_ms(lambda: match_lanes(anchors, batch["boxes"],
                                           batch["valid"]), reps=50)
    match_plain = time_ms(lambda: match_lanes_plain(
        anchors, batch["boxes"], batch["valid"]), reps=5)
    match_bound, match_by = match_bound_ms(anchors.shape[0], batch["valid"])
    print(f"[own batch] 1280x1280 batch-8 request: detections through the "
          f"NMS kernel equal the plain NMS's; sweep L={args[0].shape[0]} "
          f"k={args[0].shape[1]} {nms_ms['sweep']:.4f} ms (plain "
          f"{nms_ms['plain']:.3f}, bound {nms_bound:.5f} {nms_by}); "
          f"matching A={anchors.shape[0]} ({int(batch['valid'].sum())} "
          f"valid boxes, {kept_share(anchors, batch['boxes'], batch['valid']):.4f}"
          f" of the (tile, box) pairs kept) {match_ms:.4f} ms (plain "
          f"{match_plain:.3f}, bound {match_bound:.5f} {match_by}), all four "
          "outputs and the targets bit-equal to the plain matcher's")
    return {"nms_lanes": {"lanes": int(args[0].shape[0]),
                          "k": int(args[0].shape[1]),
                          "launches": nms_launches, "max_abs_err": nms_err,
                          "ms": nms_ms["sweep"], "plain_ms": nms_ms["plain"],
                          "bound_ms": nms_bound, "bound_by": nms_by},
            "match_lanes": {"anchors": int(anchors.shape[0]),
                            "valid_boxes": int(batch["valid"].sum()),
                            "max_abs_err": match_err, "ms": match_ms,
                            "plain_ms": match_plain, "bound_ms": match_bound,
                            "bound_by": match_by}}


def phase_parallel_and_own_batches(workdir: Path) -> tuple:
    """Phase 11. Returns the kernels' launches on its paths, the own-batch
    records, and the kernels at the 1280x1280 shapes."""
    launches = {"nms_lanes": {}, "match_lanes": {}}
    for sub, phase in (("(a)", lambda: phase_data_parallel(workdir / "dp")),
                       ("(b)", lambda: phase_multi_host_cli(
                           workdir / "multi_host"))):
        start = time.perf_counter()
        for name, counts in phase().items():
            launches[name].update(counts)
        print(f"[phase 11] {sub} took {time.perf_counter() - start:.1f} s")
    records = []
    for sub, label, path, accum in (
            ("(c)", "flagship", FLAGSHIP, FLAGSHIP_ACCUM),
            ("(d)", "resnet50 1280x1280", HIGH_RES, HIGH_RES_ACCUM)):
        start = time.perf_counter()
        record, count = own_batch(label, path, accum)
        records.append(record)
        launches["match_lanes"][f"{label} at batch {record['batch']}"] = count
        print(f"[phase 11] {sub} took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    high_res = phase_high_res_kernels()
    launches["nms_lanes"]["1280x1280 request"] = high_res["nms_lanes"][
        "launches"]
    print(f"[phase 11] (d) kernels took {time.perf_counter() - start:.1f} s")
    return launches, records, high_res


# -- phase 12: export artifacts and int8 serving ------------------------------

def read_rows(size: int, k: int, stride: int, pad_before: int,
              out: int) -> int:
    """How many of an axis's `size` input rows some window of the conv
    reads (a 1x1 conv at stride 2 reads one in two)."""
    return len({o * stride + t - pad_before for o in range(out)
                for t in range(k)} & set(range(size)))


def int8_call_bound(x, bias, y, kh: int, kw: int, stride: int,
                    pads, groups: int) -> tuple:
    """(seconds at the int8 tensor-core rate, seconds at the memory rate) of
    one int8 conv: 2 operations a multiply-add; the input pixels some
    window reads, the int8 weights (o x terms of them, not the padding of
    the packed layout), the scale (and bias) and the output, each moved
    once."""
    n, oh, ow, o = y.shape
    terms = kh * kw * (x.shape[3] if groups == 1 else 1)
    ops = 2.0 * n * oh * ow * o * terms
    rows = read_rows(x.shape[1], kh, stride, pads[0], oh)
    cols = read_rows(x.shape[2], kw, stride, pads[2], ow)
    nbytes = (n * rows * cols * x.shape[3] * x.element_size()
              + o * terms
              + (1 if bias is None else 2) * 4 * o
              + y.numel() * y.element_size())
    return ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S


def capture_int8_calls(serve, images) -> tuple:
    """One request through `serve` with every `int8_conv2d` call of the
    int8 lane recorded: (detections, [(args, output)])."""
    from retinanet_torch.export import quantize
    calls = []
    real = quantize.int8_conv2d

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    quantize.int8_conv2d = recording
    try:
        det = serve(images)
        torch.cuda.synchronize()
    finally:
        quantize.int8_conv2d = real
    return det, calls


def hold_int8_calls(calls, paths_of, label: str, timed: bool) -> tuple:
    """Every recorded call bit for bit against `int8_conv2d_plain` on the
    same tensors; with `timed`, each call's kernel, plain and cuDNN bf16
    device ms (and `torch._int_mm` for a 1x1 conv) and its bounds. Returns
    (rows, the largest |kernel - plain| over the calls)."""
    import torch.nn.functional as F
    from retinanet_torch.ops.int8_conv import (int8_conv2d_plain,
                                               quantize_activation,
                                               unpack_weights)
    from retinanet_torch.ops.int8_conv_kernel import int8_design, launch
    rows, max_err = [], 0.0
    for args, out in calls:
        x, packed, scale, bias, s_a, stride, pads, groups, kh, kw, dt = args
        with torch.inference_mode():
            want = int8_conv2d_plain(*args)
        err = (out.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        path = paths_of.get(packed.data_ptr(), "?")
        check(torch.equal(out, want),
              f"{label}: int8 conv {path} differs from its plain version "
              f"by {err}")
        row = {"path": path, "x": list(x.shape), "out": list(out.shape),
               "k": kh, "stride": stride, "groups": groups,
               "design": int8_design(x.shape[3], out.shape[3], kh, kw,
                                     stride, groups)}
        if timed:
            t_ops, t_bytes = int8_call_bound(x, bias, out, kh, kw, stride,
                                             pads, groups)
            row.update(ops_s=t_ops, bytes_s=t_bytes)
            with torch.inference_mode():
                row["ms"] = time_ms(lambda: launch(*args), reps=5)
                row["plain_ms"] = time_ms(
                    lambda: int8_conv2d_plain(*args), reps=1, warmup=0)
                c = x.shape[3]
                qw = unpack_weights(packed, scale.shape[0],
                                    c if groups == 1 else 1, kh, kw, groups)
                xb = F.pad(x.permute(0, 3, 1, 2).to(torch.bfloat16),
                           (pads[2], pads[3], pads[0], pads[1]))
                wb = qw.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                row["cudnn_bf16_ms"] = time_ms(
                    lambda: F.conv2d(xb, wb, None, stride, 0, 1, groups),
                    reps=5)
                row["int_mm_ms"] = None
                if kh == kw == 1 and groups == 1:
                    qx = quantize_activation(
                        x[:, ::stride, ::stride], s_a).reshape(-1, c)
                    qt = qw.reshape(qw.shape[0], c).t()  # (C, O), col-major
                    try:
                        row["int_mm_ms"] = time_ms(
                            lambda: torch._int_mm(qx, qt), reps=5)
                    except RuntimeError as e:
                        print(f"[int8] torch._int_mm refused {path}: {e}")
        rows.append(row)
    return rows, max_err


def print_int8_shapes(label: str, rows: list) -> list:
    """One line a distinct conv shape of `rows` (timed): its design, calls,
    and a call's kernel, bound, plain, cuDNN bf16 and `torch._int_mm`
    device ms (means over its calls). Returns the lines as records."""
    shapes = {}
    for r in rows:
        key = (r["design"], tuple(r["x"]), tuple(r["out"]), r["k"],
               r["stride"], r["groups"])
        shapes.setdefault(key, []).append(r)
    table = []
    for (design, x, out, k, stride, groups), group in sorted(
            shapes.items(), key=lambda kv: -sum(r["ms"] for r in kv[1])):
        def mean(name):
            vals = [r[name] for r in group if r[name] is not None]
            return sum(vals) / len(vals) if vals else None
        bound = max(mean("ops_s"), mean("bytes_s")) * 1e3
        rec = {"design": design, "x": list(x), "out": list(out), "k": k,
               "stride": stride, "groups": groups, "calls": len(group),
               "ms": mean("ms"), "bound_ms": bound,
               "plain_ms": mean("plain_ms"),
               "cudnn_bf16_ms": mean("cudnn_bf16_ms"),
               "int_mm_ms": mean("int_mm_ms")}
        table.append(rec)
        print(f"[int8] {label} {design:9s} {k}x{k}/{stride}"
              f"{' dw' if groups > 1 else ''} x {list(x)} -> {list(out)} "
              f"x{len(group)}: kernel {rec['ms']:.4f} ms, bound "
              f"{bound:.5f}, plain {rec['plain_ms']:.3f}, cuDNN bf16 "
              f"{rec['cudnn_bf16_ms']:.4f}"
              + ("" if rec["int_mm_ms"] is None else
                 f", torch._int_mm {rec['int_mm_ms']:.4f}"))
    for design in sorted({r["design"] for r in rows}):
        mine = [r for r in rows if r["design"] == design]
        print(f"[int8] {label} {design}: {len(mine)} calls, kernel "
              f"{sum(r['ms'] for r in mine):.3f} ms, cuDNN bf16 "
              f"{sum(r['cudnn_bf16_ms'] for r in mine):.3f} ms, bound "
              f"{sum(max(r['ops_s'], r['bytes_s']) for r in mine) * 1e3:.4f}"
              " ms")
    return table


def request_device_ms(serve, images, count: int = 3) -> tuple:
    """(device busy ms, ms of the int8 conv's kernels, those ms by kernel
    name) of one request, from a profiler trace over `count` requests
    after one that is not."""
    from torch.profiler import ProfilerActivity, profile
    from retinanet_torch.profile_serving import _NOT_KERNELS
    serve(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            serve(images)
        torch.cuda.synchronize()
    busy, by_name = 0.0, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us <= 0 or evt.key.startswith(_NOT_KERNELS):
            continue
        busy += dev_us
        if any(n in evt.key for n in INT8_KERNEL_NAMES):
            # the kernel's name and template arguments, without the
            # namespace and the parameter list
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            by_name[name] = by_name.get(name, 0.0) + dev_us / 1e3 / count
    return busy / 1e3 / count, sum(by_name.values()), by_name


def int8_weights_paths(int8_model) -> dict:
    """data_ptr of each packed weight tensor -> its conv's path."""
    from retinanet_torch.export.quantize import conv_paths
    paths = conv_paths(int8_model.model)
    return {getattr(int8_model, plan[2]).data_ptr(): paths[conv]
            for conv, plan in int8_model.plans.items()}


def export_config(workdir: Path) -> tuple:
    """The flagship with a model_dir under `workdir`, and a checkpoint at
    step 1 of its seeded weights with the class prior set to 0, so that
    random weights give detections (as in phase 5)."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.train.executor import Executor
    tree = json.loads(FLAGSHIP.read_text())
    tree["experiment"]["model_dir"] = str(workdir / "models")
    path = workdir / "flagship.json"
    path.write_text(json.dumps(tree, indent=2))
    params = Config(str(path)).params
    ex = Executor(params, run_mode="export", device="cuda")
    zero_class_prior(ex.model)
    ex._save_checkpoint(1)
    ex.close()
    return path, params


def served_ms(serve, images, requests: int) -> tuple:
    """Host ms of `requests` requests after one that is not timed
    (median), and the last detections."""
    times = []
    for _ in range(requests + 1):
        start = time.perf_counter()
        det = serve(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times[1:]), det


def as_numpy(det: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in det.items()}


def check_frozen_nms(module, images) -> int:
    """run_exported with the NMS kernel's inputs recorded: one launch, and
    its indices, scores and counts those of `batched_nms` on them."""
    from retinanet_torch.ops import nms_kernel
    from retinanet_torch.ops.nms import batched_nms
    captured = []
    real = nms_kernel.launch_design

    def recording(design, boxes, scores, *rest):
        out = real(design, boxes, scores, *rest)
        captured.append((boxes.clone(), scores.clone(), rest, out))
        return out

    nms_kernel.launch_design = recording
    nms_kernel.kernel.reset_counts()
    try:
        det = module.run_exported(images)
    finally:
        nms_kernel.launch_design = real
    check(len(captured) == 1 == nms_kernel.kernel.launches,
          f"the frozen graph launched NMS {nms_kernel.kernel.launches} "
          "times for one request")
    boxes, scores, rest, got = captured[0]
    want = batched_nms(boxes, scores, *rest)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "NMS inside the frozen graph differs from batched_nms")
    return det


def phase_export_int8(workdir: Path) -> tuple:
    """Phase 12. Returns the int8 kernel's record and the NMS launches on
    the export paths."""
    from retinanet_torch.export.__main__ import main as export_main
    from retinanet_torch.export import msgpack_codec
    from retinanet_torch.export.quantize import (detection_agreement_ap,
                                                 make_quantized_serving_fn)
    from retinanet_torch.export.serving import load_artifact
    from retinanet_torch.ops import int8_conv_kernel, nms_kernel
    from retinanet_torch.ops.int8_conv_kernel import encode_us, int8_design
    workdir.mkdir(parents=True, exist_ok=True)
    int8 = int8_conv_kernel.kernel

    # (a) the CLI, in process, on a checkpoint of seeded weights
    start = time.perf_counter()
    cfg_path, params = export_config(workdir)
    h, w = (int(v) for v in params.input.input_shape)
    art = workdir / "artifact"
    int8.reset_counts()
    nms_kernel.kernel.reset_counts()
    export_main(["--config_path", str(cfg_path), "--export_dir", str(art),
                 "--checkpoint_step", "1", "--int8", "--int8_activations",
                 "--calibration_batches", str(EXPORT_CALIBRATION_BATCHES)])
    export_paths = {"int8_conv2d": {"export CLI": int8.launches},
                    "nms_lanes": {"export CLI": nms_kernel.kernel.launches}}
    files = sorted(os.listdir(art))
    for name in ARTIFACT_FILES:
        check(name in files, f"the export CLI did not write {name}: {files}")
    scales_doc = json.loads((art / "activation_scales.json").read_text())
    check(scales_doc["calibration"]["source"] == "synthetic"
          and scales_doc["calibration"]["used_batches"]
          == EXPORT_CALIBRATION_BATCHES,
          f"calibration provenance {scales_doc['calibration']}")
    report = json.loads((art / "int8_activation_report.json").read_text())
    sizes = {n: (art / n).stat().st_size for n in files}
    print(f"[export] CLI wrote {files} in "
          f"{time.perf_counter() - start:.1f} s; {len(scales_doc['scales'])}"
          f" scales ({scales_doc['mode']}, "
          f"{scales_doc['calibration']['source']}); report {report}; "
          f"bytes {sizes}; int8 launches {int8.launches}")

    # (b) the float lane: the frozen graph against the rebuilt function,
    # NMS inside the graph index-exact
    rng = np.random.default_rng(0)
    batches = {bs: rng.integers(0, 256, (bs, h, w, 3)).astype(np.float32)
               for bs in INT8_BATCHES}
    frozen_bs = int(params.inference.batch_size)
    module = load_artifact(str(art), use_exported=True, device="cuda")
    one = batches[frozen_bs]
    eager = module.run_inference(one)
    frozen = check_frozen_nms(module, one)
    check(all(np.array_equal(eager[k], frozen[k]) for k in eager),
          "run_exported differs from run_inference (float lane)")
    check(int(eager["valid_detections"].sum()) > 0, "no detection")
    print(f"[export] float lane: run_exported equals run_inference at the "
          f"frozen batch {frozen_bs} ({eager['valid_detections'].tolist()} "
          "detections); NMS inside the graph index-exact")

    # (c) the int8 lane: frozen graph, then the main path at batch 1 and 8
    q_module = load_artifact(str(art), use_exported=True,
                             use_int8_activations=True, device="cuda")
    q_eager = q_module.run_inference(one)
    q_frozen = q_module.run_exported(one)
    check(all(np.array_equal(q_eager[k], q_frozen[k]) for k in q_eager),
          "run_exported differs from run_inference (int8 lane)")
    requests = {bs: torch.from_numpy(batches[bs]) for bs in INT8_BATCHES}
    # the main path: the int8 kernel's count at 0 just before, read after
    int8.reset_counts()
    q_ms, q_det = {}, {}
    for bs in INT8_BATCHES:
        q_ms[bs], q_det[bs] = served_ms(q_module.serve, requests[bs],
                                        INT8_REQUESTS)
    launches = int8.launches
    launches_by = dict(int8.launches_by)
    served = len(INT8_BATCHES) * (INT8_REQUESTS + 1)
    int8_model = q_module.module.model
    paths_of = int8_weights_paths(int8_model)
    _, calls = capture_int8_calls(q_module.serve, requests[8])
    check(len(calls) > 0 and launches == served * len(calls),
          f"int8 kernel launched {launches} times for {served} requests of "
          f"{len(calls)} int8 convs")
    # every dense call but the stem on the wgmma design, the stem on
    # mma.sync, and the counts of the main path say so
    stem = INT8_SHAPES[0][1]
    designs = {}
    for args, _ in calls:
        x, packed, scale, _, _, stride, _, groups, kh, kw, _ = args
        path = paths_of.get(packed.data_ptr(), "?")
        design = int8_design(x.shape[3], scale.shape[0], kh, kw, stride,
                             groups)
        want = ("mma_sync" if path == stem else
                "wgmma" if groups == 1 else "depthwise")
        check(design == want, f"int8 conv {path} takes {design}")
        designs[design] = designs.get(design, 0) + 1
    check(designs == {"wgmma": len(calls) - 1, "mma_sync": 1}
          and launches_by == {d: served * n for d, n in designs.items()},
          f"int8 launches by design {launches_by} for {served} requests "
          f"of {designs}")
    print(f"[int8] {int8_model.num_int8_convs} int8 convs, {len(calls)} "
          f"calls a request; {launches} launches in {served} requests, by "
          f"design {launches_by}")

    # float and weight-only lanes at the same batches
    f_ms, f_det, w_ms = {}, {}, {}
    qparams = msgpack_codec.read_file(str(art / "params_int8.msgpack"))
    stats = msgpack_codec.read_file(str(art / "params.msgpack"))
    weight_only = make_quantized_serving_fn(
        params, qparams, stats["batch_stats"], device="cuda")
    for bs in INT8_BATCHES:
        f_ms[bs], f_det[bs] = served_ms(module.serve, requests[bs],
                                        INT8_REQUESTS)
        w_ms[bs], _ = served_ms(weight_only, requests[bs], INT8_REQUESTS)
    agreement = detection_agreement_ap(
        as_numpy(f_det[8]), as_numpy(q_det[8]), (h, w),
        float(params.inference.score_threshold))
    for bs in INT8_BATCHES:
        print(f"[int8] batch {bs} request ms (host clock, median of "
              f"{INT8_REQUESTS}): float {f_ms[bs]:.3f}, weight-only "
              f"{w_ms[bs]:.3f}, int8 activations {q_ms[bs]:.3f}")
    print(f"[int8] detection_agreement_ap (int8 against float, batch 8): "
          f"{agreement:.4f}")

    # every int8 conv of one batch-8 request against the plain version,
    # timed beside its bounds and the library calls
    rows, max_err = hold_int8_calls(calls, paths_of, "flagship", timed=True)
    table = print_int8_shapes("flagship", rows)
    busy = {}
    for lane, serve in (("int8", q_module.serve), ("float", module.serve)):
        for bs in INT8_BATCHES:
            busy[f"{lane} batch {bs}"] = request_device_ms(serve,
                                                           requests[bs])
    for key, (ms, int8_ms, by_name) in busy.items():
        print(f"[int8] {key} request, profiler: device busy {ms:.3f} ms, "
              f"of which the int8 conv's kernels {int8_ms:.3f} ms: "
              + ", ".join(f"{n} {v:.3f}" for n, v in sorted(
                  by_name.items(), key=lambda kv: -kv[1])))
    head_args = next(a for a, _ in calls
                     if paths_of.get(a[1].data_ptr()) == INT8_SHAPES[3][1])
    x, packed, scale, _, _, stride, pads, _, kh, kw, dt = head_args
    encode = encode_us(x, packed, scale.shape[0], stride, pads, kh, kw, dt)
    print(f"[int8] encoding the three tensor maps of a wgmma call: "
          f"{encode:.3f} host us (mean of 1000, the head 3x3 at P3)")
    shapes = []
    for label, path in INT8_SHAPES:
        row = next(r for r in rows if r["path"] == path)
        bound = max(row["ops_s"], row["bytes_s"]) * 1e3
        shapes.append({"shape": label, **row, "bound_ms": bound,
                       "bound_by": ("operations" if row["ops_s"]
                                    >= row["bytes_s"] else "bytes")})
        print(f"[int8] {label} {path} x {row['x']} -> {row['out']}: kernel "
              f"{row['ms']:.4f} ms, bound {bound:.5f} ms, plain "
              f"{row['plain_ms']:.3f}, cuDNN bf16 {row['cudnn_bf16_ms']:.4f}"
              + ("" if row["int_mm_ms"] is None else
                 f", torch._int_mm {row['int_mm_ms']:.4f}"))
    t_ops = sum(r["ops_s"] for r in rows)
    t_bytes = sum(r["bytes_s"] for r in rows)
    record = {
        "name": "int8_conv2d", "route": "cuda",
        "source": "retinanet_torch/csrc/int8_conv.cu",
        "replaces": "retinanet_tpu/export/quantize.py:100",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["cudnn_bf16_ms"] for r in rows),
        "library": "cuDNN bf16 F.conv2d at every call's shape",
        "work": f"every int8 conv of one batch-8 flagship request "
                f"({len(rows)} calls)",
        "launches_by": launches_by,
        "shapes": shapes,
        "shape_table": table,
        "request_ms": {"float": f_ms, "weight_only": w_ms, "int8": q_ms},
        "request_device_ms": {k: {"busy": v[0], "int8_conv": v[1],
                                  "int8_by_kernel": v[2]}
                              for k, v in busy.items()},
        "encode_us": encode,
        "detection_agreement_ap": agreement,
    }
    print(f"[int8] {len(rows)} calls of a batch-8 request bit-equal to the "
          f"plain version; kernel {record['ms']:.3f} ms in all, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}), cuDNN bf16 "
          f"{record['library_ms']:.3f}, plain {record['plain_ms']:.1f}")

    # (d) evaluate_artifact on the goldens' JPEGs through the int8 graph
    record["launches_on_export_paths"] = dict(export_paths["int8_conv2d"])
    int8.reset_counts()
    nms_kernel.kernel.reset_counts()
    scores = evaluate_goldens(art, workdir / "eval")
    record["launches_on_export_paths"]["evaluate_artifact"] = int8.launches
    export_paths["nms_lanes"]["evaluate_artifact"] = \
        nms_kernel.kernel.launches

    # (e) a depthwise model through the int8 lane
    del module, q_module
    torch.cuda.empty_cache()
    record["depthwise_model"] = int8_depthwise_model()
    record["max_abs_err"] = max(max_err,
                                record["depthwise_model"]["max_abs_err"])
    record["coco_on_goldens"] = scores
    return record, export_paths["nms_lanes"]


def evaluate_goldens(art: Path, workdir: Path) -> dict:
    from retinanet_torch.export.evaluate_artifact import evaluate
    images_dir = workdir / "images"
    images_dir.mkdir(parents=True, exist_ok=True)
    goldens = np.load(JPEG_GOLDENS)
    images, anns = [], []
    for i in range(len([k for k in goldens.files if k.startswith("jpeg")])):
        (images_dir / f"{i}.jpg").write_bytes(goldens[f"jpeg{i}"].tobytes())
        h, w = goldens[f"pixels{i}"].shape[:2]
        images.append({"id": i + 1, "file_name": f"{i}.jpg", "height": h,
                       "width": w})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1 + i,
                     "bbox": [w / 4, h / 4, w / 2, h / 2],
                     "area": w * h / 4, "iscrowd": 0})
    ann = workdir / "annotations.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": j, "name": f"class{j:02d}"}
                       for j in range(1, 81)]}))
    start = time.perf_counter()
    scores = evaluate(str(art), str(images_dir), str(ann), use_exported=True,
                      use_int8_activations=True, device="cuda")
    for key in COCO_KEYS:
        check(-1.0 <= scores[key] <= 1.0, f"evaluate_artifact {key} is "
              f"{scores[key]}")
    check((art / "predictions.json").exists(), "no predictions.json")
    print(f"[export] evaluate_artifact (frozen int8 graph) on "
          f"{len(images)} golden JPEGs in "
          f"{time.perf_counter() - start:.1f} s: {scores}")
    return scores


def int8_depthwise_model() -> dict:
    """A depthwise model on int8 activations: calibrated on synthetic
    scenes, one batch-8 request with every int8 conv (dense and depthwise)
    held to the plain version."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.preprocessing import make_device_normalizer
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.export.calibration import calibrate_activations
    from retinanet_torch.export.quantize import detection_agreement_ap
    from retinanet_torch.export.serving import (build_serving_fn,
                                                build_serving_module)
    from retinanet_torch.models.retinanet import _compute_dtype, build_model
    from retinanet_torch.ops import int8_conv_kernel
    from retinanet_torch.profile_serving import zero_class_prior
    label, path = INT8_DEPTHWISE
    params = Config(str(path)).params
    h, w = (int(v) for v in params.input.input_shape)
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    normalizer = make_device_normalizer(params)
    dtype = _compute_dtype(params.floatx.precision)
    batches = [synthetic_train_batch(2, (h, w), 20, 80, seed=i)["image"]
               for i in range(2)]
    scales = calibrate_activations(
        model, batches, mode="minmax",
        preprocess=lambda im: normalizer(im).to(dtype))
    module = build_serving_module(params, device="cuda", model=model,
                                  int8_scales=scales)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, h, w, 3)).astype(np.uint8))

    @torch.inference_mode()
    def serve(x):
        return module(x.cuda())

    kernel = int8_conv_kernel.kernel
    kernel.reset_counts()
    q_det, calls = capture_int8_calls(serve, images)
    by = dict(kernel.launches_by)
    check(set(by) == {"wgmma", "mma_sync", "depthwise"},
          f"{label}: int8 launches by design {by}")
    rows, max_err = hold_int8_calls(calls, int8_weights_paths(module.model),
                                    label, timed=True)
    table = print_int8_shapes(label, rows)
    f_det = build_serving_fn(params, device="cuda", model=model)(images)
    agreement = detection_agreement_ap(
        as_numpy(f_det), as_numpy(q_det), (h, w),
        float(params.inference.score_threshold))
    print(f"[int8] {label}: {len(calls)} int8 conv calls in a batch-8 "
          f"request ({by}), all bit-equal to the plain version; "
          f"detection_agreement_ap {agreement:.4f}")
    return {"config": str(path.relative_to(REPO)), "calls": len(calls),
            "launches_by": by, "detection_agreement_ap": agreement,
            "max_abs_err": max_err, "ms": sum(r["ms"] for r in rows),
            "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in rows),
            "shape_table": table}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from retinanet_torch.core.config import Config
    from retinanet_torch.ops import int8_conv_kernel, match_kernel, nms_kernel

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    kernels = (nms_kernel.kernel, match_kernel.kernel,
               int8_conv_kernel.kernel)
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
    serve_record = phase_serving(params, worst)
    train_record, step_images_per_s = phase_training(params, match_err)
    records = [serve_record, train_record, phase_channel_stats()]
    # the executor's phases run as a user's run would: cuDNN's default TF32
    torch.backends.cudnn.allow_tf32 = True
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for sub, phase in (
                ("executor",
                 lambda d: phase_executor(d, step_images_per_s)),
                ("overfit", phase_overfit)):
            start = time.perf_counter()
            for kernel_name, counts in phase(Path(tmp) / sub).items():
                paths.setdefault(kernel_name, {}).update(counts)
            print(f"[{sub}] phase took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        archs, zoo_launches = phase_zoo(Path(tmp) / "zoo")
        print(f"[zoo] phase took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        p11_launches, own_batches, high_res = phase_parallel_and_own_batches(
            Path(tmp) / "phase11")
        print(f"[phase 11] took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        int8_record, export_nms = phase_export_int8(Path(tmp) / "export")
        records.append(int8_record)
        print(f"[phase 12] took {time.perf_counter() - start:.1f} s")
    for record in records:
        record["launches_on_executor_paths"] = paths.get(record["name"], {})
        record["profiler_retries"] = PROFILER_RETRIES.get(record["name"], 0)
    key = {"nms_lanes": "nms", "match_lanes": "match"}
    for record in records:
        if record["name"] in key:
            record["launches_on_zoo_paths"] = zoo_launches[record["name"]]
            record["zoo_shapes"] = [
                {"config": a["config"], **a[key[record["name"]]]}
                for a in archs]
            record["launches_on_phase11_paths"] = p11_launches[record["name"]]
            record["high_res_shape"] = {"config": str(HIGH_RES.relative_to(
                REPO)), **high_res[record["name"]]}
    records[0]["launches_on_export_paths"] = export_nms
    print(json.dumps({"zoo": [{k: a[k] for k in (
        "name", "config", "input", "batch", "parameters", "request_ms",
        "step_ms", "images_per_s", "peak_gb")} for a in archs]}))
    print(json.dumps({"own_batches": own_batches}))
    print(json.dumps({"kernels": records}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
