#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one CUDA card.

    python3 chip_smoke.py

Runs on the card only (exits non-zero without one) and imports nothing of
JAX. Phases, each fatal on failure:
  1. card: name, power limit; TF32 off for the float32 comparisons;
  2. build: every kernel of retinanet_torch/csrc/ with nvcc, one compiler
     per source, all started together;
  3. the six NMS kernels against the plain PyTorch version on the card:
     hard mode through the sweep kernel (the flagship shape, sorted and
     unsorted input, tied and all-equal scores, duplicated boxes, IoUs
     exactly at the threshold, k = 300 and 1000, more slots than
     survivors, a trained-like load) and past 1,024 candidates through the
     scan kernel (k = 1025, 2048, 5000, 8192, and soft mode there through
     the compact kernel, both bit-equal to the round kernel), soft mode
     through the decay kernel
     (sigma 0.25 on the flagship's seeded lanes at L = 640, 80, 8 and 1 and
     a trained-like copy, each timed in turns with the round kernel beside
     plain and its bound; sigma 0 at k = 1000); the lanes the round
     kernel alone took before, now on no path: soft past 8,192 candidates
     through the cluster kernel (k = 8,193, 16,384 and 76,725 at L = 1, 8
     and 80, sigma 0 at L = 8; 100,000 at L = 1, its scores spilled past
     the 81,920 the CTAs hold), soft under a negative threshold (-0.5, and
     -inf with sigma 0; k = 256, 5,000, 8,192, 16,384) through the cluster
     kernel, hard under -1e10 (-inf and -3e10; k = 77 with max_det 100,
     256, 5,000, 8,192, 16,384; every box twice, scores of -1e10 and
     below) through the scan and its tail, each timed beside plain, the
     round kernel where it takes the lane, and its bound; indices and valid
     counts equal, the sweep's and the scan's scores exactly equal, the
     soft designs' to rtol 1e-5 / atol 1e-6 (the card's exp against
     torch's), and every design but the sweep bit-equal to the round
     kernel wherever that takes the lane (k <= 8,192);
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
     launched on the "wgmma" design, the stem on "stem"
     (`ops/int8_conv_kernel.py:int8_design`); every int8 conv call of one
     batch-8 request bit-equal to `ops/int8_conv.py` and timed beside its
     bounds, cuDNN bf16 at its shape and `torch._int_mm` for a 1x1 conv
     (the stem also on "mma_sync" and "narrow" by their routes,
     `tools/int8_conv_experiments.py:STEM_ROUTES`), printed a shape a line
     with its design; float, weight-only and int8 request ms; the device
     busy ms of a request and the int8 conv's kernels in it by name
     (profiler; at batch 8 also with the stem routed to mma_sync), the stem
     kernel at most once a request and no `quantize_words_kernel`; the host
     us that encoding a wgmma call's three tensor maps takes;
     detection_agreement_ap of int8 against float; (d)
     `evaluate_artifact` through the frozen int8 graph on the JPEGs of
     tests/goldens/jpeg_decode_goldens.npz; (e) EfficientNet-lite2 512 and
     (f) MobileDet-cpu 448, each calibrated on synthetic scenes, one
     batch-8 request with its launches by design checked ({stem: 1,
     narrow: 1, wgmma: 69, depthwise: 50} and {1, 6, 93, 43}), every int8
     conv call bit-equal to the plain version and timed (depthwise beside
     cuDNN's bf16 depthwise, a narrow call beside the mma_sync design at
     its shape, the stem beside mma_sync and narrow; each design's total
     beside its bound), the share of depthwise inputs left to the
     division, the request's device busy and, in its trace, the narrow and
     stem kernels at most once a call of their design, no
     `quantize_words_kernel`, and `quantize_bytes_kernel` at most once a
     wgmma call (launches by kernel name), and the "depthwise_generic"
     design bit-equal at the first depthwise call through an input off
     16-byte alignment, timed beside its bound, cuDNN bf16 and the
     "depthwise" design on the same call aligned; (g) every distinct
     narrow shape (dense, 4 <= C <= 16) of MobileDet-edge_tpu,
     MobileDet-gpu, EfficientNet-B2 and B3 at batch 8, from their configs
     on `device="meta"`, on seeded inputs and weights: bit-equal to the
     plain version, timed beside the mma_sync design at the same shape
     (`tools/int8_conv_experiments.py:routed`), cuDNN bf16 and the bound;
     (h) seeded "depthwise_generic" calls at batch 8 of the branches no
     config reaches (C % 8 != 0, 7x7/1, stride 3: `GENERIC_CALLS`), each
     bit-equal to the plain version, timed beside its bound, the plain
     version and cuDNN bf16;
 13. the host data path: (a) a COCO download folder written here
     (`annotations/instances_{train,val}2017.json`, scenes encoded by the
     port's JPEG route under COCO's 80 category ids, crowd boxes, an image
     without a box, a train scene of 600 boxes, one file that is no JPEG)
     through `python -m retinanet_torch.tools.create_coco_tfrecords
     --remap_class_ids` as a subprocess: the one corrupt file skipped,
     every record of every shard read and parsed by the C++ reader equal
     to the Python codec (a record of more than 512 boxes among them), the
     records/s of both on one thread; then a flagship train_val on those
     shards in process (8 steps, one COCO evaluation of the val shards):
     the matching kernel once a step and the NMS sweep kernel once a val
     batch; (b) the COCO matcher on 500 seeded synthetic val images (80
     categories, ~7 gts and 100 detections an image): the C++ matcher's
     arrays equal the numpy matcher's and so do the summaries, both timed;
     the C++ matcher alone at 5,000 images; (c) an Executor fine-tuning the
     flagship from phase 12's artifact directory
     (`fine_tuning.pretrained_checkpoint`, which reads
     `<dir>/params.msgpack`): every tensor equal to the artifact's, all
     matched, none skipped;
 14. the run's observability and its optimizers: (a) a flagship
     train_val through the CLI in process (OBS_CHANGES: 50 steps at batch
     8, one COCO evaluation) with `experiment.tensorboard_dir` and
     `--enable_weights_info`: the event file, decoded by
     `train/event_file.py`, holds every JSONL scalar at float32 and no
     other, and one histogram a weight under its Flax path at step 50,
     its counts summing to the weight's size; the matching kernel once a
     step, the NMS sweep once a val batch; one `_write_weights_info`
     call's ms beside the step's; (b) `get_flops(1)` and `get_flops(8)`
     of the flagship (190,290,790,400 at batch 1) and of each zoo
     architecture equal to a count through the conv hook
     (`models/layers.py:conv_hook`), and the achieved TFLOP/s of the
     flagship's batch-8 float request and forward (device busy ms) against
     the dense bf16 peak; (c) `dump_forward_hlo()` of the flagship: one
     `aten.convolution` node a conv call of the forward; (d) each of the
     23 registry optimizers (`optimizers/registry.py`) for 3 flagship
     steps at batch 8 through `build_trainer`: losses finite, the last
     update equal to the same optimizer's float64 step on the host from
     the same state and gradients within `obs_optimizers`' bound;
 15. spatial partitioning (`parallel/spatial.py`): (a) two ranks on card
     0 over gloo on a (1, 2) grid, each the flagship's whole global batch
     of 8 and a band of its rows, 2 steps in float32 (TF32 off) and in
     mixed bfloat16: the ranks' losses and parameters bit-equal, and held
     to one process at batch 8 by phase 11 (a)'s rule (the stated bound
     plus DP_ORDER_FACTOR x the one process's move under two reorderings
     of its batch); the matching kernel once a step a rank; the exchange
     all-reduces, rows and MB a step, and their ms timed alone in a
     float32 step; then an evaluation batch of 8 through the band forward
     (`models/retinanet.py:BandedRetinaNet`, the class prior at 0): the
     head outputs gathered over the group within SPATIAL_EVAL_RTOL of one
     process's, the NMS kernel once a rank, each image's detections in
     the chief's gather once, their counts equal to one process's;
     (b) `v3-32/…-1280x1280-3x-256` at a micro-batch of
     SPATIAL_HIGH_RES_BATCH on the same grid, one step after one: each
     rank's peak beside one process's, the step's ms and the exchanges'
     ms, the losses within one bfloat16 rounding of one process's;
 16. the selection lanes on the top-k kernel (`csrc/topk.cu`,
     `ops/topk_kernel.py`): both designs, "row" and "slab", index- and
     value-exact against the plain version
     (`ops/topk.py:top_k_rows_plain`) on the card, on the flagship's
     batch-8 fused logits (phase 5's seeded model, class bias 0, so that
     the bf16 logits tie heavily) in the default lane ("packed", drop 1,
     k = 256), the exact lane ("f32", k = 256), the skip_nms lane ("f32",
     k = 5,000) and the global lane ((B, A·C) rows, "bf16" and "f32"); on
     the zoo's anchor counts at batch 8 (37,485 and 49,104: drop 0;
     110,484: drop 1; 150,381 and 306,900: "bf16"); at k = 8,192 (the
     on-chip sort's last) and past it on the radix sort (k = 8,193,
     16,384, 16,385, 24,576, 32,768, 49,152 and 76,725 = every anchor, in
     "packed", "bf16" and "f32", both designs, and the global lane at
     batch 8 and 1, k = 16,385 and 76,725; each radix case beside the
     bitonic network it replaced, `torch.topk`, the select launch alone
     and the sort's own floor, in turns) and rows of one value at k =
     16,384 and 50,000; on rows of one value
     and on the top-k over the NMS survivors: seeded rows, the real
     survivors of a zero-bias request (`_per_class_nms`'s input to
     `top_k`) and trained-like rows (>= 95% -1.0) at batch 8 and 1; each
     case timed under both designs beside its plain version, the stable
     `torch.sort` lane the port ran before (its transpose and float32 copy
     included), `torch.topk` (the same set, no tie order) and its bound
     (one read of the rows), with the slab design's levels and the device
     ms of its phases (its own %globaltimer stamps), the survivors also
     beside the launch floor (the row design's launch of a kernel that
     returns at once, `tools/topk_experiments.py`); then the flagship
     request at batch 1 and 8 in the default and the exact lane as the
     main path (host ms, device busy ms; the kernel's counts at 0 just
     before, by mode and by design), and in a request's trace
     slab_select_kernel, slab_final_kernel and row_select_kernel once each
     by name, no sort kernel in the default lane; then the radix sort's
     main path: the skip_nms export lane at pre_nms_top_k = every anchor
     (76,725 a class), batch 8 and 1, one radix sort a request (the counts
     at 0 just before), its prepare and scatter kernels by name in a
     request's trace, the outputs equal to the same lane on the plain
     top-k. The kernel's launches on the serving (5), evaluation (8),
     export and int8 (12) and spatial (15) paths are counted there and
     reported here;
 17. the soft modes: the flagship served in PerClassSoftNMS and in
     GlobalSoftNMS (`filter_per_class` false) at batch 8 and 1 on the
     zero-bias weights of phase 5, as the main path: one decay launch a
     request (the counts at 0 just before), the detections through the
     kernel equal to those through the plain NMS, one `nms_decay_kernel`
     and no other NMS kernel in a request's trace, and on the inputs each
     request gave `nms_lanes` (L = 640, 80, 8, 1) the decay kernel
     bit-equal to the round kernel, both timed in turns beside plain and
     the bound (f32 operations of each alive pair, MUFU operations of each
     intersecting one, counted by `ops/nms.py:decay_nms_plain`);
 18. the exact-parity lane, `inference.nms_top_k` 5000 (every config's
     pre_nms_top_k): the flagship served in PerClassHardNMS,
     GlobalHardNMS, PerClassSoftNMS and GlobalSoftNMS at batch 8 and 1 on
     the zero-bias weights of phase 5, as the main path: one launch a
     request of the scan design (hard) or the compact design (soft) and
     none of the round kernel (the counts at 0 just before), the
     detections through the kernel equal to those through the plain NMS,
     one `nms_scan_kernel` or `nms_compact_kernel` and no other NMS kernel
     in a request's trace; on the inputs each request gave `nms_lanes` (L
     = 640, 80, 8, 1; k = 5,000), on a trained-like copy of each (five
     candidates a lane clear the threshold) and on seeded lanes at the
     same L and k, the design bit-equal to the round kernel and
     index-exact to plain, both timed in turns beside plain and the bound
     (hard: the scores, the boxes visited and 20 f32 operations of each
     IoU that decides a candidate, `ops/nms.py:scan_nms_plain`'s count,
     with row 1's 20 a candidate a round beside it; soft: as in 17, from
     `ops/nms.py:compact_nms_plain`);
 19. pre_nms_top_k = nms_top_k = 10,000 (a user who doubles the
     reference's 5,000): the flagship served in the four NMS modes at
     batch 8 and 1 on the zero-bias weights, as the main path: one launch a
     request of the scan (hard) or the cluster design (soft) and none of
     the round kernel, one slab selection of 10,000 a request and its
     radix sort (the counts at 0 just before); the detections through the
     kernels equal to those
     through the plain NMS and to those through the plain top-k and plain
     NMS together; one `nms_scan_kernel` or `nms_cluster_kernel` and no
     other NMS kernel in a request's trace; the design on the batch-8
     inputs timed beside plain and its bound; then the skip_nms lane at
     10,000 a class, equal to the plain top-k's.
Phase 8 also prints where the pipeline's threads spend their time, by
stage (read, parse, decode, preprocess, collate).
The output ends with a JSON line of the zoo's numbers, one JSON object
describing each kernel (launches on its main-path run, on the executor's
paths and on the zoo's, error, times, bound, and the zoo shapes' times;
NMS's soft design at the PerClassSoftNMS batch-8 inputs, its launches on
the soft paths and every soft case of phases 3 and 17; the scan and
compact designs at the exact-parity lane's PerClass batch-8 inputs, their
launches on phase 18's paths and every case of phase 18; the cluster
design at phase 19's PerClassSoftNMS batch-8 inputs, its launches there
and every wide case of phases 3 and 19; the top-k's wide cases; the
int8 conv's per design and model: launches, kernel, bound and cuDNN bf16
ms), the card's line again, and {"ok": true, "device": {...}} as the last
line.
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
# soft NMS: an intersecting pair's two IEEE divisions and exp, one MUFU
# operation each (rcp, rcp, ex2), at 16 a clock on each of 132 SMs at
# 1.98 GHz (CUDA's throughput table for compute capability 9.0)
NMS_MUFU_OPS_PER_DECAY = 3
MUFU_OPS_PER_S = 132 * 16 * 1.98e9
# the soft cases' times, by phase 3 (seeded) and phase 17 (real inputs)
SOFT_NMS_SHAPES = []
# phase 18: the exact-parity lane's cases (real, trained-like, seeded)
LONG_NMS_SHAPES = []
LONG_BATCHES = {8: 2, 1: 2}     # batch size -> requests a mode
LONG_LANES = (640, 80, 8, 1)    # the seeded cases
# the lanes past the round kernel's domain: phase 3's wide cases and phase
# 19's serving cases (the cluster design, the scan's tail), one row each
WIDE_NMS_SHAPES = []
WIDE_SOFT_KS = (8193, 16384, 76725)        # soft lanes past 8,192
WIDE_SOFT_LANES = (1, 8, 80)
WIDE_NEGATIVE_KS = (256, 5000, 8192, 16384)  # soft under a negative thr
WIDE_TAIL_KS = ((77, 100), (256, 100), (5000, 100), (8192, 100),
                (16384, 100))              # hard under -1e10: (k, max_det)
WIDE_NMS_REPS = 10
# phase 16: top-k on the flagship's logits at the on-chip sort's last k
# (8,192), then past it the radix sort's up to every anchor; the global
# lane at batch 8 and 1
WIDE_TOPK_KS = (8192, 8193, 16384, 16385, 24576, 32768, 49152, 76725)
WIDE_TOPK_GLOBAL_KS = (16385, 76725)
WIDE_TOPK_REPS = 3
# phase 16: the radix sort's main path, the skip_nms export lane handing
# every anchor of every class to a downstream NMS
SKIP_NMS_ALL_K = 76725
# phase 3: a soft lane past the 81,920 candidates the cluster's CTAs hold
WIDE_SPILL_K = 100000
# phase 19: the flagship served with pre_nms_top_k = nms_top_k = WIDE_K
WIDE_K = 10000
WIDE_BATCHES = {8: 1, 1: 1}     # batch size -> requests a mode
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
INT8_KERNEL_NAMES = ("int8_conv_", "int8_conv_narrow_kernel",
                     "int8_conv_stem_kernel", "quantize_words_kernel",
                     "quantize_bytes_kernel")
# phase 12 (e), (f): models with depthwise convs, one batch-8 int8 request
# each, and the int8 conv launches it makes by design
INT8_ZOO = (
    ("efficientnet-lite2 512", REPO / "configs" / "v3-32"
     / "mscoco-retinanet-efficientnet-lite2-512x512-30x-256.json",
     {"stem": 1, "narrow": 1, "wgmma": 69, "depthwise": 50}),
    ("mobiledet-cpu 448", REPO / "configs" / "v3-8"
     / "mscoco-retinanet-mobiledet-cpu-448x448-30x-64.json",
     {"stem": 1, "narrow": 6, "wgmma": 93, "depthwise": 43}),
)
# phase 12 (h): "depthwise_generic" calls of the branches no config's
# request reaches, at batch-8 sizes: (label, (N, H, W, C), k, stride),
# "SAME" pads, an aligned bfloat16 input
GENERIC_CALLS = (
    ("C % 8 != 0 (two chunks, the second ragged)", (8, 128, 128, 36), 3,
     1),
    ("7x7/1", (8, 128, 128, 96), 7, 1),
    ("stride 3", (8, 192, 192, 32), 3, 3),
)
# phase 12 (e), (f): requests in the trace that counts the int8 kernels
INT8_PROFILED_REQUESTS = 3
# phase 12 (g): configs whose distinct narrow shapes are held and timed
NARROW_CONFIGS = (
    ("mobiledet-edge_tpu 448", REPO / "configs" / "v3-8"
     / "mscoco-retinanet-mobiledet-edge-tpu-448x448-30x-64.json"),
    ("mobiledet-gpu 512", REPO / "configs" / "v3-8"
     / "mscoco-retinanet-mobiledet-gpu-512x512-30x-64.json"),
    ("efficientnet-b2 768", REPO / "configs" / "v3-8"
     / "mscoco-retinanet-efficientnet-b2-768x768-30x-64.json"),
    ("efficientnet-b3 896", REPO / "configs" / "v3-32"
     / "mscoco-retinanet-efficientnet-b3-896x896-30x-256.json"),
)
# phase 13: the host data path. A COCO-layout folder (COCO's 80 category
# ids, scenes of 240-640 px), its shards written by the dataset tool, a
# short flagship train_val on them, the COCO matcher at val2017's scale
HOST_TRAIN_IMAGES, HOST_VAL_IMAGES = 56, 24
HOST_CROWDED_BOXES = 600        # one train scene: more than 512 boxes
HOST_TRAIN_SHARDS = 4
HOST_CHANGES = (
    (("training", "train_steps"), 8),
    (("training", "save_every"), 8),
    (("training", "validation_freq"), 8),
    (("training", "validation_samples"), 16),
    (("training", "steps_per_execution"), 4),
    (("training", "batch_size", "train"), 8),
)
COCO_IDS = tuple(i for i in range(1, 91) if i not in (
    12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
EVAL_IMAGES = 500               # the matcher, native and numpy
EVAL_IMAGES_NATIVE = 5000       # val2017's image count, native only
EVAL_GTS, EVAL_DETECTIONS = 7, 100   # an image
COCO_KEYS = ("AP-IoU=0.50:0.95", "AP-IoU=0.50", "AP-IoU=0.75",
             "AR-(all)-IoU=0.50:0.95", "AR-(L)-IoU=0.50:0.95")
# phase 14: the run's observability and its optimizers; (a) the flagship
# with only these changed (besides the paths): 50 steps reach the one
# weights-info write (every 50 outer steps), then one evaluation
OBS_CHANGES = (
    (("training", "train_steps"), 50),
    (("training", "save_every"), 50),
    (("training", "validation_freq"), -1),
    (("training", "validation_samples"), 16),
    (("training", "steps_per_execution"), 1),
    (("training", "log_every"), 10),
    (("training", "batch_size", "train"), 8),
)
OBS_BATCH = 8
FLAGSHIP_FLOPS_1 = 190_290_790_400   # 2 x multiply-adds at 640x640, batch 1
BF16_PEAK_TFLOPS = 989.0             # H100 SXM data sheet, dense
OBS_OPT_STEPS = 3
OPT_UPDATE_TOL = 1e-3
OPT_OFF_SHARE = 1e-6
OPT_L2_TOL = 1e-3


# phase 15: spatial partitioning, each image's rows in bands over SPATIAL
# ranks on card 0 (a (1, SPATIAL) grid)
SPATIAL = 2
SPATIAL_BATCH = 8               # global; the whole batch on every rank
SPATIAL_EVAL_BATCH = 8
# the gathered head outputs of a band forward against one process's, in
# float32 with TF32 off: the bands' convs take other cuDNN algorithms
SPATIAL_EVAL_RTOL = 1e-3
SPATIAL_HIGH_RES_BATCH = 16     # HIGH_RES's micro-batch: 256 / HIGH_RES_ACCUM
TOPK_BATCH = 8
TOPK_ZOO_ANCHORS = (            # anchors, where a config has them
    (37485, "MobileDet 448"), (49104, "512 (lite2, lite3, MobileDet-gpu)"),
    (110484, "EfficientNet-B2 768"), (150381, "EfficientNet-B3 896"),
    (306900, "1280x1280"))
TOPK_REQUESTS = 5               # timed, after one that is not
TOPK_PRIOR = -4.59511985        # -log(99), the class head's prior
# kernel names of a sort or a library top-k in a trace
TOPK_SORT_NAMES = ("sort", "Sort", "radix", "Radix", "gatherTopK", "sbtopk",
                   "mbtopk", "bitonic")
# the kernel's launches on the other phases' paths, by path
TOPK_PATHS = {}
# the top-k kernels' names in a trace: the slab design's two, row's one
TOPK_KERNEL_NAMES = ("slab_select_kernel", "slab_final_kernel",
                     "row_select_kernel")
# the row design's timed runs a measurement (a launch is ~0.01 ms)
TOPK_ROW_REPS = 200


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


def nms_bound_ms(boxes, md, valid, work=None) -> tuple:
    """Least time for this call: each input read once and each output
    written once, against the operations these inputs need. Hard mode:
    every score and box, and the f32 operations of every candidate in each
    round (a lane runs its selecting rounds plus the one that finds it
    frozen). Soft mode, from `work` (`ops/nms.py:decay_nms_plain`'s counts):
    every score but only the boxes of the candidates above the threshold
    (no other box is ever read), and the f32 operations of each (alive
    candidate, round) pair and, on the MUFU, the divisions and the exp of
    each pair that intersects."""
    lanes_, k = boxes.shape[0], boxes.shape[1]
    nbytes = lanes_ * md * 8 + lanes_ * 4
    nbytes += lanes_ * k * 20 if work is None else (lanes_ * k * 4
                                                    + work["staged"] * 16)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if work is None:
        rounds = torch.clamp(valid.long() + 1, max=md).sum().item()
        t_ops = NMS_OPS_PER_CANDIDATE_ROUND * k * rounds / F32_FLOP_PER_S * 1e3
    else:
        t_ops = max(
            NMS_OPS_PER_CANDIDATE_ROUND * work["alive"] / F32_FLOP_PER_S,
            NMS_MUFU_OPS_PER_DECAY * work["decayed"] / MUFU_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_nms(args, kw, design):
    """`nms_lanes` against plain on the same card tensors; it must launch
    `design`, and every design but the sweep must equal the round kernel
    bit for bit where that takes the lane (k <= 8,192). Returns max |score
    err| and the valid counts."""
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import (MAX_CANDIDATES, kernel,
                                                launch_design, nms_lanes)
    before = kernel.launches_by[design]
    idx, sc, valid = nms_lanes(*args, **kw)
    check(kernel.launches_by[design] == before + 1,
          f"nms_lanes did not launch the {design} kernel")
    w_idx, w_sc, w_valid = batched_nms(*args, **kw)
    if design != "sweep" and args[1].shape[1] <= MAX_CANDIDATES:
        rounds = launch_design("rounds", *args, kw["iou_threshold"],
                               kw["score_threshold"],
                               kw.get("soft_nms_sigma", 0.0),
                               kw.get("soft", False))
        check(all(torch.equal(g, r) for g, r in zip((idx, sc, valid),
                                                    rounds)),
              f"the {design} design differs from the round kernel")
    torch.cuda.synchronize()
    check(torch.equal(valid, w_valid), "valid counts differ")
    check(torch.equal(idx, w_idx), "indices differ")
    if design in ("sweep", "scan"):
        check(torch.equal(sc, w_sc), f"{design} scores differ")
    else:
        check(torch.allclose(sc, w_sc, rtol=1e-5, atol=1e-6),
              "scores differ")
    return (sc - w_sc).abs().max().item(), valid


def time_nms(args, kw, reps: int = 50) -> dict:
    """Device ms of the design `nms_design` picks, of the round kernel on
    the same tensors where it takes the lane (k <= 8,192; else its ms is
    None), in turns, and of plain."""
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import (MAX_CANDIDATES,
                                                launch_design, nms_design)
    boxes, scores, md = args
    soft = kw.get("soft", False)
    design = nms_design(soft, scores.shape[1], kw["score_threshold"])
    rest = (md, kw["iou_threshold"], kw["score_threshold"],
            kw.get("soft_nms_sigma", 0.0), soft)
    want = batched_nms(*args, **kw)
    yardstick = scores.shape[1] <= MAX_CANDIDATES
    designs = (design, "rounds") if yardstick else (design,)
    got = {d: launch_design(d, boxes, scores, *rest) for d in designs}
    ref = got.get("rounds", got[design])
    for d, out in got.items():
        if soft:
            check(all(torch.equal(g, r) for g, r in zip(out, ref))
                  and torch.equal(out[0], want[0])
                  and torch.equal(out[2], want[2]),
                  f"{d} kernel differs from the round kernel or plain")
        else:
            check(all(torch.equal(g, w) for g, w in zip(out, want)),
                  f"{d} kernel differs from plain")
    times = {d: [] for d in designs}
    for d in (design, "rounds", "rounds", design):
        if d in times:
            times[d].append(time_ms(
                lambda: launch_design(d, boxes, scores, *rest), reps=reps))
    out = {d: statistics.mean(t) for d, t in times.items()}
    out.setdefault("rounds", None)
    out["plain"] = time_ms(lambda: batched_nms(*args, **kw), reps=5)
    return out


def soft_nms_shape(label: str, args, kw, valid) -> dict:
    """Phase 3's and 17's soft cases: the decay design and the round kernel
    timed in turns on the same tensors, plain, the bound from this run's
    work, as a row of SOFT_NMS_SHAPES."""
    from retinanet_torch.ops.nms import decay_nms_plain
    boxes, scores, md = args
    ms = time_nms(args, kw)
    work = {}
    decay_nms_plain(boxes, scores, md, kw["iou_threshold"],
                    kw["score_threshold"], kw["soft_nms_sigma"], work=work)
    bound, by = nms_bound_ms(boxes, md, valid, work)
    row = {"case": label, "lanes": boxes.shape[0], "k": boxes.shape[1],
           "max_det": md, "valid": int(valid.sum().item()),
           "decay_ms": ms["decay"], "rounds_ms": ms["rounds"],
           "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": by,
           "alive_pairs": work["alive"], "decayed_pairs": work["decayed"]}
    SOFT_NMS_SHAPES.append(row)
    print(f"[kernel] {label} (L={row['lanes']}, k={row['k']}, valid "
          f"{row['valid']}): decay {ms['decay']:.4f} ms, round kernel "
          f"{ms['rounds']:.4f} ms, plain {ms['plain']:.4f} ms, bound "
          f"{bound:.5f} ms ({by}; {work['alive']} alive pairs, "
          f"{work['decayed']} decayed)")
    return row


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
    yield "flagship soft sigma=0.25", boxes, scores, 100, soft, "decay"
    for n in (80, 8, 1):   # PerClassSoftNMS at batch 1; GlobalSoftNMS
        yield (f"soft sigma=0.25 L={n}", boxes[:n], scores[:n], 100, soft,
               "decay")
    yield ("soft sigma=0.25, trained-like (few clear 0.05)", boxes,
           scores * 0.052, 100, soft, "decay")
    yield ("soft, threshold -inf", boxes[:64], scores[:64] - 0.5, 100,
           dict(soft, score_threshold=float("-inf")), "cluster")
    yield ("hard, threshold -inf", boxes[:64], scores[:64], 100,
           dict(iou_threshold=0.5, score_threshold=float("-inf")), "scan")
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
    yield "k=5000 L=2", *lanes(rng, 2, 5000), 100, hard, "scan"
    for n, k in ((4, 1025), (4, 2048), (2, 8192)):
        yield f"k={k} L={n}", *lanes(rng, n, k), 100, hard, "scan"
        yield (f"k={k} L={n}, in top-k order", *in_order(*lanes(rng, n, k)),
               100, hard, "scan")
    for n, k in ((4, 1025), (4, 2048), (2, 5000), (2, 8192)):
        yield f"soft sigma=0.25 k={k} L={n}", *lanes(rng, n, k), 100, soft, \
            "compact"
    yield ("soft sigma=0 L=4 k=2048", *lanes(rng, 4, 2048), 100,
           dict(iou_threshold=0.5, score_threshold=0.05, soft=True,
                soft_nms_sigma=0.0), "compact")
    yield ("soft sigma=0 L=16 k=1000", *lanes(rng, 16, 1000), 100,
           dict(iou_threshold=0.5, score_threshold=0.05, soft=True,
                soft_nms_sigma=0.0), "decay")
    yield ("ragged L=3 k=77", *lanes(rng, 3, 77), 10,
           dict(iou_threshold=0.5, score_threshold=0.2), "sweep")
    yield ("all below threshold", *lanes(rng, 2, 64), 5,
           dict(iou_threshold=0.5, score_threshold=1.5), "sweep")
    yield from wide_nms_cases(rng)


def wide_nms_cases(rng):
    """Phase 3's lanes past the round kernel's domain, as `nms_cases`
    yields them, with a label that starts with "wide"; the scan's tail on
    `tools/nms_experiments.py:tail_lanes`."""
    from retinanet_torch.tools.nms_experiments import tail_lanes
    soft = dict(iou_threshold=1.0, score_threshold=0.05, soft_nms_sigma=0.25,
                soft=True)
    for k in WIDE_SOFT_KS:
        boxes, scores = lanes(rng, max(WIDE_SOFT_LANES), k)
        for n in WIDE_SOFT_LANES:
            yield (f"wide soft sigma=0.25 k={k} L={n}", boxes[:n],
                   scores[:n], 100, soft, "cluster")
        yield (f"wide soft sigma=0 k={k} L=8", boxes[:8], scores[:8], 100,
               dict(iou_threshold=0.5, score_threshold=0.05, soft=True,
                    soft_nms_sigma=0.0), "cluster")
        del boxes, scores
    for k in WIDE_NEGATIVE_KS:
        boxes, scores = lanes(rng, 8, k)
        yield (f"wide soft threshold -0.5 k={k} L=8", boxes, scores - 0.6,
               100, dict(soft, score_threshold=-0.5), "cluster")
        yield (f"wide soft sigma=0 threshold -inf k={k} L=8", boxes,
               scores - 0.6, 100, dict(iou_threshold=0.5,
                                       score_threshold=float("-inf"),
                                       soft=True, soft_nms_sigma=0.0),
               "cluster")
    for k, md in WIDE_TAIL_KS:
        boxes, scores = tail_lanes(8, k)
        for thr in (float("-inf"), -3e10):
            yield (f"wide hard threshold {thr:g} k={k} md={md} L=8", boxes,
                   scores, md, dict(iou_threshold=0.5, score_threshold=thr),
                   "scan")
    # past the 81,920 candidates the cluster's CTAs hold: the scores spill
    boxes, scores = lanes(rng, 1, WIDE_SPILL_K)
    yield (f"wide soft sigma=0.25 k={WIDE_SPILL_K} L=1 (scores spilled)",
           boxes, scores, 100, soft, "cluster")


def wide_nms_shape(label: str, args, kw, valid) -> dict:
    """A wide case: its design and the round kernel (where that takes the
    lane) timed in turns on the same tensors, plain, the bound from this
    run's work (the cluster design's from `ops/nms.py:cluster_nms_plain`,
    the scan's from `scan_nms_plain`, its tail's pairs included), as a row
    of WIDE_NMS_SHAPES."""
    from retinanet_torch.ops.nms import cluster_nms_plain, scan_nms_plain
    from retinanet_torch.ops.nms_kernel import (SCAN_WARPS, cluster_plan,
                                                nms_design)
    boxes, scores, md = args
    soft = kw.get("soft", False)
    design = nms_design(soft, scores.shape[1], kw["score_threshold"])
    ms = time_nms(args, kw, reps=WIDE_NMS_REPS)
    work = {}
    if soft:
        cluster_nms_plain(boxes, scores, md, kw["iou_threshold"],
                          kw["score_threshold"], kw["soft_nms_sigma"],
                          work=work)
        bound, by = nms_bound_ms(boxes, md, valid, work)
    else:
        scan_nms_plain(boxes, scores, md, kw["iou_threshold"],
                       kw["score_threshold"], chunk=32 * SCAN_WARPS,
                       work=work)
        bound, by, _ = scan_bound_ms(boxes, md, valid, work)
    row = {"case": label, "design": design, "lanes": boxes.shape[0],
           "k": boxes.shape[1], "max_det": md,
           "score_threshold": kw["score_threshold"],
           "valid": int(valid.sum().item()), "ms": ms[design],
           "rounds_ms": ms["rounds"], "plain_ms": ms["plain"],
           "bound_ms": bound, "bound_by": by, "work": work}
    if design == "cluster":
        row["plan"] = cluster_plan(boxes.shape[1])._asdict()
    WIDE_NMS_SHAPES.append(row)
    rounds = ("" if ms["rounds"] is None
              else f", round kernel {ms['rounds']:.4f} ms")
    print(f"[kernel] {label} (valid {row['valid']}): {design} "
          f"{ms[design]:.4f} ms{rounds}, plain {ms['plain']:.4f} ms, bound "
          f"{bound:.5f} ms ({by}; {work})")
    return row


def phase_nms_kernel() -> float:
    from retinanet_torch.ops.nms_kernel import nms_lanes
    rng = np.random.default_rng(0)
    worst = 0.0
    traced = None
    for name, boxes, scores, md, kw, design in nms_cases(rng):
        if traced is None:
            traced = (boxes, scores, md, kw)
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
        if design == "decay" and kw["soft_nms_sigma"] > 0.0:
            soft_nms_shape(f"seeded: {name}", (boxes, scores, md), kw, valid)
        if name.startswith("wide"):
            wide_nms_shape(name, (boxes, scores, md), kw, valid)
    boxes, scores, md, kw = traced
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
    from retinanet_torch.ops import topk_kernel
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
    topk_kernel.kernel.reset_counts()
    outputs, times = [], {bs: [] for bs in BATCHES}
    for bs, images in requests:
        start = time.perf_counter()
        det = serve(images)
        torch.cuda.synchronize()
        times[bs].append((time.perf_counter() - start) * 1e3)
        outputs.append(det)
    launches = kernel.launches
    topk_by = dict(topk_kernel.kernel.launches_by)
    TOPK_PATHS["serving (phase 5)"] = topk_kernel.kernel.launches
    check(topk_by == {"packed": len(requests), "f32": len(requests)},
          f"top-k kernel launches by mode {topk_by} for {len(requests)} "
          "requests (the default lane: packed, then f32 over the NMS "
          "survivors)")
    topk_designs = dict(topk_kernel.kernel.launches_by_design)
    check(topk_designs == {"slab": len(requests), "row": len(requests)},
          f"top-k kernel launches by design {topk_designs} for "
          f"{len(requests)} requests (slab the per-class rows, row the NMS "
          "survivors)")
    check(launches == len(requests)
          and kernel.launches_by["sweep"] == len(requests),
          f"NMS kernels launched {launches} times, the sweep "
          f"{kernel.launches_by['sweep']} times, for {len(requests)} "
          "requests")
    print(f"[serving] {len(requests)} requests, NMS kernel launches "
          f"{launches}, by design {dict(kernel.launches_by)}; top-k kernel "
          f"launches by mode {topk_by}")

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


def phase_soft_nms() -> dict:
    """Phase 17: the flagship served in each soft mode at batch 8 and 1 as
    the main path, on the zero-bias weights: one decay launch a request,
    the detections through the kernel equal to the plain lane's, one
    nms_decay_kernel in a request's trace, and the decay design, the round
    kernel and plain timed on the captured inputs."""
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.nms_kernel import kernel
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.tools.nms_experiments import (SOFT_MODES,
                                                       flagship_params)

    model = build_model(flagship_params(SOFT_MODES[0]), device="cuda",
                        seed=0)
    zero_class_prior(model)
    rng = np.random.default_rng(0)
    launches, worst, record = {}, 0.0, {}
    for mode in SOFT_MODES:
        params = flagship_params(mode)
        serve = build_serving_fn(params, device="cuda", model=model)
        h, w = params.input.input_shape
        requests = [(bs, torch.from_numpy(rng.integers(
            0, 256, (bs, h, w, 3)).astype(np.uint8)))
            for bs, count in BATCHES.items() for _ in range(count)]
        md = int(params.inference.max_detections)
        # the main path: the counts at 0 just before, read just after
        kernel.reset_counts()
        for bs, images in requests:
            det = serve(images)
            torch.cuda.synchronize()
            check_detections(det, bs, md)
        launches[mode] = dict(kernel.launches_by)
        check(launches[mode] == {"decay": len(requests)},
              f"{mode}: NMS launches by design {launches[mode]} for "
              f"{len(requests)} requests (one decay launch a request)")
        print(f"[soft] {mode}: {len(requests)} requests, NMS launches by "
              f"design {launches[mode]}")
        dets, captured = nms_lanes_agree(
            params, model, [requests[0][1], requests[BATCHES[8]][1]])
        print(f"[soft] {mode}: detections through the kernel equal those "
              "through the plain NMS at batch 8 and 1 (valid at 8: "
              f"{dets[0]['valid_detections'].tolist()})")
        per_image = (int(params.architecture.head.num_classes)
                     if mode.startswith("PerClass") else 1)
        for n, args in sorted(captured.items(), reverse=True):
            kw = dict(zip(("iou_threshold", "score_threshold",
                           "soft_nms_sigma", "soft"), args[3:]))
            check(kw["soft"], f"{mode} did not call soft NMS")
            with torch.inference_mode():
                err, valid = compare_nms(args[:3], kw, "decay")
                row = soft_nms_shape(f"{mode} batch {n // per_image}",
                                     args[:3], kw, valid)
            worst = max(worst, err)
            if mode == SOFT_MODES[0] and n == 8 * per_image:
                record = {"decay_ms": row["decay_ms"],
                          "decay_rounds_ms": row["rounds_ms"],
                          "decay_plain_ms": row["plain_ms"],
                          "decay_bound_ms": row["bound_ms"],
                          "decay_bound_by": row["bound_by"]}
        with torch.inference_mode():
            names = kernels_on_card(
                "nms_lanes", lambda: serve(requests[BATCHES[8]][1]))
        nms_names = [name for name in names if "nms_" in name]
        check(len(nms_names) == 1 and "nms_decay_kernel" in nms_names[0],
              f"{mode}: a request ran {nms_names} of the NMS kernels")
        print(f"[soft] {mode}: a batch-1 request's trace holds one "
              f"nms_decay_kernel ({len(names)} device events)")
    record.update(max_abs_err=worst, launches_on_soft_paths=launches)
    return record


def scan_bound_ms(boxes, md, valid, work) -> tuple:
    """Least time for a hard-mode call past 1,024 candidates, from
    `ops/nms.py:scan_nms_plain`'s `work`: every score read once (the order
    needs them all), the boxes of the candidates the lane decides, the
    outputs; against 20 f32 operations of each IoU that decides a
    candidate, and of each IoU the tail takes under a threshold below
    -1e10 ("tail"). Also row 1's count (20 operations a candidate a round,
    and every score and box) for comparison: (ms, by, row-1 ms)."""
    lanes_, k = boxes.shape[0], boxes.shape[1]
    t_bytes = (lanes_ * k * 4 + work["visited"] * 16 + lanes_ * md * 8
               + lanes_ * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (NMS_OPS_PER_CANDIDATE_ROUND
             * (work["pairs"] + work.get("tail", 0)) / F32_FLOP_PER_S * 1e3)
    row1, _ = nms_bound_ms(boxes, md, valid)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", row1)


def long_nms_shape(label: str, args, kw, valid) -> dict:
    """Phase 18's cases: the scan or compact design and the round kernel
    timed in turns on the same tensors, plain, the bound from this run's
    work, as a row of LONG_NMS_SHAPES."""
    from retinanet_torch.ops.nms import compact_nms_plain, scan_nms_plain
    from retinanet_torch.ops.nms_kernel import (COMPACT_WARPS, SCAN_WARPS,
                                                nms_design)
    boxes, scores, md = args
    soft = kw.get("soft", False)
    design = nms_design(soft, scores.shape[1], kw["score_threshold"])
    ms = time_nms(args, kw)
    work = {}
    if soft:
        compact_nms_plain(boxes, scores, md, kw["iou_threshold"],
                          kw["score_threshold"], kw["soft_nms_sigma"],
                          threads=32 * COMPACT_WARPS, work=work)
        bound, by = nms_bound_ms(boxes, md, valid, work)
        row1 = None
    else:
        scan_nms_plain(boxes, scores, md, kw["iou_threshold"],
                       kw["score_threshold"], chunk=32 * SCAN_WARPS,
                       work=work)
        bound, by, row1 = scan_bound_ms(boxes, md, valid, work)
    row = {"case": label, "design": design, "lanes": boxes.shape[0],
           "k": boxes.shape[1], "max_det": md,
           "valid": int(valid.sum().item()), "ms": ms[design],
           "rounds_ms": ms["rounds"], "plain_ms": ms["plain"],
           "bound_ms": bound, "bound_by": by, "row1_bound_ms": row1,
           "work": work}
    LONG_NMS_SHAPES.append(row)
    print(f"[kernel] {label} (L={row['lanes']}, k={row['k']}, valid "
          f"{row['valid']}): {design} {ms[design]:.4f} ms, round kernel "
          f"{ms['rounds']:.4f} ms, plain {ms['plain']:.4f} ms, bound "
          f"{bound:.5f} ms ({by}; {work}"
          + ("" if row1 is None else f"; row 1's count {row1:.5f} ms")
          + ")")
    return row


def phase_long_nms() -> dict:
    """Phase 18: the flagship served with `inference.nms_top_k` 5000 in the
    four NMS modes at batch 8 and 1 as the main path, on the zero-bias
    weights: one scan (hard) or compact (soft) launch a request and no
    round-kernel launch, the detections through the kernel equal to the
    plain lane's, the design's kernel alone in a request's trace, and the
    design, the round kernel and plain timed on the captured inputs, on
    trained-like copies and on seeded lanes."""
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.nms_kernel import kernel
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.tools.nms_experiments import (LONG_K, LONG_MODES,
                                                       flagship_params,
                                                       trained_like)

    model = build_model(flagship_params(LONG_MODES[0], LONG_K),
                        device="cuda", seed=0)
    zero_class_prior(model)
    rng = np.random.default_rng(0)
    launches, worst, record = {}, 0.0, {}
    names = {"scan": "nms_scan_kernel", "compact": "nms_compact_kernel"}
    for mode in LONG_MODES:
        params = flagship_params(mode, LONG_K)
        design = "compact" if "Soft" in mode else "scan"
        serve = build_serving_fn(params, device="cuda", model=model)
        h, w = params.input.input_shape
        requests = [(bs, torch.from_numpy(rng.integers(
            0, 256, (bs, h, w, 3)).astype(np.uint8)))
            for bs, count in LONG_BATCHES.items() for _ in range(count)]
        md = int(params.inference.max_detections)
        # the main path: the counts at 0 just before, read just after
        kernel.reset_counts()
        for bs, images in requests:
            det = serve(images)
            torch.cuda.synchronize()
            check_detections(det, bs, md)
        launches[mode] = dict(kernel.launches_by)
        check(launches[mode] == {design: len(requests)},
              f"{mode} at nms_top_k {LONG_K}: NMS launches by design "
              f"{launches[mode]} for {len(requests)} requests (one {design} "
              "launch a request, no round kernel)")
        print(f"[long] {mode}, nms_top_k {LONG_K}: {len(requests)} "
              f"requests, NMS launches by design {launches[mode]}")
        dets, captured = nms_lanes_agree(
            params, model, [requests[0][1], requests[LONG_BATCHES[8]][1]])
        print(f"[long] {mode}: detections through the kernel equal those "
              "through the plain NMS at batch 8 and 1 (valid at 8: "
              f"{dets[0]['valid_detections'].tolist()})")
        per_image = (int(params.architecture.head.num_classes)
                     if mode.startswith("PerClass") else 1)
        for n, args in sorted(captured.items(), reverse=True):
            kw = dict(zip(("iou_threshold", "score_threshold",
                           "soft_nms_sigma", "soft"), args[3:]))
            check(args[0].shape[1] == LONG_K and kw["soft"] == (
                design == "compact"), f"{mode} called NMS with k "
                f"{args[0].shape[1]}, soft {kw['soft']}")
            label = f"{mode} batch {n // per_image}"
            trained = (args[0], trained_like(args[1],
                                             kw["score_threshold"]), args[2])
            with torch.inference_mode():
                for name, case in ((f"real {label}", args[:3]),
                                   (f"trained-like {label}", trained)):
                    err, valid = compare_nms(case, kw, design)
                    row = long_nms_shape(name, case, kw, valid)
                    worst = max(worst, err)
            if mode.startswith("PerClass") and n == 8 * per_image:
                record.update({f"{design}_ms": row["ms"],
                               f"{design}_rounds_ms": row["rounds_ms"],
                               f"{design}_plain_ms": row["plain_ms"],
                               f"{design}_bound_ms": row["bound_ms"],
                               f"{design}_bound_by": row["bound_by"]})
        with torch.inference_mode():
            traced = kernels_on_card(
                "nms_lanes", lambda: serve(requests[LONG_BATCHES[8]][1]))
        nms_names = [name for name in traced if "nms_" in name]
        check(len(nms_names) == 1 and names[design] in nms_names[0],
              f"{mode}: a request ran {nms_names} of the NMS kernels")
        print(f"[long] {mode}: a batch-1 request's trace holds one "
              f"{names[design]} ({len(traced)} device events)")
    boxes, scores = lanes(rng, max(LONG_LANES), LONG_K)
    for n in LONG_LANES:
        for soft in (False, True):
            kw = (dict(iou_threshold=1.0, score_threshold=0.05,
                       soft_nms_sigma=0.25, soft=True) if soft
                  else dict(iou_threshold=0.5, score_threshold=0.05))
            case = (boxes[:n].contiguous(), scores[:n].contiguous(), 100)
            with torch.inference_mode():
                err, valid = compare_nms(
                    case, kw, "compact" if soft else "scan")
                long_nms_shape(f"seeded {'soft' if soft else 'hard'} L={n}",
                               case, kw, valid)
            worst = max(worst, err)
    record.update(max_abs_err=worst, launches_on_long_paths=launches)
    return record


def plain_select_top_k(x, k, mode, dim=-1):
    """`ops/topk.py:select_top_k` on the plain version: the lane the
    kernel's selections are held to in phase 19."""
    from retinanet_torch.ops.topk import top_k_rows_plain
    ndim = x.dim()
    dim = dim + ndim if dim < 0 else dim
    if dim == ndim - 1:
        values, idx = top_k_rows_plain(x.reshape(-1, x.shape[-1], 1), k,
                                       mode)
        shape = tuple(x.shape[:-1]) + (k,)
        return values.reshape(shape), idx.reshape(shape)
    return top_k_rows_plain(x, k, mode)


def wide_params(mode: str):
    """The flagship with pre_nms_top_k = nms_top_k = WIDE_K (a user who
    doubles the reference's 5,000) in NMS mode `mode`."""
    from retinanet_torch.tools.nms_experiments import flagship_params
    return flagship_params(mode, WIDE_K, WIDE_K)


def phase_wide_serving() -> dict:
    """Phase 19: the flagship served with pre_nms_top_k = nms_top_k =
    WIDE_K in the four NMS modes at batch 8 and 1 on the zero-bias weights,
    as the main path: one launch a request of the scan (hard) or the
    cluster design (soft), none of the round kernel, the top-k's
    selections of 10,000 on its kernels (the counts at 0 just before); the
    detections through the kernels equal to those through the plain NMS,
    and to those through the plain top-k and the plain NMS; the design
    alone among the NMS kernels in a request's trace; the design timed
    beside plain on the batch-8 inputs; then the skip_nms lane at WIDE_K,
    equal to the same lane on the plain top-k. Returns the cluster
    design's record."""
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import postprocess, topk_kernel
    from retinanet_torch.ops.nms import batched_nms
    from retinanet_torch.ops.nms_kernel import kernel
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.tools.nms_experiments import LONG_MODES

    kernel_select, kernel_nms = postprocess.select_top_k, postprocess.nms_lanes
    model = build_model(wide_params(LONG_MODES[0]), device="cuda", seed=0)
    zero_class_prior(model)
    rng = np.random.default_rng(19)
    h, w = wide_params(LONG_MODES[0]).input.input_shape
    images = {bs: torch.from_numpy(rng.integers(
        0, 256, (bs, h, w, 3)).astype(np.uint8)) for bs in WIDE_BATCHES}
    requests = [(bs, images[bs]) for bs, count in WIDE_BATCHES.items()
                for _ in range(count)]
    launches, topk_launches, record, worst = {}, {}, {}, 0.0
    sort_launches = {}
    names = {"scan": "nms_scan_kernel", "cluster": "nms_cluster_kernel"}
    cluster_launches = 0
    for mode in LONG_MODES:
        params = wide_params(mode)
        design = "cluster" if "Soft" in mode else "scan"
        serve = build_serving_fn(params, device="cuda", model=model)
        md = int(params.inference.max_detections)
        # the main path: the counts at 0 just before, read just after
        kernel.reset_counts()
        topk_kernel.kernel.reset_counts()
        served = []
        for bs, batch in requests:
            start = time.perf_counter()
            det = serve(batch)
            torch.cuda.synchronize()
            served.append((bs, det, (time.perf_counter() - start) * 1e3))
            check_detections(det, bs, md)
        launches[mode] = dict(kernel.launches_by)
        topk_launches[mode] = dict(topk_kernel.kernel.launches_by_design)
        sort_launches[mode] = dict(topk_kernel.kernel.launches_by_sort)
        check(sort_launches[mode] == {"radix": len(requests)},
              f"{mode}: top-k launches by sort {sort_launches[mode]} (the "
              f"selection of {WIDE_K} a request past the on-chip sort's "
              f"{topk_kernel.SORT_ON_CHIP_MAX}: one radix sort)")
        check(launches[mode] == {design: len(requests)},
              f"{mode} at pre_nms_top_k = nms_top_k = {WIDE_K}: NMS "
              f"launches by design {launches[mode]} for {len(requests)} "
              f"requests (one {design} launch a request, no round kernel)")
        check(topk_launches[mode].get("slab", 0) == len(requests),
              f"{mode}: top-k launches by design {topk_launches[mode]} "
              f"(one slab selection of {WIDE_K} a request)")
        if design == "cluster":
            cluster_launches += kernel.launches_by["cluster"]
        print(f"[wide] {mode}, pre_nms_top_k = nms_top_k = {WIDE_K}: "
              f"{len(requests)} requests ("
              + ", ".join(f"batch {bs} {ms:.1f} ms" for bs, _, ms in served)
              + f"), NMS launches by design {launches[mode]}, top-k by "
              f"design {topk_launches[mode]}")
        dets, captured = nms_lanes_agree(params, model,
                                         [images[8], images[1]])
        # the kernel lane against plain top-k and plain NMS together
        try:
            postprocess.select_top_k = plain_select_top_k
            postprocess.nms_lanes = batched_nms
            for bs, det, _ in served:
                plain = serve(images[bs])
                check(all(torch.equal(plain[key], det[key]) for key in det),
                      f"{mode} batch {bs}: detections differ from the "
                      "plain top-k and plain NMS lane's")
        finally:
            postprocess.select_top_k = kernel_select
            postprocess.nms_lanes = kernel_nms
        print(f"[wide] {mode}: detections through the kernels equal those "
              "through the plain NMS and through the plain top-k and NMS "
              f"at batch 8 and 1 (valid at 8: "
              f"{dets[0]['valid_detections'].tolist()})")
        per_image = (int(params.architecture.head.num_classes)
                     if mode.startswith("PerClass") else 1)
        args = captured[8 * per_image]
        kw = dict(zip(("iou_threshold", "score_threshold", "soft_nms_sigma",
                       "soft"), args[3:]))
        check(args[0].shape[1] == WIDE_K, f"{mode} called NMS with k "
              f"{args[0].shape[1]}")
        with torch.inference_mode():
            err, valid = compare_nms(args[:3], kw, design)
            row = wide_nms_shape(f"real {mode} batch 8, k={WIDE_K}",
                                 args[:3], kw, valid)
        worst = max(worst, err)
        if mode == "PerClassSoftNMS":
            record = {"ms": row["ms"], "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"]}
        with torch.inference_mode():
            traced = kernels_on_card("nms_lanes",
                                     lambda: serve(images[1]))
        nms_names = [name for name in traced if "nms_" in name]
        check(len(nms_names) == 1 and names[design] in nms_names[0],
              f"{mode}: a request ran {nms_names} of the NMS kernels")
        print(f"[wide] {mode}: a batch-1 request's trace holds one "
              f"{names[design]} ({len(traced)} device events)")

    # the skip_nms export lane selects pre_nms_top_k = WIDE_K a class
    params = wide_params("PerClassHardNMS")
    lane = build_serving_fn(params, mode="tf_tensorrt", device="cuda",
                            model=model)
    topk_kernel.kernel.reset_counts()
    out = {bs: lane(images[bs]) for bs in WIDE_BATCHES}
    skip_launches = dict(topk_kernel.kernel.launches_by_design)
    check(skip_launches == {"slab": len(WIDE_BATCHES)},
          f"skip_nms lane: top-k launches by design {skip_launches}")
    sort_launches["skip_nms"] = dict(topk_kernel.kernel.launches_by_sort)
    check(sort_launches["skip_nms"] == {"radix": len(WIDE_BATCHES)},
          f"skip_nms lane: top-k launches by sort "
          f"{sort_launches['skip_nms']}")
    try:
        postprocess.select_top_k = plain_select_top_k
        for bs, got in out.items():
            want = lane(images[bs])
            check(tuple(got["scores"].shape) == (bs, WIDE_K, 80),
                  f"skip_nms scores {tuple(got['scores'].shape)}")
            check(all(torch.equal(got[key], want[key]) for key in got),
                  f"skip_nms lane batch {bs} differs from the plain top-k's")
    finally:
        postprocess.select_top_k = kernel_select
    print(f"[wide] skip_nms lane at pre_nms_top_k {WIDE_K}: batch 8 and 1 "
          f"equal to the plain top-k's, top-k launches {skip_launches}")
    launches["skip_nms"] = skip_launches
    record.update(launches=cluster_launches, max_abs_err=worst,
                  launches_on_wide_paths=launches,
                  topk_launches_on_wide_paths=topk_launches,
                  topk_sort_launches_on_wide_paths=sort_launches)
    return record


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
    model_dir and a tensorboard_dir under `workdir` and `step_changes`
    (train_steps overridden);
    returns (path, [(key, the base's value, value)])."""
    tree = json.loads(base.read_text())
    changes = [(("dataloader_params", "tfrecords", "train"), pattern),
               (("dataloader_params", "tfrecords", "val"), pattern),
               (("training", "annotation_file_path"), ann),
               (("experiment", "model_dir"), str(workdir / "models")),
               (("experiment", "tensorboard_dir"),
                str(workdir / "tensorboard"))]
    changes += [(key, train_steps if key[-1] == "train_steps" else value)
                for key, value in step_changes]
    done = []
    for key, value in changes:
        node = tree
        for part in key[:-1]:
            node = node[part]
        done.append((".".join(key), node.get(key[-1]), value))
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
    until PIPELINE_SECONDS have passed, that window's start and end
    (perf_counter), and the pipeline's stage seconds over the whole run
    with its count of finished samples."""
    from retinanet_torch.data.pipeline import InputPipeline
    pipeline = InputPipeline("train", params)
    it = iter(pipeline)
    next(it)
    start = end = time.perf_counter()
    batches = 0
    while end - start < PIPELINE_SECONDS:
        next(it)
        batches += 1
        end = time.perf_counter()
    it.close()
    stages = dict(pipeline.stage_seconds, samples=pipeline.stage_samples)
    return (batches * int(params.training.batch_size.train) / (end - start),
            start, end, stages)


def print_stages(label: str, stages: dict) -> None:
    """Where the pipeline's threads spent their time: seconds summed over
    the threads of each stage, per finished sample."""
    n = max(stages["samples"], 1)
    total = sum(v for k, v in stages.items() if k != "samples")
    print(f"[executor] pipeline stages {label}, {stages['samples']} samples:"
          + "".join(f" {k} {v / n * 1e3:.3f} ms/sample ({v / total:.1%})"
                    for k, v in stages.items() if k != "samples"))


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
        rate, start, end, stages = pipeline_rate(params)
    finally:
        stop.set()
        thread.join()
    del state, batch
    torch.cuda.empty_cache()
    steps = sum(start < t <= end for t in ends)
    return rate, steps, steps * bs / (end - start), stages


def phase_executor(workdir: Path, step_images_per_s: float) -> dict:
    """The flagship train_val run from tfrecords through the CLI. Returns
    the kernels' launches on the in-process paths."""
    from retinanet_torch.__main__ import main as cli_main
    from retinanet_torch.core.config import Config
    from retinanet_torch.data import host_codec
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    from retinanet_torch.ops import match_kernel, nms_kernel, topk_kernel

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
    pipe_rate, _, _, stages = pipeline_rate(params)
    print(f"[executor] host pipeline alone: train batches of {train_batch} "
          f"at {params.input.input_shape} with augmentation for "
          f"{PIPELINE_SECONDS} s, {pipe_rate:.1f} images/s "
          f"({os.cpu_count()} CPUs)")
    print_stages("alone", stages)
    beside_rate, beside_steps, step_beside_rate, stages = \
        pipeline_beside_step(params)
    print(f"[executor] host pipeline beside the train step: "
          f"{beside_rate:.1f} images/s; the step beside the pipeline: "
          f"{beside_steps} steps in the window, {step_beside_rate:.2f} "
          f"images/s (alone in phase 6: {step_images_per_s:.2f})")
    print_stages("beside the step", stages)

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
    topk_kernel.kernel.reset_counts()
    scores = cli_main(["--config_path", str(config), "--run_evaluation"])
    TOPK_PATHS["evaluation (phase 8 b)"] = topk_kernel.kernel.launches
    sweeps = nms_kernel.kernel.launches_by["sweep"]
    eval_matches = match_kernel.kernel.launches
    n_val = int(params.training.validation_samples) // val_batch
    check(sweeps == n_val and nms_kernel.kernel.launches == n_val,
          f"NMS sweep kernel launched {sweeps} times "
          f"({nms_kernel.kernel.launches} in all) for {n_val} val batches")
    check(eval_matches == 0, f"matching kernel launched {eval_matches} "
          "times in an evaluation")
    check(topk_kernel.kernel.launches_by["packed"] == n_val,
          f"top-k kernel launched {dict(topk_kernel.kernel.launches_by)} "
          f"for {n_val} val batches")
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


def dp_batches(order: str = "", batch: int = DP_BATCH) -> list:
    """The seeded global batches of `batch` images, in their order or in
    one of DP_ORDERS (the same steps in exact arithmetic)."""
    from retinanet_torch.data.synthetic import synthetic_train_batch
    rows = np.arange(batch)
    if order == DP_ORDERS[0]:
        rows = np.roll(rows, batch // 2)
    elif order == DP_ORDERS[1]:
        rows = rows[::-1]
    return [{k: v[rows] for k, v in synthetic_train_batch(
        batch, (640, 640), 100, 80, seed=i).items()}
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


def dp_hold_to_one_process(precision: str, rtol: float, runs: list,
                           batch: int = DP_BATCH, label: str = "dp",
                           shares: str = f"{DP_BATCH // DP_WORLD} a rank"
                           ) -> None:
    """The ranks' runs in `precision`: bit-equal to each other, each kernel
    launched, and held to one process at the same global batch of
    `batch` (`shares`: what a rank takes of it)."""
    from retinanet_torch.core.config import from_dict
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    refs = []
    for order in ("",) + DP_ORDERS:
        history, weights, state = dp_steps(
            from_dict(dp_tree(precision)), dp_batches(order, batch),
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
    print(f"[{label}] flagship {precision}, global batch {batch} "
          f"({shares}), {DP_STEPS} steps: losses and "
          f"parameters bit-equal across the ranks; against one process at "
          f"batch {batch}: {within} of {total} losses and tensors within "
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
    print(f"[{label}] {precision}: matching launches "
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
    device ms (and `torch._int_mm` for a 1x1 conv; a narrow call also on
    the mma_sync design it replaced, a stem call on mma_sync and on
    narrow, by their routes) and its bounds. Returns (rows, the largest
    |kernel - plain| over the calls)."""
    import torch.nn.functional as F
    from retinanet_torch.ops.int8_conv import (int8_conv2d_plain,
                                               quantize_activation,
                                               unpack_weights)
    from retinanet_torch.ops.int8_conv_kernel import int8_design, launch
    from retinanet_torch.tools.int8_conv_experiments import (
        NARROW_ROUTES, STEM_ROUTES, routed)
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
               "max_abs_err": err,
               "design": int8_design(x.shape[3], out.shape[3], kh, kw,
                                     stride, groups,
                                     x.data_ptr() % 16 == 0)}
        if timed:
            t_ops, t_bytes = int8_call_bound(x, bias, out, kh, kw, stride,
                                             pads, groups)
            row.update(ops_s=t_ops, bytes_s=t_bytes)
            with torch.inference_mode():
                row["ms"] = time_ms(lambda: launch(*args), reps=5)
                row["mma_sync_ms"] = row["narrow_ms"] = None
                routes = ({"mma_sync": NARROW_ROUTES["mma_sync"]}
                          if row["design"] == "narrow" else STEM_ROUTES
                          if row["design"] == "stem" else {})
                for other, route in routes.items():
                    with routed(route):
                        check(torch.equal(launch(*args), want),
                              f"{label}: int8 conv {path} on {other} "
                              "differs from its plain version")
                        row[f"{other}_ms"] = time_ms(
                            lambda: launch(*args), reps=5)
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
               "int_mm_ms": mean("int_mm_ms"),
               "mma_sync_ms": mean("mma_sync_ms"),
               "narrow_ms": mean("narrow_ms")}
        table.append(rec)
        print(f"[int8] {label} {design:9s} {k}x{k}/{stride}"
              f"{' dw' if groups > 1 else ''} x {list(x)} -> {list(out)} "
              f"x{len(group)}: kernel {rec['ms']:.4f} ms, bound "
              f"{bound:.5f}, plain {rec['plain_ms']:.3f}, cuDNN bf16 "
              f"{rec['cudnn_bf16_ms']:.4f}"
              + ("" if rec["int_mm_ms"] is None else
                 f", torch._int_mm {rec['int_mm_ms']:.4f}")
              + ("" if rec["mma_sync_ms"] is None else
                 f", on mma_sync {rec['mma_sync_ms']:.4f}")
              + ("" if rec["narrow_ms"] is None else
                 f", on narrow {rec['narrow_ms']:.4f}"))
    for rec in design_totals(label, rows, {}):
        print(f"[int8] {label} {rec['design']}: {rec['calls']} calls, "
              f"kernel {rec['ms']:.4f} ms, cuDNN bf16 "
              f"{rec['cudnn_bf16_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
              f"ms" + ("" if rec["mma_sync_ms"] is None else
                       f", on mma_sync {rec['mma_sync_ms']:.4f} ms")
              + ("" if rec["narrow_ms"] is None else
                 f", on narrow {rec['narrow_ms']:.4f} ms"))
    return table


def design_totals(label: str, rows: list, launches_by: dict) -> list:
    """Per design of the int8 conv, over one request's timed `rows`: its
    calls, the launches its main-path run counted, and the sums of kernel,
    bound and cuDNN bf16 ms."""
    out = []
    for design in sorted({r["design"] for r in rows}):
        mine = [r for r in rows if r["design"] == design]
        out.append({"model": label, "design": design, "calls": len(mine),
                    "launches": launches_by.get(design),
                    "ms": sum(r["ms"] for r in mine),
                    "bound_ms": sum(max(r["ops_s"], r["bytes_s"])
                                    for r in mine) * 1e3,
                    "plain_ms": sum(r["plain_ms"] for r in mine),
                    "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in mine),
                    "mma_sync_ms": (sum(r["mma_sync_ms"] for r in mine)
                                    if design in ("narrow", "stem")
                                    else None),
                    "narrow_ms": (sum(r["narrow_ms"] for r in mine)
                                  if design == "stem" else None)})
    return out


def request_device_ms(serve, images, count: int = 3,
                      every: dict = None) -> tuple:
    """(device busy ms, ms of the int8 conv's kernels, those ms by kernel
    name, their launches by kernel name) of one request, from a profiler
    trace over `count` requests after one that is not (launches: over the
    `count` requests); `every`, if given, gets every kernel's ms a request
    by name."""
    from torch.profiler import ProfilerActivity, profile
    from retinanet_torch.profile_serving import _NOT_KERNELS
    serve(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            serve(images)
        torch.cuda.synchronize()
    busy, by_name, launches = 0.0, {}, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us <= 0 or evt.key.startswith(_NOT_KERNELS):
            continue
        busy += dev_us
        if every is not None:
            every[evt.key] = every.get(evt.key, 0.0) + dev_us / 1e3 / count
        if any(n in evt.key for n in INT8_KERNEL_NAMES):
            # the kernel's name and template arguments, without the
            # namespace and the parameter list
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            by_name[name] = by_name.get(name, 0.0) + dev_us / 1e3 / count
            launches[name] = launches.get(name, 0) + evt.count
    return busy / 1e3 / count, sum(by_name.values()), by_name, launches


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
    tree["experiment"]["tensorboard_dir"] = str(workdir / "tensorboard")
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
    from retinanet_torch.ops import int8_conv_kernel, nms_kernel, topk_kernel
    from retinanet_torch.ops.int8_conv_kernel import encode_us, int8_design
    from retinanet_torch.tools.int8_conv_experiments import (STEM_ROUTES,
                                                             routed)
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
    topk_kernel.kernel.reset_counts()
    frozen = check_frozen_nms(module, one)
    TOPK_PATHS["frozen float graph (phase 12 b)"] = \
        topk_kernel.kernel.launches
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
    topk_kernel.kernel.reset_counts()
    q_ms, q_det = {}, {}
    for bs in INT8_BATCHES:
        q_ms[bs], q_det[bs] = served_ms(q_module.serve, requests[bs],
                                        INT8_REQUESTS)
    launches = int8.launches
    TOPK_PATHS["int8 requests (phase 12 c)"] = topk_kernel.kernel.launches
    launches_by = dict(int8.launches_by)
    served = len(INT8_BATCHES) * (INT8_REQUESTS + 1)
    int8_model = q_module.module.model
    paths_of = int8_weights_paths(int8_model)
    _, calls = capture_int8_calls(q_module.serve, requests[8])
    check(len(calls) > 0 and launches == served * len(calls),
          f"int8 kernel launched {launches} times for {served} requests of "
          f"{len(calls)} int8 convs")
    # every dense call but the stem on the wgmma design, the stem on the
    # stem design, and the counts of the main path say so
    stem = INT8_SHAPES[0][1]
    designs = {}
    for args, _ in calls:
        x, packed, scale, _, _, stride, _, groups, kh, kw, _ = args
        path = paths_of.get(packed.data_ptr(), "?")
        design = int8_design(x.shape[3], scale.shape[0], kh, kw, stride,
                             groups)
        want = ("stem" if path == stem else
                "wgmma" if groups == 1 else "depthwise")
        check(design == want, f"int8 conv {path} takes {design}")
        designs[design] = designs.get(design, 0) + 1
    check(designs == {"wgmma": len(calls) - 1, "stem": 1}
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
    # the batch-8 int8 request with the stem on "stem" and on the design it
    # replaced, in turns: (device busy ms, ms of the int8 conv's kernels)
    turns = {"stem": [], "stem on mma_sync": []}
    every = {"stem": {}, "stem on mma_sync": {}}  # kernel -> ms, 2 turns
    for i in range(4):
        key = "stem on mma_sync" if i % 2 else "stem"
        with routed(STEM_ROUTES["mma_sync"] if i % 2 else {}):
            got = request_device_ms(q_module.serve, requests[8],
                                    every=every[key])
        turns[key].append(got[:2])
        busy[f"int8 batch 8, {key} ({len(turns[key])})"] = got
    # the kernels whose time a request moves most between the two
    names = set(every["stem"]) | set(every["stem on mma_sync"])
    moved = sorted(((every["stem"].get(n, 0.0)
                     - every["stem on mma_sync"].get(n, 0.0)) / 2, n)
                   for n in names)
    for delta, name in moved[:5] + moved[-8:]:
        print(f"[int8] a batch-8 int8 request's kernel {name[:110]}: "
              f"{delta:+.4f} ms on stem against mma_sync (mean of 2 "
              "turns)")
    for key, (ms, int8_ms, by_name, _) in busy.items():
        print(f"[int8] {key} request, profiler: device busy {ms:.3f} ms, "
              f"of which the int8 conv's kernels {int8_ms:.3f} ms: "
              + ", ".join(f"{n} {v:.3f}" for n, v in sorted(
                  by_name.items(), key=lambda kv: -kv[1])))
    # a stem call is one kernel: in the trace of 3 requests of each batch
    # the stem kernel runs, at most once a request (the trace may lose a
    # launch), and no quantizing pass of words
    for bs in INT8_BATCHES:
        ran = busy[f"int8 batch {bs}"][3]
        stem_ran = sum(n for k, n in ran.items()
                       if "int8_conv_stem_kernel" in k)
        words_ran = sum(n for k, n in ran.items()
                        if "quantize_words_kernel" in k)
        check(0 < stem_ran <= 3 and words_ran == 0,
              f"int8 batch {bs}: int8_conv_stem_kernel {stem_ran} and "
              f"quantize_words_kernel {words_ran} launches in 3 requests")
    print("[int8] the flagship's int8 requests: int8_conv_stem_kernel at "
          "most once a request, no quantize_words_kernel (profiler)")
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
        "designs": design_totals("flagship", rows, launches_by),
        "shapes": shapes,
        "shape_table": table,
        "request_ms": {"float": f_ms, "weight_only": w_ms, "int8": q_ms},
        "request_device_ms": {k: {"busy": v[0], "int8_conv": v[1],
                                  "int8_by_kernel": v[2],
                                  "int8_launches_by_kernel": v[3]}
                              for k, v in busy.items()},
        "encode_us": encode,
        "detection_agreement_ap": agreement,
    }
    print(f"[int8] {len(rows)} calls of a batch-8 request bit-equal to the "
          f"plain version; kernel {record['ms']:.3f} ms in all, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}), cuDNN bf16 "
          f"{record['library_ms']:.3f}, plain {record['plain_ms']:.1f}")
    # the stem design's own row: the flagship's stem call
    top = shapes[0]
    stem_record = {
        "name": "int8_conv_stem", "route": "cuda",
        "source": "retinanet_torch/csrc/int8_conv.cu",
        "replaces": "retinanet_tpu/export/quantize.py:100",
        "replaces_note": "the stem's lax.conv_general_dilated(int8, int8, "
                         "int32) at :147, an XLA path (no Pallas kernel); "
                         "the mma_sync design before it",
        "launches": launches_by.get("stem", 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["design"] == "stem"),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["cudnn_bf16_ms"],
        "library": "cuDNN bf16 F.conv2d at the stem's shape",
        "mma_sync_ms": top["mma_sync_ms"], "narrow_ms": top["narrow_ms"],
        "work": f"the flagship's 7x7/2 stem in a batch-8 request "
                f"({top['x']} -> {top['out']})",
        "request_device_busy_ms": {k: [b for b, _ in v]
                                   for k, v in turns.items()},
        "request_int8_conv_ms": {k: [c for _, c in v]
                                 for k, v in turns.items()}}
    print(f"[int8] flagship stem: stem {top['ms']:.4f} ms, on mma_sync "
          f"{top['mma_sync_ms']:.4f}, on narrow {top['narrow_ms']:.4f}, "
          f"cuDNN bf16 {top['cudnn_bf16_ms']:.4f}, bound "
          f"{top['bound_ms']:.5f} ({top['bound_by']}); the batch-8 int8 "
          "request's device busy (int8 conv kernels) in turns: "
          + ", ".join(f"{k} {b:.3f} ({c:.3f})" for i in range(2)
                      for k, v in turns.items() for b, c in [v[i]])
          + " ms")
    record["stem_kernel"] = stem_record

    # (d) evaluate_artifact on the goldens' JPEGs through the int8 graph
    record["launches_on_export_paths"] = dict(export_paths["int8_conv2d"])
    int8.reset_counts()
    nms_kernel.kernel.reset_counts()
    topk_kernel.kernel.reset_counts()
    scores = evaluate_goldens(art, workdir / "eval")
    TOPK_PATHS["evaluate_artifact (phase 12 d)"] = \
        topk_kernel.kernel.launches
    record["launches_on_export_paths"]["evaluate_artifact"] = int8.launches
    export_paths["nms_lanes"]["evaluate_artifact"] = \
        nms_kernel.kernel.launches

    # (e), (f) models with depthwise convs through the int8 lane
    del module, q_module
    torch.cuda.empty_cache()
    record["depthwise_models"] = []
    for label, path, want in INT8_ZOO:
        start = time.perf_counter()
        zoo = int8_zoo_request(label, path, want)
        record["depthwise_models"].append(zoo)
        record["designs"] += zoo.pop("designs")
        stem_record.setdefault("zoo_stems", []).append(
            {"model": label, **zoo.pop("stem")})
        stem_record.setdefault("launches_on_int8_zoo_paths", {})[label] = \
            zoo["launches_by"].get("stem", 0)
        record["max_abs_err"] = max(record["max_abs_err"],
                                    zoo["max_abs_err"])
        print(f"[int8] {label} took {time.perf_counter() - start:.1f} s")
    # (g) the narrow shapes of the other configs
    start = time.perf_counter()
    narrow_rows, narrow_err = phase_narrow_shapes()
    record["max_abs_err"] = max(record["max_abs_err"], narrow_err)
    record["narrow_shapes"] = narrow_rows
    print(f"[int8] (g) took {time.perf_counter() - start:.1f} s")
    # (h) the generic design's other branches at sizes a model would give it
    start = time.perf_counter()
    generic_rows, generic_err = phase_generic_calls()
    record["max_abs_err"] = max(record["max_abs_err"], generic_err)
    record["generic_calls"] = generic_rows
    print(f"[int8] (h) took {time.perf_counter() - start:.1f} s")
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


def int8_zoo_request(label: str, path: Path, want: dict) -> dict:
    """A model with depthwise convs on int8 activations: calibrated on
    synthetic scenes, one batch-8 request as its main path (the kernel's
    counts at 0 before it), launches by design equal to `want`, every int8
    conv (dense and depthwise) held to the plain version and timed; then
    the "depthwise_generic" design held to the plain version at the
    request's first depthwise call, through an input one element off
    16-byte alignment."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.preprocessing import make_device_normalizer
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.export.calibration import calibrate_activations
    from retinanet_torch.export.quantize import detection_agreement_ap
    from retinanet_torch.export.serving import (build_serving_fn,
                                                build_serving_module)
    from retinanet_torch.models.retinanet import _compute_dtype, build_model
    from retinanet_torch.ops import int8_conv_kernel
    from retinanet_torch.ops.int8_conv import int8_conv2d_plain
    from retinanet_torch.profile_serving import zero_class_prior
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
    check(by == want and len(calls) == sum(want.values()),
          f"{label}: int8 launches by design {by} for {len(calls)} calls, "
          f"expected {want}")
    rows, max_err = hold_int8_calls(calls, int8_weights_paths(module.model),
                                    label, timed=True)
    table = print_int8_shapes(label, rows)
    doubt = sorted(doubt_share(a[0], a[4]) for a, _ in calls if a[7] > 1)
    print(f"[int8] {label}: share of a depthwise call's inputs that the "
          f"division decides (within 3e-5 of a tie): min {doubt[0]:.2e}, "
          f"median {doubt[len(doubt) // 2]:.2e}, max {doubt[-1]:.2e} over "
          f"{len(doubt)} calls")
    busy, int8_ms, by_name, ran = request_device_ms(
        serve, images, INT8_PROFILED_REQUESTS)
    print(f"[int8] {label} batch 8 int8 request, profiler: device busy "
          f"{busy:.3f} ms, of which the int8 conv's kernels {int8_ms:.3f} "
          "ms: " + ", ".join(f"{n} {v:.3f}" for n, v in sorted(
              by_name.items(), key=lambda kv: -kv[1])))
    # a narrow or stem call is one kernel: no quantizing pass. In the trace
    # of INT8_PROFILED_REQUESTS requests the narrow and stem kernels run,
    # each at most once a call of its design, no quantize_words_kernel
    # (mma_sync's pass, on no path), and quantize_bytes_kernel (wgmma's) at
    # most once a wgmma call: a pass of the narrow calls would pass those
    # bounds. The trace may lose a launch (seen in the whole script's runs,
    # never in phase 12 alone), so the counts bound from above.
    def ran_of(name):
        return sum(n for k, n in ran.items() if name in k)
    most = {"int8_conv_narrow_kernel": by.get("narrow", 0),
            "int8_conv_stem_kernel": by.get("stem", 0),
            "quantize_words_kernel": 0,
            "quantize_bytes_kernel": by.get("wgmma", 0)}
    most = {k: n * INT8_PROFILED_REQUESTS for k, n in most.items()}
    got_ran = {k: ran_of(k) for k in most}
    check(0 < got_ran["int8_conv_narrow_kernel"]
          and 0 < got_ran["int8_conv_stem_kernel"]
          and all(got_ran[k] <= n for k, n in most.items()),
          f"{label}: launches by kernel in {INT8_PROFILED_REQUESTS} "
          f"requests {got_ran}, at most {most}")
    print(f"[int8] {label}: launches by kernel in {INT8_PROFILED_REQUESTS} "
          f"requests (profiler) {got_ran}, at most {most}: each narrow and "
          "stem call one kernel, no quantizing pass")
    f_det = build_serving_fn(params, device="cuda", model=model)(images)
    agreement = detection_agreement_ap(
        as_numpy(f_det), as_numpy(q_det), (h, w),
        float(params.inference.score_threshold))
    print(f"[int8] {label}: {len(calls)} int8 conv calls in a batch-8 "
          f"request ({by}), all bit-equal to the plain version; "
          f"detection_agreement_ap {agreement:.4f}")
    # the generic design, reached by the input's alignment alone
    args = next(a for a, _ in calls if a[7] > 1)
    x = args[0]
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    before = kernel.launches_by["depthwise_generic"]
    with torch.inference_mode():
        got = int8_conv_kernel.launch(odd, *args[1:])
        want_out = int8_conv2d_plain(odd, *args[1:])
    torch.cuda.synchronize()
    check(kernel.launches_by["depthwise_generic"] == before + 1
          and torch.equal(got, want_out),
          f"{label}: depthwise_generic differs from the plain version")
    generic_ms = time_ms(lambda: int8_conv_kernel.launch(odd, *args[1:]),
                         reps=5)
    generic = next(r for r in rows if r["x"] == list(x.shape)
                   and r["k"] == args[8] and r["stride"] == args[5]
                   and r["groups"] > 1)
    generic_bound = max(generic["ops_s"], generic["bytes_s"]) * 1e3
    print(f"[int8] {label}: depthwise_generic at {list(x.shape)} k"
          f"{args[8]}/{args[5]} (input {x.element_size()} bytes off 16) "
          f"bit-equal, {generic_ms:.4f} ms; bound {generic_bound:.5f} ms "
          f"(bytes), plain {generic['plain_ms']:.3f}, cuDNN bf16 depthwise "
          f"{generic['cudnn_bf16_ms']:.4f} ms at the shape, \"depthwise\" "
          f"on the same call aligned {generic['ms']:.4f} ms")
    stem = next(r for r in rows if r["design"] == "stem")
    return {"config": str(path.relative_to(REPO)), "calls": len(calls),
            "stem": {k: stem[k] for k in (
                "x", "out", "k", "stride", "ms", "mma_sync_ms", "narrow_ms",
                "plain_ms", "cudnn_bf16_ms", "max_abs_err")} | {
                "bound_ms": max(stem["ops_s"], stem["bytes_s"]) * 1e3},
            "launches_by": by, "detection_agreement_ap": agreement,
            "max_abs_err": max_err, "ms": sum(r["ms"] for r in rows),
            "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in rows),
            "designs": design_totals(label, rows, by),
            "doubt_share": {"min": doubt[0], "median": doubt[len(doubt) // 2],
                            "max": doubt[-1]},
            "request_device_ms": {"busy": busy, "int8_conv": int8_ms,
                                  "int8_by_kernel": by_name,
                                  "int8_launches_by_kernel": ran},
            "generic_ms": generic_ms, "generic_bound_ms": generic_bound,
            "generic_cudnn_bf16_ms": generic["cudnn_bf16_ms"],
            "generic_plain_ms": generic["plain_ms"],
            "generic_depthwise_aligned_ms": generic["ms"],
            "shape_table": table}


def phase_generic_calls() -> tuple:
    """Phase 12 (h): seeded "depthwise_generic" calls at batch-8 sizes of
    its branches that no config's request reaches (C % 8 != 0, a 7x7
    window, stride 3), each bit-equal to the plain version and timed
    beside its bound, the plain version and cuDNN bf16 (the "depthwise"
    design takes none of them). Returns (records, the largest |kernel -
    plain|)."""
    import torch.nn.functional as F
    from retinanet_torch.models.layers import same_pads
    from retinanet_torch.ops import int8_conv_kernel
    from retinanet_torch.ops.int8_conv import (int8_conv2d_plain,
                                               pack_weights)
    kernel = int8_conv_kernel.kernel
    rows, max_err = [], 0.0
    for i, (label, (n, h, w, c), k, stride) in enumerate(GENERIC_CALLS):
        rng = np.random.default_rng(300 + i)
        x = torch.from_numpy(rng.normal(0, 1.5, (n, h, w, c)).astype(
            np.float32)).to(torch.bfloat16).cuda()
        qw = torch.from_numpy(rng.integers(-127, 128, (c, 1, k, k))
                              .astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(
            np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0, 1, c).astype(
            np.float32)).cuda()
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
        args = (x, pack_weights(qw, c).cuda(), scale, bias, 0.02, stride,
                pads, c, k, k, torch.bfloat16)
        design = int8_conv_kernel.int8_design(c, c, k, k, stride, c)
        check(design == "depthwise_generic", f"{label} takes {design}")
        before = kernel.launches_by["depthwise_generic"]
        with torch.inference_mode():
            got = int8_conv_kernel.launch(*args)
            want = int8_conv2d_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(kernel.launches_by["depthwise_generic"] == before + 1
              and torch.equal(got, want),
              f"{label}: depthwise_generic differs from the plain version "
              f"by {err}")
        t_ops, t_bytes = int8_call_bound(x, bias, got, k, k, stride, pads, c)
        xb = F.pad(x.permute(0, 3, 1, 2),
                   (pads[2], pads[3], pads[0], pads[1]))
        wb = qw.to(torch.bfloat16).cuda().contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            row = {"call": label, "x": [n, h, w, c], "k": k,
                   "stride": stride, "max_abs_err": err,
                   "ms": time_ms(lambda: int8_conv_kernel.launch(*args),
                                 reps=5),
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "plain_ms": time_ms(lambda: int8_conv2d_plain(*args),
                                       reps=1, warmup=0),
                   "cudnn_bf16_ms": time_ms(
                       lambda: F.conv2d(xb, wb, None, stride, 0, 1, c),
                       reps=5),
                   "depthwise_aligned_ms": None}
        rows.append(row)
        print(f"[int8] (h) {label} {list(x.shape)} {k}x{k}/{stride}: "
              f"depthwise_generic bit-equal, {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}), plain "
              f"{row['plain_ms']:.3f}, cuDNN bf16 {row['cudnn_bf16_ms']:.4f}"
              "; \"depthwise\" takes no such call")
    return rows, max_err


def narrow_shapes(path: Path) -> dict:
    """The distinct narrow convs (dense, 4 <= C <= 16) of a config's int8
    lane at batch ZOO_BATCH, from a forward on `device="meta"` (the
    prediction convs stay float): ((N, H, W, C), O, k, stride, pads) ->
    calls a request."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.export.quantize import conv_paths
    from retinanet_torch.models.layers import conv_hook
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.int8_conv_kernel import int8_design
    params = Config(str(path)).params
    model = build_model(params, device="meta").eval()
    paths = conv_paths(model)
    found = {}

    def hook(x, p, stride, pads, dtype, float_conv):
        o, cpg, kh, kw = p.weight.shape
        c = cpg * p.groups
        if kh == kw and "prediction" not in paths[p] and int8_design(
                c, o, kh, kw, stride, p.groups) == "narrow":
            key = ((ZOO_BATCH, x.shape[2], x.shape[3], c), o, kh, stride,
                   tuple(pads))
            found[key] = found.get(key, 0) + 1
        return float_conv(x)

    h, w = (int(v) for v in params.input.input_shape)
    with torch.no_grad(), conv_hook(hook):
        model(torch.empty(ZOO_BATCH, h, w, 3, device="meta"))
    return found


def phase_narrow_shapes() -> tuple:
    """Phase 12 (g): every distinct narrow shape of NARROW_CONFIGS at batch
    8, bfloat16 in and out, on seeded inputs, weights, scales and bias:
    bit-equal to the plain version, then timed beside the mma_sync design
    at the same shape, cuDNN bf16 and the bound (`hold_int8_calls`).
    Returns (the shapes' table, the largest |kernel - plain|)."""
    from retinanet_torch.ops import int8_conv_kernel
    from retinanet_torch.ops.int8_conv import pack_weights
    shapes = {}
    for label, path in NARROW_CONFIGS:
        for key, count in narrow_shapes(path).items():
            shapes.setdefault(key, []).append(f"{label} x{count}")
    calls, paths_of = [], {}
    rng = np.random.default_rng(12)
    for (xs, o, k, stride, pads), users in sorted(shapes.items()):
        x = torch.from_numpy(rng.normal(0, 1.5, xs).astype(
            np.float32)).to(torch.bfloat16).cuda()
        qw = torch.from_numpy(rng.integers(-127, 128, (o, xs[3], k, k))
                              .astype(np.int8))
        packed = pack_weights(qw, 1).cuda()
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, o).astype(
            np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0, 1, o).astype(np.float32)).cuda()
        s_a = float(x.float().abs().max()) / 127.0 * 0.8
        args = (x, packed, scale, bias, s_a, stride, pads, 1, k, k,
                torch.bfloat16)
        with torch.inference_mode():
            calls.append((args, int8_conv_kernel.launch(*args)))
        paths_of[packed.data_ptr()] = "; ".join(users)
    torch.cuda.synchronize()
    rows, max_err = hold_int8_calls(calls, paths_of, "narrow shapes",
                                    timed=True)
    check(all(r["design"] == "narrow" for r in rows),
          f"narrow shapes on {sorted({r['design'] for r in rows})}")
    table = print_int8_shapes("narrow shapes", rows)
    for rec, row in zip(sorted(table, key=lambda r: (r["x"], r["out"],
                                                     r["k"])),
                        sorted(rows, key=lambda r: (r["x"], r["out"],
                                                    r["k"]))):
        rec["models"] = row["path"]
    print(f"[int8] (g) {len(rows)} distinct narrow shapes of "
          f"{', '.join(label for label, _ in NARROW_CONFIGS)}, each "
          "bit-equal to the plain version")
    return table, max_err


def doubt_share(x, s_a: float) -> float:
    """Share of x's elements whose int8 value the depthwise design leaves
    to the division: t = x * (1 / s_a) in float32, as the kernel forms it,
    under 128 and within 3e-5 of a half-integer (`quantize_sure`)."""
    inv = (torch.ones((), dtype=torch.float32)
           / torch.full((), s_a, dtype=torch.float32)).to(x.device)
    t = x.float() * inv
    return ((t.abs() < 128) & ((t - torch.round(t)).abs() >= 0.49997)
            ).float().mean().item()


# -- phase 13: the host data path ---------------------------------------------

def write_coco_layout(root: Path, rng) -> dict:
    """A COCO download folder: `annotations/instances_{train,val}2017.json`
    and scenes encoded by the port's JPEG route under `{train,val}2017/`,
    with crowd boxes, an image without a box, a train scene of
    HOST_CROWDED_BOXES boxes and one file that is no JPEG. Returns
    {split: images that hold a non-crowd box}."""
    from retinanet_torch.data.synthetic import _scene_jpeg
    (root / "annotations").mkdir(parents=True)
    cats = [{"id": cid, "name": f"category_{cid:02d}"} for cid in COCO_IDS]
    usable = {}
    for split, n in (("train", HOST_TRAIN_IMAGES), ("val", HOST_VAL_IMAGES)):
        (root / f"{split}2017").mkdir()
        images, anns = [], []
        usable[split] = 0
        for i in range(n):
            image_id = 100_000 + 17 * i + (0 if split == "train" else 9)
            h, w = (int(v) for v in rng.integers(240, 640, 2))
            name = f"{image_id:012d}.jpg"
            images.append({"id": image_id, "height": h, "width": w,
                           "file_name": name})
            if i == 1:
                k = 0               # an image without a box
            elif split == "train" and i == 2:
                k = HOST_CROWDED_BOXES
            else:
                k = int(rng.integers(1, 8))
            side = 0.02 if k == HOST_CROWDED_BOXES else 0.3
            x1, y1 = rng.uniform(0, 0.99 - side, (2, k))
            bw = rng.uniform(0.01, side, k)
            bh = rng.uniform(0.01, side, k)
            labels = rng.integers(0, len(COCO_IDS), k)
            crowd = rng.uniform(size=k) < 0.1
            boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
            if i == 3 and split == "val":
                (root / f"{split}2017" / name).write_bytes(
                    rng.bytes(5000))  # no JPEG: skipped by the tool
            else:
                (root / f"{split}2017" / name).write_bytes(
                    _scene_jpeg(rng, h, w, boxes, labels))
                usable[split] += int((~crowd).any())
            for b, c, cr in zip(boxes, labels, crowd):
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": COCO_IDS[int(c)],
                             "bbox": [float(b[0] * w), float(b[1] * h),
                                      float((b[2] - b[0]) * w),
                                      float((b[3] - b[1]) * h)],
                             "area": float((b[2] - b[0]) * w
                                           * (b[3] - b[1]) * h),
                             "iscrowd": int(cr)})
        (root / "annotations" / f"instances_{split}2017.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": cats}))
    return usable


def records_per_s(paths, read, parse) -> tuple:
    """Records and records/s of reading and parsing every shard."""
    start = time.perf_counter()
    n = 0
    for path in paths:
        for record in read(str(path)):
            parse(record)
            n += 1
    return n, n / (time.perf_counter() - start)


def host_tools(workdir: Path) -> dict:
    """Phase 13 (a). Returns the kernels' launches in its train_val run."""
    from retinanet_torch.__main__ import main as cli_main
    from retinanet_torch.core.config import Config
    from retinanet_torch.data import host_codec, tfrecord
    from retinanet_torch.ops import match_kernel, nms_kernel
    rng = np.random.default_rng(13)
    root = workdir / "coco"
    start = time.perf_counter()
    usable = write_coco_layout(root, rng)
    print(f"[host] wrote a COCO folder of {HOST_TRAIN_IMAGES} train and "
          f"{HOST_VAL_IMAGES} val images through the "
          f"{host_codec.jpeg_route()} route in "
          f"{time.perf_counter() - start:.2f} s")

    out = workdir / "shards"
    start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "retinanet_torch.tools.create_coco_tfrecords",
         "--download_path", str(root), "--output_dir", str(out),
         "--num_shards", str(HOST_TRAIN_SHARDS), "--remap_class_ids"],
        cwd=str(workdir), env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - start
    check(proc.returncode == 0, "create_coco_tfrecords exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    check("Skipped 1 corrupted samples from val" in proc.stderr
          and "corrupted samples from train" not in proc.stderr,
          f"the tool skipped other files than the one corrupt one:\n"
          f"{proc.stderr[-3000:]}")
    shards = {split: sorted(out.glob(f"{split}-*.tfrecord"))
              for split in ("train", "val")}
    check(len(shards["train"]) == HOST_TRAIN_SHARDS,
          f"train shards {shards['train']}")

    # every record: the native reader's parse equal to the Python codec's
    n_boxes = []
    for path in shards["train"] + shards["val"]:
        records = list(host_codec.read_records(str(path), verify_crc=True))
        check(records == list(tfrecord.read_records(str(path), True)),
              f"{path.name}: the native index differs from the codec's")
        for record in records:
            got = host_codec.parse_detection_example(record)
            want = tfrecord.parse_detection_example(record)
            check(got["image"] == want["image"]
                  and got["image_id"] == want["image_id"]
                  and np.array_equal(got["boxes"], want["boxes"])
                  and np.array_equal(got["classes"], want["classes"]),
                  f"{path.name}: a native parse differs from the codec's")
            n_boxes.append(len(got["classes"]))
    check(sum(1 for p in shards["val"] for _ in tfrecord.read_records(
        str(p))) == usable["val"] and
          len(n_boxes) == usable["train"] + usable["val"],
          f"{len(n_boxes)} records for {usable} images with a box that "
          "decode")
    check(max(n_boxes) > 512, f"largest scene {max(n_boxes)} boxes")
    paths = shards["train"] + shards["val"]
    n, native_rate = records_per_s(paths, host_codec.read_records,
                                   host_codec.parse_detection_example)
    _, python_rate = records_per_s(paths, tfrecord.read_records,
                                   tfrecord.parse_detection_example)
    print(f"[host] (a) create_coco_tfrecords: exit 0 in {seconds:.1f} s, "
          f"{len(shards['train'])} train and {len(shards['val'])} val "
          f"shards, 1 corrupt file skipped; {n} records, up to "
          f"{max(n_boxes)} boxes a record, every native parse equal to the "
          f"Python codec's; read and parse, one thread: native "
          f"{native_rate:.1f} records/s, Python {python_rate:.1f} records/s")

    # a short flagship train_val on the tool's shards
    tree = json.loads(FLAGSHIP.read_text())
    tree["dataloader_params"]["tfrecords"] = {
        "train": str(out / "train-*.tfrecord"),
        "val": str(out / "val-*.tfrecord")}
    tree["training"]["annotation_file_path"] = str(
        root / "annotations" / "instances_val2017.json")
    tree["experiment"]["model_dir"] = str(workdir / "models")
    tree["experiment"]["tensorboard_dir"] = str(workdir / "tensorboard")
    for key, value in HOST_CHANGES:
        node = tree
        for part in key[:-1]:
            node = node[part]
        node[key[-1]] = value
    config = workdir / "config.json"
    config.write_text(json.dumps(tree, indent=2))
    params = Config(str(config)).params
    steps = dict(HOST_CHANGES)[("training", "train_steps")]
    n_val = int(params.training.validation_samples) // int(
        params.training.batch_size.val)
    start = time.perf_counter()
    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    done = cli_main(["--config_path", str(config)])
    launches = {"nms_lanes": {"host data train_val":
                              nms_kernel.kernel.launches},
                "match_lanes": {"host data train_val":
                                match_kernel.kernel.launches}}
    check(done is True, "the train_val run on the tool's shards did not end")
    check(match_kernel.kernel.launches == steps,
          f"matching kernel launched {match_kernel.kernel.launches} times in "
          f"{steps} steps")
    check(nms_kernel.kernel.launches_by["sweep"] == n_val,
          f"NMS sweep kernel launched {nms_kernel.kernel.launches_by} for "
          f"{n_val} val batches")
    model_dir = workdir / "models" / params.experiment.name
    records = read_jsonl(model_dir / "logs" / "train_metrics.jsonl")
    evals = [r for r in records if any(k.startswith("evaluation/")
                                       for k in r)]
    check(len(evals) == 1, f"{len(evals)} evaluation records")
    check_eval_record(evals[0], steps)
    print(f"[host] (a) flagship train_val on the tool's shards: {steps} "
          f"steps and a COCO evaluation in "
          f"{time.perf_counter() - start:.1f} s; matching launches "
          f"{match_kernel.kernel.launches}, NMS sweep launches "
          f"{nms_kernel.kernel.launches_by['sweep']}; "
          + json.dumps({k: round(evals[0][f"evaluation/{k}"], 5)
                        for k in COCO_KEYS}))
    return launches


def synthetic_coco_eval(n_images: int, seed: int) -> tuple:
    """COCO-like annotations and detections: 80 categories, about
    EVAL_GTS gts an image (1 in 20 crowd), EVAL_DETECTIONS detections an
    image, some near a gt of its category and the rest anywhere."""
    rng = np.random.default_rng(seed)
    images = [{"id": i + 1, "height": 480, "width": 640}
              for i in range(n_images)]
    cats = [{"id": cid, "name": f"category_{cid:02d}"} for cid in COCO_IDS]
    anns, dets = [], []
    for img in images:
        n_gt = int(rng.poisson(EVAL_GTS))
        xy = rng.uniform(0, 500, (n_gt, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(300), (n_gt, 2)))
        labels = rng.choice(COCO_IDS, n_gt)
        for b, c in zip(np.concatenate([xy, wh], 1), labels):
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "category_id": int(c), "bbox": b.tolist(),
                         "area": float(b[2] * b[3]),
                         "iscrowd": int(rng.uniform() < 0.05)})
        near = min(n_gt * 5, EVAL_DETECTIONS // 2)
        pick = rng.integers(0, max(n_gt, 1), near)
        boxes = np.concatenate([
            np.concatenate([xy, wh], 1)[pick] * rng.normal(
                1, 0.1, (near, 4)) if n_gt else np.zeros((0, 4)),
            np.concatenate([rng.uniform(0, 500, (EVAL_DETECTIONS - near,
                                                 2)),
                            rng.uniform(4, 300, (EVAL_DETECTIONS - near,
                                                 2))], 1)])
        labels = np.concatenate([labels[pick] if n_gt else labels[:0],
                                 rng.choice(COCO_IDS, EVAL_DETECTIONS - near)])
        for b, c, s in zip(np.abs(boxes), labels,
                           rng.uniform(0, 1, len(boxes))):
            dets.append({"image_id": img["id"], "category_id": int(c),
                         "bbox": b.tolist(), "score": float(s)})
    return {"images": images, "annotations": anns, "categories": cats}, dets


def timed_eval(gt: dict, dets: list, use_native) -> tuple:
    """(COCOEval after evaluate and accumulate, evaluate s, accumulate s)."""
    from retinanet_torch.eval.coco import COCOEval, COCOIndex
    ev = COCOEval(COCOIndex(gt), dets)
    start = time.perf_counter()
    ev.evaluate(use_native=use_native)
    mid = time.perf_counter()
    ev.accumulate()
    return ev, mid - start, time.perf_counter() - mid


def host_coco_eval() -> dict:
    """Phase 13 (b): the native COCO matcher against the numpy one at 500
    images, and alone at val2017's 5,000."""
    gt, dets = synthetic_coco_eval(EVAL_IMAGES, seed=1)
    from retinanet_torch.eval import coco, native as coco_native
    native, n_eval, n_acc = timed_eval(gt, dets, None)
    spec, s_eval, s_acc = timed_eval(gt, dets, False)
    p = native._packed
    lo = np.array([a for a, _ in coco.AREA_RNG.values()])
    hi = np.array([b for _, b in coco.AREA_RNG.values()])
    start = time.perf_counter()
    coco_native.match_groups(p, lo, hi, coco.IOU_THRS)
    match_s = time.perf_counter() - start
    for key in ("dt_matched", "dt_ignore", "num_gt"):
        check(np.array_equal(native._packed[key], spec._packed[key]),
              f"the native matcher's {key} differs from numpy's")
    check(np.array_equal(native.stats, spec.stats),
          f"summaries differ: {native.stats} vs {spec.stats}")
    groups = len(native._packed["group_keys"])
    print(f"[host] (b) COCOeval at {EVAL_IMAGES} images ({len(dets)} "
          f"detections, {len(gt['annotations'])} gts, {groups} groups): "
          f"arrays and summaries equal; evaluate native {n_eval:.3f} s, "
          f"numpy {s_eval:.3f} s ({s_eval / n_eval:.1f}x), of which the "
          f"native match call {match_s:.4f} s; accumulate "
          f"{n_acc:.3f} / {s_acc:.3f} s; AP {native.stats[0]:.5f}")
    gt, dets = synthetic_coco_eval(EVAL_IMAGES_NATIVE, seed=2)
    big, b_eval, b_acc = timed_eval(gt, dets, None)
    check(np.isfinite(big.stats).all(), f"stats {big.stats}")
    start = time.perf_counter()
    coco_native.match_groups(big._packed, lo, hi, coco.IOU_THRS)
    big_match_s = time.perf_counter() - start
    print(f"[host] (b) COCOeval at {EVAL_IMAGES_NATIVE} images "
          f"({len(dets)} detections, "
          f"{len(big._packed['group_keys'])} groups), native: evaluate "
          f"{b_eval:.3f} s, of which the match call {big_match_s:.4f} s; "
          f"accumulate {b_acc:.3f} s; AP {big.stats[0]:.5f}")
    return {"images": EVAL_IMAGES, "evaluate_native_s": n_eval,
            "evaluate_numpy_s": s_eval, "match_call_s": match_s,
            "images_native": EVAL_IMAGES_NATIVE,
            "evaluate_native_5000_s": b_eval,
            "match_call_5000_s": big_match_s,
            "accumulate_5000_s": b_acc}


def host_pretrained(workdir: Path, artifact: Path) -> None:
    """Phase 13 (c): the flagship fine-tuned from phase 12's artifact
    directory; the Executor's state equals the artifact's weights."""
    from retinanet_torch.convert import torch_to_flax
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.export import msgpack_codec
    from retinanet_torch.train.executor import Executor
    tree = json.loads(FLAGSHIP.read_text())
    tree["experiment"]["model_dir"] = str(workdir / "finetune")
    tree["experiment"]["tensorboard_dir"] = str(workdir / "tensorboard")
    tree["fine_tuning"] = {"fine_tune": True,
                           "pretrained_checkpoint": str(artifact)}
    start = time.perf_counter()
    ex = Executor(from_dict(tree), run_mode="train", device="cuda")
    path, matched, skipped = ex.pretrained
    want = msgpack_codec.read_file(str(artifact / "params.msgpack"))
    got = torch_to_flax(ex.model.state_dict())

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)
    want, got = dict(leaves(want)), dict(leaves(got))
    check(sorted(want) == sorted(got), "the artifact's leaves differ from "
          "the model's")
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    check(not differ, f"{len(differ)} tensors differ from the artifact's, "
          f"e.g. {differ[:3]}")
    check(path == str(artifact / "params.msgpack") and matched == len(want)
          and skipped == 0, f"{path}: {matched} matched, {skipped} skipped "
          f"of {len(want)}")
    ex.close()
    print(f"[host] (c) fine-tuning from {path}: {matched} tensors matched, "
          f"{skipped} skipped; every tensor of the Executor equal to the "
          f"artifact's ({time.perf_counter() - start:.1f} s)")


def phase_host_data(workdir: Path, artifact: Path) -> tuple:
    """Phase 13. Returns the kernels' launches on its paths and the
    matcher's times."""
    workdir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    launches = host_tools(workdir)
    print(f"[host] (a) took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    times = host_coco_eval()
    print(f"[host] (b) took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    host_pretrained(workdir, artifact)
    print(f"[host] (c) took {time.perf_counter() - start:.1f} s")
    return launches, times


def obs_train_val(workdir: Path) -> tuple:
    """Phase 14 (a): the flagship train_val through the CLI with
    `experiment.tensorboard_dir` and `--enable_weights_info`: OBS_CHANGES'
    50 steps reach one weights-info write, then one evaluation. The event
    file, decoded by `train/event_file.py`: every scalar equal to its JSONL
    line at float32 (and none without one), a histogram for each weight of
    the model under its Flax path, its counts summing to the weight's
    size. Returns (the kernels' launches, seconds of the weights-info
    call, the step's median seconds)."""
    from retinanet_torch.__main__ import main as cli_main
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    from retinanet_torch.models.retinanet import build_model, flax_path
    from retinanet_torch.ops import match_kernel, nms_kernel
    from retinanet_torch.train import event_file
    from retinanet_torch.train.executor import Executor

    pattern, ann = write_synthetic_tfrecords(
        str(workdir / "data"), "train", num_shards=2, samples_per_shard=16,
        num_classes=80, seed=0, write_annotations=True)
    steps = dict(OBS_CHANGES)[("training", "train_steps")]
    config, changes = derived_config(workdir, pattern, ann, steps,
                                     step_changes=OBS_CHANGES)
    for key, old, new in changes:
        print(f"[observability] config {key}: {old!r} -> {new!r}")
    params = Config(str(config)).params
    n_val = int(params.training.validation_samples) // int(
        params.training.batch_size.val)

    # one weights-info call timed as the run makes it: the norms and the
    # buckets on the card, each fetched once
    seconds = []
    write = Executor._write_weights_info

    def timed_write(self, step):
        torch.cuda.synchronize()
        start = time.perf_counter()
        write(self, step)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)

    nms_kernel.kernel.reset_counts()
    match_kernel.kernel.reset_counts()
    start = time.perf_counter()
    Executor._write_weights_info = timed_write
    try:
        done = cli_main(["--config_path", str(config),
                         "--enable_weights_info"])
    finally:
        Executor._write_weights_info = write
    wall = time.perf_counter() - start
    launches = {"nms_lanes": {"observability train_val":
                              nms_kernel.kernel.launches},
                "match_lanes": {"observability train_val":
                                match_kernel.kernel.launches}}
    check(done is True, "the observability train_val run did not end")
    check(match_kernel.kernel.launches == steps,
          f"matching kernel launched {match_kernel.kernel.launches} times in "
          f"{steps} steps")
    check(nms_kernel.kernel.launches_by["sweep"] == n_val,
          f"NMS sweep kernel launched {nms_kernel.kernel.launches_by} for "
          f"{n_val} val batches")
    check(len(seconds) == 1, f"{len(seconds)} weights-info writes in "
          f"{steps} steps, 1 expected")

    name = params.experiment.name
    records = read_jsonl(workdir / "models" / name / "logs" /
                         "train_metrics.jsonl")
    logdir = workdir / "tensorboard" / name / "train"
    files = event_file.event_files(str(logdir))
    check(len(files) == 1, f"event files under {logdir}: {files}")
    events = list(event_file.read_events(files[0]))
    check(events[0].file_version == event_file.FILE_VERSION,
          f"first event {events[0]}")
    scalars, hists = {}, {}
    for event in events[1:]:
        for value in event.values:
            array = value.tensor.numpy()
            if value.plugin_name == event_file.SCALARS_PLUGIN:
                check(array.dtype == np.float32 and array.shape == (),
                      f"scalar {value.tag}: {array.dtype} {array.shape}")
                scalars[(event.step, value.tag)] = array
            else:
                check(value.plugin_name == event_file.HISTOGRAMS_PLUGIN,
                      f"plugin {value.plugin_name}")
                hists[(event.step, value.tag)] = array
    want = {(r["step"], k): np.float32(v) for r in records
            for k, v in r.items() if k != "step"}
    check(set(want) == set(scalars), "scalars in the events but not the "
          f"JSONL: {sorted(set(scalars) - set(want))[:5]}; the other way: "
          f"{sorted(set(want) - set(scalars))[:5]}")
    differ = [k for k in want if not scalars[k] == want[k]]
    check(not differ, f"{len(differ)} scalars differ from the JSONL, e.g. "
          f"{differ[:3]}")
    model = build_model(params, device="meta")
    sizes = {f"weights-hist/{flax_path(n)}": p.numel()
             for n, p in model.named_parameters()}
    check({k for k in hists} == {(steps, tag) for tag in sizes},
          f"histogram tags {sorted(hists)[:3]} do not match the model's "
          f"{len(sizes)} Flax paths")
    for (_, tag), rows in hists.items():
        check(rows.shape == (event_file.BUCKET_COUNT, 3)
              and rows.dtype == np.float64, f"{tag}: {rows.shape}")
        check(rows[:, 2].sum() == sizes[tag], f"{tag}: counts sum to "
              f"{rows[:, 2].sum()}, size {sizes[tag]}")
        check(np.all(np.diff(rows[:, 0]) >= 0), f"{tag}: edges not sorted")
    step_s = statistics.median(r["execution-time"] for r in records
                               if "execution-time" in r)
    evals = [r for r in records if any(k.startswith("evaluation/")
                                       for k in r)]
    check(len(evals) == 1, f"{len(evals)} evaluation records")
    check_eval_record(evals[0], steps)
    print(f"[observability] (a) train_val, {steps} steps and a COCO "
          f"evaluation in {wall:.1f} s: {len(scalars)} scalars in the event "
          f"file, each equal to its JSONL line at float32; "
          f"{len(hists)} histograms at step {steps}, one a weight, counts "
          f"summing to its size; one _write_weights_info call (norms and "
          f"30 buckets of {len(sizes)} weights on the card, each fetched "
          f"once) {seconds[0] * 1e3:.2f} ms beside the step's "
          f"{step_s * 1e3:.2f} ms (median execution-time)")
    return launches, seconds[0], step_s


def hook_flops(params, batch: int) -> tuple:
    """(2 x multiply-adds, convs) of the eval forward at `batch`, counted
    independently of `get_flops`: the conv hook (`models/layers.py:
    conv_hook`) sees every conv with its weights, on `device="meta"`."""
    from retinanet_torch.models.layers import conv_hook
    from retinanet_torch.models.retinanet import _compute_dtype, build_model
    model = build_model(params, device="meta").eval()
    total = [0, 0]

    def hook(x, p, stride, pads, dtype, float_conv):
        y = float_conv(x)
        _, c_group, kh, kw = p.weight.shape
        total[0] += 2 * y.numel() * c_group * kh * kw
        total[1] += 1
        return y

    h, w = (int(v) for v in params.input.input_shape)
    images = torch.zeros((batch, h, w, int(params.input.channels)),
                         dtype=_compute_dtype(params.floatx.precision),
                         device="meta")
    with conv_hook(hook), torch.no_grad():
        model(images)
    return total[0], total[1]


def forward_busy_ms(params, model, images, count: int = 3) -> float:
    """Device busy ms of the eval forward alone (no pre- or post-processing)
    at `images`, from a profiler trace over `count` calls after one."""
    from torch.profiler import ProfilerActivity, profile
    from retinanet_torch.profile_serving import _NOT_KERNELS
    from retinanet_torch.models.retinanet import _compute_dtype
    from retinanet_torch.train.step import make_eval_forward
    forward = make_eval_forward(model, _compute_dtype(
        params.floatx.precision))
    forward(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            forward(images)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if not e.key.startswith(_NOT_KERNELS))
    return busy / 1e3 / count


def obs_introspection(workdir: Path) -> dict:
    """Phase 14 (b) and (c): `get_flops(1)` and `get_flops(8)` of the
    flagship and of each zoo architecture against `hook_flops`; the
    flagship's batch-8 float request and forward: achieved TFLOP/s of their
    device busy ms against the dense bf16 peak; `dump_forward_hlo()` of the
    flagship with one `aten.convolution` node a conv call."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.train.executor import Executor
    out = {}
    for label, path in (("flagship", FLAGSHIP),) + tuple(
            (a, REPO / "configs" / c) for a, c in ZOO):
        tree = json.loads(path.read_text())
        tree["experiment"]["model_dir"] = str(workdir / "models")
        tree["experiment"]["tensorboard_dir"] = str(workdir / "tensorboard")
        params = from_dict(tree)
        ex = Executor(params, run_mode="export", device="cuda")
        start = time.perf_counter()
        flops = {b: ex.get_flops(b) for b in (1, OBS_BATCH)}
        seconds = time.perf_counter() - start
        hooks = {b: hook_flops(params, b) for b in (1, OBS_BATCH)}
        for b in flops:
            check(flops[b] == hooks[b][0], f"{label}: get_flops({b}) "
                  f"{flops[b]:.0f} != the conv hooks' {hooks[b][0]}")
        print(f"[observability] (b) {label} {path.name} at "
              f"{params.input.input_shape}: get_flops(1) {flops[1]:.0f}, "
              f"get_flops({OBS_BATCH}) {flops[OBS_BATCH]:.0f} "
              f"({seconds:.2f} s for both, device=\"meta\"), equal to the "
              f"conv hooks' count over {hooks[1][1]} conv calls")
        out[label] = {"config": str(path.relative_to(REPO)),
                      "flops_1": flops[1], f"flops_{OBS_BATCH}":
                      flops[OBS_BATCH], "convs": hooks[1][1]}
        if label != "flagship":
            ex.close()
            continue
        check(flops[1] == FLAGSHIP_FLOPS_1, f"flagship get_flops(1) "
              f"{flops[1]:.0f}, {FLAGSHIP_FLOPS_1} expected")
        # (c) the forward graph
        start = time.perf_counter()
        graph = Path(ex.dump_forward_hlo())
        text = graph.read_text()
        n_conv = text.count("torch.ops.aten.convolution.default(")
        check(graph == Path(ex.model_dir) / "forward.export.txt",
              f"dump_forward_hlo wrote {graph}")
        check(n_conv == hooks[1][1], f"the exported graph has {n_conv} "
              f"aten.convolution nodes, the forward {hooks[1][1]} convs")
        print(f"[observability] (c) dump_forward_hlo: {graph.name}, "
              f"{len(text)} characters, {n_conv} aten.convolution nodes = "
              f"the forward's conv calls ({time.perf_counter() - start:.1f}"
              f" s)")
        ex.close()
        # achieved rate of the batch-8 float request and of its forward
        model = build_model(params, device="cuda", seed=0)
        zero_class_prior(model)
        serve = build_serving_fn(params, device="cuda", model=model)
        h, w = params.input.input_shape
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (OBS_BATCH, h, w, 3)).astype(np.uint8))
        request_ms = request_device_ms(serve, images)[0]
        normalized = images.cuda().float()
        forward_ms = forward_busy_ms(params, model, normalized)
        for key, ms in (("request", request_ms), ("forward", forward_ms)):
            tflops = flops[OBS_BATCH] / (ms / 1e3) / 1e12
            out["flagship"][f"{key}_busy_ms"] = ms
            out["flagship"][f"{key}_tflops"] = tflops
            print(f"[observability] (b) flagship batch-{OBS_BATCH} float "
                  f"{key}: device busy {ms:.3f} ms, "
                  f"{flops[OBS_BATCH]:.0f} FLOPs (convolutions) -> "
                  f"{tflops:.2f} TFLOP/s achieved, "
                  f"{100 * tflops / BF16_PEAK_TFLOPS:.2f}% of the "
                  f"{BF16_PEAK_TFLOPS:.0f} TFLOP/s dense bf16 peak "
                  f"({card_line()})")
        del model, serve
    return out


def _host64(value):
    """A float64 copy on the host of every floating tensor in a nested
    state_dict (other values as they are)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", copy=True)
        return value.double() if value.is_floating_point() else value
    if isinstance(value, dict):
        return {k: _host64(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host64(v) for v in value)
    return value


def obs_optimizers() -> dict:
    """Phase 14 (d): each registry optimizer on the flagship at batch
    OBS_BATCH for OBS_OPT_STEPS steps through `build_trainer`: losses
    finite; the last step's update held to the same optimizer's step on
    the host in float64 from the same state and the card's (clipped)
    gradients. Bound, a tensor: an element is off when it differs from the
    float64 result by more than 2^-22 of its magnitude plus OPT_UPDATE_TOL
    of the tensor's largest float64 update; at most OPT_OFF_SHARE of all
    elements may be off (a sign taken at the rounding level, in lion and
    yogi); and the L2 distance to the float64 result rounded to float32
    (what float32 weights can hold: lars's and adadelta's first updates
    are ~100 ulps of a weight) stays under OPT_L2_TOL of the update's
    norm. The flagship's own SGD runs the same steps first, for its step
    ms beside theirs."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.optimizers import registry
    from retinanet_torch.train.trainer import build_trainer
    params = from_dict(json.loads(FLAGSHIP.read_text()))
    h, w = params.input.input_shape
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        OBS_BATCH, (h, w), int(params.encoder_params.max_boxes),
        int(params.architecture.head.num_classes), seed=0).items()}
    rows = {}
    for name in ("sgd",) + tuple(registry.SIGNATURES):
        tree = json.loads(FLAGSHIP.read_text())
        tree["training"]["optimizer"]["name"] = name
        state, step = build_trainer(from_dict(tree), device="cuda", seed=0)
        opt = state.optimizer
        check(name == "sgd" or isinstance(opt, registry.RegistryOptimizer),
              f"{name}: built {type(opt).__name__}")
        losses, times = [], []
        for i in range(OBS_OPT_STEPS):
            if i == OBS_OPT_STEPS - 1 and name != "sgd":
                named = {n: p for n, p in state.model.named_parameters()
                         if p.requires_grad}
                before = {n: p.detach().to("cpu", torch.float64)
                          for n, p in named.items()}
                saved = _host64(opt.state_dict())
                generator = (None if opt.generator is None
                             else opt.generator.get_state())
            marks = []
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = step(state, batch, marks)
            loss = float(metrics["total-loss"])
            times.append(time.perf_counter() - start)
            losses.append(loss)
        # the clip and the update (the EMA is off): the device span from the
        # end of the backward to the end of the optimizer, last step
        spans = dict(marks)
        opt_ms = spans["backward"].elapsed_time(spans["optimizer"])
        check(all(math.isfinite(v) for v in losses),
              f"{name}: losses {losses}")
        if name == "sgd":
            rows[name] = {"losses": losses, "optimizer_ms": opt_ms,
                          "step_ms": [t * 1e3 for t in times]}
            print(f"[observability] (d) sgd (the flagship's KerasSGD, the "
                  f"baseline): losses " + " ".join(f"{v:.5f}" for v in losses)
                  + f"; step ms {times[-1] * 1e3:.1f} (first "
                  f"{times[0] * 1e3:.1f}), clip and update {opt_ms:.2f} ms "
                  "on the device")
            del state, step, opt
            torch.cuda.empty_cache()
            continue
        after = {n: p.detach().to("cpu", torch.float64)
                 for n, p in named.items()}
        host = {n: torch.nn.Parameter(v.clone()) for n, v in before.items()}
        ref = registry.RegistryOptimizer(host, name, opt.schedule,
                                         opt.hyper, clipnorm=None)
        if generator is not None:
            # the same draws: the host step takes them from the card's
            # generator in its state before the step
            ref.generator = torch.Generator(device=opt.generator.device)
            saved["generator"] = generator
        ref.load_state_dict(saved)
        for n, p in host.items():
            p.grad = named[n].grad.detach().to("cpu", torch.float64)
        ref.step()
        off = total = 0
        err2 = norm2 = 0.0
        for n, p in host.items():
            want = p.detach()
            update = want - before[n]
            tol = (2.0 ** -22 * want.abs()
                   + OPT_UPDATE_TOL * update.abs().max())
            diff = (after[n] - want).abs()
            off += int((diff > tol).sum())
            total += diff.numel()
            err2 += float(((after[n] - want.float().double()) ** 2).sum())
            norm2 += float((update ** 2).sum())
        l2 = math.sqrt(err2 / max(norm2, 1e-300))
        check(off <= OPT_OFF_SHARE * total and l2 <= OPT_L2_TOL,
              f"{name}: {off} of {total} elements off the float64 step, "
              f"update L2 error {l2:.3g}")
        rows[name] = {"losses": losses, "optimizer_ms": opt_ms,
                      "step_ms": [t * 1e3 for t in times],
                      "off": off, "l2": l2}
        print(f"[observability] (d) {name} {json.dumps(opt.hyper)}: losses "
              + " ".join(f"{v:.5f}" for v in losses)
              + f"; step ms {times[-1] * 1e3:.1f} (first "
              f"{times[0] * 1e3:.1f}), clip and update {opt_ms:.2f} ms on "
              f"the device; last update against float64 on the "
              f"host: {off} of {total} elements off, L2 error {l2:.3g} "
              "(to the float64 result in float32)")
        del state, step, opt, ref, host, named, before, after
        torch.cuda.empty_cache()
    return rows


def phase_observability(workdir: Path) -> tuple:
    """Phase 14. Returns the kernels' launches on its paths and its
    numbers."""
    workdir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    launches, weights_info_s, step_s = obs_train_val(workdir / "train_val")
    print(f"[observability] (a) took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    flops = obs_introspection(workdir / "introspection")
    print(f"[observability] (b, c) took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    optimizers = obs_optimizers()
    print(f"[observability] (d) took {time.perf_counter() - start:.1f} s")
    return launches, {"weights_info_ms": weights_info_s * 1e3,
                      "step_ms": step_s * 1e3, "flops": flops,
                      "optimizers": optimizers}



# -- phase 15: spatial partitioning -------------------------------------------

def spatial_rank(out_dir: str) -> None:
    """One rank of phase 15 (a), in a process of its own on card 0, on a
    (1, SPATIAL) grid: the flagship's steps in each of DP_PRECISIONS on the
    whole global batch (a band of its rows), the rows and bytes the
    exchanges move a step and their ms, then (float32) one evaluation batch
    through the band forward, its detections gathered once."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.preprocessing import make_device_normalizer
    from retinanet_torch.models.retinanet import BandedRetinaNet
    from retinanet_torch.ops import match_kernel, nms_kernel, topk_kernel
    from retinanet_torch.ops.postprocess import make_inference_fn
    from retinanet_torch.parallel import distributed, spatial
    from retinanet_torch.profile_serving import zero_class_prior
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = distributed.make_grid(SPATIAL)
    device = torch.device("cuda", 0)
    batches = dp_batches(batch=SPATIAL_BATCH)
    runs = {}
    # float32 last: its trained state serves the timing and the evaluation
    for precision in reversed(DP_PRECISIONS):
        match_kernel.kernel.reset_counts()
        spatial.STATS.reset()
        torch.cuda.reset_peak_memory_stats()
        history, weights, state = dp_steps(
            from_dict(dp_tree(precision)), batches, device)
        runs[precision] = {
            "history": history, "weights": weights,
            "match_launches": match_kernel.kernel.launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "exchange": {k: getattr(spatial.STATS, k) / DP_STEPS
                         for k in ("calls", "rows", "bytes")}}
        if precision != "float32":
            del state
            torch.cuda.empty_cache()
    params = from_dict(dp_tree("float32"))
    images = np.random.default_rng(5).integers(
        0, 256, (SPATIAL_EVAL_BATCH, 640, 640, 3)).astype(np.uint8)
    state.model.eval()
    zero_class_prior(state.model)
    banded = BandedRetinaNet(state.model, grid)
    normalizer = make_device_normalizer(params)
    with torch.inference_mode():
        outputs = banded(normalizer(torch.from_numpy(images).to(device)))
    nms_kernel.kernel.reset_counts()
    topk_kernel.kernel.reset_counts()
    infer = make_inference_fn(banded, params, from_params(params),
                              normalizer, compute_dtype=torch.float32,
                              device=device)
    det = infer(torch.from_numpy(images))
    parts = distributed.gather_to_chief(
        {k: v.cpu().numpy() for k, v in det.items()}
        if grid.spatial_index == 0 else None)
    del state, banded, infer
    torch.cuda.empty_cache()
    # a float32 step after one: the exchanges alone (the device synchronised
    # around each all-reduce), then a step untimed
    from retinanet_torch.train.trainer import build_trainer
    state, step = build_trainer(params, device=device, seed=0)
    step_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in batches[0].items()}
    step(state, step_batch)
    spatial.STATS.reset()
    spatial.STATS.timed = True
    torch.cuda.synchronize()
    start = time.perf_counter()
    step(state, step_batch)
    torch.cuda.synchronize()
    timed_ms = (time.perf_counter() - start) * 1e3
    spatial.STATS.timed = False
    exchange_ms = spatial.STATS.seconds * 1e3
    start = time.perf_counter()
    step(state, step_batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3
    torch.save({"runs": runs,
                "outputs": {kind: {lvl: y.cpu() for lvl, y in levels.items()}
                            for kind, levels in outputs.items()},
                "nms_launches": nms_kernel.kernel.launches,
                "topk_launches": topk_kernel.kernel.launches,
                "detections": (None if parts is None else
                               [p for p in parts if p is not None]),
                "exchange_ms": exchange_ms, "timed_step_ms": timed_ms,
                "step_ms": step_ms},
               f"{out_dir}/rank{distributed.process_index()}.pt")


def spatial_eval_reference(weights: dict, ranks: list) -> None:
    """One process's eval forward and detections on the ranks' float32
    weights (the class prior at 0 in both, so that every image has
    detections) and the same images: the gathered head outputs against
    the whole forward's, each image's detections once and like one
    process's."""
    from retinanet_torch.core.config import from_dict
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.data.preprocessing import make_device_normalizer
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.postprocess import make_inference_fn
    from retinanet_torch.profile_serving import zero_class_prior
    params = from_dict(dp_tree("float32"))
    model = build_model(params, device="cuda")
    model.load_state_dict(weights)
    model.eval()
    zero_class_prior(model)
    images = np.random.default_rng(5).integers(
        0, 256, (SPATIAL_EVAL_BATCH, 640, 640, 3)).astype(np.uint8)
    normalizer = make_device_normalizer(params)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        whole = model(normalizer(torch.from_numpy(images).cuda()))
        det = make_inference_fn(model, params, from_params(params),
                                normalizer, compute_dtype=torch.float32,
                                device="cuda")(torch.from_numpy(images))
    torch.backends.cudnn.allow_tf32 = tf32
    worst = 0.0
    for res in ranks:
        for kind, levels in whole.items():
            for lvl, want in levels.items():
                got = res["outputs"][kind][lvl].cuda()
                check(got.shape == want.shape,
                      f"gathered {kind} {lvl}: {tuple(got.shape)}")
                err = float((got - want).abs().max() / want.abs().max())
                worst = max(worst, err)
    check(worst <= SPATIAL_EVAL_RTOL,
          f"gathered head outputs {worst} of their magnitude from the whole "
          f"forward's (bound {SPATIAL_EVAL_RTOL})")
    parts = ranks[0]["detections"]
    check(len(parts) == 1 and ranks[1]["detections"] is None,
          "the detections of the spatial group must enter the chief's "
          "gather once")
    got = parts[0]
    check(len(got["valid_detections"]) == SPATIAL_EVAL_BATCH,
          f"the chief gathered {len(got['valid_detections'])} images")
    want = {k: v.cpu().numpy() for k, v in det.items()}
    counts_equal = int(np.sum(got["valid_detections"]
                              == want["valid_detections"]))
    check(counts_equal == SPATIAL_EVAL_BATCH and want[
        "valid_detections"].min() > 0, "detections a image: "
          f"{got['valid_detections'].tolist()} through the bands, "
          f"{want['valid_detections'].tolist()} in one process")
    score_err = max((float(np.abs(
        np.sort(got["scores"][i][:n])
        - np.sort(want["scores"][i][:n])).max())
        for i, n in enumerate(want["valid_detections"])
        if n and got["valid_detections"][i] == n), default=0.0)
    for r, res in enumerate(ranks):
        check(res["nms_launches"] == 1,
              f"rank {r}: NMS kernel launched {res['nms_launches']} times")
    print(f"[spatial] evaluation batch of {SPATIAL_EVAL_BATCH} through the "
          f"band forward (float32, TF32 off): head outputs gathered over the "
          f"group within {worst:.3g} of their magnitude of one process's "
          f"(bound {SPATIAL_EVAL_RTOL}); NMS launches a rank "
          + ", ".join(str(res["nms_launches"]) for res in ranks)
          + f"; the chief gathered {SPATIAL_EVAL_BATCH} images once; valid "
          f"detections {got['valid_detections'].tolist()} (one process "
          f"{want['valid_detections'].tolist()}, {counts_equal} of "
          f"{SPATIAL_EVAL_BATCH} counts equal, scores within "
          f"{score_err:.3g} where equal)")


def spatial_high_res_rank(out_dir: str) -> None:
    """One rank of phase 15 (b): the 1280x1280 config at a micro-batch of
    SPATIAL_HIGH_RES_BATCH, one step and one timed."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.ops import match_kernel
    from retinanet_torch.parallel import distributed
    from retinanet_torch.profile_training import measure_step
    from retinanet_torch.parallel import spatial
    distributed.make_grid(SPATIAL)
    params = Config(str(HIGH_RES)).params
    match_kernel.kernel.reset_counts()
    out = measure_step(params, SPATIAL_HIGH_RES_BATCH, 1, steps=1,
                       warmup=1)
    launches = match_kernel.kernel.launches
    # one more step with the exchanges timed alone
    spatial.STATS.reset()
    spatial.STATS.timed = True
    out["step"](out["state"], out["batch"])
    torch.cuda.synchronize()
    spatial.STATS.timed = False
    torch.save({k: out[k] for k in ("step_ms", "peak_gb", "metrics")}
               | {"match_launches": launches,
                  "exchange_ms": spatial.STATS.seconds * 1e3,
                  "exchange_mb": spatial.STATS.bytes / 1e6,
                  "exchange_calls": spatial.STATS.calls},
               f"{out_dir}/high_res{distributed.process_index()}.pt")


def phase_spatial(workdir: Path) -> tuple:
    """Phase 15: (a) the flagship on a (1, SPATIAL) grid of ranks on card 0
    against one process, its exchanges and a band evaluation; (b) the
    1280x1280 config at S = SPATIAL, each rank's peak beside one
    process's. Returns the kernels' launches on its paths and its
    numbers."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.profile_training import measure_step
    from retinanet_torch.tools.multiprocess_smoke import run_group
    workdir.mkdir(parents=True)
    torch.cuda.empty_cache()
    start = time.perf_counter()
    run_group(spatial_rank, SPATIAL, workdir, args=(str(workdir),),
              device="cuda:0", backend="gloo", timeout=600)
    print(f"[spatial] (a) {SPATIAL} ranks on card 0 over gloo: "
          f"{time.perf_counter() - start:.1f} s")
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(SPATIAL)]
    for precision, rtol in DP_PRECISIONS.items():
        dp_hold_to_one_process(
            precision, rtol, [res["runs"][precision] for res in ranks],
            batch=SPATIAL_BATCH, label="spatial",
            shares=f"the whole batch on each of {SPATIAL} ranks, a band of "
            "its rows each")
    spatial_eval_reference(ranks[0]["runs"]["float32"]["weights"], ranks)
    record = {"precisions": {}}
    for precision in DP_PRECISIONS:
        ex = [res["runs"][precision]["exchange"] for res in ranks]
        check(all(e == ex[0] for e in ex), f"{precision}: the ranks' "
              f"exchanges differ: {ex}")
        record["precisions"][precision] = {
            "exchange_calls_a_step": ex[0]["calls"],
            "exchange_rows_a_step": ex[0]["rows"],
            "exchange_mb_a_step": ex[0]["bytes"] / 1e6,
            "peak_gb_a_rank": [res["runs"][precision]["peak_gb"]
                               for res in ranks]}
        print(f"[spatial] {precision}: a step moves {ex[0]['calls']:.0f} "
              f"all-reduces of exchanged rows, {ex[0]['rows']:.0f} rows, "
              f"{ex[0]['bytes'] / 1e6:.2f} MB a rank (forward and "
              "backward)")
    record.update(
        exchange_ms=[res["exchange_ms"] for res in ranks],
        timed_step_ms=[res["timed_step_ms"] for res in ranks],
        step_ms=[res["step_ms"] for res in ranks])
    print("[spatial] float32 step, batch 8: exchanges "
          + " / ".join(f"{v:.1f}" for v in record["exchange_ms"])
          + " ms of a step of "
          + " / ".join(f"{v:.1f}" for v in record["timed_step_ms"])
          + " ms with the device synchronised around each all-reduce (rank "
          "0 / 1, host clock); the step untimed "
          + " / ".join(f"{v:.1f}" for v in record["step_ms"]) + " ms")
    for r, res in enumerate(ranks):
        TOPK_PATHS[f"spatial rank {r} evaluation (phase 15)"] = res[
            "topk_launches"]
    launches = {"nms_lanes": {f"spatial rank {r} evaluation":
                              res["nms_launches"]
                              for r, res in enumerate(ranks)},
                "match_lanes": {
                    f"spatial rank {r} {precision}":
                        res["runs"][precision]["match_launches"]
                    for r, res in enumerate(ranks)
                    for precision in DP_PRECISIONS}}
    del ranks
    torch.cuda.empty_cache()

    start = time.perf_counter()
    run_group(spatial_high_res_rank, SPATIAL, workdir, args=(str(workdir),),
              device="cuda:0", backend="gloo", timeout=600)
    high = [torch.load(workdir / f"high_res{r}.pt", weights_only=False)
            for r in range(SPATIAL)]
    print(f"[spatial] (b) {SPATIAL} ranks at 1280x1280: "
          f"{time.perf_counter() - start:.1f} s")
    torch.cuda.empty_cache()
    one = measure_step(Config(str(HIGH_RES)).params, SPATIAL_HIGH_RES_BATCH,
                       1, steps=1, warmup=1)
    rtol = DP_PRECISIONS["mixed_bfloat16"]
    for r, res in enumerate(high):
        check(res["match_launches"] == 2,
              f"1280x1280 rank {r}: matching launched "
              f"{res['match_launches']} times in 2 steps")
        check(res["metrics"] == high[0]["metrics"],
              f"1280x1280: rank {r}'s losses differ from rank 0's")
        for key, want in one["metrics"].items():
            got = res["metrics"][key]
            check(math.isfinite(got) and abs(got - want)
                  <= rtol * abs(want) + 1e-7,
                  f"1280x1280 rank {r} {key}: {got}, one process {want} "
                  f"(bound {rtol} of it)")
    record["high_res"] = {
        "config": str(HIGH_RES.relative_to(REPO)),
        "micro_batch": SPATIAL_HIGH_RES_BATCH,
        "peak_gb_a_rank": [res["peak_gb"] for res in high],
        "peak_gb_one_process": one["peak_gb"],
        "step_ms_a_rank": [res["step_ms"] for res in high],
        "step_ms_one_process": one["step_ms"],
        "exchange_ms_a_rank": [res["exchange_ms"] for res in high],
        "exchange_mb_a_step": high[0]["exchange_mb"],
        "exchange_calls_a_step": high[0]["exchange_calls"],
        "total_loss": high[0]["metrics"]["total-loss"],
        "total_loss_one_process": one["metrics"]["total-loss"]}
    launches["match_lanes"].update({f"spatial 1280x1280 rank {r}":
                                    res["match_launches"]
                                    for r, res in enumerate(high)})
    print(f"[spatial] 1280x1280 micro-batch {SPATIAL_HIGH_RES_BATCH} "
          f"(mixed bfloat16): peak allocated a rank "
          + ", ".join(f"{res['peak_gb']:.2f}" for res in high)
          + f" GB against {one['peak_gb']:.2f} GB in one process; step "
          + ", ".join(f"{res['step_ms']:.1f}" for res in high)
          + f" ms a rank (two ranks share the card) against "
          f"{one['step_ms']:.1f} ms; a step's {high[0]['exchange_calls']} "
          f"exchanges move {high[0]['exchange_mb']:.2f} MB a rank in "
          + " / ".join(f"{res['exchange_ms']:.1f}" for res in high)
          + " ms (timed alone, the device synchronised around each); "
          "total-loss "
          f"{high[0]['metrics']['total-loss']:.6f} (one process "
          f"{one['metrics']['total-loss']:.6f}; every loss within {rtol:.3g} "
          "of it)")
    del one
    torch.cuda.empty_cache()
    return launches, record


def topk_bound_ms(rows: torch.Tensor, k: int) -> float:
    """Least time of one selection: the rows read once, the k values and
    int32 indices of each written once, at the card's memory rate (the
    compares are far below the compute rate)."""
    b, _, c = rows.shape
    nbytes = rows.numel() * rows.element_size() + b * c * k * (
        rows.element_size() + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def topk_sort_lane(rows: torch.Tensor, k: int):
    """The lane the port ran before: the rows transposed to (B, C, N) in
    float32, a stable descending sort, cut to k."""
    values, idx = torch.sort(rows.to(torch.float32).transpose(1, 2), dim=-1,
                             descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def hold_topk(label: str, rows: torch.Tensor, k: int, mode: str,
              timed: bool = True, reps: int = 10) -> dict:
    """Both designs of the kernel on rows (B, N, C) against the plain
    version on the card: indices and value bits equal. Timed beside plain,
    the sort lane and `torch.topk` along N, and the bound; the slab
    design's phases from its own stamps."""
    from retinanet_torch.ops.topk import packed_layout, top_k_rows_plain
    from retinanet_torch.ops.topk_kernel import (DESIGNS, launch,
                                                 slab_trace, topk_design)
    want_v, want_i = top_k_rows_plain(rows, k, mode)
    view = torch.int32 if mode == "f32" else torch.int16
    for design in DESIGNS:
        got_v, got_i = launch(rows, k, mode, design=design)
        torch.cuda.synchronize()
        check(torch.equal(got_i, want_i),
              f"top-k {label} ({design}): indices differ")
        check(torch.equal(got_v.view(view), want_v.view(view)),
              f"top-k {label} ({design}): values differ")
    del want_v, want_i, got_v, got_i
    b, n, c = rows.shape
    out = {"case": label, "mode": mode, "shape": [b, n, c], "k": k,
           "design": topk_design(b, n, c, k),
           "bound_ms": topk_bound_ms(rows, k)}
    if mode == "packed":
        out["drop"] = packed_layout(n)[1]
    trace = slab_trace(rows, k, mode)
    out["slab_levels"] = trace["levels"]
    out["slab_rows_active"] = trace["rows_active"]
    out["slab_rows_deep"] = trace["rows_deep"]
    out["slab_candidates"] = trace["candidates"]
    out["slab_phase_ms"] = {name: ns / 1e6
                            for name, ns in trace["phase_ns"].items()}
    if timed:
        times = {"row": [], "slab": [], "plain": []}
        for name in ("row", "slab", "plain", "plain", "slab", "row"):
            times[name].append(time_ms(
                (lambda: top_k_rows_plain(rows, k, mode)) if name == "plain"
                else (lambda d=name: launch(rows, k, mode, design=d)),
                reps=2 if name == "plain" else reps))
        out["row_ms"] = statistics.mean(times["row"])
        out["slab_ms"] = statistics.mean(times["slab"])
        out["ms"] = out[f"{out['design']}_ms"]
        out["plain_ms"] = statistics.mean(times["plain"])
        out["sort_lane_ms"] = time_ms(lambda: topk_sort_lane(rows, k),
                                      reps=3)
        out["torch_topk_ms"] = time_ms(
            lambda: torch.topk(rows, k, dim=1), reps=reps)
        print(f"[topk] {label} ({mode}, {b}x{n}x{c}, k={k}, "
              f"{out['design']}): slab {out['slab_ms']:.4f} ms, row "
              f"{out['row_ms']:.4f}, bound {out['bound_ms']:.5f}, plain "
              f"{out['plain_ms']:.3f}, stable sort lane "
              f"{out['sort_lane_ms']:.3f}, torch.topk "
              f"{out['torch_topk_ms']:.4f}; both designs index- and "
              "value-exact")
    else:
        print(f"[topk] {label} ({mode}, {b}x{n}x{c}, k={k}): both designs "
              "index- and value-exact")
    print(f"[topk] {label}: slab levels {trace['levels']}, rows deep or "
          f"ready after each {trace['rows_active']} (deep "
          f"{trace['rows_deep']}), {trace['candidates']} candidates, "
          "phases (ms) "
          + ", ".join(f"{name} {ms:.4f}"
                      for name, ms in out["slab_phase_ms"].items()))
    return out


def hold_wide_topk(label: str, rows: torch.Tensor, k: int, mode: str,
                   select_alone) -> dict:
    """k past SORT_ON_CHIP_MAX (`tools/topk_experiments.py:wide_case`):
    both designs (their winners sorted by the radix sort) and the bitonic
    network through global memory that it replaced (on no path) against
    the plain version on the card, indices and value bits equal; timed in
    turns with `torch.topk` along N and the select launch alone
    (`select_alone`, a build whose radix sort returns at once: the
    difference is the sort's ms); beside the plain version, the
    function's bound (one read, the outputs) and the radix sort's own
    floor (`radix_floor_ms`)."""
    from retinanet_torch.tools.topk_experiments import wide_case
    res = wide_case(rows, k, mode, {"cut: the select alone": select_alone},
                    card_line(), sweep=False, reps=WIDE_TOPK_REPS)
    check(all(res["exact"].values()),
          f"top-k {label}: differs from plain: {res['exact']}")
    ms = {name: statistics.mean(t) for name, t in res["ms"].items()}
    other = "row" if res["design"] == "slab" else "slab"
    out = {"case": label, "mode": mode, "shape": res["shape"], "k": k,
           "design": res["design"], "sort": "radix", "ms": ms["radix"],
           f"{res['design']}_ms": ms["radix"],
           f"{other}_ms": ms[f"radix, {other}"],
           "bitonic_ms": ms["bitonic"],
           "select_ms": ms["radix, cut: the select alone"],
           "sort_ms": ms["radix"] - ms["radix, cut: the select alone"],
           "torch_topk_ms": ms["torch.topk"], "plain_ms": res["plain_ms"],
           "bound_ms": res["bound_ms"], "sort_floor_ms": res["sort_floor_ms"],
           "plan": {"passes": len(res["plan"]["digits"]),
                    "key_bytes": res["plan"]["key_bytes"],
                    "ctas_a_row": res["plan"]["segments"]}}
    b, n, c = res["shape"]
    print(f"[topk] {label} ({mode}, {b}x{n}x{c}, k={k}, {out['design']}, "
          f"radix sort: {out['plan']['passes']} passes of "
          f"{out['plan']['key_bytes']}-byte keys, "
          f"{out['plan']['ctas_a_row']} CTAs a row): slab "
          f"{out['slab_ms']:.4f} ms, row {out['row_ms']:.4f}, bitonic "
          f"{out['bitonic_ms']:.4f}, torch.topk {out['torch_topk_ms']:.4f} "
          f"({'under' if out['ms'] < out['torch_topk_ms'] else 'OVER'} it); "
          f"select alone {out['select_ms']:.4f}, so the sort "
          f"{out['sort_ms']:.4f} (floor {out['sort_floor_ms']:.5f}); bound "
          f"{out['bound_ms']:.5f}, plain {out['plain_ms']:.3f}; both "
          "designs and the bitonic network index- and value-exact")
    return out


def phase_radix_path(model, images: dict) -> dict:
    """Phase 16's main path of the radix sort: the skip_nms export lane
    with pre_nms_top_k = SKIP_NMS_ALL_K (every anchor of every class handed
    to a downstream NMS) at batch 8 and 1, the counts at 0 just before:
    one slab selection and one radix sort a request; the radix sort's
    kernels by name in a request's trace; the outputs equal to the same
    lane on the plain top-k."""
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.ops import postprocess
    from retinanet_torch.ops.topk_kernel import kernel
    from retinanet_torch.tools.nms_experiments import flagship_params
    params = flagship_params("PerClassHardNMS", SKIP_NMS_ALL_K,
                             SKIP_NMS_ALL_K)
    lane = build_serving_fn(params, mode="tf_tensorrt", device="cuda",
                            model=model)
    kernel.reset_counts()
    with torch.inference_mode():
        out = {bs: lane(images[bs]) for bs in (8, 1)}
    torch.cuda.synchronize()
    by_sort = dict(kernel.launches_by_sort)
    by_design = dict(kernel.launches_by_design)
    check(by_sort == {"radix": 2} and by_design == {"slab": 2},
          f"skip_nms lane at pre_nms_top_k {SKIP_NMS_ALL_K}: top-k "
          f"launches by sort {by_sort}, by design {by_design} for 2 "
          "requests")
    kernel_select = postprocess.select_top_k
    try:
        postprocess.select_top_k = plain_select_top_k
        with torch.inference_mode():
            for bs, got in out.items():
                want = lane(images[bs])
                check(tuple(got["scores"].shape) == (bs, SKIP_NMS_ALL_K, 80),
                      f"skip_nms scores {tuple(got['scores'].shape)}")
                check(all(torch.equal(got[key], want[key]) for key in got),
                      f"skip_nms lane at {SKIP_NMS_ALL_K}, batch {bs}: "
                      "differs from the plain top-k's")
    finally:
        postprocess.select_top_k = kernel_select
    del out
    with torch.inference_mode():
        names = kernels_on_card("top_k_radix_sort",
                                lambda: lane(images[1]))
    counts = {t: sum(t in n for n in names)
              for t in ("radix_prepare_kernel", "radix_scatter_kernel",
                        "radix_count_kernel", "bitonic")}
    check(counts["radix_prepare_kernel"] == 1
          and counts["radix_scatter_kernel"] >= 1 and not counts["bitonic"],
          f"skip_nms lane at {SKIP_NMS_ALL_K}: radix kernels {counts} in a "
          "request's trace")
    print(f"[topk] skip_nms lane at pre_nms_top_k {SKIP_NMS_ALL_K}: batch 8 "
          f"and 1 equal to the plain top-k's; top-k by sort {by_sort}, by "
          f"design {by_design}; a batch-1 request's trace: {counts}")
    return {"launches_by_sort": by_sort, "launches_by_design": by_design,
            "trace": counts}


def hold_survivors(label: str, rows: torch.Tensor, k: int,
                   floor_library) -> dict:
    """The top-k over the NMS survivors (rows (B, C * max_detections, 1)
    float32): both designs bit-equal to the plain version and timed beside
    it, `torch.topk` and the bound (`hold_topk`), and the launch floor: the
    same launch of a kernel that returns at once
    (`tools/topk_experiments.py:launch_floor_library`)."""
    from retinanet_torch.ops.topk_kernel import launch
    out = hold_topk(label, rows, k, "f32", reps=TOPK_ROW_REPS)
    out["fill_share"] = float((rows == -1.0).float().mean())
    out["floor_ms"] = time_ms(lambda: launch(
        rows, k, "f32", design="row", library=floor_library),
        reps=TOPK_ROW_REPS)
    print(f"[topk] {label} (-1.0 share {out['fill_share']:.4f}): row design "
          f"{out['row_ms']:.5f} ms, launch floor {out['floor_ms']:.5f}, slab "
          f"{out['slab_ms']:.5f}, torch.topk {out['torch_topk_ms']:.5f}, "
          f"bound {out['bound_ms']:.6f}, plain {out['plain_ms']:.4f} "
          f"({card_line()})")
    return out


def sort_kernels(names) -> list:
    return sorted({n for n in names if any(s in n for s in TOPK_SORT_NAMES)
                   and not any(t in n for t in TOPK_KERNEL_NAMES)})


def phase_topk(floor_library, select_alone) -> list:
    """Phase 16. Returns the records of the top-k kernel's two designs
    and of its radix sort. `floor_library`: `csrc/topk.cu` with the row
    design's kernel returning at once; `select_alone`: with the radix sort
    returning at once; both built beside the kernels."""
    from retinanet_torch.core.config import Config, from_dict
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops import topk_kernel
    from retinanet_torch.profile_serving import zero_class_prior
    from retinanet_torch.tools.topk_experiments import (
        capture_survivors, trained_like_survivors)
    params = Config(str(FLAGSHIP)).params
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    h, w = params.input.input_shape
    rng = np.random.default_rng(16)
    images = {bs: torch.from_numpy(rng.integers(
        0, 256, (bs, h, w, 3)).astype(np.uint8)) for bs in (8, 1)}
    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    default_serve = build_serving_fn(params, device="cuda", model=model)
    with torch.inference_mode():
        logits = fused_fn(images[8])["class_logits"]        # (8, A, 80) f32
    k = min(int(params.inference.get("nms_top_k", 256)),
            int(params.inference.pre_nms_top_k))
    pre_k = int(params.inference.pre_nms_top_k)
    md = int(params.inference.max_detections)
    a, c = logits.shape[1], logits.shape[2]
    bf = logits.to(torch.bfloat16)
    distinct = torch.unique(bf[0, :, 0]).numel()
    print(f"[topk] flagship fused logits at batch 8, class bias 0: {a} "
          f"anchors x {c} classes, {distinct} distinct bf16 values in "
          f"{a} of one row")
    cases = []
    with torch.inference_mode():
        cases.append(hold_topk("flagship default lane", bf, k, "packed"))
        cases.append(hold_topk("flagship exact lane", logits, k, "f32"))
        cases.append(hold_topk("flagship skip_nms lane",
                               torch.sigmoid(logits), pre_k, "f32"))
        flat = bf.reshape(TOPK_BATCH, a * c, 1)
        cases.append(hold_topk("flagship global lane", flat, k, "bf16"))
        cases.append(hold_topk(
            "flagship global skip_nms lane",
            torch.sigmoid(logits).reshape(TOPK_BATCH, a * c, 1), pre_k,
            "f32"))
        survivors = torch.from_numpy(np.where(
            rng.uniform(size=(TOPK_BATCH, c * md, 1)) < 0.3, -1.0,
            np.round(rng.uniform(0.05, 1.0, (TOPK_BATCH, c * md, 1)) * 64)
            / 64).astype(np.float32)).cuda()
        cases.append(hold_topk("NMS survivors", survivors, md, "f32"))
        # the row design's main path: the real survivors of a zero-bias
        # request (`_per_class_nms`'s input to `top_k`) and trained-like
        # rows, at batch 8 and 1
        survivor_cases = []
        for bs in (8, 1):
            real = capture_survivors(default_serve, images[bs])
            for label, rows in (
                    (f"real survivors, batch {bs}",
                     real[..., None].contiguous()),
                    (f"trained-like survivors, batch {bs}",
                     trained_like_survivors(bs, c * md))):
                survivor_cases.append(hold_survivors(label, rows, md,
                                                     floor_library))
        cases.append(hold_topk(
            "rows of one value", torch.zeros(
                (TOPK_BATCH, TOPK_ZOO_ANCHORS[0][0], c),
                dtype=torch.bfloat16, device="cuda"), k, "packed"))
        # in the three modes on the flagship's fused logits: the on-chip
        # sort's last k (8,192), then the radix sort's up to every anchor
        wide = []
        for kw in WIDE_TOPK_KS:
            for mode, rows in (("packed", bf), ("bf16", bf),
                               ("f32", logits)):
                wide.append(
                    hold_topk(f"flagship wide k={kw}", rows, kw, mode,
                              reps=WIDE_TOPK_REPS)
                    if kw <= topk_kernel.SORT_ON_CHIP_MAX else
                    hold_wide_topk(f"flagship wide k={kw}", rows, kw, mode,
                                   select_alone))
        ones = torch.zeros((TOPK_BATCH, a, c), dtype=torch.bfloat16,
                           device="cuda")
        wide.append(hold_topk("rows of one value, wide", ones, 16384,
                              "packed", reps=WIDE_TOPK_REPS))
        wide.append(hold_wide_topk("rows of one value, radix", ones, 50000,
                                   "packed", select_alone))
        del ones
        # the radix sort's record: the skip_nms lane's selection of every
        # anchor, on its own input (the scores)
        radix = hold_wide_topk("flagship skip_nms lane, every anchor",
                               torch.sigmoid(logits), a, "f32",
                               select_alone)
        wide.append(radix)
        for batch in (8, 1):
            for kw in WIDE_TOPK_GLOBAL_KS:
                for mode, rows in (("bf16", bf), ("f32", logits)):
                    wide.append(hold_wide_topk(
                        f"global lane batch {batch} k={kw}",
                        rows[:batch].reshape(batch, a * c, 1), kw, mode,
                        select_alone))
        cases.extend(wide)
        for anchors, label in TOPK_ZOO_ANCHORS:
            zoo = torch.from_numpy(rng.normal(
                TOPK_PRIOR, 1.5, (TOPK_BATCH, anchors, c)).astype(
                    np.float32)).cuda().to(torch.bfloat16)
            mode = "packed" if anchors <= 1 << 17 else "bf16"
            cases.append(hold_topk(f"{label} default lane", zoo, k, mode))
            if anchors == TOPK_ZOO_ANCHORS[-1][0]:
                cases.append(hold_topk(f"{label} skip_nms lane",
                                       zoo.to(torch.float32), pre_k, "f32",
                                       timed=False))
            del zoo
        torch.cuda.empty_cache()

    # the main path: the flagship request at batch 1 and 8, both lanes
    exact_tree = params.to_dict()
    exact_tree["inference"]["use_approx_top_k"] = False
    lanes = {"default": default_serve,
             "exact": build_serving_fn(from_dict(exact_tree), device="cuda",
                                       model=model)}
    kernel = topk_kernel.kernel
    kernel.reset_counts()
    request = {}
    for lane, serve in lanes.items():
        for bs in (8, 1):
            host, _ = served_ms(serve, images[bs], TOPK_REQUESTS)
            request[f"{lane} batch {bs}"] = {"host_ms": host}
    launches, launches_by = kernel.launches, dict(kernel.launches_by)
    by_design = dict(kernel.launches_by_design)
    served = 2 * (TOPK_REQUESTS + 1)
    check(launches_by == {"packed": served, "f32": 3 * served},
          f"top-k launches by mode {launches_by} for {served} requests a "
          "lane (default: packed + f32 a request; exact: f32 twice)")
    check(by_design == {"slab": 2 * served, "row": 2 * served},
          f"top-k launches by design {by_design} for {served} requests a "
          "lane (each: its per-class selection on slab, the NMS "
          "survivors' on row)")
    for lane, serve in lanes.items():
        for bs in (8, 1):
            busy = request_device_ms(serve, images[bs])[0]
            request[f"{lane} batch {bs}"]["device_busy_ms"] = busy
            print(f"[topk] flagship {lane} lane, batch {bs}: request "
                  f"{request[f'{lane} batch {bs}']['host_ms']:.3f} ms (host, "
                  f"median of {TOPK_REQUESTS}), device busy {busy:.3f} ms")
    traces = {}
    for lane, serve in lanes.items():
        names = kernels_on_card("top_k_rows",
                                lambda: serve(images[8]))
        traces[lane] = sort_kernels(names)
        counts = {t: sum(t in n for n in names) for t in TOPK_KERNEL_NAMES}
        check(counts == {"slab_select_kernel": 1, "slab_final_kernel": 1,
                         "row_select_kernel": 1},
              f"{lane} lane: top-k kernels {counts} in a request (the slab "
              "design's two on the per-class selection, row's one on the "
              "NMS survivors)")
    check(not traces["default"],
          f"sort kernels in a default-lane request: {traces['default']}")
    print("[topk] a request of either lane ran slab_select_kernel, "
          "slab_final_kernel and row_select_kernel once each, and the "
          "default lane no sort kernel; the exact lane's sort kernels: "
          f"{traces['exact']}")
    for path, count in TOPK_PATHS.items():
        check(count > 0, f"top-k kernel launched no time on {path}")
    radix_path = phase_radix_path(model, images)
    # the row design's record on the seeded survivors, the rows its earlier
    # records were timed on; the real and trained-like ones beside them
    main = cases[0]
    tail = next(case for case in cases if case["case"] == "NMS survivors")
    common = {"route": "cuda", "source": "retinanet_torch/csrc/topk.cu",
              "max_abs_err": 0.0, "bound_by": "bytes",
              "library": "torch.topk along the anchors (no tie order)"}
    return [
        {"name": "top_k_slab", **common,
         "replaces": "retinanet_tpu/ops/postprocess.py:54",
         "replaces_note": "approx_max_k_packed / lax.approx_max_k and "
                          "lax.top_k, XLA paths (no Pallas kernel); two "
                          "launches a selection",
         "launches": by_design["slab"], "ms": main["slab_ms"],
         "row_ms": main["row_ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "library_ms": main["torch_topk_ms"],
         "sort_lane_ms": main["sort_lane_ms"],
         "phase_ms": main["slab_phase_ms"],
         "work": f"the default lane's selection of a batch-8 flagship "
                 f"request ({main['shape']}, k={main['k']})",
         "launches_by": launches_by, "launches_by_design": by_design,
         "cases": cases, "wide_cases": wide, "request": request,
         "launches_on_paths": dict(TOPK_PATHS)},
        {"name": "top_k_rows", **common,
         "replaces": "retinanet_tpu/ops/postprocess.py:326",
         "replaces_note": "lax.top_k over the NMS survivors, an XLA path "
                          "(no Pallas kernel)",
         "launches": by_design["row"], "ms": tail["row_ms"],
         "slab_ms": tail["slab_ms"], "plain_ms": tail["plain_ms"],
         "bound_ms": tail["bound_ms"], "library_ms": tail["torch_topk_ms"],
         "floor_ms": survivor_cases[0]["floor_ms"],
         "survivor_cases": survivor_cases,
         "work": f"the top-k over a batch-8 request's NMS survivors, "
                 f"seeded ({tail['shape']}, k={tail['k']}); "
                 f"survivor_cases: the real ones of a zero-bias request "
                 f"and trained-like rows at batch 8 and 1"},
        {"name": "top_k_radix_sort", **common,
         "replaces": "retinanet_tpu/ops/postprocess.py:326",
         "replaces_note": "the order of lax.top_k's k past 8,192 "
                          "winners, an XLA path (no Pallas kernel); "
                          "before, the on-chip sort up to 16,384 and the "
                          "bitonic network through global memory past "
                          "it (bitonic_ms)",
         "launches": radix_path["launches_by_sort"]["radix"],
         "ms": radix["ms"], "sort_ms": radix["sort_ms"],
         "select_ms": radix["select_ms"], "bitonic_ms": radix["bitonic_ms"],
         "plain_ms": radix["plain_ms"], "bound_ms": radix["bound_ms"],
         "sort_floor_ms": radix["sort_floor_ms"],
         "library_ms": radix["torch_topk_ms"],
         "work": f"the selection of every anchor of each class of a batch-8 "
                 f"flagship request in the skip_nms lane ({radix['shape']}, "
                 f"f32, k={radix['k']}): ms the slab selection with its "
                 "radix sort, sort_ms the sort's share (the selection less "
                 "the select launch alone), bound the function's (one "
                 "read, the outputs), sort_floor_ms the radix sort's "
                 "passes' bytes",
         "main_path": radix_path,
         "under_torch_topk": [
             {"case": w["case"], "mode": w["mode"], "k": w["k"],
              "ms": w["ms"], "torch_topk_ms": w["torch_topk_ms"]}
             for w in wide if w.get("sort") == "radix"]}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from retinanet_torch.core.config import Config
    from retinanet_torch.ops import (int8_conv_kernel, match_kernel,
                                     nms_kernel, topk_kernel)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    from retinanet_torch.tools.topk_experiments import (
        launch_floor_library, select_alone_library)
    kernels = (nms_kernel.kernel, match_kernel.kernel,
               int8_conv_kernel.kernel, topk_kernel.kernel)
    topk_floor = launch_floor_library()
    topk_select_alone = select_alone_library()
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels) + 2) as pool:
        for future in [pool.submit(k.build)
                       for k in (*kernels, topk_floor, topk_select_alone)]:
            future.result()
    print(f"[build] {len(kernels)} kernels, the top-k launch floor and its "
          "select launch alone built side by side in "
          f"{time.perf_counter() - start:.2f} s")
    for k in kernels:
        print(f"[build] {k.source.name} built in {k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.source.name}: {line.strip()}")
    params = Config(str(FLAGSHIP)).params

    start = time.perf_counter()
    worst = phase_nms_kernel()
    print(f"[phase 3] took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    match_err = phase_match_kernel(params)
    serve_record = phase_serving(params, worst)
    train_record, step_images_per_s = phase_training(params, match_err)
    records = [serve_record, train_record, phase_channel_stats()]
    print(f"[phases 4-7] took {time.perf_counter() - start:.1f} s")
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
        records += [int8_record, int8_record.pop("stem_kernel")]
        print(f"[phase 12] took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        host_launches, host_eval = phase_host_data(
            Path(tmp) / "host", Path(tmp) / "export" / "artifact")
        print(f"[phase 13] took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        obs_launches, observability = phase_observability(
            Path(tmp) / "observability")
        print(f"[phase 14] took {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        spatial_launches, spatial_record = phase_spatial(
            Path(tmp) / "spatial")
        print(f"[phase 15] took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    records.extend(phase_topk(topk_floor, topk_select_alone))
    print(f"[phase 16] took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    soft = phase_soft_nms()
    print(f"[phase 17] took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    long = phase_long_nms()
    print(f"[phase 18] took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    wide = phase_wide_serving()
    print(f"[phase 19] took {time.perf_counter() - start:.1f} s")
    phase3_cluster = next(row for row in WIDE_NMS_SHAPES
                          if row["design"] == "cluster")
    records.append({
        "name": "nms_cluster", "route": "cuda",
        "source": "retinanet_torch/csrc/nms.cu",
        "replaces": "retinanet_tpu/ops/pallas/nms_kernel.py:36",
        "replaces_note": "the soft lanes of _nms_kernel past 8,192 "
                         "candidates and under a negative threshold",
        "launches": wide.pop("launches"),
        "max_abs_err": max(wide.pop("max_abs_err"),
                           serve_record["max_abs_err"]),
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": None,
        "work": f"PerClassSoftNMS lanes of a batch-8 flagship request at "
                f"pre_nms_top_k = nms_top_k = {WIDE_K}",
        "first_seeded_case": phase3_cluster["case"],
        "launches_on_wide_paths": wide["launches_on_wide_paths"],
        "topk_launches_on_wide_paths": wide["topk_launches_on_wide_paths"],
        "wide_shapes": WIDE_NMS_SHAPES})
    next(r for r in records if r["name"] == "top_k_radix_sort")[
        "launches_on_wide_paths"] = wide.pop(
            "topk_sort_launches_on_wide_paths")
    serve_record["max_abs_err"] = max(serve_record["max_abs_err"],
                                      soft.pop("max_abs_err"),
                                      long.pop("max_abs_err"))
    serve_record.update(soft, soft_design="decay",
                        soft_shapes=SOFT_NMS_SHAPES)
    serve_record.update(long, long_designs=["scan", "compact"],
                        long_shapes=LONG_NMS_SHAPES)
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
    for record in records:
        if record["name"] in host_launches:
            record["launches_on_host_data_path"] = host_launches[
                record["name"]]
        if record["name"] in obs_launches:
            record["launches_on_observability_path"] = obs_launches[
                record["name"]]
        if record["name"] in spatial_launches:
            record["launches_on_spatial_path"] = spatial_launches[
                record["name"]]
    print(json.dumps({"spatial": spatial_record}))
    print(json.dumps({"observability": observability}))
    print(json.dumps({"host_coco_eval": host_eval}))
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
