"""Matching kernel experiments on the card: where the time of a call goes at
a light load, and how the shape of a CTA trades the light load against the
heavy one.

    python -m retinanet_torch.tools.match_experiments

The flagship anchors (76,725) with 8 images of 100 boxes: one valid box an
image, the synthetic train batch (`synthetic_train_batch(8, ...)`, 34 valid
boxes), and every box valid (800). It runs on the card only and prints
device times (`utils/benchmark.py:device_time_ms`) beside the card's name
and power limit.

Each variant is `csrc/match.cu` with one edit, compiled beside the package's
build. The shape variants (threads of a CTA x anchors of a thread) compute
the same function and must equal the plain version. The two cut variants do
not: one returns before the ticket (no per-box decode and no per-anchor
store), one at once (the cost of a launch of this grid); they are timed only,
and the scratch is zeroed behind them.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from retinanet_torch.ops import match_kernel
from retinanet_torch.ops.match import match_lanes_plain
from retinanet_torch.tools.kernel_variants import (Edits, build_all,
                                                   card_line,
                                                   variant_library)
from retinanet_torch.utils.benchmark import device_time_ms

_REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = (_REPO / "configs" / "v3-8"
            / "mscoco-retinanet-resnet50-640x640-30x-64.json")


def _shape(threads: int, per_thread: int) -> Edits:
    return [("constexpr int kThreads = 128;",
             f"constexpr int kThreads = {threads};"),
            ("constexpr int kPerThread = 3; ",
             f"constexpr int kPerThread = {per_thread}; ")]


VARIANTS: Dict[str, Edits] = {
    "256 threads x 1 anchor": _shape(256, 1),
    "256 threads x 2 anchors": _shape(256, 2),
    "256 threads x 3 anchors": _shape(256, 3),
    "128 threads x 2 anchors": _shape(128, 2)[1:],
    "128 threads x 4 anchors": _shape(128, 4)[1:],
    "128 threads x 6 anchors": _shape(128, 6)[1:],
    "cut: returns before the ticket": [
        ("  __syncthreads();\n  if (tid == 0) {\n    __threadfence();  // the "
         "CTA's keys", "  return;\n  if (tid == 0) {\n    __threadfence();  "
         "// the CTA's keys")],
    "cut: returns at once": [
        ("  extern __shared__ unsigned long long smem[];",
         "  return;\n  extern __shared__ unsigned long long smem[];")],
}


def loads(anchor_gen):
    """name -> (gt_boxes (8, G, 4), gt_valid (8, G)) on the card."""
    from retinanet_torch.data.synthetic import synthetic_train_batch
    h, w = anchor_gen.image_height, anchor_gen.image_width
    rng = np.random.default_rng(0)
    gt = np.stack([rng.uniform(0.1 * w, 0.9 * w, (8, 100)),
                   rng.uniform(0.1 * h, 0.9 * h, (8, 100)),
                   rng.uniform(0.03 * w, 0.5 * w, (8, 100)),
                   rng.uniform(0.03 * h, 0.5 * h, (8, 100))],
                  -1).astype(np.float32)
    gt = torch.from_numpy(gt).cuda()
    batch = synthetic_train_batch(8, (h, w), 100, 80, seed=0)
    every = torch.ones((8, 100), dtype=torch.bool, device="cuda")
    return {
        "one box an image": (gt[:, :1].contiguous(), every[:, :1].clone()),
        "train batch, 34 valid": (torch.from_numpy(batch["boxes"]).cuda(),
                                  torch.from_numpy(batch["valid"]).cuda()),
        "all 800 valid": (gt, every),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("match_experiments: no CUDA device; this tool runs on the card "
              "only", file=sys.stderr)
        return 1
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    card = card_line()
    print(f"[card] {card}")
    libraries = {"as built: 128 threads x 3 anchors": match_kernel.kernel}
    libraries.update({name: variant_library(
        match_kernel.kernel, match_kernel.declare, name, edits)
        for name, edits in VARIANTS.items()})
    build_all(libraries.values())

    anchor_gen = from_params(Config(str(FLAGSHIP)).params)
    anchors = torch.from_numpy(anchor_gen.boxes).cuda()
    for load, (gt, valid) in loads(anchor_gen).items():
        want = match_lanes_plain(anchors, gt, valid)
        for name, lib in libraries.items():
            got = match_kernel.launch(anchors, gt, valid, library=lib)
            torch.cuda.synchronize()
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            if not name.startswith("cut") and not equal:
                raise RuntimeError(f"{name} differs from plain at {load}")
            ms = device_time_ms(
                lambda: match_kernel.launch(anchors, gt, valid, library=lib),
                reps=50)
            if name.startswith("cut"):   # it left keys or tickets behind
                torch.cuda.synchronize()
                for buf in match_kernel._scratch.values():
                    buf.zero_()
            print(f"[time] {load} | {name}: {ms:.4f} ms"
                  + ("" if not name.startswith("cut") else " (timed only)"))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
