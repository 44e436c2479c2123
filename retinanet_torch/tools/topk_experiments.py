"""The top-k kernel's slab design on the card: its candidate buffer's
capacity and one-edit variants of `csrc/topk.cu`, each timed with its
phases (the kernel's own %globaltimer stamps) beside the base build.

Cases: the flagship's batch-8 fused logits (the seeded model with the
class bias at 0, as `chip_smoke.py` phase 16 makes them: ~2,400 distinct
bf16 values in a row of 76,725, so the k-th value ties heavily) in the
default ("packed") and the exact ("f32") lane, the same at batch 1, and
normal logits around the class prior at the flagship's shape. A variant
whose name starts with "cut:" computes something else and is timed only;
every other one must equal the plain version, or the tool exits 1.

    python -m retinanet_torch.tools.topk_experiments \\
        [--out chiprun_out/topk_experiments.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from retinanet_torch.ops import topk_kernel as tk
from retinanet_torch.tools.kernel_variants import (build_all, card_line,
                                                   variant_library)

CAPACITIES = (4096, tk.SLAB_CAPACITY)
VARIANTS = {
    "no stage: candidates straight to their buffers": [
        ("    st.on = readies > 0;", "    st.on = false;")],
    "four bf16 vectors a thread a round": [
        ("  constexpr int kU = F32 ? 4 : 2;", "  constexpr int kU = 4;")],
    "cut: the loads alone": [
        ("      if (!mine || vi >= nv) continue;\n",
         "      if (!mine || vi >= nv) continue;\n"
         "      run_cnt ^= cur[u].x ^ cur[u].y ^ cur[u].z ^ cur[u].w;\n"
         "      continue;\n"),
        ("  if (RUNS) run_close<true>(hist, run_idx, run_cnt);\n",
         "  if (run_cnt == 0x9E3779B9u) hist[0] = 1u;\n"
         "  if (RUNS) run_close<true>(hist, run_idx, run_cnt);\n")],
    "cut: the loads alone, four bf16 vectors a round": [
        ("  constexpr int kU = F32 ? 4 : 2;", "  constexpr int kU = 4;"),
        ("      if (!mine || vi >= nv) continue;\n",
         "      if (!mine || vi >= nv) continue;\n"
         "      run_cnt ^= cur[u].x ^ cur[u].y ^ cur[u].z ^ cur[u].w;\n"
         "      continue;\n"),
        ("  if (RUNS) run_close<true>(hist, run_idx, run_cnt);\n",
         "  if (run_cnt == 0x9E3779B9u) hist[0] = 1u;\n"
         "  if (RUNS) run_close<true>(hist, run_idx, run_cnt);\n")],
    "cut: no candidate written": [
        ("      if (ready_hits) {\n", "      if (ready_hits && tid < 0) {\n")],
}
PRIOR = -4.59511985


def flagship_logits(batch: int = 8) -> torch.Tensor:
    """The flagship's fused class logits (B, A, 80) in float32 on the card,
    as `chip_smoke.py` phase 16 makes them."""
    from pathlib import Path

    from retinanet_torch.core.config import Config
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.profile_serving import zero_class_prior
    config = (Path(__file__).resolve().parents[2] / "configs" / "v3-8"
              / "mscoco-retinanet-resnet50-640x640-30x-64.json")
    params = Config(str(config)).params
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    h, w = params.input.input_shape
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, h, w, 3)).astype(np.uint8))
    fused = build_serving_fn(params, mode="onnx", device="cuda", model=model)
    with torch.inference_mode():
        return fused(images)["class_logits"]


def measure(x: torch.Tensor, k: int, mode: str, capacity=None,
            library=None) -> dict:
    from retinanet_torch.ops.topk import top_k_rows_plain
    from retinanet_torch.utils.benchmark import device_time_ms
    want = top_k_rows_plain(x, k, mode)
    got = tk.launch(x, k, mode, design="slab", capacity=capacity,
                    library=library)
    torch.cuda.synchronize()
    view = torch.int32 if mode == "f32" else torch.int16
    exact = (torch.equal(got[1], want[1])
             and torch.equal(got[0].view(view), want[0].view(view)))
    ms = device_time_ms(lambda: tk.launch(
        x, k, mode, design="slab", capacity=capacity, library=library), 10)
    trace = tk.slab_trace(x, k, mode, capacity=capacity, library=library)
    return {"ms": ms, "exact": exact, "levels": trace["levels"],
            "rows_active": trace["rows_active"],
            "candidates": trace["candidates"],
            "phase_ms": {name: ns / 1e6
                         for name, ns in trace["phase_ns"].items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="JSONL of the results")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_experiments: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}", flush=True)
    variants = {name: variant_library(tk.kernel, tk.declare, name, edits)
                for name, edits in VARIANTS.items()}
    build_all([tk.kernel, *variants.values()])
    logits = flagship_logits(8)
    rng = np.random.default_rng(0)
    normal = torch.from_numpy(rng.normal(PRIOR, 1.5, logits.shape).astype(
        np.float32)).cuda()
    cases = {"flagship default lane": (logits.to(torch.bfloat16), "packed"),
             "flagship exact lane": (logits, "f32"),
             "flagship default lane, batch 1": (
                 logits[:1].to(torch.bfloat16).contiguous(), "packed"),
             "normal logits, default lane": (normal.to(torch.bfloat16),
                                             "packed")}
    results, failed = [], False
    for label, (x, mode) in cases.items():
        runs = [(f"base, capacity {cap}", cap, None) for cap in CAPACITIES]
        runs += [(name, None, lib) for name, lib in variants.items()]
        for name, cap, lib in runs:
            res = {"case": label, "shape": list(x.shape), "mode": mode,
                   "k": 256, "run": name, "card": card,
                   **measure(x, 256, mode, cap, lib)}
            failed |= not res["exact"] and not name.startswith("cut:")
            results.append(res)
            print(f"[topk] {label} / {name}: {res['ms']:.4f} ms, "
                  f"{'exact' if res['exact'] else 'differs'}, levels "
                  f"{res['levels']} {res['rows_active']}, "
                  f"{res['candidates']} candidates; "
                  + ", ".join(f"{p} {v:.4f}"
                              for p, v in res["phase_ms"].items()),
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
