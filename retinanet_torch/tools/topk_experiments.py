"""The top-k kernel's two designs on the card, each beside one-edit
variants of `csrc/topk.cu`.

`--design slab` (the default): the slab design's candidate buffer's
capacity and its variants, each timed with its phases (the kernel's own
%globaltimer stamps) beside the base build. Cases: the flagship's batch-8
fused logits (the seeded model with the class bias at 0, as
`chip_smoke.py` phase 16 makes them: ~2,400 distinct bf16 values in a row
of 76,725, so the k-th value ties heavily) in the default ("packed") and
the exact ("f32") lane, the same at batch 1, and normal logits around the
class prior at the flagship's shape.

`--design row`: the top-k over the NMS survivors (k = max_detections =
100) at batch 8 and 1 on the real survivors of a zero-bias flagship
request (`_per_class_nms`'s input to `top_k`), on trained-like rows (a few
kept scores a class, >= 95% -1.0 fill) and on the seeded rows of
`chip_smoke.py` phase 16 (30% -1.0, 1/64 steps): the row design beside
cuts that end it after a step (`ROW_CUTS`: their differences are the
steps' times), the launch floor (the same launch of a kernel that returns
at once, `launch_floor_library`), the slab design, `torch.topk`, the plain
version, the bytes bound, and with `--parent DIR` the row design of
another tree's `csrc/topk.cu` (the same C interface), each timed twice in
turns.

A variant whose name starts with "cut:" computes something else and is
timed only; every other one must equal the plain version, or the tool
exits 1.

    python -m retinanet_torch.tools.topk_experiments [--design row] \\
        [--parent DIR] [--out chiprun_out/topk_experiments.jsonl]
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
# the row design cut after a step (timed only: their differences are the
# steps' times)
ROW_CUTS = {
    "cut: the row's read": [
        ("    hist_words[i] = make_uint4(0u, 0u, 0u, 0u);\n  }\n"
         "  __syncthreads();\n",
         "    hist_words[i] = make_uint4(0u, 0u, 0u, 0u);\n  }\n"
         "  __syncthreads();\n"
         "  if (n > 0) {\n    uint32_t acc = live;\n"
         "    for (int j = 0; j < ITEMS; ++j) acc ^= key[j];\n"
         "    if (acc == 0x9E3779B9u) out_idx[0] = 0;\n    return;\n  }\n")],
    "cut: the read and the passes": [
        ("  // 2. the k winners into shared memory",
         "  if (n > 0) {\n    if ((prefix ^ live ^ win) == 0x9E3779B9u) "
         "out_idx[0] = 0;\n    return;\n  }\n"
         "  // 2. the k winners into shared memory")],
    "cut: all but the sort": [
        ("  __syncthreads();\n\n  // 3. the k winners sorted",
         "  __syncthreads();\n  if (n > 0) {\n"
         "    if (tid == 0 && keys[0] == 0x9E3779B9ull) out_idx[0] = 0;\n"
         "    return;\n  }\n\n  // 3. the k winners sorted")],
}
LAUNCH_FLOOR = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const unsigned row = blockIdx.x;\n",
     "  if (n > 0) return;\n"
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const unsigned row = blockIdx.x;\n")]
PRIOR = -4.59511985
SURVIVORS_K = 100


def launch_floor_library():
    """`csrc/topk.cu` with the row design's kernel returning at its entry:
    the same grid, threads, shared memory and host path, no work. On no
    route: measurements only."""
    return variant_library(tk.kernel, tk.declare, "cut: launch floor",
                           LAUNCH_FLOOR)


def capture_survivors(serve, images) -> torch.Tensor:
    """The float32 scores that one request's `_per_class_nms` hands to
    `top_k` (B, C * max_detections): the NMS survivors, -1.0 where a
    class kept fewer than max_detections."""
    from retinanet_torch.ops import postprocess
    seen = []
    top_k = postprocess.top_k

    def recording(x, k):
        seen.append(x.detach().clone())
        return top_k(x, k)

    postprocess.top_k = recording
    try:
        with torch.inference_mode():
            serve(images)
    finally:
        postprocess.top_k = top_k
    if len(seen) != 1:
        raise RuntimeError(f"a request called top_k {len(seen)} times")
    return seen[0]


def trained_like_survivors(batch: int, n: int = 8000, seed: int = 0,
                           md: int = 100) -> torch.Tensor:
    """Seeded rows (B, n, 1) like a trained head's survivors: each class's
    md slots hold 0-8 kept scores in descending order, then -1.0 (>= 95%
    of the row)."""
    rng = np.random.default_rng(seed)
    x = np.full((batch, n, 1), -1.0, np.float32)
    for b in range(batch):
        for start in range(0, n, md):
            kept = rng.integers(0, 9)
            x[b, start:start + kept, 0] = np.sort(
                rng.uniform(0.05, 1.0, kept))[::-1]
    return torch.from_numpy(x).cuda()


def seeded_survivors(batch: int, n: int = 8000, seed: int = 16
                     ) -> torch.Tensor:
    """The rows of `chip_smoke.py` phase 16's first survivors case: 30%
    -1.0, the rest 1/64 steps in [0.05, 1]."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.uniform(size=(batch, n, 1)) < 0.3, -1.0,
                 np.round(rng.uniform(0.05, 1.0, (batch, n, 1)) * 64) / 64)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def time_row(x: torch.Tensor, libraries: dict, reps: int = 200) -> dict:
    """Each library's row design on x (B, n, 1) against the plain version,
    timed twice in turns (forward, then backward through `libraries`),
    beside the slab design, `torch.topk`, the plain version and the bytes
    bound. Names starting with "cut:" are timed only."""
    from retinanet_torch.ops.topk import top_k_rows_plain
    from retinanet_torch.utils.benchmark import device_time_ms
    k, mode = SURVIVORS_K, "f32"
    want_v, want_i = top_k_rows_plain(x, k, mode)
    exact = {}
    for name, lib in libraries.items():
        got_v, got_i = tk.launch(x, k, mode, design="row", library=lib)
        torch.cuda.synchronize()
        exact[name] = (torch.equal(got_i, want_i) and torch.equal(
            got_v.view(torch.int32), want_v.view(torch.int32)))
    ms = {name: [] for name in libraries}
    for name in [*libraries, *reversed(libraries)]:
        lib = libraries[name]
        ms[name].append(device_time_ms(
            lambda: tk.launch(x, k, mode, design="row", library=lib), reps))
    b, n, c = x.shape
    nbytes = x.numel() * 4 + b * c * k * 8
    return {"shape": [b, n, c], "k": k, "exact": exact, "ms": ms,
            "fill_share": float((x == -1.0).float().mean()),
            "slab_ms": device_time_ms(
                lambda: tk.launch(x, k, mode, design="slab"), 50),
            "torch_topk_ms": device_time_ms(
                lambda: torch.topk(x, k, dim=1), reps),
            "plain_ms": device_time_ms(
                lambda: top_k_rows_plain(x, k, mode), 20),
            "bound_ms": nbytes / 3.35e12 * 1e3}


def row_main(args, card: str) -> int:
    from pathlib import Path
    libraries = {"row": tk.kernel}
    if args.parent:
        libraries["parent row"] = tk.TopkLibrary(
            "topk_parent", source=Path(args.parent) / "retinanet_torch"
            / "csrc" / "topk.cu")
    libraries.update({name: variant_library(tk.kernel, tk.declare, name, e)
                      for name, e in ROW_CUTS.items()})
    libraries["cut: launch floor"] = launch_floor_library()
    build_all(libraries.values())
    serve, images = flagship_request()
    cases = {}
    for bs in (8, 1):
        real = capture_survivors(serve, images[:bs])
        cases[f"real survivors, batch {bs}"] = real[..., None].contiguous()
        cases[f"trained-like, batch {bs}"] = trained_like_survivors(bs)
        cases[f"seeded, batch {bs}"] = seeded_survivors(bs)
    results, failed = [], False
    for label, x in cases.items():
        res = {"case": label, "card": card, **time_row(x, libraries)}
        failed |= not all(ok for name, ok in res["exact"].items()
                          if not name.startswith("cut:"))
        results.append(res)
        print(f"[topk row] {label} ({res['shape']}, k={res['k']}, -1.0 "
              f"share {res['fill_share']:.4f}): "
              + ", ".join(f"{name} " + " / ".join(f"{v:.5f}" for v in t)
                          + ("" if res["exact"][name] or name.startswith(
                              "cut:") else " DIFFERS")
                          for name, t in res["ms"].items())
              + f"; slab {res['slab_ms']:.5f}, torch.topk "
              f"{res['torch_topk_ms']:.5f}, plain {res['plain_ms']:.4f}, "
              f"bound {res['bound_ms']:.6f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
    return 1 if failed else 0


def flagship_request(batch: int = 8):
    """The flagship's serving function in the default lane on the seeded
    model with the class bias at 0, and seeded images (B, H, W, 3)."""
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
    return build_serving_fn(params, device="cuda", model=model), images


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
    parser.add_argument("--design", choices=("slab", "row"), default="slab")
    parser.add_argument("--parent", default=None,
                        help="a tree whose csrc/topk.cu's row design is "
                             "timed beside this one's (--design row)")
    parser.add_argument("--out", default=None, help="JSONL of the results")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_experiments: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}", flush=True)
    if args.design == "row":
        return row_main(args, card)
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
