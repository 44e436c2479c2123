"""The top-k kernel's two designs on the card, each beside one-edit
variants of `csrc/topk.cu`.

`--design slab` (the default): the slab design's candidate buffer's
capacity and its variants, each timed with its phases (the kernel's own
%globaltimer stamps) beside the base build, and with `--parent DIR` the
slab design of another tree's `csrc/topk.cu`. Cases: the flagship's batch-8
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

`--design wide`: k past 8,192 winners on the flagship's batch-8 fused
logits (640 rows x 76,725) in "packed", "bf16" and "f32" (WIDE_KS: the
on-chip sort's last k, 8,192, then the radix sort's k up to every
anchor), and on the global lane at batch 8 and 1 (rows of 6,138,000,
GLOBAL_KS): past SORT_ON_CHIP_MAX the radix sort on both
designs, at 1, 2, 4 CTAs a row and a CTA a tile beside `radix_plan`'s
pick, the bitonic network it replaced (`sort="bitonic"`), the variants of
WIDE_VARIANTS (the select alone: its difference is the sort's time; 64-bit
keys where 32 bits hold them), at k <= SORT_ON_CHIP_MAX the on-chip sort
beside the radix sort; all timed in turns with `torch.topk` along the
anchors;
beside the plain version, the bytes bound and the radix sort's own floor
(`radix_floor_ms`).

A variant whose name starts with "cut:" computes something else and is
timed only; every other one must equal the plain version, or the tool
exits 1.

    python -m retinanet_torch.tools.topk_experiments [--design row|wide] \\
        [--parent DIR] [--out chiprun_out/topk_experiments.jsonl]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from retinanet_torch.ops import topk_kernel as tk
from retinanet_torch.ops.cuda_build import CudaLibrary
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
WIDE_KS = (8192, 8193, 16384, 16385, 24576, 32768, 49152, 76725)
GLOBAL_KS = (16385, 76725)
# the radix sort's variants (k > SORT_ON_CHIP_MAX only)
WIDE_VARIANTS = {
    "cut: the select alone": [
        ("  const RadixPlan p = radix_plan(rows, k, vbits + ibits, "
         "segments);\n",
         "  const RadixPlan p = radix_plan(rows, k, vbits + ibits, "
         "segments);\n  if (rows > 0) return 0;\n")],
    "64-bit keys": [("  p.key_bytes = key_bits <= 32 ? 4 : 8;",
                     "  p.key_bytes = 8;")],
}


def launch_floor_library():
    """`csrc/topk.cu` with the row design's kernel returning at its entry:
    the same grid, threads, shared memory and host path, no work. On no
    route: measurements only."""
    return variant_library(tk.kernel, tk.declare, "cut: launch floor",
                           LAUNCH_FLOOR)


def declare_on_chip(lib) -> None:
    """The launches of k <= SORT_ON_CHIP_MAX, whose C interface an older
    tree's `csrc/topk.cu` shares (its wide launches differ)."""
    lib.topk_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_rows_launch.restype = ctypes.c_int
    lib.topk_slab_launch.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.topk_slab_launch.restype = ctypes.c_int
    lib.topk_error_string.argtypes = [ctypes.c_int]
    lib.topk_error_string.restype = ctypes.c_char_p


def parent_library(tree: str) -> CudaLibrary:
    """Another tree's `retinanet_torch/csrc/topk.cu`, built for its
    launches at k <= SORT_ON_CHIP_MAX."""
    from pathlib import Path
    return CudaLibrary("topk_parent", declare_on_chip, source=Path(tree)
                       / "retinanet_torch" / "csrc" / "topk.cu")


def select_alone_library():
    """`csrc/topk.cu` with the radix sort returning at once: a wide
    selection's select launch alone (its outputs unwritten), whose time
    taken from the whole selection's is the sort's. On no route:
    measurements only."""
    name = "cut: the select alone"
    return variant_library(tk.kernel, tk.declare, name, WIDE_VARIANTS[name])


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
    libraries = {"row": tk.kernel}
    if args.parent:
        libraries["parent row"] = parent_library(args.parent)
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


def radix_floor_ms(x: torch.Tensor, k: int, mode: str, values,
                   idx) -> float:
    """The radix sort's own floor at 3.35 TB/s: its passes' bytes for these
    winners (the selection's outputs `values`, `idx`): the prepare read of
    the 64-bit winners and write of the compact keys, then for each row
    every pass its digit does not skip reading and writing the keys, the
    last writing values and int32 indices in their place."""
    from retinanet_torch.ops.topk import value_key
    b, n, c = x.shape
    _, vbits, ibits = tk.radix_layout(n, mode, "slab")
    plan = tk.radix_plan(b * c, k, vbits + ibits)
    vkey = value_key(values, mode, n)
    key = (vkey << ibits) | ((1 << ibits) - 1 - idx.long())
    key = key.reshape(b * c, k)
    moved = torch.zeros(b * c, dtype=torch.int64, device=x.device)
    for shift, bits in plan.digits:
        digit = (key >> shift) & ((1 << bits) - 1)
        moved += (digit != digit[:, :1]).any(1).long()
    kb = plan.key_bytes
    per_key = (8 + kb + (2 * moved.clamp(min=1) - 1) * kb
               + x.element_size() + 4)
    return float(per_key.sum()) * k / 3.35e12 * 1e3


def wide_case(x: torch.Tensor, k: int, mode: str, variants: dict,
              card: str, sweep: bool = True, reps: int = 5) -> dict:
    """One wide case, every run index- and value-exact to the plain
    version (cuts timed only), timed twice in turns: past
    SORT_ON_CHIP_MAX the radix sort on both designs, the bitonic network
    and each of `variants` (built libraries, by name), with `sweep` the
    radix sort at 1, 2, 4 CTAs a row and a CTA a tile too; else the
    on-chip sort beside the radix sort."""
    from retinanet_torch.ops.topk import top_k_rows_plain
    from retinanet_torch.utils.benchmark import device_time_ms
    b, n, c = x.shape
    design = tk.topk_design(b, n, c, k)
    other = "row" if design == "slab" else "slab"
    runs = {}
    if k > tk.SORT_ON_CHIP_MAX:
        plan = tk.radix_plan(b * c, k, sum(tk.radix_layout(n, mode,
                                                           design)[1:]))
        runs["radix"] = lambda: tk.launch(x, k, mode)
        runs["bitonic"] = lambda: tk.launch(x, k, mode, sort="bitonic")
        runs[f"radix, {other}"] = lambda: tk.launch(x, k, mode,
                                                    design=other)
        for s in (sorted({1, 2, 4, plan.tiles} - {plan.segments})
                  if sweep else ()):
            runs[f"radix, {s} CTAs a row"] = (
                lambda s=s: tk.launch(x, k, mode, segments=s))
        for name, lib in variants.items():
            if name == "64-bit keys" and plan.key_bytes == 8:
                continue
            runs[f"radix, {name}"] = (
                lambda lib=lib: tk.launch(x, k, mode, library=lib))
    else:
        plan = None
        runs["on chip"] = lambda: tk.launch(x, k, mode)
        runs["radix"] = lambda: tk.launch(x, k, mode, sort="radix")
    want = top_k_rows_plain(x, k, mode)
    view = torch.int32 if mode == "f32" else torch.int16
    exact = {}
    for name, fn in runs.items():
        if "cut:" in name:
            continue
        got = fn()
        torch.cuda.synchronize()
        exact[name] = (torch.equal(got[1], want[1]) and torch.equal(
            got[0].view(view), want[0].view(view)))
        del got
    runs["torch.topk"] = lambda: torch.topk(x, k, dim=1)
    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(device_time_ms(runs[name], reps=reps))
    res = {"mode": mode, "shape": [b, n, c], "k": k, "design": design,
           "card": card, "exact": exact, "ms": times,
           "bound_ms": (x.numel() * x.element_size()
                        + b * c * k * (x.element_size() + 4)) / 3.35e12
           * 1e3}
    if plan is not None:
        res["plan"] = plan._asdict()
        res["sort_floor_ms"] = radix_floor_ms(x, k, mode, *want)
    del want
    res["plain_ms"] = device_time_ms(lambda: top_k_rows_plain(x, k, mode),
                                     reps=2)
    return res


def wide_main(args, card: str) -> int:
    variants = {name: variant_library(tk.kernel, tk.declare, name, edits)
                for name, edits in WIDE_VARIANTS.items()}
    build_all([tk.kernel, *variants.values()])
    logits = flagship_logits(8)
    bf = logits.to(torch.bfloat16)
    cases = [(f"flagship {mode}", rows, k, mode)
             for mode, rows in (("packed", bf), ("bf16", bf),
                                ("f32", logits))
             for k in WIDE_KS]
    for batch in (8, 1):
        for mode, rows in (("bf16", bf), ("f32", logits)):
            flat = rows[:batch].reshape(batch, -1, 1)
            cases += [(f"global lane, batch {batch}, {mode}", flat, k, mode)
                      for k in GLOBAL_KS]
    results, failed = [], False
    for label, x, k, mode in cases:
        res = {"case": label, **wide_case(x, k, mode, variants, card)}
        failed |= not all(res["exact"].values())
        results.append(res)
        print(f"[wide] {label} {res['shape']} k={k} ({res['design']}): "
              + ", ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ms)
                          + ("" if res["exact"].get(name, True)
                             else " DIFFERS")
                          for name, ms in res["ms"].items())
              + f" ms; bound {res['bound_ms']:.5f}"
              + (f", sort floor {res['sort_floor_ms']:.5f}"
                 if "sort_floor_ms" in res else "")
              + f", plain {res['plain_ms']:.3f}"
              + (f"; plan {res['plan']['segments']} CTAs a row, "
                 f"{len(res['plan']['digits'])} passes, "
                 f"{res['plan']['key_bytes']}-byte keys"
                 if "plan" in res else ""), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--design", choices=("slab", "row", "wide"),
                        default="slab")
    parser.add_argument("--parent", default=None,
                        help="a tree whose csrc/topk.cu's row or slab "
                             "design is timed beside this one's (--design "
                             "row, slab)")
    parser.add_argument("--out", default=None, help="JSONL of the results")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_experiments: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}", flush=True)
    if args.design == "row":
        return row_main(args, card)
    if args.design == "wide":
        return wide_main(args, card)
    variants = {name: variant_library(tk.kernel, tk.declare, name, edits)
                for name, edits in VARIANTS.items()}
    if args.parent:
        variants["parent"] = parent_library(args.parent)
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
