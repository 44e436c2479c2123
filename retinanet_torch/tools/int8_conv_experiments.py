"""Int8 conv kernel experiments on the card: where the time of the wgmma,
depthwise and narrow designs goes, at the shapes of the int8 lane.

    python -m retinanet_torch.tools.int8_conv_experiments \
        [--designs wgmma depthwise narrow]

Seven convs of a batch-8 flagship request, bfloat16 in and out, seeded
inputs, and the 7x7/2 stem a second time on the wgmma design (routed there
as if C = 3 were above `WGMMA_MIN_CHANNELS`: taps of 32 channels), which
says what keeping it on the mma_sync design saves; seven depthwise convs
of a batch-8 lite2 request; and the dense convs with C <= 16 of batch-8
lite2, MobileDet-cpu and MobileDet-edge_tpu requests, each a second time on
the other of the narrow and mma_sync designs (routed by
`NARROW_MIN_CHANNELS`: C <= 16 on mma_sync, what narrow replaced; the C = 3
stems on narrow). For each variant and case: the design, the device ms of
a call (`utils/benchmark.py:device_time_ms`), and the ms of its CUDA
kernels by name from a profiler trace (the quantizing pass and the GEMM),
beside the card's name and power limit.

A source variant is `csrc/int8_conv.cu` with one edit, compiled beside the
package's build; a plan variant (`DW_PLANS`, `NARROW_PLANS`) is the
depthwise or narrow plan of `ops/int8_conv_kernel.py` with one constant
changed (tile or item size, channel chunk, ring depth, staging tiles,
shared-memory budget), on the package's build. The cut variants (name
"cut: ...": no stores, no epilogue, no products, no quantization) compute
something else and are timed only; every other variant must equal the
plain version at every case, and the tool exits 1 when one does not.
`routed` and `NARROW_ROUTES` also serve `chip_smoke.py`, which times each
narrow call on mma_sync too.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict

import numpy as np
import torch

from retinanet_torch.models.layers import same_pads
from retinanet_torch.ops import int8_conv, int8_conv_kernel
from retinanet_torch.ops.int8_conv import int8_conv2d_plain, pack_weights
from retinanet_torch.tools.kernel_variants import (Edits, build_all,
                                                   card_line,
                                                   variant_library)
from retinanet_torch.utils.benchmark import device_time_ms

# (label, (N, H, W, C), O, k, stride, pads; None: "SAME")
SHAPES = (
    ("head 3x3 at P3", (8, 80, 80, 256), 256, 3, 1, None),
    ("3x3 bottleneck 40", (8, 40, 40, 256), 256, 3, 1, None),
    ("3x3 at P7", (8, 5, 5, 256), 256, 3, 1, None),
    ("1x1 160 64->256", (8, 160, 160, 64), 256, 1, 1, None),
    ("1x1 40 256->1024", (8, 40, 40, 256), 1024, 1, 1, None),
    ("1x1/2 projection", (8, 160, 160, 256), 512, 1, 2, None),
    ("stem 7x7/2", (8, 646, 646, 3), 64, 7, 2, (0, 0, 0, 0)),
)
# shapes timed a second time with every dense conv routed to wgmma
ON_WGMMA = ("stem 7x7/2",)
# (label, (N, H, W, C), k, stride): depthwise convs of a batch-8 lite2
# request ("SAME" pads)
DW_SHAPES = (
    ("dw 256 x32 3x3/1", (8, 256, 256, 32), 3, 1),
    ("dw 256 x96 3x3/2", (8, 256, 256, 96), 3, 2),
    ("dw 128 x144 3x3/1", (8, 128, 128, 144), 3, 1),
    ("dw 128 x144 5x5/2", (8, 128, 128, 144), 5, 2),
    ("dw 64 x160 3x3/1", (8, 64, 64, 160), 3, 1),
    ("dw 32 x720 5x5/1", (8, 32, 32, 720), 5, 1),
    ("dw 4 x160 3x3/1", (8, 4, 4, 160), 3, 1),
)
# (label, (N, H, W, C), O, k, stride, pads): dense convs with C <= 16 of
# batch-8 requests (lite2 and MobileDet-cpu's 1x1 convs and a squeeze-excite
# conv on a 1x1 map, MobileDet-edge_tpu's windows), and the C = 3 stems
NARROW_SHAPES = (
    ("lite2 1x1 256 16->96", (8, 256, 256, 16), 96, 1, 1, (0, 0, 0, 0)),
    ("mdc 1x1 224 8->32", (8, 224, 224, 8), 32, 1, 1, (0, 0, 0, 0)),
    ("mdc 1x1 224 16->8", (8, 224, 224, 16), 8, 1, 1, (0, 0, 0, 0)),
    ("mdc 1x1 112 16->128", (8, 112, 112, 16), 128, 1, 1, (0, 0, 0, 0)),
    ("mdc SE 1x1 8->32", (8, 1, 1, 8), 32, 1, 1, (0, 0, 0, 0)),
    ("edge 3x3 224 8->16", (8, 224, 224, 8), 16, 3, 1, (1, 1, 1, 1)),
    ("edge 3x3/2 224 16->128", (8, 224, 224, 16), 128, 3, 2, (0, 1, 0, 1)),
    ("edge 5x5/2 112 16->128", (8, 112, 112, 16), 128, 5, 2, (1, 2, 1, 2)),
    ("stem 3x3/2 448 3->16", (8, 448, 448, 3), 16, 3, 2, (0, 1, 0, 1)),
    ("stem 3x3/2 512 3->32", (8, 512, 512, 3), 32, 3, 2, (0, 1, 0, 1)),
    ("stem 7x7/2 646 3->64", (8, 646, 646, 3), 64, 7, 2, (0, 0, 0, 0)),
)
# the routes of a dense conv with C <= 16 to the other design
NARROW_ROUTES = {"mma_sync": {"NARROW_MIN_CHANNELS": 17},
                 "narrow": {"NARROW_MIN_CHANNELS": 1}}

VARIANTS: Dict[str, Edits] = {
    "non-persistent grid": [
        ("config.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles "
         ": sms));", "config.gridDim = dim3(static_cast<unsigned>(tiles));")],
    "no programmatic dependent launch": [
        ("early.val.programmaticStreamSerializationAllowed = 1;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim = dim3(static_cast<unsigned>(tiles < sms",
         "early.val.programmaticStreamSerializationAllowed = 0;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim = dim3(static_cast<unsigned>(tiles < sms")],
    "quantizing pass: one vector a thread, no grid-stride": [
        ("  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond "
         "that\n  int4* qt", "  int4* qt")],
    "quantizing pass: 512 threads a block": [
        ("constexpr int kQuantThreads = 256;",
         "constexpr int kQuantThreads = 512;")],
    "wait for each stage's products": [
        ("      wgmma_wait<1>();\n", "      wgmma_wait<0>();\n")],
    "at most 4 stages": [
        ("kFree / (kABytes + kBBytes) < 8 ? kFree / (kABytes + kBBytes) : 8",
         "kFree / (kABytes + kBBytes) < 4 ? kFree / (kABytes + kBBytes) : 4")],
    "one staging buffer": [
        ("uint8_t* buf = out + (ep & 1) * kOutBuf;", "uint8_t* buf = out;"),
        ("if (tid == 0) bulk_wait_read<1>();",
         "if (tid == 0) bulk_wait_read<0>();")],
    "cut: no stores to y": [
        ("if (tid == 0) tma_store_2d(", "if (tid == 0 && s.o < 0) "
                                         "tma_store_2d(")],
    "cut: no epilogue": [
        ("for (int part = 0; part < BN / kCols; ++part, ++ep) {",
         "for (int part = 0; part < BN / kCols * 0; ++part, ++ep) {")],
    "cut: no products": [
        ("        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);",
         "        if (s.o < 0) "
         "Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);")],
}

# one-edit variants of the depthwise design (source)
DW_VARIANTS: Dict[str, Edits] = {
    "dw: no programmatic dependent launch": [
        ("early.val.programmaticStreamSerializationAllowed = 1;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim = dim3(static_cast<unsigned>(dw_grid(",
         "early.val.programmaticStreamSerializationAllowed = 0;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim = dim3(static_cast<unsigned>(dw_grid(")],
    "cut: dw quantization without arithmetic": [
        ("  const float t = __fmul_rn(v, sc.inv);\n  const float tc",
         "  byte = __float_as_uint(v);\n  return true;\n  const float t = "
         "__fmul_rn(v, sc.inv);\n  const float tc")],
    "cut: dw quantization without the divisions in doubt": [
        ("    while (doubt != 0) {", "    while (doubt != 0 && s.c < 0) {")],
    "cut: dw without quantization": [
        ("    dw_quantize_box(reinterpret_cast<const TIn*>(smem + st * "
         "raw_stride), q,\n                    s, sc);\n", "")],
    "cut: dw without products and epilogue": [
        ("for (int b = worker; b < blocks; b += workers) {",
         "for (int b = worker; b < blocks * 0; b += workers) {")],
    "cut: dw without stores": [
        ("      tma_store_4d(&y_map, out,",
         "      if (s.c < 0) tma_store_4d(&y_map, out,")],
}
# one-edit variants of the narrow design (source)
NARROW_VARIANTS: Dict[str, Edits] = {
    "narrow: no programmatic dependent launch": [
        ("early.val.programmaticStreamSerializationAllowed = 1;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim =\n      dim3(static_cast<unsigned>(s.items < "
         "resident",
         "early.val.programmaticStreamSerializationAllowed = 0;\n"
         "  cudaLaunchConfig_t config = {};\n"
         "  config.gridDim =\n      dim3(static_cast<unsigned>(s.items < "
         "resident")],
    "narrow: units of one fragment (16 pixels)": [
        ("constexpr int kUnitM = 2;", "constexpr int kUnitM = 1;")],
    "narrow: the epilogue's stores a pair a lane, no stmatrix": [
        ("const bool matrices = kMatrices && s.tma_out;",
         "const bool matrices = kMatrices && s.tma_out && s.c < 0;")],
    "narrow: registers for 3 CTAs an SM": [
        ("__global__ void __launch_bounds__(kNarrowThreads, 2)",
         "__global__ void __launch_bounds__(kNarrowThreads, 3)")],
    "narrow: registers for 4 CTAs an SM": [
        ("__global__ void __launch_bounds__(kNarrowThreads, 2)",
         "__global__ void __launch_bounds__(kNarrowThreads, 4)")],
    "cut: narrow without the epilogue": [
        ("        if (mf0 + i < mfrags) epilogue(mf0 + i, n0, acc[i]);",
         "        if (mf0 + i < mfrags && s.c < 0) epilogue(mf0 + i, n0, "
         "acc[i]);")],
    "cut: narrow without the barrier before the stores": [
        ("    __syncthreads();  // the staging tile whole, q free for the "
         "next box",
         "    // the staging tile whole, q free for the next box")],
    "cut: narrow without quantization": [
        ("      narrow_quantize_raw(reinterpret_cast<const TIn*>(smem + st * "
         "raw_stride),\n                          q, s, sc, pw);\n", "")],
    "cut: narrow without products": [
        ("for (int kk = 0; kk < s.k_steps; ++kk) {",
         "for (int kk = 0; kk < s.k_steps * 0; ++kk) {")],
    "cut: narrow without stores": [
        ("          tma_store_4d(&y_map, stage + ch * tm * rb,",
         "          if (s.c < 0) tma_store_4d(&y_map, stage + ch * tm * rb,")],
}
# one-constant variants of the narrow plan (ops/int8_conv_kernel.py)
NARROW_PLANS: Dict[str, Dict[str, object]] = {
    "narrow plan: ring of 1 box": {"NARROW_STAGES": 1},
    "narrow plan: ring of 3 boxes": {"NARROW_STAGES": 3},
    "narrow plan: one staging tile": {"NARROW_OUT_BUFS": 1},
    "narrow plan: items of 64 pixels": {"NARROW_TILE_MS": (64,)},
    "narrow plan: items of 128 pixels": {"NARROW_TILE_MS": (128,)},
    "narrow plan: items of 256 pixels": {"NARROW_TILE_MS": (256,)},
    "narrow plan: units of 32 channels": {"NARROW_TILE_NS": (32,)},
    "narrow plan: three CTAs an SM": {
        "NARROW_SMEM_BUDGETS": (int8_conv_kernel.SM_SMEM // 3 - 1024,
                                int8_conv_kernel.SMEM_LIMIT)},
}
# one-constant variants of the depthwise plan (ops/int8_conv_kernel.py)
DW_PLANS: Dict[str, Dict[str, object]] = {
    "dw plan: tiles of 4 x 16 at most": {
        "DW_TILES": ((4, 16), (4, 8), (4, 4))},
    "dw plan: tiles of 8 x 16 first": {
        "DW_TILES": ((8, 16), (4, 16), (4, 8), (4, 4))},
    "dw plan: chunks of 64 channels": {"DW_CHUNK": 64},
    "dw plan: chunks of 16 channels": {"DW_CHUNK": 16},
    "dw plan: ring of 1 box": {"DW_STAGES": 1},
    "dw plan: ring of 3 boxes": {"DW_STAGES": 3},
    "dw plan: two CTAs an SM": {
        "DW_SMEM_BUDGET": int8_conv_kernel.SM_SMEM // 2 - 1024},
}


@contextlib.contextmanager
def plan_constants(changes: Dict[str, object]):
    """The depthwise plan with `changes` to its module constants while the
    block runs."""
    old = {name: getattr(int8_conv_kernel, name) for name in changes}
    for name, value in changes.items():
        setattr(int8_conv_kernel, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(int8_conv_kernel, name, value)


@contextlib.contextmanager
def wgmma_from(channels: int):
    """Dense convs of `channels` input channels or more take the wgmma
    design (taps of 32 channels) while the block runs: the packing, the
    plain version and the wrapper's routing all read the threshold."""
    old = int8_conv.WGMMA_MIN_CHANNELS
    int8_conv.WGMMA_MIN_CHANNELS = channels
    int8_conv_kernel.WGMMA_MIN_CHANNELS = channels
    try:
        yield
    finally:
        int8_conv.WGMMA_MIN_CHANNELS = old
        int8_conv_kernel.WGMMA_MIN_CHANNELS = old


@contextlib.contextmanager
def routed(route: Dict[str, int]):
    """Dense convs routed as `route` says while the block runs: its
    WGMMA_MIN_CHANNELS (`wgmma_from`) and NARROW_MIN_CHANNELS."""
    rest = {k: v for k, v in route.items() if k != "WGMMA_MIN_CHANNELS"}
    with wgmma_from(route.get("WGMMA_MIN_CHANNELS",
                              int8_conv.WGMMA_MIN_CHANNELS)), \
            plan_constants(rest):
        yield


def shape_args(shape, rng, groups: int = 1):
    """The arguments of `launch` for a dense shape of SHAPES, or (groups
    C) a depthwise shape of DW_SHAPES."""
    if groups == 1:
        label, (n, h, w, c), o, k, stride, pads = shape
    else:
        label, (n, h, w, c), k, stride = shape
        o, pads = c, None
    x = torch.from_numpy(rng.normal(0, 1.5, (n, h, w, c)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    qw = torch.from_numpy(rng.integers(-127, 128, (o, c // groups, k, k))
                          .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, o).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0, 1, o).astype(np.float32)).cuda()
    if pads is None:
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    return (x, pack_weights(qw, groups).cuda(), scale, bias, 0.02, stride,
            pads, groups, k, k, torch.bfloat16)


def kernel_ms(fn, calls: int = 10) -> Dict[str, float]:
    """Device ms a call of each CUDA kernel that `fn` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and ("int8_conv" in evt.key or "quantize" in evt.key):
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").split("<")[0]
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--designs", nargs="+",
                    default=["wgmma", "depthwise", "narrow"],
                    choices=["wgmma", "depthwise", "narrow"],
                    help="whose shapes and variants to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_experiments runs on the card only", file=sys.stderr)
        return 1
    print(f"[card] {card_line()}")
    base = int8_conv_kernel.kernel
    # (variant, the source edits or None, plan constants, the shapes' design)
    runs = [("base", None, {}, d) for d in args.designs]
    if "wgmma" in args.designs:
        runs += [(n, e, {}, "wgmma") for n, e in VARIANTS.items()]
    if "depthwise" in args.designs:
        runs += [(n, e, {}, "depthwise") for n, e in DW_VARIANTS.items()]
        runs += [(n, None, c, "depthwise") for n, c in DW_PLANS.items()]
    if "narrow" in args.designs:
        runs += [(n, e, {}, "narrow") for n, e in NARROW_VARIANTS.items()]
        runs += [(n, None, c, "narrow") for n, c in NARROW_PLANS.items()]
    libs = {"base": base}
    libs.update({name: variant_library(base, int8_conv_kernel.declare, name,
                                       edits)
                 for name, edits, _, _ in runs if edits is not None})
    build_all(libs.values())
    for name, lib in libs.items():
        entry = "?"
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                # the mangled kernel name: its name and template arguments
                entry = line.split("'")[1].split("int8_conv_")[-1][:48]
            if "registers" in line or "stack frame" in line:
                print(f"[build] {name}: {entry}: {line.strip()}")
    # design -> [(label, the route, args, plain)]
    cases = {"wgmma": [], "depthwise": [], "narrow": []}
    if "wgmma" in args.designs:
        for shape in SHAPES:
            routes = [{}] + ([{"WGMMA_MIN_CHANNELS": 1}]
                             if shape[0] in ON_WGMMA else [])
            for route in routes:
                with routed(route), torch.inference_mode():
                    a = shape_args(shape, np.random.default_rng(
                        len(cases["wgmma"])))
                    cases["wgmma"].append((shape[0], route, a,
                                           int8_conv2d_plain(*a)))
    if "depthwise" in args.designs:
        for i, shape in enumerate(DW_SHAPES):
            with torch.inference_mode():
                a = shape_args(shape, np.random.default_rng(100 + i),
                               groups=shape[1][3])
                cases["depthwise"].append((shape[0], {}, a,
                                           int8_conv2d_plain(*a)))
    if "narrow" in args.designs:
        for i, shape in enumerate(NARROW_SHAPES):
            other = NARROW_ROUTES["narrow" if shape[1][3] <
                                  int8_conv_kernel.NARROW_MIN_CHANNELS
                                  else "mma_sync"]
            with torch.inference_mode():
                a = shape_args(shape, np.random.default_rng(200 + i))
                want = int8_conv2d_plain(*a)
            cases["narrow"] += [(shape[0], {}, a, want),
                                (shape[0], other, a, want)]
    failed = []
    try:
        for name, edits, constants, design_of in runs:
            int8_conv_kernel.kernel = libs[name if edits is not None
                                           else "base"]
            for label, route, a, want in cases[design_of]:
                x, _, scale, _, _, stride, _, groups, kh, kw, _ = a
                with routed(route), plan_constants(constants), \
                        torch.inference_mode():
                    design = int8_conv_kernel.int8_design(
                        x.shape[3], scale.shape[0], kh, kw, stride, groups)
                    if (design_of == "narrow" and design != "narrow"
                            and name != "base"):
                        continue    # mma_sync: the base build only
                    got = int8_conv_kernel.launch(*a)
                    ms = device_time_ms(
                        lambda: int8_conv_kernel.launch(*a), reps=20)
                    split = kernel_ms(lambda: int8_conv_kernel.launch(*a))
                same = torch.equal(got, want)
                if not same and not name.startswith("cut:"):
                    failed.append(f"{name} at {label} on {design}")
                parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                print(f"[int8 exp] {name:45s} {label:18s} {design:9s} "
                      f"{ms:.4f} ms ({parts})"
                      f"{'' if same else '  DIFFERS from plain'}")
    finally:
        int8_conv_kernel.kernel = base
    for what in failed:
        print(f"[int8 exp] FAILED: {what} differs from the plain version",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
