"""Int8 conv kernel experiments on the card: where the time of the wgmma
and depthwise designs goes, at the flagship's and EfficientNet-lite2's
shapes.

    python -m retinanet_torch.tools.int8_conv_experiments \
        [--designs wgmma depthwise]

Seven convs of a batch-8 flagship request, bfloat16 in and out, seeded
inputs, and the 7x7/2 stem a second time on the wgmma design (routed there
as if C = 3 were above `WGMMA_MIN_CHANNELS`: taps of 32 channels), which
says what keeping it on the mma_sync design saves; and seven depthwise
convs of a batch-8 lite2 request. For each variant and case: the design,
the device ms of a call (`utils/benchmark.py:device_time_ms`), and the ms
of its CUDA kernels by name from a profiler trace (the quantizing pass and
the GEMM), beside the card's name and power limit.

A source variant is `csrc/int8_conv.cu` with one edit, compiled beside the
package's build; a plan variant (`DW_PLANS`) is the depthwise plan of
`ops/int8_conv_kernel.py` with one constant changed (tile, channel chunk,
ring depth, shared-memory budget), on the package's build. The cut
variants (name "cut: ...": no stores, no epilogue, no products, no
quantization) compute something else and are timed only; every other
variant must equal the plain version at every case, and the tool exits 1
when one does not.
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
    ap.add_argument("--designs", nargs="+", default=["wgmma", "depthwise"],
                    choices=["wgmma", "depthwise"],
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
    libs = {"base": base}
    libs.update({name: variant_library(base, int8_conv_kernel.declare, name,
                                       edits)
                 for name, edits, _, _ in runs if edits is not None})
    build_all(libs.values())
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] {name}: {line.strip()}")
    # design -> [(label, the route's WGMMA_MIN_CHANNELS, args, plain)]
    cases = {"wgmma": [], "depthwise": []}
    if "wgmma" in args.designs:
        for shape in SHAPES:
            routes = [int8_conv.WGMMA_MIN_CHANNELS] + (
                [1] if shape[0] in ON_WGMMA else [])
            for channels in routes:
                with wgmma_from(channels), torch.inference_mode():
                    a = shape_args(shape, np.random.default_rng(
                        len(cases["wgmma"])))
                    cases["wgmma"].append((shape[0], channels, a,
                                           int8_conv2d_plain(*a)))
    if "depthwise" in args.designs:
        for i, shape in enumerate(DW_SHAPES):
            with torch.inference_mode():
                a = shape_args(shape, np.random.default_rng(100 + i),
                               groups=shape[1][3])
                cases["depthwise"].append((shape[0], int8_conv.
                                           WGMMA_MIN_CHANNELS, a,
                                           int8_conv2d_plain(*a)))
    failed = []
    try:
        for name, edits, constants, design_of in runs:
            int8_conv_kernel.kernel = libs[name if edits is not None
                                           else "base"]
            for label, channels, a, want in cases[design_of]:
                x, _, scale, _, _, stride, _, groups, kh, kw, _ = a
                with wgmma_from(channels), plan_constants(constants), \
                        torch.inference_mode():
                    design = int8_conv_kernel.int8_design(
                        x.shape[3], scale.shape[0], kh, kw, stride, groups)
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
