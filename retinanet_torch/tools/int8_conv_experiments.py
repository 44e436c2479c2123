"""Int8 conv kernel experiments on the card: where the time of the wgmma
design goes, at the flagship's shapes.

    python -m retinanet_torch.tools.int8_conv_experiments

Seven convs of a batch-8 flagship request, bfloat16 in and out, seeded
inputs, and the 7x7/2 stem a second time on the wgmma design (routed there
as if C = 3 were above `WGMMA_MIN_CHANNELS`: taps of 32 channels), which
says what keeping it on the mma_sync design saves. For each variant and
case: the design, the device ms of a call
(`utils/benchmark.py:device_time_ms`), and the ms of its CUDA kernels by
name from a profiler trace (the quantizing pass and the GEMM), beside the
card's name and power limit.

Each variant is `csrc/int8_conv.cu` with one edit, compiled beside the
package's build. The cut variants (name "cut: ...": no stores, no
epilogue, no products) compute something else and are timed only; every
other variant must equal the plain version at every case, and the tool
exits 1 when one does not.
"""

from __future__ import annotations

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

VARIANTS: Dict[str, Edits] = {
    "non-persistent grid": [
        ("config.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles "
         ": sms));", "config.gridDim = dim3(static_cast<unsigned>(tiles));")],
    "no programmatic dependent launch": [
        ("early.val.programmaticStreamSerializationAllowed = 1;",
         "early.val.programmaticStreamSerializationAllowed = 0;")],
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


def shape_args(shape, rng):
    label, (n, h, w, c), o, k, stride, pads = shape
    x = torch.from_numpy(rng.normal(0, 1.5, (n, h, w, c)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    qw = torch.from_numpy(rng.integers(-127, 128, (o, c, k, k)).astype(
        np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, o).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0, 1, o).astype(np.float32)).cuda()
    if pads is None:
        pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    return (x, pack_weights(qw, 1).cuda(), scale, bias, 0.02, stride, pads,
            1, k, k, torch.bfloat16)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_conv_experiments runs on the card only", file=sys.stderr)
        return 1
    print(f"[card] {card_line()}")
    base = int8_conv_kernel.kernel
    libs = {"base": base}
    libs.update({name: variant_library(base, int8_conv_kernel.declare, name,
                                       edits)
                 for name, edits in VARIANTS.items()})
    build_all(libs.values())
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] {name}: {line.strip()}")
    # (label, the route's WGMMA_MIN_CHANNELS, args, plain output)
    cases = []
    for shape in SHAPES:
        routes = [int8_conv.WGMMA_MIN_CHANNELS] + (
            [1] if shape[0] in ON_WGMMA else [])
        for channels in routes:
            with wgmma_from(channels), torch.inference_mode():
                args = shape_args(shape, np.random.default_rng(len(cases)))
                cases.append((shape[0], channels, args,
                              int8_conv2d_plain(*args)))
    failed = []
    try:
        for name, lib in libs.items():
            int8_conv_kernel.kernel = lib
            for label, channels, args, want in cases:
                x, _, scale, _, _, stride, _, groups, kh, kw, _ = args
                with wgmma_from(channels), torch.inference_mode():
                    design = int8_conv_kernel.int8_design(
                        x.shape[3], scale.shape[0], kh, kw, stride, groups)
                    got = int8_conv_kernel.launch(*args)
                    ms = device_time_ms(
                        lambda: int8_conv_kernel.launch(*args), reps=20)
                    split = kernel_ms(lambda: int8_conv_kernel.launch(*args))
                same = torch.equal(got, want)
                if not same and not name.startswith("cut:"):
                    failed.append(f"{name} at {label} on {design}")
                print(f"[int8 exp] {name:45s} {label:18s} {design:8s} "
                      f"{ms:.4f} ms "
                      f"({', '.join(f'{k} {v:.4f}' for k, v in split.items())})"
                      f"{'' if same else '  DIFFERS from plain'}")
    finally:
        int8_conv_kernel.kernel = base
    for what in failed:
        print(f"[int8 exp] FAILED: {what} differs from the plain version",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
