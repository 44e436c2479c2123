"""Where a serving request's time goes on the card.

    python -m retinanet_torch.profile_serving [--config PATH] [--batch 8]
        [--requests 3]

Builds the config (the flagship unless `--config` names another) as
`chip_smoke.py` does (seeded random weights, class-head bias 0 so that NMS
has work), warms up, then prints:
  * the request time on the host clock, and the device time of its two
    halves from CUDA events: model (normalize, backbone, neck, heads, fuse)
    and post-processing (top-k, decode, NMS, finalize);
  * from `torch.profiler`, the device time per request by kernel family,
    and the device's idle share: 1 - busy / request time.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = (Path(__file__).resolve().parent.parent / "configs" / "v3-8"
            / "mscoco-retinanet-resnet50-640x640-30x-64.json")

# kernel name pattern -> family, first match wins
_FAMILIES = (
    ("nms (hand kernel)", r"nms_lanes_kernel|nms_sweep_kernel"),
    ("match (hand kernel)", r"match_kernel|decode_keys_kernel"),
    ("optimizer / clip (foreach)", r"multi_tensor"),
    ("sort / top-k", r"sort|radix|Sort|topk|bitonic|slab_select|slab_final"),
    ("batch norm", r"batch_norm|batchnorm|bn_fw"),
    # cuDNN names its depthwise kernels (one channel a group) *2d_c1_k1_*;
    # ATen's own are conv_depthwise2d_*
    ("depthwise convolution", r"depthwise|_c1_k1_"),
    ("convolution", r"conv|xmma|gemm|implicit|cutlass|sm90|wgrad|dgrad|"
                    r"fprop|winograd|cudnn"),
    ("gather / index", r"gather|index|scatter"),
    # not "gpu_kernel_impl_nocast", which is any broadcasting elementwise op
    ("copy / cast / layout", r"copy|Copy|(?<!no)cast|permute|transpose|"
                             r"CatArray"),
    ("elementwise", r"elementwise|vectorized|unrolled|reduce|pool|"
                    r"max_pool|where|clamp"),
)


# profiler ranges of the host side, which carry their kernels' device time
_NOT_KERNELS = ("cuda", "aten::", "Optimizer.", "autograd::", "_BatchStats")


def _family(name: str) -> str:
    for fam, pat in _FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def add_config_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", type=Path, default=FLAGSHIP,
                    help="config JSON to build (default: the flagship)")


def zero_class_prior(model) -> None:
    """The class head's prediction bias to 0, so that random weights give
    scores near 0.5 and every NMS lane has work."""
    pred = model.class_head.prediction
    with torch.no_grad():
        (pred.pointwise if pred.separable else pred.conv).bias.zero_()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def print_profile(prof, count: int, unprofiled_ms: float, span_ms: float,
                  unit: str) -> None:
    """Device time per `unit` (a request, a step) by kernel family, the idle
    share against the unprofiled time of one unit, and the top kernels, from
    a `torch.profiler` run over `count` units that took `span_ms`."""
    by_family = defaultdict(float)
    launches = defaultdict(int)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or evt.key.startswith(_NOT_KERNELS):
            continue
        fam = _family(evt.key)
        by_family[fam] += dev_us / 1e3 / count
        launches[fam] += evt.count // count
    busy = sum(by_family.values())
    if busy == 0:
        print("profiler recorded no device time")
        return
    per_unit = span_ms / count
    print(f"profiler: device busy {busy:.3f} ms a {unit}; idle share "
          f"{1 - busy / unprofiled_ms:.3f} of the unprofiled "
          f"{unprofiled_ms:.3f} ms {unit} ({1 - busy / per_unit:.3f} of the "
          f"{per_unit:.3f} ms profiled one)")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:28s} {ms:9.3f} ms  {ms / busy:6.1%}  "
              f"{launches[fam]:5d} launches")
    top = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    print("top kernels:")
    for evt in [e for e in top if not e.key.startswith(_NOT_KERNELS)][:14]:
        ms = getattr(evt, "self_device_time_total", 0.0) / 1e3
        print(f"  {ms / count:9.3f} ms  x{evt.count // count:4d}  "
              f"{evt.key[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_argument(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")

    from retinanet_torch.core.config import Config
    from retinanet_torch.data.anchors import from_params
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.ops.postprocess import make_postprocess_fn

    print(f"card: {card_line()}")
    print(f"config: {args.config}")
    params = Config(str(args.config)).params
    model = build_model(params, device="cuda", seed=0)
    zero_class_prior(model)
    serve = build_serving_fn(params, device="cuda", model=model)
    fused_fn = build_serving_fn(params, mode="onnx", device="cuda",
                                model=model)
    post = make_postprocess_fn(params, from_params(params), "cuda")
    h, w = params.input.input_shape
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch, h, w, 3)).astype(np.uint8))
    for _ in range(2):
        serve(images)
    torch.cuda.synchronize()

    wall, model_ms, post_ms = [], [], []
    for _ in range(args.requests):
        start = time.perf_counter()
        serve(images)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - start) * 1e3)
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        with torch.inference_mode():
            e0.record()
            fused = fused_fn(images)
            e1.record()
            post(fused)
            e2.record()
        e2.synchronize()
        model_ms.append(e0.elapsed_time(e1))
        post_ms.append(e1.elapsed_time(e2))
    print(f"batch {args.batch}: request {statistics.median(wall):.3f} ms "
          f"(host clock, median of {args.requests}); device: model "
          f"{statistics.median(model_ms):.3f} ms, post-processing "
          f"{statistics.median(post_ms):.3f} ms (CUDA events)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(args.requests):
            serve(images)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - start) * 1e3
    print_profile(prof, args.requests, statistics.median(wall), span_ms,
                  "request")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
