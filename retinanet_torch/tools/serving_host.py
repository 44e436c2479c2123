"""The host's share of a float serving request: what the Python side of
`build_serving_fn` costs, apart from the card's work.

    python retinanet_torch/tools/serving_host.py [--tree DIR]
        [--config PATH] [--batches 1 8] [--requests 40] [--device cuda]

Builds the config (the flagship by default) as `profile_serving.py` does
(seeded weights, class-head bias 0) and, for each batch, after two warm-up
requests, times `--requests` requests, each after a synchronize that is not
timed:
  * `dispatch_ms`: until `serve(images)` returns (no request of the float
    lane waits on the card, so this is the host's work: the copy of the
    images, then every launch enqueued);
  * `request_ms`: until the card has finished as well;
median and least of each. Then one request is counted: Python function
calls (`sys.setprofile`) and ATen operator calls (`torch.profiler`, CPU).
Prints one JSON line.

`--tree DIR` imports `retinanet_torch` from another checkout (run this file
by its path, not with `-m`), so that two trees are compared on one card
by the same script: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = (REPO / "configs" / "v3-8"
            / "mscoco-retinanet-resnet50-640x640-30x-64.json")


def count_calls(fn) -> tuple:
    """(Python calls, ATen operator calls) made by one `fn()`."""
    import torch
    calls = [0]

    def profile(frame, event, arg):
        if event in ("call", "c_call"):
            calls[0] += 1

    sys.setprofile(profile)
    try:
        fn()
    finally:
        sys.setprofile(None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    aten = sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))
    return calls[0], aten


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose retinanet_torch to import")
    ap.add_argument("--config", type=Path, default=FLAGSHIP)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tree = (args.tree or REPO).resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch
    import retinanet_torch
    package = Path(retinanet_torch.__file__).resolve().parent
    if package.parent != tree:
        raise SystemExit(f"serving_host: imported {package}, not {tree}'s "
                         "package: run this file by its path")
    from retinanet_torch.core.config import Config
    from retinanet_torch.export.serving import build_serving_fn
    from retinanet_torch.models.retinanet import build_model
    from retinanet_torch.profile_serving import zero_class_prior

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("serving_host: no CUDA device")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = Config(str(args.config)).params
    model = build_model(params, device=args.device, seed=0)
    zero_class_prior(model)
    serve = build_serving_fn(params, device=args.device, model=model)
    h, w = (int(v) for v in params.input.input_shape)
    result = {"tree": str(args.tree or REPO)}
    if cuda:
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    for bs in args.batches:
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (bs, h, w, 3)).astype(np.uint8))
        for _ in range(2):
            serve(images)
        sync()
        dispatch, request = [], []
        for _ in range(args.requests):
            sync()
            start = time.perf_counter()
            serve(images)
            dispatch.append((time.perf_counter() - start) * 1e3)
            sync()
            request.append((time.perf_counter() - start) * 1e3)
        py_calls, aten_calls = count_calls(lambda: (serve(images), sync()))
        result[f"batch_{bs}"] = {
            "dispatch_ms": statistics.median(dispatch),
            "dispatch_ms_least": min(dispatch),
            "request_ms": statistics.median(request),
            "request_ms_least": min(request),
            "python_calls": py_calls, "aten_calls": aten_calls}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
