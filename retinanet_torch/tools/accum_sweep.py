"""Every config under configs/ at its own global train batch on one card,
with the smallest `training.grad_accum_steps` whose micro-batch fits.

    python -m retinanet_torch.tools.accum_sweep [--out PATH]

Each config runs in a process of its own through
`profile_training.measure_step` (one warm-up step, then `STEPS` timed
ones, seeded random weights, one repeated synthetic batch): K = 1, 2, 4,
... (the powers of two that divide the batch) until a step fits; an
out-of-memory error moves on to the next K, and is recorded. Prints the
card's line, then one JSON line a config: config, batch, K, micro-batch,
step_ms (host clock, median), images_per_s, peak_gb (allocated), the K
that ran out of memory, seconds; `--out` also writes the lines to a file.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
TAG = "SWEEP "
STEPS = 2                       # timed steps a config, after one warm-up


def sweep_one(path: Path) -> dict:
    """The config at its train batch with the smallest K that fits."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.profile_training import measure_step
    params = Config(str(path)).params
    batch = int(params.training.batch_size.train)
    record = {"config": str(path.relative_to(CONFIGS.parent)),
              "batch": batch, "out_of_memory_at_k": []}
    start = time.perf_counter()
    k = 1
    while batch % k == 0:
        try:
            out = measure_step(params, batch, k, steps=STEPS, warmup=1)
        except torch.OutOfMemoryError as error:
            record["out_of_memory_at_k"].append(k)
            print(f"{path.name}: K={k}: {str(error)[:300]}", file=sys.stderr)
        else:
            record.update(k=k, micro_batch=batch // k,
                          step_ms=out["step_ms"],
                          images_per_s=out["images_per_s"],
                          peak_gb=out["peak_gb"])
            break
        finally:
            out = None
            gc.collect()
            torch.cuda.empty_cache()
        k *= 2
    record["seconds"] = time.perf_counter() - start
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--one", type=Path, default=None,
                    help=argparse.SUPPRESS)  # a child's config
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("accum_sweep: no CUDA device")
    if args.one is not None:
        print(TAG + json.dumps(sweep_one(args.one)), flush=True)
        return 0

    from retinanet_torch.profile_serving import card_line
    print(f"card: {card_line()}")
    lines = []
    for path in sorted(CONFIGS.glob("*/*.json")):
        proc = subprocess.run(
            [sys.executable, "-m", "retinanet_torch.tools.accum_sweep",
             "--one", str(path)],
            capture_output=True, text=True, timeout=900)
        found = [ln[len(TAG):] for ln in proc.stdout.splitlines()
                 if ln.startswith(TAG)]
        if proc.returncode != 0 or not found:
            print(proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"accum_sweep: {path} failed "
                             f"({proc.returncode})")
        print(found[0], flush=True)
        lines.append(found[0])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
