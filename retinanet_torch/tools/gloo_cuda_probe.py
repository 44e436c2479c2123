"""Which gloo collectives carry CUDA tensors, with two processes on card 0.

    python -m retinanet_torch.tools.gloo_cuda_probe [--out DIR]

NCCL refuses two ranks on one card, so the port runs several ranks on one
card over gloo on CUDA tensors (`parallel/distributed.py`), and spatial
partitioning (`parallel/spatial.py`) moves its rows with all-reduce only.
This probe records what gloo does with each collective on CUDA tensors:
all-reduce in int32, float32, bfloat16 and int16, all-gather, and send /
recv, the last on a group of its own with a 15 s timeout. A collective
that fails is recorded with its error; one that ends its process (send on
a CUDA tensor aborts the sender) shows as that rank's missing result and
its exit code. Prints one JSON line a rank.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist


def _trial(results: dict, name: str, fn) -> None:
    try:
        results[name] = fn()
    except RuntimeError as error:   # the probe's finding, not a failure
        results[name] = f"error: {error}"[:300]


def _rank(out_dir: str) -> None:
    from retinanet_torch.parallel import distributed
    rank = distributed.process_index()
    device = torch.device("cuda", 0)
    results = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def all_reduce(dtype):
        t = torch.full((1000,), rank + 1, dtype=dtype, device=device)
        dist.all_reduce(t)
        return float(t[0].item())

    for dtype in (torch.int32, torch.float32, torch.bfloat16, torch.int16):
        _trial(results, f"all_reduce {dtype}",
               lambda dtype=dtype: all_reduce(dtype))

    def all_gather():
        t = torch.full((4,), float(rank), device=device)
        out = [torch.empty_like(t) for _ in range(distributed.process_count())]
        dist.all_gather(out, t)
        return [float(o[0]) for o in out]

    _trial(results, "all_gather float32", all_gather)
    Path(out_dir, f"probe{rank}.json").write_text(json.dumps(results))
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=15))

    def send_recv():
        t = torch.full((4,), 7.0 if rank == 0 else 0.0, device=device)
        if rank == 0:
            dist.send(t, 1, group=group)
        else:
            dist.recv(t, 0, group=group)
        torch.cuda.synchronize()
        return t.tolist()

    _trial(results, "send/recv float32", send_recv)
    Path(out_dir, f"probe{rank}.json").write_text(json.dumps(results))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the ranks' JSON (a temporary one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    from retinanet_torch.tools.multiprocess_smoke import run_group
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        out = args.out or tmp
        Path(out).mkdir(parents=True, exist_ok=True)
        try:
            run_group(_rank, 2, tmp, args=(out,), device="cuda:0",
                      backend="gloo", timeout=120)
        except RuntimeError as error:   # a rank the probe ended
            print(f"gloo_cuda_probe: {error}")
        for rank in range(2):
            path = Path(out, f"probe{rank}.json")
            print(json.dumps({"rank": rank, **(json.loads(path.read_text())
                                               if path.exists() else {})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
