"""`chip_smoke.py`'s phase 8 (the flagship train_val run and the host
pipeline) from several checkouts in turn, on one card, for comparing them.

    python retinanet_torch/tools/host_pipeline_ab.py --trees A B B A \
        [--out host_pipeline_ab.jsonl]

Each tree runs in a process of its own, which imports that tree's
`chip_smoke.py` and `retinanet_torch`: it builds the tree's NMS and
matching kernels, times the bare train step of the flagship at batch 8 on
one repeated in-memory batch (after two steps that are not timed), sets
cuDNN's TF32 as `chip_smoke.main` does for the executor's phases, and runs
`phase_executor` with the pipeline's windows `--pipeline_seconds` long
(a step starved by the pipeline ends once or twice in phase 8's 3 s).
From what that prints, a JSON line a run: the pipeline's
images/s alone, the pipeline's and the step's beside each other, the
executor's median images/s, the bare step's, and (on a tree whose
pipeline counts them) the stage lines. Runs on the card only; exits
non-zero when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import sys, tempfile, time
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
import torch
import chip_smoke as c
c.PIPELINE_SECONDS = float(sys.argv[2])
from retinanet_torch.core.config import Config
from retinanet_torch.data.synthetic import synthetic_train_batch
from retinanet_torch.ops import match_kernel, nms_kernel
from retinanet_torch.train.trainer import build_trainer
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
for kernel in (nms_kernel.kernel, match_kernel.kernel):
    kernel.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = True
params = Config(str(c.FLAGSHIP)).params
bs = c.TRAIN_BATCH
state, step = build_trainer(params, device="cuda", seed=0)
batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
    bs, tuple(params.input.input_shape), int(params.encoder_params.max_boxes),
    int(params.architecture.head.num_classes), seed=0).items()}
for _ in range(2):
    state, _ = step(state, batch)
torch.cuda.synchronize()
start = time.perf_counter()
for _ in range(c.TRAIN_STEPS):
    state, _ = step(state, batch)
torch.cuda.synchronize()
rate = c.TRAIN_STEPS * bs / (time.perf_counter() - start)
print(f"[ab] bare step {rate:.2f} images/s")
del state, batch
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory(prefix="host_ab_") as tmp:
    c.phase_executor(Path(tmp) / "executor", rate)
"""

_PATTERNS = {
    "bare_step_images_per_s": r"\[ab\] bare step ([\d.]+) images/s",
    "pipeline_alone_images_per_s":
        r"host pipeline alone: .*?, ([\d.]+) images/s",
    "pipeline_beside_step_images_per_s":
        r"host pipeline beside the train step: ([\d.]+) images/s",
    "step_beside_pipeline_images_per_s":
        r"the step beside the pipeline: \d+ steps in the window, "
        r"([\d.]+) images/s",
    "executor_images_per_s":
        r"images/s logged by the executor at batch \d+: median ([\d.]+)",
}


def run_tree(tree: str, timeout: int, pipeline_seconds: float) -> dict:
    tree = str(Path(tree).resolve())
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", _CHILD, tree,
                           str(pipeline_seconds)], env=env,
                          cwd=tree, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = {"tree": tree, "pipeline_seconds": pipeline_seconds}
    for key, pattern in _PATTERNS.items():
        found = re.search(pattern, proc.stdout)
        if found is None:
            raise RuntimeError(f"{tree}: no {key} in\n{proc.stdout[-3000:]}")
        out[key] = float(found.group(1))
    out["stages"] = [line for line in proc.stdout.splitlines()
                     if "pipeline stages" in line]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chip_smoke.py's phase 8 from several trees in turn.")
    parser.add_argument("--trees", nargs="+", required=True,
                        help="Checkouts to run, in this order")
    parser.add_argument("--out", default="",
                        help="Also append the JSON lines to this file")
    parser.add_argument("--timeout", type=int, default=600,
                        help="Seconds a run may take")
    parser.add_argument("--pipeline_seconds", type=float, default=3.0,
                        help="The window of phase 8's pipeline measurements "
                             "(chip_smoke.py's PIPELINE_SECONDS is 3)")
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}")
    for tree in args.trees:
        line = json.dumps(dict(run_tree(tree, args.timeout,
                                        args.pipeline_seconds),
                               card=card.strip()))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
