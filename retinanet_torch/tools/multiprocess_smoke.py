"""A real multi-process run of the port: processes joined by
`torch.distributed` over gloo on the CPU (counterpart of the JAX package's
`tools/multiprocess_smoke.py`).

    python -m retinanet_torch.tools.multiprocess_smoke [--procs 2]

Each process runs the same checks:
  * an all-reduce sees every process's contribution once;
  * `agree_preemption`: a flag raised on the last process only is seen by
    every process, and no flag by none;
  * a real Executor across the processes, on synthetic tfrecords that the
    parent writes: the train loop with device prefetch, where the SIGTERM
    flag is raised on the last process only during the third step; with
    `log_every = 2` every process must checkpoint step 4 and stop. A fresh
    Executor resumes from it and finishes; then a sharded evaluation: each
    process decodes its slice of every val batch, the chief scores COCO
    once, with every val image accumulated exactly once, and the other
    processes return {};
  * the logged losses and the parameters after the run are the same on
    every process (bit for bit; the parent compares them).

`run_group` starts the processes (spawn) and joins them into one group; the
tests and `chip_smoke.py` start theirs with it too.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

TRAIN_STEPS = 8
PREEMPT_AT_CALL = 3     # the step during which the last process's flag rises
PREEMPT_STEP = 4        # the log step at which every process must stop
VAL_IMAGES = 16


def _child(target: Callable, rank: int, world: int, store: str, device: str,
           backend, args: Sequence) -> None:
    from retinanet_torch.parallel import distributed
    torch.set_num_threads(1)
    index = torch.device(device).index
    try:
        distributed.initialize_distributed(
            backend=backend, device=device, init_method=f"file://{store}",
            world_size=world, rank=rank,
            local_rank=rank if index is None else index)
        try:
            target(*args)
        finally:
            distributed.shutdown()
    except BaseException:
        traceback.print_exc()
        raise


def run_group(target: Callable, world: int, workdir, args: Sequence = (),
              device: str = "cpu", backend=None,
              timeout: float = 600.0) -> None:
    """Run `target(*args)` in `world` fresh processes (spawn) joined into one
    process group through a file store under `workdir`: gloo on the CPU,
    NCCL on cards, or `backend` as named ("gloo" with device "cuda:0" puts
    every process on card 0). `target` must be importable by its module
    path. Raises when a process fails or outlives `timeout`; every process
    is gone when it returns."""
    fd, store = tempfile.mkstemp(prefix="store-", dir=str(workdir))
    os.close(fd)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, name=f"rank{rank}", args=(
        target, rank, world, store, device, backend, tuple(args)))
        for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(code != 0 for code in codes):
        raise RuntimeError(f"process exit codes {codes} (a negative code is "
                           f"the signal that ended it; timeout {timeout} s)")


def config_tree(workdir: Path, pattern: str, ann: str) -> dict:
    """A narrow ResNet10 at 64x64, float32: small enough for the CPU."""
    return {
        "experiment": {"name": "mpexec", "run_mode": "train",
                       "model_dir": str(workdir / "models")},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 4,
                     "num_anchors": 9}},
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {
            "train_steps": TRAIN_STEPS, "save_every": 100, "log_every": 2,
            "batch_size": {"train": 8, "val": 8},
            "annotation_file_path": ann, "remap_class_ids": False,
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "clipnorm": 10.0,
                "lr_params": {"schedule_type": "cosine_decay",
                              "initial_learning_rate": 0.01,
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 2}}},
        "dataloader_params": {
            "tfrecords": {"train": pattern, "val": pattern},
            "augmentations": {"use_augmentation": False,
                              "horizontal_flip": False},
            "shuffle_buffer_size": 8},
        "inference": {"mode": "PerClassHardNMS", "score_threshold": 0.05,
                      "pre_nms_top_k": 256, "max_detections": 25,
                      "use_approx_top_k": False},
    }


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"multiprocess smoke: {msg}")


def _process_checks(workdir: str) -> None:
    """One process's part; writes what the parent compares to
    `workdir/rank<r>.json`."""
    from retinanet_torch.core.config import Config
    from retinanet_torch.data.pipeline import InputPipeline
    from retinanet_torch.parallel import distributed
    from retinanet_torch.train import executor as executor_mod
    from retinanet_torch.train.executor import Executor, agree_preemption

    rank, world = distributed.process_index(), distributed.process_count()
    chief, last = rank == 0, rank == world - 1
    total = distributed.all_reduce_sum_(torch.tensor([float(rank + 1)]))
    check(total.item() == world * (world + 1) / 2,
          f"all-reduce gave {total.item()}")
    check(agree_preemption(last) is True, "one process's flag not agreed")
    check(agree_preemption(False) is False, "a flag agreed from none")

    workdir = Path(workdir)
    params = Config(str(workdir / "config.json")).params

    def train_fn():
        return InputPipeline("train", params, is_multi_host=True,
                             process_index=rank, process_count=world, seed=7)

    def val_fn():
        return InputPipeline(
            "val", params, batch_size=distributed.local_batch_size(
                int(params.training.batch_size.val)),
            seed=7, val_shard_index=rank, val_shard_count=world)

    ex = Executor(params, run_mode="train", train_input_fn=train_fn,
                  val_input_fn=val_fn, device="cpu")
    check((ex.metrics._jsonl is not None) == chief,
          "a metrics sink is open on a process other than the chief")
    step_fn, calls = ex._train_step, [0]

    def preempted_step(state, batch):
        calls[0] += 1
        if calls[0] == PREEMPT_AT_CALL and last:
            ex._preempt_requested = True
        return step_fn(state, batch)

    ex._train_step = preempted_step
    check(ex.train() is True, "the preempted run did not return True")
    check(ex.latest_checkpoint_step() == PREEMPT_STEP,
          f"preemption checkpoint {ex.latest_checkpoint_step()}")
    check(int(ex.state.step) == PREEMPT_STEP, f"stopped at {ex.state.step}")
    ex.close()

    ex2 = Executor(params, run_mode="train", train_input_fn=train_fn,
                   val_input_fn=val_fn, device="cpu")
    check(int(ex2.state.step) == PREEMPT_STEP,
          f"resumed at {ex2.state.step}")
    step_fn2, last_metrics = ex2._train_step, {}

    def recording_step(state, batch):
        state, metrics = step_fn2(state, batch)
        last_metrics.update(metrics)
        return state, metrics

    ex2._train_step = recording_step
    check(ex2.train() is True, "the resumed run did not finish")
    check(int(ex2.state.step) == TRAIN_STEPS, f"ended at {ex2.state.step}")

    seen = []
    accumulate = executor_mod.COCOEvaluator.accumulate_results

    def counting(evaluator, results):
        seen.extend(int(i) for i in np.asarray(results["image_id"])
                    if i >= 0)
        return accumulate(evaluator, results)

    executor_mod.COCOEvaluator.accumulate_results = counting
    try:
        scores = ex2.evaluate()
    finally:
        executor_mod.COCOEvaluator.accumulate_results = accumulate
    if chief:
        check(bool(scores) and all(np.isfinite(v) for v in scores.values()),
              f"chief scores {scores}")
        check(sorted(seen) == list(range(VAL_IMAGES)),
              f"the chief accumulated images {sorted(seen)}")
    else:
        check(scores == {} and not seen, f"non-chief scores {scores}")
    ex2.close()

    digest = hashlib.sha256()
    for name, value in sorted(ex2.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(value.detach().cpu().numpy().tobytes())
    (workdir / f"rank{rank}.json").write_text(json.dumps({
        "losses": {k: float(v) for k, v in last_metrics.items()},
        "state": digest.hexdigest()}))


def prepare(workdir: Path) -> None:
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    pattern, ann = write_synthetic_tfrecords(
        str(workdir / "data"), "train", num_shards=4,
        samples_per_shard=VAL_IMAGES // 4, num_classes=4,
        write_annotations=True)
    (workdir / "config.json").write_text(json.dumps(
        config_tree(workdir, pattern, ann), indent=1))


def run(workdir, procs: int = 2) -> dict:
    """The whole check in `workdir`; returns the chief's losses."""
    workdir = Path(workdir)
    prepare(workdir)
    run_group(_process_checks, procs, workdir, args=(str(workdir),),
              timeout=180)
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(procs)]
    for r in ranks[1:]:
        check(r == ranks[0], f"processes differ: {ranks}")
    return ranks[0]["losses"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="mpsmoke_") as tmp:
        losses = run(tmp, args.procs)
    print(f"MULTIPROCESS SMOKE OK ({args.procs} processes over gloo, the "
          "same losses and parameters on every process): "
          + json.dumps(losses))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
