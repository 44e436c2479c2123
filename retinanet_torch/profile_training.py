"""Where a train step's time goes on the card.

    python -m retinanet_torch.profile_training [--config PATH] [--batch 8]
        [--grad_accum_steps K] [--steps 4]

Builds the trainer of the config (the flagship unless `--config` names
another) as `chip_smoke.py` does (`build_trainer`, seeded random weights,
one seeded synthetic batch of `--batch` images, the global batch of a step,
folded into K micro-batches with `--grad_accum_steps`), warms up, then
prints:
  * the step time on the host clock, images/s, and the device time of its
    phases from CUDA events, summed over the micro-batches: encode,
    forward, backward, optimizer;
  * peak memory;
  * from `torch.profiler`, the device time per step by kernel family, the
    device's idle share (1 - busy / step time), and the top kernels.
Out of memory, it raises an error that names the micro-batch, the peak and
`training.grad_accum_steps`. Runs on the card only.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from retinanet_torch.profile_serving import (add_config_argument, card_line,
                                             print_profile)

# distinct drawn images in a synthetic batch; a larger batch repeats them,
# so that 256 images at 1280x1280 cost the host what 16 do
SEED_IMAGES = 16


def train_batch(params, batch_size: int, seed: int = 0,
                device="cuda") -> dict:
    """A seeded synthetic train batch of `batch_size` on `device`: the
    first SEED_IMAGES images of `synthetic_train_batch` with their boxes,
    repeated on the device."""
    from retinanet_torch.data.synthetic import synthetic_train_batch
    base = synthetic_train_batch(
        min(batch_size, SEED_IMAGES), tuple(params.input.input_shape),
        int(params.encoder_params.max_boxes),
        int(params.architecture.head.num_classes), seed=seed)
    reps = -(-batch_size // len(base["image"]))
    return {k: torch.from_numpy(v).to(device).repeat(
        (reps,) + (1,) * (v.ndim - 1))[:batch_size] for k, v in base.items()}


def measure_step(params, batch_size: int, grad_accum_steps: int = 1,
                 steps: int = 4, warmup: int = 2) -> dict:
    """`warmup` and then `steps` steps of the config at a global batch of
    `batch_size` in `grad_accum_steps` micro-batches, on the card, one
    repeated batch. Returns step_ms (host clock, median), images_per_s,
    peak_gb (allocated, over the timed steps), the device ms of each phase
    (CUDA events, median; summed over the micro-batches), the last step's
    metrics, and the trainer's state and step and the batch. Out of
    memory, raises `train/step.py:out_of_memory`'s error."""
    from retinanet_torch.train import step as step_lib
    from retinanet_torch.train.trainer import build_trainer
    k = int(grad_accum_steps)
    params.training.grad_accum_steps = k
    device = torch.device("cuda")
    try:
        state, step = build_trainer(params, device=device, seed=0)
        batch = train_batch(params, batch_size)
        if k > 1:
            batch = step_lib.fold_micro_batches(batch, k)
        for _ in range(warmup):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, splits = [], []
        for _ in range(steps):
            marks = []
            start = time.perf_counter()
            state, metrics = step(state, batch, marks)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - start) * 1e3)
            split = collections.defaultdict(float)
            for before, (name, event) in zip(marks, marks[1:]):
                split[name] += before[1].elapsed_time(event)
            splits.append(split)
    except torch.OutOfMemoryError as error:
        raise step_lib.out_of_memory(
            error, params.experiment.name, batch_size // k, k,
            device) from error
    step_ms = statistics.median(wall)
    return {"step_ms": step_ms, "images_per_s": batch_size / step_ms * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms": {name: statistics.median(s[name] for s in splits)
                          for name in splits[0]},
            "metrics": {name: float(v) for name, v in metrics.items()},
            "state": state, "step": step, "batch": batch}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_argument(ap)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch of a step")
    ap.add_argument("--grad_accum_steps", type=int, default=1,
                    help="micro-batches a step (K)")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: no CUDA device")

    from retinanet_torch.core.config import Config

    print(f"card: {card_line()}")
    print(f"config: {args.config}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    params = Config(str(args.config)).params
    k = args.grad_accum_steps
    out = measure_step(params, args.batch, k, args.steps)
    print(f"batch {args.batch} in {k} micro-batches of {args.batch // k}: "
          f"step {out['step_ms']:.3f} ms (host clock, median of "
          f"{args.steps}), {out['images_per_s']:.2f} images/s; device (CUDA "
          "events, summed over the micro-batches): " + ", ".join(
              f"{name} {ms:.3f} ms" for name, ms in out["device_ms"].items())
          + f"; peak memory {out['peak_gb']:.2f} GB")

    state, step, batch = out["state"], out["step"], out["batch"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - start) * 1e3
    print_profile(prof, args.steps, out["step_ms"], span_ms, "step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
