"""Where a train step's time goes on the card.

    python -m retinanet_torch.profile_training [--config PATH] [--batch 8]
        [--steps 4]

Builds the trainer of the config (the flagship unless `--config` names
another) as `chip_smoke.py` does (`build_trainer`, seeded
random weights, one seeded synthetic batch), warms up, then prints:
  * the step time on the host clock and the device time of its phases from
    CUDA events: encode, forward, backward, optimizer;
  * peak memory;
  * from `torch.profiler`, the device time per step by kernel family, the
    device's idle share (1 - busy / step time), and the top kernels.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from retinanet_torch.profile_serving import (add_config_argument, card_line,
                                             print_profile)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_argument(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: no CUDA device")

    from retinanet_torch.core.config import Config
    from retinanet_torch.data.synthetic import synthetic_train_batch
    from retinanet_torch.train.trainer import build_trainer

    print(f"card: {card_line()}")
    print(f"config: {args.config}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    params = Config(str(args.config)).params
    state, step = build_trainer(params, device="cuda", seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_train_batch(
        args.batch, tuple(params.input.input_shape),
        int(params.encoder_params.max_boxes),
        int(params.architecture.head.num_classes), seed=0).items()}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wall, splits = [], []
    for _ in range(args.steps):
        marks = []
        start = time.perf_counter()
        step(state, batch, marks)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - start) * 1e3)
        splits.append({name: before[1].elapsed_time(event) for before,
                       (name, event) in zip(marks, marks[1:])})
    print(f"batch {args.batch}: step {statistics.median(wall):.3f} ms (host "
          f"clock, median of {args.steps}), "
          f"{args.batch / statistics.median(wall) * 1e3:.2f} images/s; device "
          "(CUDA events): " + ", ".join(
              f"{name} {statistics.median(s[name] for s in splits):.3f} ms"
              for name in splits[0])
          + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - start) * 1e3
    print_profile(prof, args.steps, statistics.median(wall), span_ms, "step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
