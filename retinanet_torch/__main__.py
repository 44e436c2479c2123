"""Trainer CLI: `python -m retinanet_torch --config_path ...` (counterpart of
`retinanet_tpu/__main__.py`, the same flags).

Runs on the CUDA card unless `--device cpu` asks for the CPU. Boolean flags
take `--flag`, `--noflag` and `--flag=true|false`. `--xla` is accepted and
ignored (PyTorch runs eagerly). `main(argv)` can be called in process with
the arguments after the program name.

`--is_multi_host` runs one process of a data-parallel group, launched by
torchrun (which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT): NCCL on the cards, one a process, or gloo with `--device
cpu`:

    torchrun --nproc_per_node 2 -m retinanet_torch --config_path CONFIG \
        --device cpu --is_multi_host

Each process reads its share of the train files and decodes its slice of
every val batch; the global batch sizes stay the config's. Under
`training.spatial_partition` S > 1 the S processes of a data index read
the same batches, a band of their rows each (`parallel/spatial.py`).
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
from typing import List, Optional

import numpy as np
import torch

_TRUE = ("1", "true", "t", "yes", "y")
_FALSE = ("0", "false", "f", "no", "n")


def _parse_bool(text: str) -> bool:
    value = text.strip().lower()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def _add_bool(parser: argparse.ArgumentParser, name: str, default: bool,
              help_text: str) -> None:
    parser.add_argument(f"--{name}", dest=name, nargs="?", const=True,
                        default=default, type=_parse_bool, help=help_text)
    parser.add_argument(f"--no{name}", dest=name, action="store_false",
                        help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch",
        description="Train or evaluate RetinaNet from a JSON config.")
    parser.add_argument("--config_path", required=True,
                        help="Path to the experiment config")
    parser.add_argument("--model_dir", default=None,
                        help="Override experiment.model_dir from the config")
    parser.add_argument("--resume_from", default=None,
                        help="Checkpoint step to resume from (default: "
                             "latest)")
    _add_bool(parser, "run_evaluation", False,
              "Run evaluation instead of training")
    _add_bool(parser, "run_continuous_evaluation", False,
              "Continuously evaluate new checkpoints")
    _add_bool(parser, "xla", True, "Accepted and ignored")
    _add_bool(parser, "is_multi_host", False,
              "Join a torch.distributed group from torchrun's environment "
              "and shard the input over its processes")
    _add_bool(parser, "debug", False, "Verbose logging")
    parser.add_argument("--global_seed", type=int, default=1337,
                        help="Global RNG seed")
    parser.add_argument("--log_dir", default="",
                        help="Also write the log to a file in this directory")
    _add_bool(parser, "enable_weights_info", False,
              "Log per-weight norms every 50 outer steps")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def _setup_logging(debug: bool, log_dir: str) -> None:
    level = logging.DEBUG if debug else logging.INFO
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter("%(levelname).1s %(asctime)s %(name)s] "
                            "%(message)s")
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in root.handlers):
        stream = logging.StreamHandler()
        stream.setFormatter(fmt)
        root.addHandler(stream)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handler = logging.FileHandler(
            os.path.join(log_dir, "retinanet_torch.log"))
        handler.setFormatter(fmt)
        root.addHandler(handler)


def main(argv: Optional[List[str]] = None):
    """Parse `argv`, build the Executor and run it; returns what the run
    returns (True when training finished, the scores of an evaluation)."""
    args = build_parser().parse_args(argv)
    from retinanet_torch.core.config import Config
    from retinanet_torch.parallel import distributed

    _setup_logging(args.debug, args.log_dir)
    random.seed(args.global_seed)
    np.random.seed(args.global_seed)
    torch.manual_seed(args.global_seed)

    params = Config(args.config_path).params
    run_mode = params.experiment.get("run_mode", "train")
    if args.run_evaluation:
        run_mode = "val"
    if args.run_continuous_evaluation:
        run_mode = "continuous_eval"

    if not args.is_multi_host:
        return _run(args, params, run_mode)
    distributed.initialize_distributed(device=args.device)
    try:
        return _run(args, params, run_mode)
    finally:
        distributed.shutdown()


def _run(args, params, run_mode: str):
    from retinanet_torch.data.pipeline import InputPipeline
    from retinanet_torch.parallel import distributed
    from retinanet_torch.train.executor import Executor

    # the data index and count of the process grid, which the Executor
    # makes before it reads a batch: the processes of a spatial group read
    # the same files and batches
    def train_input_fn():
        return InputPipeline(
            "train", params, is_multi_host=args.is_multi_host,
            process_index=distributed.data_index(),
            process_count=distributed.data_count(), seed=args.global_seed)

    def val_input_fn():
        # every process walks the whole val record stream in the same order
        # and decodes its contiguous slice of each global batch; the chief
        # scores the gathered detections (Executor.evaluate)
        return InputPipeline(
            "val", params,
            batch_size=distributed.local_batch_size(
                int(params.training.batch_size.val)),
            seed=args.global_seed, val_shard_index=distributed.data_index(),
            val_shard_count=distributed.data_count())

    executor = Executor(
        params,
        run_mode=run_mode,
        model_dir=args.model_dir,
        resume_from=args.resume_from,
        train_input_fn=train_input_fn if "train" in run_mode else None,
        val_input_fn=val_input_fn if run_mode != "train" else None,
        enable_weights_info=args.enable_weights_info,
        device=args.device)
    logging.getLogger(__name__).info(
        "device %s, run mode %s, model_dir %s", executor.device, run_mode,
        executor.model_dir)
    try:
        return executor.run()
    finally:
        executor.close()


if __name__ == "__main__":
    result = main(sys.argv[1:])
    sys.exit(0 if result is not False else 1)
