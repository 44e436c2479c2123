"""Batched inference over the processes of a group (counterpart of the root
`examples/multi_device_inference.py`): every process reads the same global
batches of a folder, serves its contiguous slice of each
(`parallel/distributed.py:process_slice`) on its own card, and the chief
gathers the detections (`gather_to_chief`). In one process (no torchrun)
the whole batch is served on the one card.

    python -m retinanet_torch.examples.multi_device_inference \
        --artifact_dir export/ --image_dir images/ --batch_size 16
    torchrun --nproc_per_node 4 -m \
        retinanet_torch.examples.multi_device_inference --is_multi_host ...
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger("retinanet_torch.examples.multi_device_inference")


def build_parser() -> argparse.ArgumentParser:
    from retinanet_torch.__main__ import _add_bool
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.examples.multi_device_inference",
        description="Serve a folder of images over the group's cards.")
    parser.add_argument("--artifact_dir", required=True,
                        help="Exported serving artifact")
    parser.add_argument("--image_dir", required=True,
                        help="Directory of images")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Global batch (split across the processes)")
    _add_bool(parser, "is_multi_host", False,
              "Join a torch.distributed group from torchrun's environment")
    parser.add_argument("--device", default=None,
                        help="torch device (default: this process's card)")
    return parser


def main(argv: Optional[List[str]] = None) -> Optional[List[Dict]]:
    """Returns the chief's detections per global batch (None elsewhere)."""
    args = build_parser().parse_args(argv)
    from retinanet_torch.__main__ import _setup_logging
    from retinanet_torch.parallel import distributed

    _setup_logging(False, "")
    if args.is_multi_host:
        distributed.initialize_distributed(device=args.device)
    try:
        return _serve(args)
    finally:
        if args.is_multi_host:
            distributed.shutdown()


def _serve(args) -> Optional[List[Dict]]:
    from retinanet_torch.export.serving import load_artifact
    from retinanet_torch.parallel import distributed
    from retinanet_torch.utils.image_utils import ImageGenerator

    index, count = distributed.process_index(), distributed.process_count()
    module = load_artifact(args.artifact_dir, device=args.device)
    log.info("process %d of %d on %s", index, count, module.device)
    gen = ImageGenerator(args.image_dir, module.params.input.input_shape,
                         batch_size=args.batch_size)
    results = []
    total, start = 0, time.perf_counter()
    for batch in gen:
        n = batch.shape[0]
        if n < args.batch_size:  # pad the final batch
            pad = np.zeros((args.batch_size - n,) + batch.shape[1:],
                           batch.dtype)
            batch = np.concatenate([batch, pad])
        det = module.run_inference(
            distributed.process_slice(batch, index, count))
        parts = distributed.gather_to_chief(det)
        if parts is not None:
            merged = {k: np.concatenate([p[k] for p in parts])[:n]
                      for k in parts[0]}
            results.append(merged)
            log.info("batch of %d done; first image's detections: %d", n,
                     int(merged["valid_detections"][0]))
        total += n
    seconds = time.perf_counter() - start
    log.info("%d images in %.2f s (%.1f images/s over %d processes)", total,
             seconds, total / max(seconds, 1e-9), count)
    return results if distributed.is_chief() else None


if __name__ == "__main__":
    main(sys.argv[1:])
