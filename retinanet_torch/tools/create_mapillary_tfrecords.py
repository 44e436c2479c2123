"""CLI: the Mapillary Traffic Sign dataset -> sharded detection tfrecords
(the port's own copy of `retinanet_tpu/tools/create_mapillary_tfrecords.py`,
the same flags and the same files byte for byte).

    python -m retinanet_torch.tools.create_mapillary_tfrecords \
        --download_path /data/mapillary --output_dir /data/mtsd_tfrecords

Reads `splits/{train,val}.txt`, `annotations/<name>.json` and
`images/<name>.jpg`; writes `train-0001.tfrecord` ... (`--num_shards`, 64
by default) and `val-0001.tfrecord` ... `val-0016.tfrecord`. The boxes are
already normalized by the parser, so no image is decoded; an image that
cannot be read is skipped and counted.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from retinanet_torch.tools.parser import log


def write_tfrecords(data: List[dict], num_shards: int, output_dir: str,
                    split_name: str) -> Dict[str, int]:
    """Returns {"written": n, "skipped": n}."""
    from retinanet_torch.tools.tfrecord_writer import TFrecordWriter
    writer = TFrecordWriter(n_samples=len(data), n_shards=num_shards,
                            output_dir=output_dir, prefix=split_name)
    written = bad = 0
    for sample in data:
        try:
            with open(sample["image"], "rb") as f:
                image = f.read()
        except OSError:
            bad += 1
            continue
        writer.push(image,
                    np.asarray(sample["label"]["boxes"], np.float32),
                    np.asarray(sample["label"]["classes"], np.int32),
                    sample["image_id"])
        written += 1
    writer.flush_last()
    if bad:
        log.warning("Skipped %d unreadable images from %s", bad, split_name)
    return {"written": written, "skipped": bad}


def build_parser() -> argparse.ArgumentParser:
    from retinanet_torch.__main__ import _add_bool
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.tools.create_mapillary_tfrecords",
        description="Mapillary Traffic Sign -> sharded tfrecords.")
    parser.add_argument("--download_path", required=True,
                        help="Mapillary dataset root")
    parser.add_argument("--output_dir", default="mtsd_tfrecords",
                        help="Output directory")
    parser.add_argument("--num_shards", type=int, default=64,
                        help="Train shards (val fixed at 16)")
    _add_bool(parser, "discard_classes", False,
              "Collapse every class to `traffic_sign`")
    _add_bool(parser, "skip_ambiguous", False, "Skip ambiguous instances")
    _add_bool(parser, "only_val", False, "Only process the val split")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, int]]:
    """Run the tool on `argv`; returns {split: {"written", "skipped"}}."""
    from retinanet_torch.__main__ import _setup_logging
    from retinanet_torch.tools.mapillary_parser import MapillaryParser
    args = build_parser().parse_args(argv)
    _setup_logging(False, "")
    os.makedirs(args.output_dir, exist_ok=True)
    parser = MapillaryParser(args.download_path,
                             discard_classes=args.discard_classes,
                             skip_ambiguous=args.skip_ambiguous,
                             only_val=args.only_val)
    parser.dump_parsed_dataset()
    counts: Dict[str, Dict[str, int]] = {}
    if not args.only_val:
        counts["train"] = write_tfrecords(parser.dataset["train"],
                                          args.num_shards, args.output_dir,
                                          "train")
    counts["val"] = write_tfrecords(parser.dataset["val"], 16,
                                    args.output_dir, "val")
    return counts


if __name__ == "__main__":
    main(sys.argv[1:])
