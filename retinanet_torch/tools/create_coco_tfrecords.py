"""CLI: a COCO download directory -> sharded detection tfrecords (the
port's own copy of `retinanet_tpu/tools/create_coco_tfrecords.py`, the
same flags and the same files byte for byte).

    python -m retinanet_torch.tools.create_coco_tfrecords \
        --download_path /data/coco --output_dir /data/coco_tfrecords

Reads `annotations/instances_{train,val}2017.json` and the images under
`{train,val}2017/`; writes `train-0001.tfrecord` ... (`--num_shards`, 256
by default) and `val-0001.tfrecord` ... `val-0032.tfrecord`, with boxes
normalized by the image's size. The label map and the remapping info go
to the working directory. The size comes from decoding the whole image
through the port's JPEG route (`data/host_codec.py:jpeg_size`, on the
worker threads); an image that cannot be read or does not decode whole is
skipped and counted, as the JAX tool skips what `cv2.imdecode` refuses.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from retinanet_torch.tools.parser import log


def _read_with_size(sample: dict) -> Optional[Tuple[bytes, int, int]]:
    """(bytes, height, width), or None for a file that cannot be read or
    that is no whole JPEG."""
    from retinanet_torch.data.host_codec import jpeg_size
    try:
        with open(sample["image"], "rb") as f:
            image = f.read()
        h, w = jpeg_size(image)
    except (OSError, ValueError):
        return None
    return image, h, w


def write_tfrecords(data: List[dict], num_shards: int, output_dir: str,
                    split_name: str, workers: int = 0) -> Dict[str, int]:
    """Write `data`'s samples in `num_shards` shards (sized by the number
    of samples, skipped ones included, as the JAX tool sizes them).
    Returns {"written": n, "skipped": n}."""
    from retinanet_torch.tools.tfrecord_writer import TFrecordWriter
    writer = TFrecordWriter(n_samples=len(data), n_shards=num_shards,
                            output_dir=output_dir, prefix=split_name)
    written = bad = 0
    with ThreadPoolExecutor(workers or os.cpu_count() or 1) as pool:
        for sample, read in zip(data, pool.map(_read_with_size, data)):
            if read is None:
                bad += 1
                continue
            image, h, w = read
            boxes = (np.asarray(sample["label"]["boxes"], np.float32)
                     / np.array([w, h, w, h], np.float32))
            writer.push(image, boxes,
                        np.asarray(sample["label"]["classes"], np.int32),
                        sample["image_id"])
            written += 1
    writer.flush_last()
    if bad:
        log.warning("Skipped %d corrupted samples from %s", bad, split_name)
    return {"written": written, "skipped": bad}


def build_parser() -> argparse.ArgumentParser:
    from retinanet_torch.__main__ import _add_bool
    parser = argparse.ArgumentParser(
        prog="python -m retinanet_torch.tools.create_coco_tfrecords",
        description="COCO annotations and images -> sharded tfrecords.")
    parser.add_argument("--download_path", required=True,
                        help="COCO root directory")
    parser.add_argument("--output_dir", default="coco_tfrecords",
                        help="Output directory")
    parser.add_argument("--num_shards", type=int, default=256,
                        help="Train shards (val is fixed at 32)")
    _add_bool(parser, "remap_class_ids", False,
              "Remap category ids to contiguous [0, N)")
    _add_bool(parser, "only_dump_parsed_dataset", False,
              "Only write label map / remapping info")
    _add_bool(parser, "only_val", False, "Only process the val split")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, int]]:
    """Run the tool on `argv`; returns {split: {"written", "skipped"}}."""
    from retinanet_torch.__main__ import _setup_logging
    from retinanet_torch.tools.coco_parser import CocoParser
    args = build_parser().parse_args(argv)
    _setup_logging(False, "")
    os.makedirs(args.output_dir, exist_ok=True)
    parser = CocoParser(args.download_path,
                        remap_class_ids=args.remap_class_ids,
                        only_val=args.only_val)
    parser.dump_parsed_dataset()
    counts: Dict[str, Dict[str, int]] = {}
    if args.only_dump_parsed_dataset:
        return counts
    if not args.only_val:
        counts["train"] = write_tfrecords(parser.dataset["train"],
                                          args.num_shards, args.output_dir,
                                          "train")
    counts["val"] = write_tfrecords(parser.dataset["val"], 32,
                                    args.output_dir, "val")
    for split, c in counts.items():
        log.info("%s: %d samples written, %d skipped", split, c["written"],
                 c["skipped"])
    return counts


if __name__ == "__main__":
    main(sys.argv[1:])
