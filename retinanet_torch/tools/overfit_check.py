"""End-to-end learning check (the port's counterpart of
`tools/overfit_check.py`): overfit a tiny synthetic dataset through the
Executor in train_val and require COCO AP@0.5 to climb well above zero.

It runs the whole loop: tfrecord writing and reading, JPEG decode, host
preprocessing, label encoding with the matching kernel, SGD, inference
with the NMS kernel, box rescaling and COCOeval. The config is the JAX
tool's: ResNet18, 128x128, FPN 64, two head convs, 16 images, 300 steps.

    python -m retinanet_torch.tools.overfit_check [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, Optional

TARGET_AP = 0.3  # the JAX tool's --target_ap default


def make_params(workdir: str, pattern: str, ann: str, steps: int,
                input_size: int = 128, depth: int = 18, filters: int = 64,
                head_convs: int = 2):
    """The overfit experiment's config, the same tree as the JAX tool's."""
    from retinanet_torch.core import config as cfg
    return cfg.from_dict({
        "experiment": {"name": "overfit",
                       "model_dir": os.path.join(workdir, "models")},
        "input": {"input_shape": [input_size, input_size], "channels": 3},
        "floatx": {"precision":
                   "mixed_bfloat16" if input_size >= 640 else "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": depth},
            "feature_fusion": {"type": "fpn", "filters": filters,
                               "min_level": 3,
                               "max_level": 6, "backbone_max_level": 5},
            "head": {"num_convs": head_convs, "filters": filters,
                     "num_classes": 6,
                     "num_anchors": 9},
        },
        "anchor_params": {
            "areas": [1024.0, 4096.0, 16384.0, 65536.0],
            "aspect_ratios": [0.5, 1.0, 2.0],
            "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "loss": {"box_loss_weight": 50.0},
        "training": {
            "train_steps": steps, "save_every": max(steps, 100),
            "steps_per_execution": 50,
            "batch_size": {"train": 8, "val": 8},
            "annotation_file_path": ann,
            "remap_class_ids": False,
            "use_weight_decay": True, "weight_decay_alpha": 1e-4,
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "clipnorm": 10.0,
                "lr_params": {"schedule_type": "cosine_decay",
                              "initial_learning_rate": 0.08,
                              "warmup_learning_rate": 0.004,
                              "warmup_steps": 30}},
        },
        "dataloader_params": {
            "tfrecords": {"train": pattern, "val": pattern},
            "augmentations": {"use_augmentation": False,
                              "horizontal_flip": False},
            "shuffle_buffer_size": 16},
        "inference": {"mode": "PerClassHardNMS", "score_threshold": 0.3,
                      "pre_nms_top_k": 1000, "max_detections": 25},
    })


def run(workdir: str, steps: int = 300, num_images: int = 16,
        device=None, input_size: int = 128, depth: int = 18,
        filters: int = 64, head_convs: int = 2) -> Dict[str, float]:
    """Train `steps` steps on `num_images` synthetic images, then evaluate;
    returns the COCO scores."""
    from retinanet_torch.data.pipeline import InputPipeline
    from retinanet_torch.data.synthetic import write_synthetic_tfrecords
    from retinanet_torch.train.executor import Executor

    pattern, ann = write_synthetic_tfrecords(
        os.path.join(workdir, "data"), "train", num_shards=1,
        samples_per_shard=num_images, num_classes=6,
        write_annotations=True, seed=11)
    params = make_params(workdir, pattern, ann, steps, input_size, depth,
                         filters, head_convs)
    ex = Executor(
        params, run_mode="train_val",
        train_input_fn=lambda: InputPipeline("train", params, max_boxes=20),
        val_input_fn=lambda: InputPipeline("val", params), device=device)
    try:
        if not ex.train():
            raise RuntimeError("training did not finish")
        return ex.evaluate()
    finally:
        ex.close()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--num_images", type=int, default=16)
    parser.add_argument("--target_ap", type=float, default=TARGET_AP)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="overfit_")
    scores = run(workdir, args.steps, args.num_images, args.device)
    ap50 = scores["AP-IoU=0.50"]
    print(f"AP@0.5 after {args.steps} steps: {ap50:.4f} (target "
          f"{args.target_ap})")
    return 0 if ap50 >= args.target_ap else 1


if __name__ == "__main__":
    sys.exit(main())
