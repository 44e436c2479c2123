"""The port's consumed-knob audit (counterpart of `tests/test_knob_audit.py`):
no config key may be accepted and then ignored.

1. Read tracing: every leaf key in the union of the port's defaults
   (`retinanet_torch/core/config.py:_DEFAULTS`) and every shipped config
   must be READ while the port is driven on the CPU over a
   `trace_reads` copy of a config: Executor train steps, an evaluation,
   export, and a second drive of the paths one run cannot take (cosine
   schedule, fine-tuning restore, backbone checkpoint, SoftNMS, separable
   convs, the auxiliary head). A key the port does not read is declared in
   `INTENTIONALLY_INERT` with its reason, or in `CONSUMED_OUTSIDE_DRIVES`
   with the `file:line` that reads it.
2. Structural knobs (whose job is to change the parameter tree) change the
   shapes of the port's `state_dict`.
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.core import config as cfg  # noqa: E402
from retinanet_torch.core.config import _DEFAULTS  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords)
from retinanet_torch.export.serving import export_artifact  # noqa: E402
from retinanet_torch.models.retinanet import build_model  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Keys the port deliberately does not read, each with its reason.
INTENTIONALLY_INERT = {
    "architecture.feature_fusion.use_residual_connections":
        "inert in the reference and in the JAX package as well: no module "
        "reads it (MobileDet's residual connections are fixed by the "
        "architecture)",
}

# Keys read outside what the drives below reach, with the reading line.
CONSUMED_OUTSIDE_DRIVES = {
    # the CLI maps it to Executor(run_mode=...) before the Executor sees
    # the config; the drives construct Executors directly
    "experiment.run_mode": "retinanet_torch/__main__.py:120",
}


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaf_paths(v, p)
        else:
            yield p


def _schema_paths():
    paths = set(_leaf_paths(_DEFAULTS))
    corpus = glob.glob(os.path.join(REPO, "configs", "**", "*.json"),
                       recursive=True)
    assert len(corpus) >= 15, "shipped config corpus missing?"
    for config_path in corpus:
        with open(config_path) as f:
            paths.update(_leaf_paths(json.load(f)))
    return paths


def _drive_tree(tmp, pattern, ann):
    """A 64x64 ResNet10 config that reaches as many subsystems as one run
    can: EMA, weight decay, clipnorm, Nesterov, gradient accumulation, the
    inflection recovery, augmentations, tensorboard_dir and the backbone
    checkpoint hook."""
    return {
        "experiment": {"name": "audit_drive",
                       "model_dir": os.path.join(tmp, "models"),
                       "run_mode": "train",
                       "tensorboard_dir": os.path.join(tmp, "tb")},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10, "checkpoint": ""},
            "conv_2d": {"use_seperable_conv": False,
                        "use_bias_before_bn": False},
            "batch_norm": {"use_sync": True, "momentum": 0.99,
                           "epsilon": 1e-3},
            "activation": {"type": "relu"},
            "feature_fusion": {"type": "fpn", "filters": 16,
                               "fusion_mode": "sum",
                               "use_balanced_features": True,
                               "use_residual_connections": False,
                               "min_level": 3, "max_level": 5,
                               "backbone_max_level": 5},
            "auxillary_head": {"use_auxillary_head": False,
                               "num_convs": 1, "filters": 16},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "encoder_params": {"match_iou": 0.5, "ignore_iou": 0.5,
                           "box_variance": [0.1, 0.1, 0.2, 0.2],
                           "scale_box_targets": False, "max_boxes": 20},
        "loss": {
            "focal_loss": {"alpha": 0.25, "gamma": 1.5,
                           "label_smoothing": 0.01},
            "smooth_l1_loss": {"delta": 0.1},
            "normalizer": {"use_moving_average": True, "momentum": 0.99},
            "class_loss_weight": 1.0, "box_loss_weight": 50.0,
            "auxillary_loss_weight": 0.0,
        },
        "training": {
            "train_steps": 2, "save_every": 2, "log_every": 1,
            "steps_per_execution": 1, "grad_accum_steps": 2,
            "device_prefetch": 1, "spatial_partition": 1,
            "use_weight_decay": True, "weight_decay_alpha": 1e-4,
            "strategy": {"type": "tpu", "name": "local"},
            "restore_checkpoint": True,
            "freeze_variables": [],
            "validation_freq": -1, "validation_samples": 8,
            "remap_class_ids": True,
            "annotation_file_path": ann,
            "batch_size": {"train": 4, "val": 4},
            "recovery": {"use_inflection_detector": True,
                         "metric_key": "total-loss",
                         "threshold": 1e9, "max_trials": 2},
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "nesterov": True,
                "clipnorm": 10.0,
                "use_moving_average": True, "moving_average_decay": 0.99,
                "lr_params": {"schedule_type": "piecewise_constant_decay",
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 1,
                              "values": [0.01], "boundaries": []}},
        },
        "fine_tuning": {"fine_tune": False, "pretrained_checkpoint": ""},
        "dataloader_params": {
            "tfrecords": {"train": pattern, "val": pattern},
            "augmentations": {"use_augmentation": True,
                              "horizontal_flip": True,
                              "scale_jitter": {"min_scale": 0.5,
                                               "max_scale": 2.0}},
            "preprocessing": {"mean": [127.0, 127.0, 127.0],
                              "stddev": [128.0, 128.0, 128.0],
                              "pixel_scale": 1.0},
            "shuffle_buffer_size": 8},
        "inference": {"batch_size": 1, "mode": "PerClassHardNMS",
                      "iou_threshold": 0.5, "score_threshold": 0.05,
                      "soft_nms_sigma": 0.5, "pre_nms_top_k": 200,
                      "filter_per_class": True, "max_detections": 10,
                      "use_approx_top_k": True,
                      "approx_recall_target": 0.95},
    }


def _pipeline(mode, params):
    # two decode threads: the drive shares the CPU with the torch step
    return lambda: InputPipeline(mode, params, num_workers=2)


@pytest.fixture(scope="module")
def traced_reads(tmp_path_factory):
    """Drive the port over read-traced configs; returns the union of the
    leaf paths read."""
    tmp = str(tmp_path_factory.mktemp("knob_audit"))
    pattern, ann = write_synthetic_tfrecords(
        os.path.join(tmp, "data"), "train", num_shards=2,
        samples_per_shard=8, num_classes=6, write_annotations=True)
    reads = set()

    # drive A: 2 steps (accumulation, EMA, inflection), evaluation, export
    traced_a, reads_a = cfg.trace_reads(
        cfg.from_dict(_drive_tree(tmp, pattern, ann)))
    ex = Executor(traced_a, run_mode="train_val",
                  train_input_fn=_pipeline("train", traced_a),
                  val_input_fn=_pipeline("val", traced_a),
                  enable_tensorboard=True, device="cpu")
    assert ex.train()
    ex.evaluate()
    export_artifact(traced_a, ex.model, os.path.join(tmp, "artifact"))
    ckpt_path = os.path.join(tmp, "artifact", "params.msgpack")
    ex.close()
    reads |= reads_a

    # drive B: the paths one run cannot take: cosine schedule, fine-tuning
    # restore, backbone checkpoint, auxiliary head, SoftNMS (reads
    # soft_nms_sigma), separable convs
    tree_b = _drive_tree(tmp, pattern, ann)
    tree_b["experiment"]["name"] = "audit_drive_b"
    tree_b["architecture"]["backbone"]["checkpoint"] = ckpt_path
    tree_b["architecture"]["conv_2d"]["use_seperable_conv"] = True
    tree_b["architecture"]["auxillary_head"] = {
        "use_auxillary_head": True, "num_convs": 1, "filters": 16}
    tree_b["loss"]["auxillary_loss_weight"] = 0.5
    tree_b["fine_tuning"] = {"fine_tune": True,
                             "pretrained_checkpoint": ckpt_path}
    tree_b["training"]["optimizer"]["lr_params"] = {
        "schedule_type": "cosine_decay", "initial_learning_rate": 0.01,
        "alpha": 0.1, "warmup_learning_rate": 0.001, "warmup_steps": 1}
    tree_b["inference"]["mode"] = "PerClassSoftNMS"
    traced_b, reads_b = cfg.trace_reads(cfg.from_dict(tree_b))
    ex_b = Executor(traced_b, run_mode="val",
                    val_input_fn=_pipeline("val", traced_b),
                    enable_tensorboard=False, device="cpu")
    ex_b.evaluate()
    ex_b.close()
    reads |= reads_b
    return reads


def test_every_config_key_is_read_by_the_port(traced_reads):
    missing = sorted(
        p for p in _schema_paths()
        if p not in traced_reads
        and p not in INTENTIONALLY_INERT
        and p not in CONSUMED_OUTSIDE_DRIVES)
    assert not missing, (
        "config keys never READ while driving the port's train / eval / "
        "export (wire them or declare them in INTENTIONALLY_INERT with a "
        f"reason): {missing}")


def test_inert_list_is_minimal(traced_reads):
    """A key declared inert must be inert: once the port reads it, the
    declaration goes."""
    stale = sorted(set(INTENTIONALLY_INERT) & traced_reads)
    assert not stale, f"keys declared inert but read: {stale}"


def test_selection_lane_keys_are_read(traced_reads):
    """The keys of the selection lane, which no shipped config sets (the
    default lane serves them all), are read when a config sets them."""
    assert {"inference.use_approx_top_k",
            "inference.approx_recall_target"} <= traced_reads


def test_tensorboard_dir_is_read(traced_reads, tmp_path):
    assert "experiment.tensorboard_dir" in traced_reads


def test_outside_sites_read_their_key():
    """Each `file:line` of CONSUMED_OUTSIDE_DRIVES reads its key."""
    for key, site in CONSUMED_OUTSIDE_DRIVES.items():
        path, line = site.rsplit(":", 1)
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert key.rsplit(".", 1)[-1] in text, (key, site, text)


# ------------------------------------------------------------- structural

def _base(neck="fpn"):
    return {
        "experiment": {"name": "audit"},
        "input": {"input_shape": [128, 128], "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 18},
            "feature_fusion": {"type": neck, "fusion_mode": "sum",
                               "filters": 32, "min_level": 3,
                               "max_level": 7, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 32, "num_classes": 8,
                     "num_anchors": 9},
        },
    }


def _state_shapes(tree_overrides, neck="fpn"):
    params = cfg.from_dict(cfg.deep_merge(_base(neck), tree_overrides))
    model = build_model(params, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


STRUCTURAL_KNOBS = [
    # (id, neck type, override that must change the parameter tree)
    ("use_seperable_conv", "fpn",
     {"architecture": {"conv_2d": {"use_seperable_conv": True}}}),
    ("use_bias_before_bn/mlaf", "multi_level_attention",
     {"architecture": {"conv_2d": {"use_bias_before_bn": True}}}),
    ("use_bias_before_bn/stacked", "stacked_multi_level_attention",
     {"architecture": {"conv_2d": {"use_bias_before_bn": True}}}),
    ("use_bias_before_bn/fpn_p5", "fpn_p5",
     {"architecture": {"conv_2d": {"use_bias_before_bn": True}}}),
    ("use_auxillary_head", "fpn",
     {"architecture": {"auxillary_head": {"use_auxillary_head": True}}}),
    ("fusion_mode=fast_attention", "fpn",
     {"architecture": {"feature_fusion": {"fusion_mode": "fast_attention"}}}),
    ("use_channel_attention", "multi_level_attention",
     {"architecture": {"feature_fusion": {"use_channel_attention": True}}}),
    ("head.num_convs", "fpn",
     {"architecture": {"head": {"num_convs": 2}}}),
    ("backbone.depth", "fpn",
     {"architecture": {"backbone": {"depth": 34}}}),
]


@pytest.mark.parametrize(
    "knob_id,neck,override", STRUCTURAL_KNOBS,
    ids=[k for k, _, _ in STRUCTURAL_KNOBS])
def test_structural_knob_changes_state_dict(knob_id, neck, override):
    default = _state_shapes({}, neck=neck)
    flipped = _state_shapes(override, neck=neck)
    assert default != flipped, (
        f"structural knob {knob_id!r} flipped but the state_dict shapes are "
        "the same: the knob is not wired through build_model")


def test_use_balanced_features_changes_outputs():
    """BalanceFeatures has no parameters, so the state_dict cannot show it:
    the forward outputs must change instead."""
    def forward(override):
        params = cfg.from_dict(cfg.deep_merge(_base("fpn"), override))
        model = build_model(params, device="cpu", seed=0).eval()
        x = torch.ones((1, 128, 128, 3), dtype=torch.float32)
        with torch.no_grad():
            return model(x)

    base = forward({})
    flipped = forward(
        {"architecture": {"feature_fusion": {"use_balanced_features": True}}})
    same = all(torch.equal(base[kind][level], flipped[kind][level])
               for kind in base for level in base[kind])
    assert not same, (
        "use_balanced_features flipped but the forward outputs are the same:"
        " BalanceFeatures is not wired through build_model")
