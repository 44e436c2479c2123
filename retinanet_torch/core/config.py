"""Config system: JSON experiment file -> validated, attribute-accessible tree.

The port's own copy of `retinanet_tpu/core/config.py` (the same JSON schema,
defaults and validation), so that `retinanet_torch` never imports the JAX
package, and `trace_reads`, the read-traced copy behind the consumed-knob
audit (`tests/test_torch_knob_audit.py`). Remote (gs://) paths are not
carried over.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping


class ConfigDict(dict):
    """A dict with attribute access. Nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(
                f"Config has no key '{name}'. Available: {sorted(self.keys())}"
            ) from e
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigDict) else (
                dict(v) if isinstance(v, dict) else v)
        return out


def _wrap(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return ConfigDict({k: _wrap(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return [_wrap(v) for v in tree]
    return tree


def deep_merge(base: dict, override: Mapping) -> dict:
    """Recursively merge `override` into `base` (returns new dict)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# Defaults for optional subtrees, identical to the JAX package's.
_DEFAULTS: dict = {
    "floatx": {"precision": "mixed_bfloat16"},
    "architecture": {
        "conv_2d": {"use_seperable_conv": False, "use_bias_before_bn": False},
        "batch_norm": {"use_sync": True, "momentum": 0.99, "epsilon": 1e-3},
        "activation": {"type": "relu"},
        "auxillary_head": {
            "use_auxillary_head": False, "num_convs": 2, "filters": 256},
        "feature_fusion": {
            "type": "fpn",
            "use_balanced_features": False,
            "fusion_mode": "sum",
        },
    },
    "loss": {
        "focal_loss": {"alpha": 0.25, "gamma": 1.5, "label_smoothing": 0.0},
        "smooth_l1_loss": {"delta": 0.1},
        "normalizer": {"use_moving_average": False, "momentum": 0.99},
        "class_loss_weight": 1.0,
        "box_loss_weight": 50.0,
        "auxillary_loss_weight": 0.0,
    },
    "training": {
        "use_weight_decay": True,
        "weight_decay_alpha": 1e-4,
        "strategy": {"type": "tpu", "name": "local"},
        "restore_checkpoint": True,
        "freeze_variables": [],
        "validation_freq": -1,
        "validation_samples": -1,
        "remap_class_ids": True,
        "steps_per_execution": 1,
        "log_every": 20,
        "grad_accum_steps": 1,
        "device_prefetch": 2,
        "spatial_partition": 1,
        "save_every": 1000,
        "recovery": {
            "use_inflection_detector": False,
            "metric_key": "l2-regularization",
            "threshold": 0.05,
            "max_trials": 10,
        },
    },
    "fine_tuning": {"fine_tune": False, "pretrained_checkpoint": ""},
    "anchor_params": {
        "areas": [1024.0, 4096.0, 16384.0, 65536.0, 262144.0],
        "aspect_ratios": [0.5, 1.0, 2.0],
        "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)],
    },
    "encoder_params": {
        "match_iou": 0.5,
        "ignore_iou": 0.5,
        "box_variance": [0.1, 0.1, 0.2, 0.2],
        "scale_box_targets": False,
        "max_boxes": 100,
    },
    "dataloader_params": {
        "augmentations": {
            "use_augmentation": True,
            "horizontal_flip": True,
            "scale_jitter": {"min_scale": 0.1, "max_scale": 2.0},
        },
        "preprocessing": {
            "mean": [127.0, 127.0, 127.0],
            "stddev": [128.0, 128.0, 128.0],
            "pixel_scale": 1.0,
        },
        "shuffle_buffer_size": 1024,
    },
    "inference": {
        "batch_size": 1,
        "mode": "PerClassHardNMS",
        "iou_threshold": 0.5,
        "score_threshold": 0.05,
        "soft_nms_sigma": 0.5,
        "pre_nms_top_k": 5000,
        "filter_per_class": True,
        "max_detections": 100,
    },
}

_REQUIRED_PATHS = [
    "experiment.name",
    "input.input_shape",
    "architecture.backbone.type",
    "architecture.feature_fusion.min_level",
    "architecture.feature_fusion.max_level",
    "architecture.head.num_classes",
    "architecture.head.num_anchors",
]


class ConfigError(ValueError):
    pass


def _check_required(params: ConfigDict) -> None:
    for path in _REQUIRED_PATHS:
        node: Any = params
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                raise ConfigError(f"Missing required config key: '{path}'")
            node = node[part]


def validate(params: ConfigDict) -> ConfigDict:
    _check_required(params)
    arch = params.architecture
    ff = arch.feature_fusion
    if ff.min_level >= ff.max_level:
        raise ConfigError("feature_fusion.min_level must be < max_level")
    n_anchor = (len(params.anchor_params.aspect_ratios)
                * len(params.anchor_params.scales))
    if arch.head.num_anchors != n_anchor:
        raise ConfigError(
            f"head.num_anchors ({arch.head.num_anchors}) != "
            f"len(aspect_ratios) * len(scales) ({n_anchor})")
    h, w = params.input.input_shape
    if h % 2 ** ff.max_level or w % 2 ** ff.max_level:
        raise ConfigError(
            f"input_shape {params.input.input_shape} must be divisible by "
            f"2^max_level ({2 ** ff.max_level})")
    precision = params.floatx.precision
    if precision not in ("float32", "mixed_bfloat16", "mixed_float16"):
        raise ConfigError(f"Unsupported precision: {precision}")
    accum = int(params.training.get("grad_accum_steps", 1))
    if accum < 1:
        raise ConfigError(
            f"training.grad_accum_steps must be >= 1, got {accum}")
    train_bs = params.training.get("batch_size", {}).get("train", None)
    if accum > 1 and train_bs is not None and int(train_bs) % accum:
        raise ConfigError(
            f"batch_size.train ({train_bs}) must be divisible by "
            f"grad_accum_steps ({accum})")
    return params


class Config:
    """Load a JSON experiment config: `Config(path).params` is the tree."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(f"Config file not found: {path}")
        with open(path) as f:
            user = json.load(f)
        merged = deep_merge(copy.deepcopy(_DEFAULTS), user)
        self.params = validate(_wrap(merged))

    def __repr__(self):
        return json.dumps(self.params.to_dict(), indent=2)


def from_dict(tree: Mapping) -> ConfigDict:
    """Build validated params from an in-memory dict (tests / programmatic)."""
    merged = deep_merge(copy.deepcopy(_DEFAULTS), tree)
    return validate(_wrap(merged))


class _TracingConfigDict(ConfigDict):
    """A ConfigDict that records every LEAF read (its dotted path) into a
    shared set. It backs the consumed-knob audit: the port is driven over a
    traced config, and every schema key must have been read or be declared
    inert, which catches a key that is accepted and then ignored.

    Neutral operations record no read: `to_dict()`, plain dict iteration
    (`items`, `keys`, `values`) and `dict(...)` copies, since the Executor
    writes the whole config to JSON at its start."""

    def __init__(self, data: Mapping, prefix: str, reads: set):
        super().__init__()
        object.__setattr__(self, "_trace_prefix", prefix)
        object.__setattr__(self, "_trace_reads", reads)
        for k, v in data.items():
            p = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                dict.__setitem__(self, k, _TracingConfigDict(v, p, reads))
            else:
                dict.__setitem__(self, k, v)

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        if not isinstance(value, dict):
            prefix = self._trace_prefix
            self._trace_reads.add(f"{prefix}.{key}" if prefix else str(key))
        return value

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setattr__(self, name, value):
        if name.startswith("_trace"):
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    def __deepcopy__(self, memo):
        # a deep copy keeps tracing into the same set
        return _TracingConfigDict(
            copy.deepcopy(self.to_dict(), memo),
            self._trace_prefix, self._trace_reads)


def trace_reads(params: ConfigDict):
    """Returns (traced_params, reads): a deep tracing copy of `params` and
    the live set that gathers the dotted leaf paths on every read."""
    reads: set = set()
    return _TracingConfigDict(params, "", reads), reads
