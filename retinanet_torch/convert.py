"""Flax variables <-> torch state_dict, both ways and bit-exact.

The JAX model's `{"params": ..., "batch_stats": ...}` tree, as nested dicts
of numpy arrays, maps leaf by leaf onto the port's modules, whose names
follow the flax paths (`backbone/group1/block0/conv1/conv/kernel` ->
`backbone.group1.block0.conv1.conv.weight`):
  * conv `kernel` (H, W, I, O) -> `weight` (O, I, H, W); a depthwise kernel
    (H, W, 1, C) becomes (C, 1, H, W) by the same transpose;
  * BN `scale` / `bias` -> `weight` / `bias`; `batch_stats` `mean` / `var`
    -> `running_mean` / `running_var`;
  * every other leaf (conv `bias`, fusion weights) keeps its name.
`torch_to_flax` is the inverse. A tree shaped like the parameters (the SGD
velocity) goes through the same two functions as a `params` collection.
A partial tree (pretrained weights of a backbone alone, or of a model with
another head) is merged by name into the model's own whole tree first
(`merge_by_name`), and the whole tree is then loaded.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from retinanet_torch.models.retinanet import flax_path

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "lower_level_weight": "lower_level_weight",
                 "upper_level_weight": "upper_level_weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_torch(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """Convert flax variables to a state_dict. Raises on a leaf it does not
    know how to map."""
    unknown = set(variables_np) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(variables_np.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(
                    f"no torch counterpart for {collection}/"
                    f"{'/'.join(path)}")
            value = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                if value.ndim != 4:
                    raise ValueError(
                        f"{'/'.join(path)}: expected an HWIO kernel, got "
                        f"shape {value.shape}")
                value = value.transpose(3, 2, 0, 1)
            name = ".".join(path[:-1] + (leaves[path[-1]],))
            if name in out:
                raise KeyError(f"two flax leaves map to {name}")
            out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def load_flax_variables(model: nn.Module, variables_np: Mapping) -> None:
    """Copy flax variables into `model`. Every leaf must map, both ways, with
    equal shapes."""
    state = flax_to_torch(variables_np)
    target = model.state_dict()
    missing = sorted(set(target) - set(state))
    extra = sorted(set(state) - set(target))
    if missing or extra:
        raise KeyError(f"flax/torch mismatch: missing in flax {missing}, "
                       f"unused flax leaves {extra}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(target[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(value.shape)} != "
                             f"torch shape {tuple(target[name].shape)}")
    model.load_state_dict(state, strict=True)


def torch_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Convert a state_dict (or any name -> tensor mapping with the model's
    names) to `{"params": ..., "batch_stats": ...}` nested dicts of float32
    numpy arrays. A collection without leaves is left out."""
    out: Dict[str, dict] = {}
    for name, value in state.items():
        path = flax_path(name).split("/")
        leaf = path[-1]
        value = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{name}: expected an OIHW weight, got "
                                 f"shape {value.shape}")
            value = value.transpose(2, 3, 1, 0)
        if leaf in _STAT_LEAVES:
            collection = "batch_stats"
        elif leaf in _PARAM_LEAVES:
            collection = "params"
        else:
            raise KeyError(f"no flax counterpart for {name}")
        node = out.setdefault(collection, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return out


def merge_by_name(dst: Mapping, src: Mapping) -> Tuple[dict, int, int]:
    """`src`'s leaves merged into the tree `dst` where a leaf of the same
    path and shape is there, cast to its dtype; every other key of `src` is
    skipped (a subtree whose counterpart is a leaf counts once). Returns
    (merged, matched, skipped): the JAX Executor's merge of pretrained
    weights (`retinanet_tpu/train/executor.py:_maybe_load_pretrained`)."""
    merged = dict(dst)
    matched = skipped = 0
    for key, value in src.items():
        if key not in dst:
            skipped += 1
            continue
        if isinstance(value, Mapping) and isinstance(dst[key], Mapping):
            merged[key], m, s = merge_by_name(dst[key], value)
            matched += m
            skipped += s
            continue
        if isinstance(value, torch.Tensor):  # a bfloat16 leaf
            value = value.float().numpy()
        shape = getattr(dst[key], "shape", None)
        if hasattr(value, "shape") and shape is not None and \
                tuple(shape) == tuple(value.shape):
            merged[key] = np.asarray(value).astype(dst[key].dtype)
            matched += 1
        else:
            skipped += 1  # another shape: skipped, as JAX loads by name
    return merged, matched, skipped


def velocity_to_flax(optimizer, model: nn.Module) -> Optional[dict]:
    """The SGD velocity as a tree shaped like flax `params` (zeros for a
    parameter that has no buffer yet); None without momentum."""
    if not any(g["momentum"] for g in optimizer.param_groups):
        return None
    named = {name: optimizer.velocity(p)
             for name, p in model.named_parameters() if p.requires_grad}
    return torch_to_flax(named).get("params", {})

