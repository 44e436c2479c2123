"""RetinaNet assembly and `build_model` from config (counterpart of
`retinanet_tpu/models/retinanet.py`).

backbone -> neck -> (optional BalanceFeatures) -> box/class heads. The model
takes NHWC images, as the JAX model does, and returns
  {'class-predictions': {lvl: (B,H,W,A*K)},
   'box-predictions':   {lvl: (B,H,W,A*4)}}.
Inside, tensors are NCHW; the NHWC input viewed as NCHW is a channels-last
tensor, which cuDNN's convolutions keep.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional

import torch
from torch import nn

from retinanet_torch.core.device import resolve_device
from retinanet_torch.models.fpn import FPN, FPNP5
from retinanet_torch.models.heads import (build_auxillary_head,
                                          build_detection_heads)
from retinanet_torch.models.layers import (BalanceFeatures, BatchNorm,
                                           get_activation, init_parameters)
from retinanet_torch.models.resnet import ResNet

# Regexes for layer freezing, written against flax-style parameter paths
# such as 'backbone/group1/block0/conv1/conv/kernel'; the same keys as the
# JAX package. `flax_path` turns a torch name into such a path.
FREEZE_VARS_REGEX = {
    "backbone": re.compile(r"^backbone/"),
    "backbone-bn": re.compile(r"^backbone/.*bn"),
    "fpn": re.compile(r"^neck/"),
    "fpn-bn": re.compile(r"^neck/.*bn"),
    "head": re.compile(r"^(box_head|class_head)/(?!.*prediction)"),
    "head-bn": re.compile(r"^(box_head|class_head)/.*bn"),
    "bn": re.compile(r".*bn"),
    "resnet_initial": re.compile(r"^backbone/(stem|stem_bn)/"),
}


def flax_path(torch_name: str) -> str:
    """'a.b.conv.weight' -> 'a/b/conv/kernel', 'a.bn.weight' -> 'a/bn/scale',
    'a.bn.running_mean' -> 'a/bn/mean'; every other leaf keeps its name. The
    freeze masks and the weight decay match their regexes against this."""
    parts = torch_name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if len(parts) > 1 and parts[-2] == "bn" else "kernel"
    elif leaf in ("running_mean", "running_var"):
        leaf = leaf[len("running_"):]
    return "/".join(parts[:-1] + [leaf])


def freeze_regexes(freeze_keys) -> tuple:
    regexes = []
    for key in freeze_keys:
        if key not in FREEZE_VARS_REGEX:
            raise ValueError(
                f"Unknown freeze_variables key '{key}'. "
                f"Available: {sorted(FREEZE_VARS_REGEX)}")
        regexes.append(FREEZE_VARS_REGEX[key])
    return tuple(regexes)


class RetinaNet(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 box_head: nn.Module, class_head: nn.Module,
                 balance_features: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.box_head = box_head
        self.class_head = class_head
        self.balance_features = balance_features

    def forward(self, images: torch.Tensor
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        features = self.backbone(images.permute(0, 3, 1, 2))
        features = self.neck(features)
        if self.balance_features is not None:
            features = self.balance_features(features)
        return {
            "box-predictions": self.box_head(features),
            "class-predictions": self.class_head(features),
        }


def _compute_dtype(precision: str) -> torch.dtype:
    if precision == "mixed_float16":
        # The JAX package substitutes bf16 for fp16 (no loss scaling
        # needed); the port keeps that mapping so both run the same model.
        logging.getLogger(__name__).warning(
            "floatx.precision='mixed_float16' requested: substituting "
            "bfloat16, as the JAX package does. Set "
            "floatx.precision='mixed_bfloat16' to silence this warning.")
    return {
        "float32": torch.float32,
        "mixed_bfloat16": torch.bfloat16,
        "mixed_float16": torch.bfloat16,
    }[precision]


def build_backbone(arch, bn, dtype, device=None) -> nn.Module:
    kind = arch.backbone.type
    if kind == "resnet":
        return ResNet(depth=int(arch.backbone.depth), bn_epsilon=bn.epsilon,
                      dtype=dtype,
                      remat=bool(arch.backbone.get("remat", False)),
                      device=device)
    if kind.startswith(("efficientnet", "mobiledet")):
        raise NotImplementedError(
            f"backbone {kind!r} is not ported yet: ROADMAP Queue 1 #5 (rest "
            "of the model zoo)")
    raise ValueError(f"Unsupported backbone type: {kind}")


def build_neck(arch, in_channels, bn, activation, dtype,
               device=None) -> nn.Module:
    ff = arch.feature_fusion
    kind = ff.type
    common = dict(
        filters=int(ff.filters),
        min_level=int(ff.min_level),
        max_level=int(ff.max_level),
        backbone_max_level=int(ff.backbone_max_level),
        fusion_mode=ff.get("fusion_mode", "sum"),
        separable_conv=bool(arch.conv_2d.use_seperable_conv),
        bn_epsilon=bn.epsilon, activation=activation, dtype=dtype,
        device=device)
    if kind == "fpn":
        return FPN(in_channels, **common)
    if kind == "fpn_p5":
        return FPNP5(in_channels, **common)
    if kind in ("multi_level_attention", "stacked_multi_level_attention"):
        raise NotImplementedError(
            f"neck {kind!r} is not ported yet: ROADMAP Queue 1 #5 (rest of "
            "the model zoo)")
    raise ValueError(f"Unsupported neck type: {kind}")


def build_model(params, device=None, seed: int = 0) -> RetinaNet:
    """Assemble the detector in eval mode, every parameter drawn from its
    flax initializer's distribution with a `torch.Generator` seeded by
    `seed` (on the CPU, so a seed gives the same weights on every device).
    On `device="meta"` nothing is allocated or drawn (parameter counts)."""
    device = resolve_device(device)
    build_on = device if device.type == "meta" else torch.device("cpu")
    arch = params.architecture
    dtype = _compute_dtype(params.floatx.precision)
    activation = get_activation(arch.activation.type)
    bn = arch.batch_norm
    ff = arch.feature_fusion
    min_level, max_level = int(ff.min_level), int(ff.max_level)

    backbone = build_backbone(arch, bn, dtype, build_on)
    neck = build_neck(arch, backbone.out_channels, bn, activation, dtype,
                      build_on)
    box_head, class_head = build_detection_heads(
        arch.head, in_channels=int(ff.filters),
        min_level=min_level, max_level=max_level,
        separable_conv=bool(arch.conv_2d.use_seperable_conv),
        bn_epsilon=bn.epsilon, activation=activation, dtype=dtype,
        device=build_on)
    if arch.auxillary_head.use_auxillary_head:
        build_auxillary_head()
    balance = None
    if ff.use_balanced_features:
        balance = BalanceFeatures(min_level, max_level, min_level + 1)

    model = RetinaNet(backbone, neck, box_head, class_head, balance)
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.momentum = float(bn.momentum)
    if device.type != "meta":
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
