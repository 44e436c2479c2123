"""Train state: everything a train step changes (counterpart of
`retinanet_tpu/train/train_state.py`).

The parameters and the BatchNorm running statistics live in `model`, the
momentum buffers and the schedule counter in `optimizer`; both are updated
in place. `step` counts the optimizer updates taken.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: object
    step: int = 0
    # moving average of the parameters by name, when the config asks for one
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # moving-average loss normalizer, a scalar tensor
    normalizer_ema: Optional[torch.Tensor] = None


def create_train_state(model: nn.Module, optimizer, use_ema: bool = False,
                       use_normalizer_ema: bool = False) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(
        model=model, optimizer=optimizer, step=0,
        ema_params=({name: p.detach().clone()
                     for name, p in model.named_parameters()}
                    if use_ema else None),
        normalizer_ema=(torch.zeros((), dtype=torch.float32, device=device)
                        if use_normalizer_ema else None))
