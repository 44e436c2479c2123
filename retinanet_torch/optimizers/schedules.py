"""Learning-rate schedules (counterpart of
`retinanet_tpu/optimizers/schedules.py`).

Each schedule maps an integer step to a Python float. It is evaluated on
the host in float32 arithmetic (numpy scalars), operation for operation as
the JAX package evaluates it, so that both give the same rate at every
step. The piecewise schedule shifts its boundaries by -1, as the reference
does, so the rate changes on the same step numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

_F = np.float32


def piecewise_constant_decay_with_warmup(warmup_learning_rate: float,
                                         warmup_steps: int,
                                         boundaries: Sequence[int],
                                         values: Sequence[float]
                                         ) -> Callable[[int], float]:
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    warmup_lr = _F(warmup_learning_rate)
    warmup = _F(int(warmup_steps))
    bnds = np.asarray([b - 1 for b in boundaries], dtype=np.float32)
    vals = np.asarray(values, dtype=np.float32)
    step_size = _F(float(values[0]) - float(warmup_learning_rate))

    def schedule(step: int) -> float:
        step_f = _F(step)
        if step_f < warmup:
            return float(warmup_lr + step_f / warmup * step_size)
        return float(vals[int(np.sum(step_f > bnds))])

    return schedule


def cosine_decay_with_warmup(initial_learning_rate: float,
                             warmup_learning_rate: float,
                             warmup_steps: int, total_steps: int,
                             alpha: float = 0.0) -> Callable[[int], float]:
    init_lr = _F(initial_learning_rate)
    warmup_lr = _F(warmup_learning_rate)
    warmup = _F(int(warmup_steps))
    decay_steps = _F(int(total_steps) - int(warmup_steps))
    step_size = _F(float(initial_learning_rate)
                   - float(warmup_learning_rate))
    alpha32 = _F(alpha)
    one_minus_alpha = _F(1.0 - float(alpha))

    def schedule(step: int) -> float:
        step_f = _F(step)
        if step_f < warmup:
            return float(warmup_lr + step_f / warmup * step_size)
        # the global step feeds the cosine (not step - warmup_steps), as in
        # the reference
        p = np.minimum(step_f, decay_steps) / decay_steps
        cosine = _F(0.5) * (_F(1.0) + np.cos(_F(math.pi) * p))
        return float(init_lr * (one_minus_alpha * cosine + alpha32))

    return schedule


def inverse_decay(initial_learning_rate: float,
                  decay_rate: float) -> Callable[[int], float]:
    init_lr = _F(initial_learning_rate)
    rate = _F(decay_rate)

    def schedule(step: int) -> float:
        denom = _F(1.0) + rate * _F(step)
        return 0.0 if denom == 0.0 else float(init_lr / denom)

    return schedule


def from_params(lr_params, total_steps: int) -> Callable[[int], float]:
    """Dispatch on `schedule_type`."""
    kind = lr_params.schedule_type
    if kind == "piecewise_constant_decay":
        return piecewise_constant_decay_with_warmup(
            warmup_learning_rate=lr_params.warmup_learning_rate,
            warmup_steps=lr_params.warmup_steps,
            boundaries=list(lr_params["boundaries"]),
            # indexed access: 'values' collides with dict.values
            values=list(lr_params["values"]))
    if kind == "cosine_decay":
        return cosine_decay_with_warmup(
            initial_learning_rate=lr_params.initial_learning_rate,
            warmup_learning_rate=lr_params.warmup_learning_rate,
            warmup_steps=lr_params.warmup_steps,
            total_steps=total_steps,
            alpha=float(lr_params.get("alpha", 0.0)))
    if kind == "inverse_decay":
        return inverse_decay(
            initial_learning_rate=lr_params.initial_learning_rate,
            decay_rate=lr_params.decay_rate)
    raise ValueError(f"Invalid learning rate schedule: {kind}")
