"""Optimizer construction (counterpart of
`retinanet_tpu/optimizers/builder.py`).

  * SGD with the Keras momentum semantics of the reference (`KerasSGD`);
    `adam` and `adamw` map to torch's, driven by the same schedule.
  * Gradient clipping: each tensor to `clipnorm`, then the global norm to
    `clipnorm` (`clip_per_tensor_then_global`).
  * Layer freezing by the config's `freeze_variables` keys: a frozen
    parameter takes no gradient (`requires_grad` off), so it enters neither
    the clip's norms nor any update.

Weight decay is an explicit L2 penalty over the conv kernels added to the
loss (`train/step.py`), not decoupled decay, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from retinanet_torch.models.retinanet import flax_path, freeze_regexes
from retinanet_torch.optimizers import schedules


@torch.no_grad()
def clip_per_tensor_then_global(grads: List[torch.Tensor],
                                threshold: float) -> torch.Tensor:
    """tf.clip_by_norm on each tensor, then tf.clip_by_global_norm, both at
    `threshold`, in place. Returns the global norm after both clips. No
    value leaves the device."""
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.clamp(threshold / torch.clamp(norms, min=1e-20), max=1.0)
    g_norm = torch.linalg.vector_norm(norms * scales)
    g_scale = torch.clamp(threshold / torch.clamp(g_norm, min=1e-20),
                          max=1.0)
    torch._foreach_mul_(grads, list((scales * g_scale).unbind()))
    return g_norm * g_scale


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


class KerasSGD(torch.optim.Optimizer):
    """SGD with the Keras momentum semantics of the reference.

    Keras folds the learning rate into the velocity: `v = momentum * v -
    lr * g`, then `w += v` (Nesterov: `w += momentum * v - lr * g`), so past
    gradients stay scaled by the rate that was active when they were taken.
    `torch.optim.SGD` keeps a raw-gradient buffer and multiplies by the
    current rate: the same under a constant rate, another optimizer under
    warmup and piecewise decay. With momentum 0 there is no buffer.

    `schedule(count)` gives the rate of the update; `count` starts at 0 and
    grows by 1 an update. `clipnorm` clips as
    `clip_per_tensor_then_global` before the update; `last_grad_norm` then
    holds the global norm after the clip (before it when `clipnorm` is
    None)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], momentum: float = 0.0,
                 nesterov: bool = False, clipnorm: Optional[float] = None):
        super().__init__(params, dict(momentum=float(momentum),
                                      nesterov=bool(nesterov)))
        self.schedule = schedule
        self.clipnorm = None if not clipnorm else float(clipnorm)
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    def velocity(self, p: torch.nn.Parameter) -> torch.Tensor:
        state = self.state[p]
        if "velocity" not in state:
            state["velocity"] = torch.zeros_like(p)
        return state["velocity"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasSGD takes no closure")
        lr = float(self.schedule(self.count))
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            self.last_grad_norm = (
                clip_per_tensor_then_global(grads, self.clipnorm)
                if self.clipnorm is not None else global_norm(grads))
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            m = group["momentum"]
            if m == 0.0:
                torch._foreach_add_(params, grads, alpha=-lr)
                continue
            vel = [self.velocity(p) for p in params]
            torch._foreach_mul_(vel, m)
            torch._foreach_add_(vel, grads, alpha=-lr)
            if group["nesterov"]:
                update = torch._foreach_mul(vel, m)
                torch._foreach_add_(update, grads, alpha=-lr)
                torch._foreach_add_(params, update)
            else:
                torch._foreach_add_(params, vel)
        self.count += 1


class _ScheduledTorchOptimizer:
    """torch's Adam or AdamW under the port's schedule and clip: the same
    `step()`, `count`, `schedule` and `last_grad_norm` as `KerasSGD`."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 clipnorm: Optional[float]):
        self.inner = inner
        self.schedule = schedule
        self.clipnorm = None if not clipnorm else float(clipnorm)
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self):
        lr = float(self.schedule(self.count))
        grads = []
        for group in self.inner.param_groups:
            group["lr"] = lr
            grads += [p.grad for p in group["params"] if p.grad is not None]
        if grads:
            self.last_grad_norm = (
                clip_per_tensor_then_global(grads, self.clipnorm)
                if self.clipnorm is not None else global_norm(grads))
        self.inner.step()
        self.count += 1

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)


def freeze_mask_fn(freeze_keys: Sequence[str]) -> Callable[[str], bool]:
    """Returns fn(torch parameter name) -> True when trainable."""
    regexes = freeze_regexes(freeze_keys)

    def trainable(torch_name: str) -> bool:
        path = flax_path(torch_name)
        return not any(r.search(path) for r in regexes)

    return trainable


def build_optimizer(opt_params, train_steps: int,
                    named_parameters: Dict[str, torch.nn.Parameter],
                    freeze_variables: Sequence[str] = ()
                    ) -> Tuple[object, Callable[[int], float]]:
    """Returns (optimizer, schedule) over the trainable ones of
    `named_parameters`; the frozen ones get `requires_grad` off."""
    schedule = schedules.from_params(opt_params.lr_params, train_steps)
    trainable = freeze_mask_fn(freeze_variables)
    params = []
    for name, p in named_parameters.items():
        p.requires_grad_(trainable(name))
        if p.requires_grad:
            params.append(p)
    clipnorm = opt_params.get("clipnorm", None)

    name = opt_params.name.lower()
    if name == "sgd":
        return KerasSGD(
            params, schedule,
            momentum=float(opt_params.get("momentum", 0.0)),
            nesterov=bool(opt_params.get("nesterov", False)),
            clipnorm=clipnorm), schedule
    if name in ("adam", "adamw"):
        # optax defaults: eps 1e-8, adamw weight_decay 1e-4
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        kwargs = {} if name == "adam" else {"weight_decay": 1e-4}
        inner = cls(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                    **kwargs)
        return _ScheduledTorchOptimizer(inner, schedule, clipnorm), schedule
    raise NotImplementedError(
        f"optimizer {opt_params.name!r}: only sgd, adam and adamw are "
        "ported; the by-name optimizer registry is ROADMAP Queue 1 #7")
