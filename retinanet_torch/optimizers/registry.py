"""The by-name optimizer registry (counterpart of the optax passthrough of
`retinanet_tpu/optimizers/builder.py:175-185`).

The JAX package runs any optax factory named by `training.optimizer.name`,
called with the schedule as its learning rate and with the config fields
that match its signature. Under optax 0.2.6, 23 factories run in its train
step that way; this module holds a torch counterpart of each, as one
`torch.optim.Optimizer` (`RegistryOptimizer`) whose update is the optax
chain, transform by transform, in float32, with `torch._foreach_*` where
the update is elementwise:

  adabelief adadelta adafactor adagrad adamax adamaxw adan amsgrad fromage
  lamb lars lion nadam nadamw noisy_sgd novograd optimistic_adam_v2
  optimistic_gradient_descent radam rmsprop scale_by_learning_rate
  sign_sgd yogi

`SIGNATURES` is the port's own copy of each factory's keywords and their
defaults (optax 0.2.6), so that the port never imports optax; a config
field whose name is there is forwarded (never `learning_rate`). A keyword
that takes a mask or a dtype object (`mask`, `weight_decay_mask`,
`trust_ratio_mask`, `mu_dtype`, `dtype_momentum`) accepts only its default:
a JSON config cannot name a function or a JAX dtype.

Scalars that optax computes from the step count in float32 (the bias
corrections `1 - b**t`, RAdam's `rho`, Adafactor's decay rate, the noise's
standard deviation) are computed on the host in float32, so that no value
leaves the device during a step. `adafactor` factors each tensor over the
two dimensions optax picks on its Flax layout (a conv kernel HWIO, a dense
kernel (in, out)), not on the port's OIHW. `noisy_sgd` draws from a
`torch.Generator` on the parameters' device, seeded from the run's seed (or
from the config's `key` / `seed`); its draws are not JAX's.

The state (moments, the step count, the generator) lives in the
optimizer's `state_dict`, so the Executor's checkpoints carry it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from retinanet_torch.models.retinanet import flax_path

# optax 0.2.6: each factory's keywords (learning_rate left out) and defaults
SIGNATURES: Dict[str, Dict[str, object]] = {
    "adabelief": dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16,
                      nesterov=False),
    "adadelta": dict(rho=0.9, eps=1e-6, weight_decay=0.0,
                     weight_decay_mask=None),
    "adafactor": dict(min_dim_size_to_factor=128, decay_rate=0.8,
                      decay_offset=0, multiply_by_parameter_scale=True,
                      clipping_threshold=1.0, momentum=None,
                      dtype_momentum="float32", weight_decay_rate=None,
                      eps=1e-30, factored=True, weight_decay_mask=None),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "adamax": dict(b1=0.9, b2=0.999, eps=1e-8),
    "adamaxw": dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
                    mask=None),
    "adan": dict(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
                 weight_decay=0.0, mask=None),
    "amsgrad": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                    mu_dtype=None),
    "fromage": dict(min_norm=1e-6),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0, mask=None),
    "lars": dict(weight_decay=0.0, weight_decay_mask=True,
                 trust_coefficient=0.001, eps=0.0, trust_ratio_mask=True,
                 momentum=0.9, nesterov=False),
    "lion": dict(b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3,
                 mask=None),
    "nadam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
                  nesterov=True),
    "nadamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
                   weight_decay=1e-4, mask=None, nesterov=True),
    "noisy_sgd": dict(eta=0.01, gamma=0.55, key=None, seed=None),
    "novograd": dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0,
                     weight_decay=0.0),
    "optimistic_adam_v2": dict(alpha=1.0, beta=1.0, b1=0.9, b2=0.999,
                               eps=1e-8, eps_root=0.0, mu_dtype=None,
                               nesterov=True),
    "optimistic_gradient_descent": dict(alpha=1.0, beta=1.0),
    "radam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0,
                  nesterov=False),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0,
                    eps_in_sqrt=True, centered=False, momentum=None,
                    nesterov=False, bias_correction=False),
    "scale_by_learning_rate": dict(flip_sign=True),
    "sign_sgd": dict(),
    "yogi": dict(b1=0.9, b2=0.999, eps=1e-3),
}

# keywords that take an object no config can name: only the default passes
FIXED_KEYWORDS = ("mask", "weight_decay_mask", "trust_ratio_mask",
                  "mu_dtype", "dtype_momentum")

# optax factories the JAX package's train step cannot run with a schedule
REFUSED = {
    "lbfgs": "its update needs the loss value, the gradient and the loss "
             "function (value, grad, value_fn), which a train step's "
             "update does not pass",
    "optimistic_adam": "it refuses a learning-rate schedule (a float "
                       "learning rate only)",
    "rprop": "it takes a float learning rate only, not a schedule",
    "scale_by_rprop": "it takes a float learning rate only, not a schedule",
    "sm3": "it takes a float learning rate only, not a schedule",
}

_F32 = np.float32


def forwarded_kwargs(name: str, opt_params) -> Dict[str, object]:
    """The keywords of factory `name`: its defaults, overridden by the
    config fields of the same name (never `learning_rate`), as the JAX
    package's `inspect.signature` filter forwards them. Raises ValueError
    for a refused or unknown name and for a value of a fixed keyword other
    than its default."""
    if name in REFUSED:
        raise ValueError(f"optimizer {name!r} cannot run in the train step "
                         f"with a learning-rate schedule: {REFUSED[name]}")
    if name not in SIGNATURES:
        raise ValueError(
            f"Unsupported optimizer: {name!r}; the registry has "
            f"{sorted(SIGNATURES)}, and sgd, adam and adamw")
    kwargs = dict(SIGNATURES[name])
    for key in kwargs:
        if key in opt_params and key != "learning_rate":
            kwargs[key] = opt_params[key]
    for key in FIXED_KEYWORDS:
        if key in kwargs and kwargs[key] != SIGNATURES[name][key]:
            raise ValueError(
                f"optimizer {name!r}: {key}={kwargs[key]!r} is not "
                f"supported; only its default {SIGNATURES[name][key]!r} (a "
                "config cannot name a mask function or a JAX dtype)")
    if name == "noisy_sgd" and kwargs["key"] is not None \
            and kwargs["seed"] is not None:
        raise ValueError("noisy_sgd: only one of seed or key can be given")
    return kwargs


def flax_layout(torch_name: str, ndim: int) -> Tuple[int, ...]:
    """The permutation that views a port tensor in its Flax layout: a conv
    kernel OIHW as HWIO, a dense kernel (out, in) as (in, out); every other
    leaf as it is."""
    if flax_path(torch_name).endswith("kernel"):
        if ndim == 4:
            return (2, 3, 1, 0)
        if ndim == 2:
            return (1, 0)
    return tuple(range(ndim))


def _bias(decay: float, t: int) -> float:
    """optax's `1 - decay**t` in float32 (the float32 power of
    float32(decay), correctly rounded)."""
    return float(_F32(1) - _F32(np.float64(_F32(decay)) ** t))


def _ema_(moments: List[torch.Tensor], x: List[torch.Tensor],
          decay: float) -> None:
    """moments <- (1 - decay) * x + decay * moments, in place (optax's
    `tree_update_moment`, order 1)."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(x, 1.0 - decay))


def _ema_sq_(moments: List[torch.Tensor], x: List[torch.Tensor],
             decay: float) -> None:
    """The same with x * x (order 2)."""
    _ema_(moments, torch._foreach_mul(x, x), decay)


def _safe(norms: torch.Tensor, min_norm: float) -> torch.Tensor:
    """optax's `safe_norm` of stacked L2 norms: `min_norm` where a norm is
    no larger."""
    return torch.where(norms <= min_norm, torch.full_like(norms, min_norm),
                       norms)


def _trust_ratio_(u: List[torch.Tensor], params: List[torch.Tensor],
                  min_norm: float = 0.0, coefficient: float = 1.0,
                  eps: float = 0.0) -> None:
    """optax's `scale_by_trust_ratio`, in place: each tensor's ratio from
    the norms of all tensors at once."""
    p_norm = _safe(torch.stack(torch._foreach_norm(params)), min_norm)
    u_norm = _safe(torch.stack(torch._foreach_norm(u)), min_norm)
    ratio = coefficient * p_norm / (u_norm + eps)
    zero = (p_norm == 0.0) | (u_norm == 0.0)
    ratio = torch.where(zero, torch.ones_like(ratio), ratio)
    torch._foreach_mul_(u, list(ratio.unbind()))


def _rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    """optax's `safe_root_mean_squares`."""
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


def _factored_dims(shape: Sequence[int], factored: bool,
                   min_dim: int) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: (second largest, largest) dimension of the
    Flax shape, when the second largest is at least `min_dim`."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class RegistryOptimizer(torch.optim.Optimizer):
    """One optax factory of `SIGNATURES` over the trainable parameters.

    `named_params` maps the port's parameter names (for the Flax layout) to
    the parameters. `schedule(count)` gives the rate of the update; `count`
    starts at 0 and grows by 1 an update, as optax's counts do. `clipnorm`
    clips as `builder.clip_per_tensor_then_global` before the update;
    `last_grad_norm` then holds the global norm after the clip (before it
    when `clipnorm` is None). A parameter without a gradient takes a zero
    gradient, as JAX differentiates every leaf."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 name: str, schedule: Callable[[int], float],
                 kwargs: Dict[str, object],
                 clipnorm: Optional[float] = None, seed: int = 0):
        if name not in SIGNATURES:
            raise ValueError(f"Unsupported optimizer: {name!r}")
        params = list(named_params.values())
        super().__init__(params, {})
        self.name = name
        self.hyper = dict(kwargs)
        self.schedule = schedule
        self.clipnorm = None if not clipnorm else float(clipnorm)
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._layouts = [flax_layout(n, p.dim())
                         for n, p in named_params.items()]
        self.generator: Optional[torch.Generator] = None
        if name == "noisy_sgd":
            device = params[0].device if params else torch.device("cpu")
            self.generator = torch.Generator(device=device)
            given = self.hyper["key"] if self.hyper["key"] is not None \
                else self.hyper["seed"]
            self.generator.manual_seed(int(seed if given is None
                                           else given))
        self._update = getattr(self, f"_{name}")

    # --------------------------------------------------------------- step

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]]

    def _buffers(self, key: str, init: Callable[[torch.Tensor],
                                                torch.Tensor]):
        """The state `key` of every parameter, made by `init(param)` at its
        first use."""
        out = []
        for p in self._params():
            state = self.state[p]
            if key not in state:
                state[key] = init(p)
            out.append(state[key])
        return out

    def _zeros(self, key: str) -> List[torch.Tensor]:
        return self._buffers(key, lambda p: torch.zeros_like(
            p, memory_format=torch.preserve_format))

    def _full(self, key: str, value: float) -> List[torch.Tensor]:
        return self._buffers(key, lambda p: torch.full_like(p, value))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{self.name} takes no closure")
        # here, not at the top: builder imports this module
        from retinanet_torch.optimizers.builder import (
            clip_per_tensor_then_global, global_norm)
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grads:
            self.last_grad_norm = (
                clip_per_tensor_then_global(grads, self.clipnorm)
                if self.clipnorm is not None else global_norm(grads))
            lr = _F32(self.schedule(self.count))
            updates = self._update(params, grads, lr, self.count + 1)
            torch._foreach_add_(params, updates)
        self.count += 1

    def state_dict(self):
        """torch's optimizer state plus the step count (and the noise
        generator's state)."""
        out = {**super().state_dict(), "count": self.count}
        if self.generator is not None:
            out["generator"] = self.generator.get_state()
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        generator = state_dict.pop("generator", None)
        if self.generator is not None:
            self.generator.set_state(generator.cpu())
        super().load_state_dict(state_dict)

    # ------------------------------------------------------ shared pieces

    @staticmethod
    def _scale(u: List[torch.Tensor], lr) -> List[torch.Tensor]:
        """`scale_by_learning_rate`: u * -lr, the rate in float32."""
        return torch._foreach_mul(u, float(-lr))

    @staticmethod
    def _decayed(u, params, weight_decay: float) -> List[torch.Tensor]:
        """`add_decayed_weights`: u + weight_decay * p."""
        return torch._foreach_add(u, torch._foreach_mul(params,
                                                        float(weight_decay)))

    def _adam(self, grads, t: int, b1: float, b2: float, eps: float,
              eps_root: float, nesterov: bool) -> List[torch.Tensor]:
        """`scale_by_adam`."""
        mu, nu = self._zeros("mu"), self._zeros("nu")
        _ema_(mu, grads, b1)
        _ema_sq_(nu, grads, b2)
        mu_hat = self._mu_hat(mu, grads, b1, t, nesterov)
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_add_(denom, float(eps_root))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(eps))
        return torch._foreach_div(mu_hat, denom)

    @staticmethod
    def _mu_hat(mu, grads, b1: float, t: int, nesterov: bool):
        """The bias-corrected first moment; with Nesterov,
        b1 * mu / (1 - b1^(t+1)) + (1 - b1) * g / (1 - b1^t)."""
        if not nesterov:
            return torch._foreach_div(mu, _bias(b1, t))
        ahead = torch._foreach_div(mu, _bias(b1, t + 1))
        torch._foreach_mul_(ahead, b1)
        now = torch._foreach_div(grads, _bias(b1, t))
        torch._foreach_mul_(now, 1.0 - b1)
        return torch._foreach_add(ahead, now)

    def _optimistic(self, u, t: int, alpha: float, beta: float):
        """`scale_by_optimistic_gradient`: (alpha + beta) * u - beta *
        previous u (u itself at the first step)."""
        prev = self._zeros("previous_gradient")
        if t == 1:
            torch._foreach_copy_(prev, u)
        out = torch._foreach_mul(u, alpha + beta)
        torch._foreach_sub_(out, torch._foreach_mul(prev, beta))
        torch._foreach_copy_(prev, u)
        return out

    def _trace(self, u, decay: float, nesterov: bool):
        """`trace`: the momentum buffer t <- u + decay * t."""
        trace = self._zeros("trace")
        torch._foreach_mul_(trace, decay)
        torch._foreach_add_(trace, u)
        if not nesterov:
            return list(trace)
        return torch._foreach_add(u, torch._foreach_mul(trace, decay))

    # ---------------------------------------------------------- factories

    def _adabelief(self, params, grads, lr, t):
        h = self.hyper
        mu, nu = self._zeros("mu"), self._zeros("nu")
        _ema_(mu, grads, h["b1"])
        _ema_sq_(nu, torch._foreach_sub(grads, mu), h["b2"])
        torch._foreach_add_(nu, float(h["eps_root"]))
        mu_hat = self._mu_hat(mu, grads, h["b1"], t, h["nesterov"])
        denom = torch._foreach_div(nu, _bias(h["b2"], t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        return self._scale(torch._foreach_div(mu_hat, denom), lr)

    def _adadelta(self, params, grads, lr, t):
        h = self.hyper
        u = self._decayed(grads, params, h["weight_decay"])
        e_g, e_x = self._zeros("e_g"), self._zeros("e_x")
        _ema_sq_(e_g, u, h["rho"])
        num = torch._foreach_add(e_x, float(h["eps"]))
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, float(h["eps"]))
        torch._foreach_sqrt_(den)
        u = torch._foreach_mul(torch._foreach_div(num, den), u)
        _ema_sq_(e_x, u, h["rho"])
        return self._scale(u, lr)

    def _adafactor(self, params, grads, lr, t):
        h = self.hyper
        step = t - 1 - int(h["decay_offset"])
        rate = float(1.0 - torch.tensor(step + 1, dtype=torch.float32).pow(
            -float(h["decay_rate"])))
        rate_c = float(_F32(1.0) - _F32(rate))
        eps = float(h["eps"])
        updates = []
        for p, g, perm in zip(params, grads, self._layouts):
            state = self.state[p]
            gf = g.permute(perm)
            dims = _factored_dims(tuple(gf.shape), bool(h["factored"]),
                                  int(h["min_dim_size_to_factor"]))
            sq = gf * gf + eps
            if dims is not None:
                d1, d0 = dims
                if "v_row" not in state:
                    state["v_row"] = torch.zeros_like(sq.mean(dim=d0))
                    state["v_col"] = torch.zeros_like(sq.mean(dim=d1))
                v_row = rate * state["v_row"] + rate_c * sq.mean(dim=d0)
                v_col = rate * state["v_col"] + rate_c * sq.mean(dim=d1)
                state["v_row"], state["v_col"] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean).pow(-0.5)
                col_factor = v_col.pow(-0.5)
                u = (gf * row_factor.unsqueeze(d0)
                     * col_factor.unsqueeze(d1))
            else:
                if "v" not in state:
                    state["v"] = torch.zeros_like(sq)
                v = rate * state["v"] + rate_c * sq
                state["v"] = v
                u = gf * v.pow(-0.5)
            updates.append(u.permute(tuple(np.argsort(perm))))
        if h["clipping_threshold"] is not None:
            threshold = float(h["clipping_threshold"])
            for u in updates:
                rms = torch.sqrt(torch.mean(u * u))
                u.div_(torch.clamp(rms / threshold, min=1.0))
        torch._foreach_mul_(updates, float(lr))
        if h["multiply_by_parameter_scale"]:
            for u, p in zip(updates, params):
                u.mul_(_rms(p, 1e-3))
        if h["momentum"] is not None:
            ema = self._zeros("ema")
            _ema_(ema, updates, float(h["momentum"]))
            updates = list(ema)
        if h["weight_decay_rate"] is not None:
            updates = self._decayed(updates, params, h["weight_decay_rate"])
        return torch._foreach_mul(updates, -1.0)

    def _adagrad(self, params, grads, lr, t):
        h = self.hyper
        sos = self._full("sum_of_squares",
                         float(h["initial_accumulator_value"]))
        torch._foreach_add_(sos, torch._foreach_mul(grads, grads))
        inv = torch._foreach_add(sos, float(h["eps"]))
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(s > 0, i, torch.zeros_like(i))
               for s, i in zip(sos, inv)]
        return self._scale(torch._foreach_mul(inv, grads), lr)

    def _adamax_core(self, grads, t):
        h = self.hyper
        mu, nu = self._zeros("mu"), self._zeros("nu")
        _ema_(mu, grads, h["b1"])
        peak = torch._foreach_abs(grads)
        torch._foreach_add_(peak, float(h["eps"]))
        torch._foreach_mul_(nu, h["b2"])
        torch._foreach_maximum_(nu, peak)
        return torch._foreach_div(torch._foreach_div(mu, _bias(h["b1"], t)),
                                  nu)

    def _adamax(self, params, grads, lr, t):
        return self._scale(self._adamax_core(grads, t), lr)

    def _adamaxw(self, params, grads, lr, t):
        u = self._decayed(self._adamax_core(grads, t), params,
                          self.hyper["weight_decay"])
        return self._scale(u, lr)

    def _adan(self, params, grads, lr, t):
        h = self.hyper
        b1, b2, b3 = h["b1"], h["b2"], h["b3"]
        m, v, n = self._zeros("m"), self._zeros("v"), self._zeros("n")
        prev = self._zeros("g")
        diff = (torch._foreach_mul(grads, 0.0) if t == 1
                else torch._foreach_sub(grads, prev))
        _ema_(m, grads, b1)
        _ema_(v, diff, b2)
        sq = torch._foreach_add(grads, torch._foreach_mul(diff, 1.0 - b2))
        _ema_sq_(n, sq, b3)
        u = torch._foreach_div(m, _bias(b1, t))
        torch._foreach_add_(u, torch._foreach_mul(
            torch._foreach_div(v, _bias(b2, t)), 1.0 - b2))
        denom = torch._foreach_div(n, _bias(b3, t))
        torch._foreach_add_(denom, float(h["eps_root"]))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        u = torch._foreach_div(u, denom)
        torch._foreach_copy_(prev, grads)
        return self._scale(self._decayed(u, params, h["weight_decay"]), lr)

    def _amsgrad(self, params, grads, lr, t):
        h = self.hyper
        mu, nu = self._zeros("mu"), self._zeros("nu")
        nu_max = self._zeros("nu_max")
        _ema_(mu, grads, h["b1"])
        _ema_sq_(nu, grads, h["b2"])
        torch._foreach_maximum_(nu_max,
                                torch._foreach_div(nu, _bias(h["b2"], t)))
        denom = torch._foreach_add(nu_max, float(h["eps_root"]))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        mu_hat = torch._foreach_div(mu, _bias(h["b1"], t))
        return self._scale(torch._foreach_div(mu_hat, denom), lr)

    def _fromage(self, params, grads, lr, t):
        u = [g.clone() for g in grads]
        _trust_ratio_(u, params, min_norm=float(self.hyper["min_norm"]))
        # optax: the rate times 1/sqrt(1 + lr^2); the decay's count never
        # advances, so it keeps the first step's rate
        def mult(rate):
            return _F32(1) / np.sqrt(_F32(1) + rate * rate)
        u = self._scale(u, _F32(mult(lr) * lr))
        first = _F32(self.schedule(0))
        return self._decayed(u, params, float(_F32(mult(first) - _F32(1))))

    def _lamb(self, params, grads, lr, t):
        h = self.hyper
        u = self._adam(grads, t, h["b1"], h["b2"], h["eps"], h["eps_root"],
                       False)
        u = self._decayed(u, params, h["weight_decay"])
        _trust_ratio_(u, params)
        return self._scale(u, lr)

    def _lars(self, params, grads, lr, t):
        h = self.hyper
        u = self._decayed(grads, params, h["weight_decay"])
        _trust_ratio_(u, params, coefficient=float(h["trust_coefficient"]),
                      eps=float(h["eps"]))
        return self._trace(self._scale(u, lr), float(h["momentum"]),
                           bool(h["nesterov"]))

    def _lion(self, params, grads, lr, t):
        h = self.hyper
        mu = self._zeros("mu")
        u = torch._foreach_mul(grads, 1.0 - h["b1"])
        torch._foreach_add_(u, torch._foreach_mul(mu, h["b1"]))
        u = torch._foreach_sign(u)
        _ema_(mu, grads, h["b2"])
        return self._scale(self._decayed(u, params, h["weight_decay"]), lr)

    def _nadam(self, params, grads, lr, t):
        h = self.hyper
        return self._scale(self._adam(grads, t, h["b1"], h["b2"], h["eps"],
                                      h["eps_root"], h["nesterov"]), lr)

    def _nadamw(self, params, grads, lr, t):
        h = self.hyper
        u = self._adam(grads, t, h["b1"], h["b2"], h["eps"], h["eps_root"],
                       h["nesterov"])
        return self._scale(self._decayed(u, params, h["weight_decay"]), lr)

    def _noisy_sgd(self, params, grads, lr, t):
        h = self.hyper
        power = float(torch.tensor(float(t), dtype=torch.float32).pow(
            float(h["gamma"])))
        std = float(np.sqrt(_F32(h["eta"]) / _F32(power)))
        # float32 draws on the generator's device (the parameters'), then
        # in the gradients' dtype and place
        noise = [torch.randn(g.shape, dtype=torch.float32,
                             device=self.generator.device,
                             generator=self.generator).to(g)
                 for g in grads]
        u = torch._foreach_add(grads, torch._foreach_mul(noise, std))
        return self._scale(u, lr)

    def _novograd(self, params, grads, lr, t):
        h = self.hyper
        b1, b2 = h["b1"], h["b2"]
        mu = self._zeros("mu")
        nu = self._buffers("nu", lambda p: torch.zeros(
            (), dtype=p.dtype, device=p.device))
        norms = torch._foreach_norm(grads)
        sq = torch._foreach_mul(norms, norms)
        if t == 1:
            torch._foreach_copy_(nu, sq)
        else:
            _ema_(nu, sq, b2)
        denom = torch._foreach_add(nu, float(h["eps_root"]))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        step = torch._foreach_div(grads, denom)
        torch._foreach_add_(step, torch._foreach_mul(
            params, float(h["weight_decay"])))
        if t == 1:
            torch._foreach_copy_(mu, step)
        else:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, step)
        return self._scale(mu, lr)

    def _optimistic_adam_v2(self, params, grads, lr, t):
        h = self.hyper
        u = self._adam(grads, t, h["b1"], h["b2"], h["eps"], h["eps_root"],
                       h["nesterov"])
        u = self._optimistic(u, t, float(h["alpha"]), float(h["beta"]))
        return self._scale(u, lr)

    def _optimistic_gradient_descent(self, params, grads, lr, t):
        h = self.hyper
        u = self._optimistic(grads, t, float(h["alpha"]), float(h["beta"]))
        return self._scale(u, lr)

    def _radam(self, params, grads, lr, t):
        h = self.hyper
        b1, b2 = h["b1"], h["b2"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        mu, nu = self._zeros("mu"), self._zeros("nu")
        _ema_(mu, grads, b1)
        _ema_sq_(nu, grads, b2)
        b2t = _F32(np.float64(_F32(b2)) ** t)
        ro = _F32(ro_inf) - _F32(2 * t) * b2t / (_F32(1) - b2t)
        mu_hat = self._mu_hat(mu, grads, b1, t, h["nesterov"])
        if not ro >= _F32(h["threshold"]):
            return self._scale(mu_hat, lr)
        r = np.sqrt((ro - _F32(4)) * (ro - _F32(2)) * _F32(ro_inf)
                    / (_F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_add_(denom, float(h["eps_root"]))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        u = torch._foreach_div(torch._foreach_mul(mu_hat, float(r)), denom)
        return self._scale(u, lr)

    def _rmsprop(self, params, grads, lr, t):
        h = self.hyper
        decay = h["decay"]
        nu = self._full("nu", float(h["initial_scale"]))
        _ema_sq_(nu, grads, decay)
        nu_hat = (torch._foreach_div(nu, _bias(decay, t))
                  if h["bias_correction"] else list(nu))
        if h["centered"]:
            mu = self._zeros("mu")
            _ema_(mu, grads, decay)
            mu_hat = (torch._foreach_div(mu, _bias(decay, t))
                      if h["bias_correction"] else list(mu))
            nu_hat = torch._foreach_sub(nu_hat,
                                        torch._foreach_mul(mu_hat, mu_hat))
        if h["eps_in_sqrt"]:
            scaling = torch._foreach_add(nu_hat, float(h["eps"]))
            torch._foreach_rsqrt_(scaling)
        else:
            scaling = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(scaling, float(h["eps"]))
            torch._foreach_reciprocal_(scaling)
        u = self._scale(torch._foreach_mul(scaling, grads), lr)
        if h["momentum"] is None:
            return u
        return self._trace(u, float(h["momentum"]), bool(h["nesterov"]))

    def _scale_by_learning_rate(self, params, grads, lr, t):
        sign = -1.0 if self.hyper["flip_sign"] else 1.0
        return torch._foreach_mul(grads, float(_F32(sign) * lr))

    def _sign_sgd(self, params, grads, lr, t):
        return self._scale(torch._foreach_sign(grads), lr)

    def _yogi(self, params, grads, lr, t):
        h = self.hyper
        b1, b2 = h["b1"], h["b2"]
        mu, nu = self._full("mu", 1e-6), self._full("nu", 1e-6)
        _ema_(mu, grads, b1)
        sq = torch._foreach_mul(grads, grads)
        step = torch._foreach_sign(torch._foreach_sub(nu, sq))
        torch._foreach_mul_(step, 1.0 - b2)
        torch._foreach_sub_(nu, torch._foreach_mul(step, sq))
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(h["eps"]))
        mu_hat = torch._foreach_div(mu, _bias(b1, t))
        return self._scale(torch._foreach_div(mu_hat, denom), lr)
