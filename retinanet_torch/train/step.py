"""The train and eval step factories (counterpart of
`retinanet_tpu/train/step.py`).

One train step, all on the card: normalize the images, cast them to the
compute dtype, encode the labels (anchor matching, without gradient),
forward in training mode, loss plus the L2 penalty, backward, clip, update.
PyTorch runs it eagerly; the model, the optimizer and the `TrainState` are
updated in place, and no value comes back to the host unless the caller
reads a metric.

Weight decay is `alpha * sum(||kernel||^2 / 2)` over every parameter whose
flax-style path ends in `kernel`, minus the frozen ones, added to the loss.

Under data parallelism (`parallel/distributed.py`, a process group of P
processes when the step is built) each process takes its share of the
global batch, and the step differentiates what the JAX package's sharded
step differentiates: (the sum over the global batch of focal + Huber) / the
global normalizer + L2. Each process's loss is its images' sums over the
global normalizer, the gradients are summed over the processes once a step,
after the last micro-batch's backward and before the clip, and the L2
penalty is differentiated on the chief only, so that it counts once. The
logged losses are the global ones, the same on every process.

Under spatial partitioning (a grid of D data indices by S spatial ones,
`parallel/distributed.py:make_grid`) the S processes of a data index take
the same images: each cuts its band of rows (`parallel/spatial.py`), runs
the model on it, and takes the loss of its own anchors over the global
normalizer, whose positives are summed over the data group. The gradients
and the logged losses are summed over the whole world as above; the batch
is the data count's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from retinanet_torch.losses.losses import RetinaNetLoss
from retinanet_torch.models.layers import BatchNorm, spatial_partition
from retinanet_torch.models.retinanet import flax_path, freeze_regexes
from retinanet_torch.parallel import distributed
from retinanet_torch.parallel.spatial import image_band, partition_for
from retinanet_torch.train.train_state import TrainState

BATCH_KEYS = ("image", "boxes", "classes", "valid")


def decay_kernels(model: nn.Module, exclude_regexes=()
                  ) -> List[torch.nn.Parameter]:
    """The parameters under weight decay: conv kernels only, never BN scale
    or bias nor conv biases, and no frozen kernel."""
    out = []
    for name, p in model.named_parameters():
        path = flax_path(name)
        if path.endswith("kernel") and not any(
                r.search(path) for r in exclude_regexes):
            out.append(p)
    return out


def weight_decay_loss(kernels: Sequence[torch.Tensor],
                      alpha: float) -> torch.Tensor:
    """alpha * sum(l2_loss(kernel)) with l2_loss(x) = sum(x^2) / 2, in
    float32."""
    total = None
    for w in kernels:
        term = 0.5 * torch.sum(torch.square(w.to(torch.float32)))
        total = term if total is None else total + term
    return alpha * total


def fold_micro_batches(batch: Dict, k: int) -> Dict:
    """[B, ...] -> [K, B/K, ...]: the layout that a step built with
    `grad_accum_steps = K` takes."""
    return {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
            for key, v in batch.items()}


# the losses that are sums over the images, summed over the processes
_SUMMED_LOSSES = ("box-loss", "class-loss", "weighted-loss",
                  "iou-prediction-loss")


def global_losses(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One process's share of the losses -> the global batch's, in one
    all-reduce: the per-image sums add up over the processes, the
    normalizer and the L2 penalty are the same on every process."""
    keys = [k for k in _SUMMED_LOSSES if k in losses]
    summed = distributed.all_reduce_sum_(torch.stack([losses[k]
                                                      for k in keys]))
    out = dict(losses)
    out.update(zip(keys, summed.unbind()))
    out["total-loss"] = out["weighted-loss"]
    if "l2-regularization" in out:
        out["total-loss"] = out["total-loss"] + out["l2-regularization"]
    return out


def out_of_memory(error: Exception, config_name: str, micro_batch: int,
                  grad_accum_steps: int,
                  device: torch.device) -> torch.OutOfMemoryError:
    """The error to raise in place of an out-of-memory error in a train
    step: it names the config, the micro-batch and the peak, and the remedy.
    Nothing retries at a smaller batch."""
    peak = (f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"
            if device.type == "cuda" else "not measured")
    return torch.OutOfMemoryError(
        f"{config_name}: out of memory in a train step at a micro-batch of "
        f"{micro_batch} images a process (training.grad_accum_steps="
        f"{grad_accum_steps}), peak {peak} allocated. Raise "
        "training.grad_accum_steps, so that the micro-batch (the "
        "per-process batch / grad_accum_steps) fits on the card. "
        f"({error})")


def set_frozen_batch_norms(model: nn.Module, regexes) -> int:
    """A frozen layer's BatchNorm runs in eval mode inside the training
    model: it normalizes by its running statistics and does not move them.
    Module paths get a trailing slash so that regexes written against
    parameter paths ('^backbone/(stem|stem_bn)/') match them. Returns the
    number of frozen BatchNorms."""
    frozen = 0
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            path = name.replace(".", "/") + "/"
            module.frozen = any(r.search(path) for r in regexes)
            frozen += module.frozen
    return frozen


def _mark(marks: Optional[list], name: str) -> None:
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


def make_train_step(model: nn.Module, loss_fn: RetinaNetLoss,
                    encoder: Callable, normalizer: Callable, optimizer,
                    schedule: Callable[[int], float],
                    use_weight_decay: bool, weight_decay_alpha: float,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    ema_decay: Optional[float] = None,
                    grad_accum_steps: int = 1,
                    freeze_keys: Sequence[str] = ()):
    """Returns step(state, batch, marks=None) -> (state, metrics).

    `batch` holds "image" (B, H, W, 3) raw pixels, "boxes" (B, G, 4) centre
    format, "classes" (B, G) and "valid" (B, G), as tensors or numpy arrays;
    the step copies them to the model's device. The metrics are scalar
    tensors on the device, `learning-rate` a float. `state` is updated in
    place and returned. `marks`, when a list, receives (name, CUDA event)
    pairs at the phase boundaries, for timing.

    `grad_accum_steps > 1` runs the batch as K micro-batches in turn: the
    batch arrives stacked [K, B/K, ...] (`fold_micro_batches`), the
    gradients add up in `.grad`, and one optimizer update applies their
    mean, so the schedule, the EMA and `step` advance once. BatchNorm
    moments and the loss normalizer are per micro-batch, and the running
    statistics and the normalizer's moving average advance K times; under
    data parallelism micro-batch i is the union of every process's
    micro-batch i, as JAX folds each host's batch before sharding it.

    Under a spatial grid (`distributed.grid()` when the step is built; the
    encoder then cuts the targets to the same bands) each micro-batch's
    images are cut into this process's band of rows."""
    regexes = freeze_regexes(freeze_keys)
    set_frozen_batch_norms(model, regexes)
    kernels = decay_kernels(model, regexes) if use_weight_decay else []
    trainable = [p for p in model.parameters() if p.requires_grad]
    device = next(model.parameters()).device
    world = distributed.process_count()
    chief = distributed.is_chief()
    grid = distributed.grid()

    def losses_and_backward(state: TrainState, batch: Dict,
                            marks: Optional[list]) -> Dict:
        images, part = batch["image"], None
        if grid.spatial_count > 1:
            part = partition_for(grid, images.shape[1:3])
            images = image_band(images, part)
        images = normalizer(images).to(compute_dtype)
        targets = encoder(batch["boxes"], batch["classes"], batch["valid"])
        _mark(marks, "encode")
        with spatial_partition(part):
            preds = model(images)
        losses, new_norm_ema = loss_fn(targets, preds, state.normalizer_ema)
        total = losses["weighted-loss"]
        if use_weight_decay:
            # constant across micro-batches, so the mean of the accumulated
            # gradients is exact: sum(g + wd) / K == mean(g) + wd; the
            # gradients are summed over the processes, so only the chief's
            # penalty takes one
            with torch.set_grad_enabled(chief):
                l2 = weight_decay_loss(kernels, weight_decay_alpha)
            losses["l2-regularization"] = l2
            if chief:
                total = total + l2
        losses["total-loss"] = total
        _mark(marks, "forward")
        total.backward()
        _mark(marks, "backward")
        if new_norm_ema is not None:
            state.normalizer_ema = new_norm_ema.detach()
        return {k: v.detach() for k, v in losses.items()}

    def step(state: TrainState, batch: Dict, marks: Optional[list] = None
             ) -> Tuple[TrainState, Dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("this step was built for another model or "
                             "optimizer than the state holds")
        if not model.training:
            model.train()
        batch = {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
                 for k in BATCH_KEYS}
        _mark(marks, "start")
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps <= 1:
            losses = losses_and_backward(state, batch, marks)
            batch_size = batch["image"].shape[0]
        else:
            # a batch stacked with K' != K micro-batches would add up K'
            # gradients and scale by 1/K: a wrong effective learning rate
            # with no error
            if batch["image"].shape[0] != grad_accum_steps:
                raise ValueError(
                    f"stacked batch has {batch['image'].shape[0]} "
                    f"micro-batches but the step was built with "
                    f"grad_accum_steps={grad_accum_steps}; the applied "
                    "gradient would be silently mis-scaled")
            losses = None
            for i in range(grad_accum_steps):
                micro = losses_and_backward(
                    state, {k: v[i] for k, v in batch.items()}, marks)
                losses = micro if losses is None else {
                    k: losses[k] + micro[k] for k in micro}
            inv_k = 1.0 / grad_accum_steps
            torch._foreach_mul_([p.grad for p in trainable
                                 if p.grad is not None], inv_k)
            # the mean over micro-batches; the per-image metric below then
            # divides by the micro size: (sum / K) / (B / K) == sum / B
            losses = {k: v * inv_k for k, v in losses.items()}
            batch_size = batch["image"].shape[1]
        if world > 1:
            # one reduction a step (accumulation's no_sync), before the
            # clip inside optimizer.step() sees the gradient
            distributed.all_reduce_gradients(trainable)
            losses = global_losses(losses)
            batch_size *= grid.data_count

        optimizer.step()

        if state.ema_params is not None and ema_decay is not None:
            # tfa MovingAverage with dynamic_decay: min(decay, (1+t)/(10+t))
            t = float(state.step)
            decay = min(float(ema_decay), (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                names = list(state.ema_params)
                params = dict(model.named_parameters())
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, [params[n].detach() for n in names],
                                    alpha=1.0 - decay)
        _mark(marks, "optimizer")

        metrics = dict(losses)
        # the normalizer per image
        metrics["num-anchors-matched"] = (
            losses["num-anchors-matched"] / batch_size)
        # the global norm after the clip, over trainable gradients only
        metrics["gradient-norm"] = optimizer.last_grad_norm
        metrics["learning-rate"] = schedule(state.step)
        state.step += 1
        return state, metrics

    return step


def make_multi_step(step_fn: Callable):
    """`steps_per_execution`: run `step_fn` over batches stacked on a
    leading axis; returns the last step's metrics."""

    def multi_step(state: TrainState, stacked_batch: Dict):
        metrics = None
        for i in range(stacked_batch["image"].shape[0]):
            state, metrics = step_fn(
                state, {k: v[i] for k, v in stacked_batch.items()})
        return state, metrics

    return multi_step


def make_eval_forward(model: nn.Module,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """Forward on the running statistics, without gradient, giving the raw
    per-level predictions; `ops/postprocess.py` attaches separately. The
    model's mode is put back afterwards."""

    def forward(images: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(images.to(compute_dtype))
        finally:
            model.train(was_training)

    return forward
