"""Assembly of the train step from a config: the one entry that the card
check, the tests and the later Executor share."""

from __future__ import annotations

from typing import Callable, Tuple

from retinanet_torch.core.device import resolve_device
from retinanet_torch.data import anchors as anchor_lib
from retinanet_torch.data.label_encoder import make_batched_encoder
from retinanet_torch.data.preprocessing import make_device_normalizer
from retinanet_torch.losses.losses import RetinaNetLoss
from retinanet_torch.models.retinanet import _compute_dtype, build_model
from retinanet_torch.optimizers.builder import build_optimizer
from retinanet_torch.train import step as step_lib
from retinanet_torch.train.train_state import TrainState, create_train_state


def build_trainer(params, device=None, seed: int = 0
                  ) -> Tuple[TrainState, Callable]:
    """model -> encoder -> normalizer -> loss -> optimizer -> state -> step,
    from the config tree `params`, on the card unless `device="cpu"`; the
    weights are drawn from `seed`. Returns (state, step_fn) with
    step_fn(state, batch) -> (state, metrics) as `make_train_step` gives it.
    With `training.grad_accum_steps` K > 1 the step takes batches folded by
    `fold_micro_batches(batch, K)`."""
    device = resolve_device(device)
    t = params.training
    freeze = list(t.get("freeze_variables", []))
    model = build_model(params, device=device, seed=seed).train()
    anchors = anchor_lib.from_params(params)
    encoder = make_batched_encoder(
        anchors, params.encoder_params,
        use_iou_targets=bool(
            params.architecture.auxillary_head.use_auxillary_head),
        device=device)
    normalizer = make_device_normalizer(params)
    loss_fn = RetinaNetLoss(int(params.architecture.head.num_classes),
                            params.loss)
    optimizer, schedule = build_optimizer(
        t.optimizer, int(t.train_steps), dict(model.named_parameters()),
        freeze_variables=freeze)
    use_ema = bool(t.optimizer.get("use_moving_average", False))
    state = create_train_state(
        model, optimizer, use_ema=use_ema,
        use_normalizer_ema=loss_fn.use_moving_average)
    step_fn = step_lib.make_train_step(
        model, loss_fn, encoder, normalizer, optimizer, schedule,
        use_weight_decay=bool(t.use_weight_decay),
        weight_decay_alpha=float(t.weight_decay_alpha),
        compute_dtype=_compute_dtype(params.floatx.precision),
        ema_decay=(float(t.optimizer.get("moving_average_decay", 0.0))
                   if use_ema else None),
        grad_accum_steps=int(t.get("grad_accum_steps", 1)),
        freeze_keys=freeze)
    return state, step_fn
