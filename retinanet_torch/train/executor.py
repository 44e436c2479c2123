"""Executor: the training / evaluation / continuous-evaluation runner
(counterpart of `retinanet_tpu/train/executor.py`).

  * The train step is `train/trainer.py:build_trainer_parts`'s, eager on
    one device, one batch a step. `training.steps_per_execution` (spe) is a
    cadence here, not a stack of batches: metrics are fetched and
    preemption, saves and evaluations are checked every spe steps, as the
    JAX package's multi-step returns only the last step's metrics.
  * Batches come from the host pipeline through `DevicePrefetcher`: pinned
    host memory, the copy to the card on a side stream, a few batches
    ahead.
  * Checkpoints are torch files, `model_dir/checkpoints/<step>.pt`: the
    model's state_dict (parameters and BatchNorm running statistics), the
    optimizer's state (the SGD velocity and the schedule counter), `step`,
    `ema_params` and `normalizer_ema`. A file is written under a temporary
    name and renamed; the 10 newest are kept. Periodic saves copy the state
    to the host at once and write it on one background thread; preemption,
    final and rewind saves block.
  * Loss-inflection recovery rewinds to the checkpoint one save interval
    before the latest; SIGTERM checkpoints at the next step boundary.
  * Evaluation swaps in the EMA parameters when configured, runs the model
    in eval mode through `ops/postprocess.py:make_inference_fn` (NMS on the
    card), one batch deep, and scores COCO mAP on the host.
  * Metrics: JSONL, and TensorBoard event files (`train/event_file.py`,
    written without TensorFlow) under `experiment.tensorboard_dir/<name>/
    train`, or `model_dir/logs/train` when that key is empty; per-weight
    norms and histograms with `enable_weights_info`; throughput meter and
    ETA log lines, optional Discord webhook; a `torch.profiler` window
    from PROFILE_START_STEP to PROFILE_END_STEP (outer steps) under
    `model_dir/profile`.
  * Under a process group (`parallel/distributed.py`) each process trains
    on its share of the global batch (`local_batch_size`) and infers its
    slice of each val batch. The chief alone writes the config, the
    metrics and the checkpoints, and scores COCO on the detections that
    every process gathers to it; every process reads a checkpoint. Every
    decision that changes the control flow is taken from values that are
    the same on every process: the global losses, the step count, the
    SIGTERM flag agreed over the group (`agree_preemption`) and the chief's
    checkpoint listing. Otherwise one process would reach a collective
    that the others never call.
  * Under spatial partitioning (`training.spatial_partition` S > 1, a grid
    of world / S data indices, `parallel/distributed.py:make_grid`) the S
    processes of a data index read the same batches; each trains on its
    band of the rows, and the evaluation runs the band forward and gathers
    the head outputs over the spatial group before post-processing
    (`models/retinanet.py:BandedRetinaNet`). Spatial index 0 alone sends
    its detections to the chief, so that every image counts once.

PyTorch runs eagerly: there is no ahead-of-time compile, so the JAX
package's background precompile of the eval function has no counterpart.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import signal
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from retinanet_torch.core.device import resolve_device
from retinanet_torch.core.strategy import resolve_strategy
from retinanet_torch.data.prefetch import DevicePrefetcher
from retinanet_torch.eval.coco_evaluator import COCOEvaluator
from retinanet_torch.models.retinanet import (BandedRetinaNet, build_model,
                                              flax_path)
from retinanet_torch.ops.postprocess import make_inference_fn
from retinanet_torch.parallel import distributed
from retinanet_torch.train import step as step_lib
from retinanet_torch.train.diagnostics import (
    AverageMeter, DiscordLogger, InflectionDetector, MetricsLogger,
    format_eta)
from retinanet_torch.train.trainer import build_trainer_parts

# "export" builds and restores the state for `python -m
# retinanet_torch.export`; `run()` has nothing to run in it
_RUN_MODES = ("train", "val", "train_val", "continuous_eval", "export")
MAX_CHECKPOINTS = 10
log = logging.getLogger(__name__)


def agree_preemption(local_flag: bool) -> bool:
    """The SIGTERM flag ORed over the processes. A signal reaches each host
    on its own; every process must checkpoint the same step, or one would
    leave for the save while the others wait in the next step's
    all-reduce. The processes call this at the same steps."""
    return distributed.any_process(local_flag)


def _concat_results(parts: List[Dict]) -> Dict:
    """Every process's slice of one val batch, in process order: the global
    batch."""
    if len(parts) == 1:
        return parts[0]
    return {key: ({k: np.concatenate([p[key][k] for p in parts])
                   for k in parts[0][key]}
                  if isinstance(parts[0][key], dict)
                  else np.concatenate([p[key] for p in parts]))
            for key in parts[0]}


class _EvalForward(torch.nn.Module):
    """The eval forward as one module, for `torch.export`: images cast to
    the compute dtype, the raw per-level predictions out."""

    def __init__(self, model: torch.nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, images: torch.Tensor):
        return self.model(images.to(self.dtype))


def _host_copy(value):
    """A copy on the host of every tensor in a nested dict/list."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v) for v in value)
    return value


class Executor:
    def __init__(self,
                 params,
                 run_mode: str,
                 model_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 train_input_fn: Optional[Callable[[], Iterator]] = None,
                 val_input_fn: Optional[Callable[[], Iterator]] = None,
                 enable_tensorboard: bool = True,
                 enable_weights_info: bool = False,
                 device=None):
        if run_mode not in _RUN_MODES:
            raise ValueError(f"run_mode must be one of {_RUN_MODES}")
        self.params = params
        self.run_mode = run_mode
        self.device = resolve_device(device)
        self.train_input_fn = train_input_fn
        self.val_input_fn = val_input_fn

        self.model_dir = os.path.abspath(
            model_dir or os.path.join(
                params.experiment.get("model_dir", "model_files"),
                params.experiment.name))
        os.makedirs(self.model_dir, exist_ok=True)
        self.resume_from = resume_from
        self._chief = distributed.is_chief()
        # the config next to the checkpoints: a run describes itself
        if self._chief:
            with open(os.path.join(self.model_dir,
                                   f"{params.experiment.name}.json"),
                      "w") as f:
                json.dump(params.to_dict(), f, indent=4)

        t = params.training
        self.train_steps = int(t.train_steps)
        self.steps_per_execution = int(t.get("steps_per_execution", 1))
        self.grad_accum = max(1, int(t.get("grad_accum_steps", 1)))
        self.save_every = int(t.save_every)
        self.val_freq = int(t.get("validation_freq", -1))
        self.validation_samples = int(t.get("validation_samples", -1))
        self.batch_size = dict(t.batch_size)
        self.use_ema = bool(t.optimizer.get("use_moving_average", False))
        # per-leg wall-clock breakdown of the most recent evaluate() call
        self.last_eval_timing: Optional[Dict[str, float]] = None

        resolve_strategy(t, self.device)
        self.local_train_batch = distributed.local_batch_size(
            int(self.batch_size["train"]))
        if self.local_train_batch % self.grad_accum:
            raise ValueError(
                f"per-process train batch {self.local_train_batch} not "
                f"divisible by grad_accum_steps={self.grad_accum}")
        if self.steps_per_execution > 1:
            for knob, value in (("save_every", self.save_every),
                                ("validation_freq", self.val_freq)):
                if value > 0 and value % self.steps_per_execution:
                    log.warning(
                        "%s=%d is not a multiple of steps_per_execution=%d;"
                        " it will trigger on the next multiple", knob, value,
                        self.steps_per_execution)

        # -- model / encoder / normalizer / loss / optimizer / step -----------
        parts = build_trainer_parts(
            params, self.device, seed=int(params.experiment.get("seed", 0)))
        self.state = parts.state
        self._train_step = parts.step_fn
        self.anchors = parts.anchors
        self.normalizer = parts.normalizer
        self.compute_dtype = parts.compute_dtype
        self._inference_fn = None  # built at the first evaluation

        # -- checkpointing ----------------------------------------------------
        self.ckpt_dir = os.path.join(self.model_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # one writer thread: saves land in order
        self._saver = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="checkpoint")
        self._pending_saves: List[concurrent.futures.Future] = []

        # -- observability ----------------------------------------------------
        # experiment.tensorboard_dir, when set, is the root of the event
        # files (<root>/<experiment>/train, as the JAX package and the
        # reference put them); the JSONL stays under model_dir/logs
        tb_root = str(params.experiment.get("tensorboard_dir", "") or "")
        self.metrics = MetricsLogger(
            os.path.join(self.model_dir, "logs"), "train",
            use_tensorboard=enable_tensorboard, enabled=self._chief,
            tensorboard_dir=os.path.join(
                tb_root, params.experiment.name, "train") if tb_root else "")
        self.discord = DiscordLogger(enabled=self._chief)
        rec = t.recovery
        self._use_inflection = bool(rec.use_inflection_detector)
        self._inflection = InflectionDetector(
            rec.metric_key, float(rec.threshold)) if self._use_inflection \
            else None
        self._max_trials = int(rec.get("max_trials", 1))
        self._current_trial = 1
        self._profile_start_step = int(
            os.environ.get("PROFILE_START_STEP", 10))
        self._profile_end_step = int(os.environ.get("PROFILE_END_STEP", 12))
        self._profiler = None
        self.enable_weights_info = enable_weights_info
        self._preempt_requested = False
        self.pretrained = None  # (path, matched, skipped) once loaded

        self._setup_state()

    # ------------------------------------------------------------------ state

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def _setup_state(self) -> None:
        if self.resume_from is not None:
            self._restore_checkpoint(step=int(self.resume_from))
        elif (self.params.training.restore_checkpoint
                and self.latest_checkpoint_step() is not None):
            self._restore_checkpoint(step=self.latest_checkpoint_step())
        else:
            self._maybe_load_pretrained()

    def _maybe_load_pretrained(self) -> None:
        """Backbone-checkpoint init, or fine-tuning from a full pretrained
        state, merged by name: a tensor whose name or shape does not match
        is skipped. The source is Flax weights, as the JAX Executor reads
        them (`<src>` ending in `.msgpack`, else `<src>/params.msgpack`: an
        export artifact's directory), or a torch file: a checkpoint of this
        Executor or a bare state_dict. Sets `self.pretrained` to (path,
        matched, skipped)."""
        bb_ckpt = self.params.architecture.backbone.get("checkpoint", "")
        ft = self.params.fine_tuning
        src, scope = None, None
        if ft.get("fine_tune", False) and ft.get("pretrained_checkpoint"):
            src = ft.pretrained_checkpoint
        elif bb_ckpt:
            src, scope = bb_ckpt, "backbone"
        if not src:
            return
        if src.endswith(".msgpack") or os.path.isdir(src):
            path = src if src.endswith(".msgpack") else os.path.join(
                src, "params.msgpack")
            matched, skipped = self._load_flax_pretrained(path, scope)
        else:
            path = src
            matched, skipped = self._load_torch_pretrained(path, scope)
        self.pretrained = (path, matched, skipped)
        log.info("Loaded pretrained weights from %s: %d tensors matched, "
                 "%d skipped", path, matched, skipped)

    def _load_flax_pretrained(self, path: str, scope: Optional[str]):
        """JAX's merge: `params` and `batch_stats` each merged by name into
        the model's own tree; the backbone scope takes the file's
        `backbone` subtree, or the whole file when it has none."""
        from retinanet_torch import convert
        from retinanet_torch.export import msgpack_codec
        if not os.path.exists(path):
            raise FileNotFoundError(f"pretrained weights not found: {path}")
        loaded = msgpack_codec.read_file(path)
        own = convert.torch_to_flax(self.model.state_dict())
        src_params = loaded.get("params", loaded)
        src_stats = loaded.get("batch_stats", {})
        if scope == "backbone":
            src_params = {"backbone": src_params.get("backbone", src_params)}
            src_stats = {"backbone": src_stats.get("backbone", src_stats)}
        params, m1, s1 = convert.merge_by_name(own.get("params", {}),
                                               src_params)
        stats, m2, s2 = convert.merge_by_name(own.get("batch_stats", {}),
                                              src_stats)
        convert.load_flax_variables(
            self.model, {"params": params, "batch_stats": stats})
        return m1 + m2, s1 + s2

    def _load_torch_pretrained(self, path: str, scope: Optional[str]):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"pretrained weights not found: {path}")
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        loaded = loaded.get("model", loaded)
        own = self.model.state_dict()
        merged, matched, skipped = {}, 0, 0
        for name, value in loaded.items():
            if scope is not None and not name.startswith(scope + "."):
                continue
            if name in own and tuple(own[name].shape) == tuple(value.shape):
                merged[name] = value
                matched += 1
            else:
                skipped += 1  # by name: a mismatch is skipped
        self.model.load_state_dict(merged, strict=False)
        return matched, skipped

    def all_checkpoint_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.ckpt_dir):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                steps.append(int(stem))
        return sorted(steps)

    def wait_for_saves(self) -> None:
        """Wait for the background writes; a failed write raises here."""
        pending, self._pending_saves = self._pending_saves, []
        for future in pending:
            future.result()

    def _checkpoint_steps(self) -> List[int]:
        """The chief's listing, on every process. A background save may
        still be writing: settle first, so that no step is named that is
        not on disk. Every choice of a checkpoint comes from here, so that
        no process acts on its own (possibly stale) view of the disk."""
        self.wait_for_saves()
        return distributed.broadcast_from_chief(self.all_checkpoint_steps())

    def latest_checkpoint_step(self) -> Optional[int]:
        steps = self._checkpoint_steps()
        return steps[-1] if steps else None

    def _snapshot(self) -> Dict:
        s = self.state
        return _host_copy({
            "model": s.model.state_dict(),
            "optimizer": s.optimizer.state_dict(),
            "step": int(s.step),
            "ema_params": s.ema_params,
            "normalizer_ema": s.normalizer_ema,
        })

    def _write(self, step: int, snapshot: Dict) -> None:
        path = os.path.join(self.ckpt_dir, f"{step}.pt")
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(snapshot, tmp)
        os.replace(tmp, path)
        for old in self.all_checkpoint_steps()[:-MAX_CHECKPOINTS]:
            os.unlink(os.path.join(self.ckpt_dir, f"{old}.pt"))

    def _save_checkpoint(self, step: int, blocking: bool = True) -> None:
        """Periodic in-loop saves pass `blocking=False`: the copy to the
        host is taken now, the disk write runs on the writer thread. Every
        process calls it at the same step; the chief writes (the state is
        the same on every process)."""
        if not self._chief:
            return
        snapshot = self._snapshot()
        self._pending_saves.append(
            self._saver.submit(self._write, step, snapshot))
        if blocking:
            self.wait_for_saves()

    def _restore_checkpoint(self, step: int) -> None:
        self.wait_for_saves()
        path = os.path.join(self.ckpt_dir, f"{step}.pt")
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        s = self.state
        s.model.load_state_dict(ckpt["model"])
        s.optimizer.load_state_dict(ckpt["optimizer"])
        s.step = int(ckpt["step"])
        if s.ema_params is not None:
            s.ema_params = ckpt["ema_params"]
        if s.normalizer_ema is not None:
            s.normalizer_ema = ckpt["normalizer_ema"]
        log.info("Restored checkpoint at step %d from %s", step,
                 self.ckpt_dir)

    def close(self) -> None:
        """Finish the background writes and close the metrics file."""
        self.wait_for_saves()
        self._saver.shutdown(wait=True)
        self.metrics.close()

    # ------------------------------------------------------------------ train

    def run(self):
        if self.run_mode in ("train", "train_val"):
            return self.train()
        if self.run_mode == "val":
            return self.evaluate()
        if self.run_mode == "continuous_eval":
            return self.continuous_evaluate()
        raise ValueError(f"run() not supported for mode {self.run_mode}")

    def _stop_profiler(self) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            path = os.path.join(self.model_dir, "profile", "trace.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            log.info("Profiler trace written to %s", path)

    def _maybe_profile(self, step: int) -> None:
        if not self._chief:  # one trace file, the chief's process
            return
        spe = self.steps_per_execution
        if step == spe * self._profile_start_step and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(os.path.join(self.model_dir, "profile"),
                        exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            log.info("Starting profiler at step %d", step)
        elif step >= spe * self._profile_end_step:
            self._stop_profiler()

    def _run_training_loop(self) -> bool:
        """One training trial inside a SIGTERM trap: a preemption's SIGTERM
        checkpoints at the next step boundary and returns cleanly, so a
        relaunch resumes where the run stopped."""
        self._preempt_requested = False

        def _on_sigterm(signum, frame):
            del signum, frame
            self._preempt_requested = True
            log.warning("SIGTERM: will checkpoint at the next step boundary "
                        "and exit cleanly")

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not on the main thread (embedded use)
            prev_sigterm = None
        try:
            return self._training_trial()
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)

    def _training_trial(self) -> bool:
        current = int(self.state.step)
        if current >= self.train_steps:
            log.info("Training already completed at step %d", current)
            return True
        log.info("Starting training from step %d for %d steps (trial %d/%d)",
                 current, self.train_steps, self._current_trial,
                 self._max_trials)
        spe = max(self.steps_per_execution, 1)
        # metrics come to the host every `log_every` steps only: each fetch
        # waits for the card
        log_every = spe if spe > 1 else max(
            1, int(self.params.training.get("log_every", 20)))
        if self._use_inflection and spe == 1:
            # the detector samples its metric at the log cadence; a 20-step
            # cadence would miss short divergence spikes
            log_every = 1
        train_iter = iter(self.train_input_fn())
        accum = self.grad_accum

        def make_batch():
            batch = next(train_iter)
            return (step_lib.fold_micro_batches(batch, accum) if accum > 1
                    else batch)

        batches = DevicePrefetcher(make_batch, self._prefetch_depth(),
                                   device=self.device)
        try:
            return self._trial_loop(batches, current, spe, log_every)
        finally:
            batches.close()

    def _prefetch_depth(self) -> int:
        """Batches staged on the device ahead of the step, at least one
        (`training.device_prefetch`), for training and evaluation alike."""
        return max(int(self.params.training.get("device_prefetch", 2)), 1)

    def _trial_loop(self, batches, current: int, spe: int,
                    log_every: int) -> bool:
        meter = AverageMeter()
        global_bs = int(self.batch_size["train"])
        state = self.state
        while current < self.train_steps:
            t0 = time.time()
            # one outer step: spe steps, one batch each; only the last
            # step's metrics are read
            for _ in range(spe):
                state, metrics = self._step_or_name_remedy(state,
                                                           next(batches))
            self._maybe_profile(current)
            prev = current
            current += spe

            should_log = (current % log_every == 0
                          or current >= self.train_steps)
            # several processes agree at the log cadence (the same steps on
            # every process), so that a step is not held up by a host
            # collective
            if distributed.process_count() > 1:
                preempt = (agree_preemption(self._preempt_requested)
                           if should_log else False)
            else:
                preempt = self._preempt_requested
            if preempt:
                self._stop_profiler()
                current = int(state.step)
                self._save_checkpoint(current)
                log.warning("Preemption checkpoint saved at step %d; exiting "
                            "cleanly (a relaunch resumes from here)", current)
                return True
            if should_log:
                metrics = {k: float(v) for k, v in metrics.items()}
                current = int(state.step)
            dt = time.time() - t0
            meter.accumulate(1.0 / dt)
            imgs_per_sec = meter.averaged_value * global_bs * spe
            eta = format_eta((self.train_steps - current)
                             / max(meter.averaged_value * spe, 1e-6))
            if should_log:
                metrics["execution-time"] = round(dt, 4)
                metrics["images-per-second"] = imgs_per_sec
                self.metrics.log(current, metrics)
                log.info("[trial %d/%d][step %d/%d][ETA %s][%.1f imgs/s] %s",
                         self._current_trial, self._max_trials, current,
                         self.train_steps, eta, imgs_per_sec,
                         {k: round(v, 4) for k, v in metrics.items()})

            def _crossed(interval: int) -> bool:
                # robust to spe-sized jumps over the exact multiple
                return interval > 0 and (current // interval) > (
                    prev // interval)

            if self.save_every and _crossed(self.save_every):
                self._save_checkpoint(current, blocking=False)
            if self.enable_weights_info and _crossed(50 * spe):
                self._write_weights_info(current)
            if self._use_inflection and should_log:
                value = float(metrics.get(self._inflection.name, 0.0))
                if self._inflection.is_value_anomalous(value):
                    log.warning("Inflection detected in %s; recent: %s",
                                self._inflection.name,
                                self._inflection.data[-5:])
                    self._current_trial += 1
                    return False
            if (self.val_freq > 0 and _crossed(self.val_freq)
                    and "val" in self.run_mode):
                self.evaluate()

        self._stop_profiler()
        log.info("Saving final checkpoint at step %d", current)
        self._save_checkpoint(current)
        if "val" in self.run_mode and self.val_freq <= 0:
            self.evaluate()
        return True

    def _step_or_name_remedy(self, state, batch):
        """The train step; out of memory, it raises an error that names the
        config, the micro-batch, the peak and `grad_accum_steps`."""
        try:
            return self._train_step(state, batch)
        except torch.OutOfMemoryError as error:
            raise step_lib.out_of_memory(
                error, self.params.experiment.name,
                self.local_train_batch // self.grad_accum, self.grad_accum,
                self.device) from error

    def train(self) -> bool:
        """Training with inflection-recovery retries: on an anomaly, rewind
        to the checkpoint one save interval before the latest."""
        if self.train_input_fn is None:
            raise ValueError("train_input_fn is required for training")
        done = self._run_training_loop()
        while not done and self._current_trial <= self._max_trials:
            steps = self._checkpoint_steps()
            if steps:
                latest = steps[-1]
                rewind = self.save_every * ((latest // self.save_every) - 1)
                if rewind <= 0:
                    break
                target = max((s for s in steps if s <= rewind), default=None)
                if target is None:
                    break
                self._restore_checkpoint(step=target)
            if self._inflection is not None:
                self._inflection.reset()
            done = self._run_training_loop()
        if not done:
            log.warning("Training failed after %d trials", self._current_trial)
        return done

    # ------------------------------------------------------------------- eval

    def _build_inference(self):
        if self._inference_fn is None:
            grid = distributed.grid()
            model = (self.model if grid.spatial_count == 1
                     else BandedRetinaNet(self.model, grid))
            self._inference_fn = make_inference_fn(
                model, self.params, self.anchors, self.normalizer,
                compute_dtype=self.compute_dtype, device=self.device)
        return self._inference_fn

    def _swap_ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """Put the EMA parameters into the model; returns the live ones to
        put back (None without EMA)."""
        if not self.use_ema or self.state.ema_params is None:
            return None
        live = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                live[name] = p.detach().clone()
                p.copy_(self.state.ema_params[name])
        return live

    def _unswap_ema(self, live: Optional[Dict[str, torch.Tensor]]) -> None:
        if live is None:
            return
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(live[name])

    def evaluate(self) -> Dict[str, float]:
        """COCO evaluation over the validation set, bounded by
        `training.validation_samples`. Inference runs one batch deep:
        batch N's detections come to the host after batch N+1 is launched.
        `last_eval_timing` holds the legs in seconds: host_decode and h2d
        (the prefetcher's thread, overlapping the rest), staged_wait,
        dispatch, gather, accumulate, cocoeval, total.

        Under a process group each process's `val_input_fn` yields its
        slice of every global val batch (`val_shard_*`); the detections and
        the images' metadata are gathered to the chief in process order, so
        that every image is counted once, and the chief scores them. The
        other processes return {}. Under a spatial grid the processes of a
        spatial group take the same slice, and only spatial index 0's
        detections are gathered."""
        if self.val_input_fn is None:
            raise ValueError("val_input_fn is required for evaluation")
        infer = self._build_inference()
        sends = distributed.grid().spatial_index == 0
        evaluator = None if not self._chief else COCOEvaluator(
            input_shape=self.params.input.input_shape,
            annotation_file_path=self.params.training.annotation_file_path,
            prediction_file_path=os.path.join(self.model_dir,
                                              "predictions.json"),
            remap_class_ids=bool(
                self.params.training.get("remap_class_ids", False)))
        max_batches = None
        if self.validation_samples > 0:
            max_batches = max(
                self.validation_samples // int(self.batch_size["val"]), 1)
        timing = {"host_decode_s": 0.0, "h2d_s": 0.0, "staged_wait_s": 0.0,
                  "dispatch_s": 0.0, "gather_s": 0.0, "accumulate_s": 0.0}
        batch_iter = iter(self.val_input_fn())
        produced = [0]

        def make_eval_batch():
            if max_batches is not None and produced[0] >= max_batches:
                raise StopIteration
            t0 = time.perf_counter()
            batch = next(batch_iter)
            timing["host_decode_s"] += time.perf_counter() - t0
            produced[0] += 1
            return batch

        def gather_and_accumulate(detections, meta) -> None:
            t0 = time.perf_counter()
            results = None if not sends else {
                "image_id": meta["image_id"],
                "detections": {k: v.cpu().numpy()
                               for k, v in detections.items()},
                "resize_scale": meta["resize_scale"]}
            parts = distributed.gather_to_chief(results)
            timing["gather_s"] += time.perf_counter() - t0
            if evaluator is not None:
                t0 = time.perf_counter()
                evaluator.accumulate_results(_concat_results(
                    [p for p in parts if p is not None]))
                timing["accumulate_s"] += time.perf_counter() - t0

        staged = DevicePrefetcher(make_eval_batch, self._prefetch_depth(),
                                  device=self.device, keys=("image",))
        live = self._swap_ema()
        was_training = self.model.training
        self.model.eval()
        pending = None
        n_batches = 0
        t_eval0 = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(staged)
                except StopIteration:
                    break
                timing["staged_wait_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                detections = infer(batch["image"])
                timing["dispatch_s"] += time.perf_counter() - t0
                if pending is not None:
                    gather_and_accumulate(*pending)
                pending = (detections, batch)
                n_batches += 1
            if pending is not None:
                gather_and_accumulate(*pending)
        finally:
            staged.close()
            self.model.train(was_training)
            self._unswap_ema(live)
        timing["h2d_s"] = staged.stage_seconds
        timing["total_s"] = time.perf_counter() - t_eval0
        timing["n_batches"] = n_batches
        if evaluator is None:
            self.last_eval_timing = dict(timing)
            return {}
        t0 = time.perf_counter()
        scores = evaluator.evaluate()
        timing["cocoeval_s"] = time.perf_counter() - t0
        self.last_eval_timing = dict(timing)
        log.info("Evaluated %d batches (timing: %s)", n_batches,
                 {k: round(v, 3) for k, v in timing.items()})
        step = int(self.state.step)
        self.metrics.log(step, {
            **{f"evaluation/{k}": v for k, v in scores.items()},
            **{f"eval-timing/{k}": v for k, v in timing.items()}})
        if self.discord.enabled:
            self.discord.log(f"[step {step}] eval: {scores}")
        log.info("Evaluation at step %d: %s", step, scores)
        return scores

    def _write_weights_info(self, step: int) -> None:
        """Per-weight L2 norms, computed on the device and fetched once, and
        with TensorBoard each weight's value histogram (`weights-hist/<flax
        path>`), bucketed on the device and fetched once; by the chief (the
        weights are the same on every process)."""
        if not self._chief:
            return
        names, params = zip(*self.model.named_parameters())
        with torch.no_grad():
            norms = torch.stack(
                torch._foreach_norm([p.float() for p in params])).tolist()
        self.metrics.log(step, {f"weights/{flax_path(n)}": v
                                for n, v in zip(names, norms)})
        if self.metrics.has_tensorboard:
            self.metrics.log_histograms(step, {
                f"weights-hist/{flax_path(n)}": p
                for n, p in zip(names, params)})

    # -------------------------------------------------------- introspection

    def _meta_eval_model(self) -> torch.nn.Module:
        """The config's model on `device="meta"`, in eval mode: shapes
        without memory."""
        return build_model(self.params, device="meta").eval()

    def _meta_images(self, batch_size: int) -> torch.Tensor:
        h, w = (int(v) for v in self.params.input.input_shape)
        return torch.zeros((batch_size, h, w,
                            int(self.params.input.channels)),
                           dtype=self.compute_dtype, device="meta")

    def get_flops(self, batch_size: int = 1) -> float:
        """FLOPs of the batch-`batch_size` eval forward pass at the config's
        input shape: 2 x the multiply-adds of every convolution and matmul,
        counted by `torch.utils.flop_counter.FlopCounterMode` on the model
        built on `device="meta"` (no memory is used on the card). JAX's
        counterpart reads XLA's cost analysis of the compiled forward, which
        counts only what its compiler kept (the taps on padding it folded
        away, among others)."""
        from torch.utils.flop_counter import FlopCounterMode
        model = self._meta_eval_model()
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(self._meta_images(batch_size))
        return float(counter.get_total_flops())

    def dump_forward_hlo(self, path: Optional[str] = None) -> str:
        """Write the graph of the batch-1 eval forward, in the compute
        dtype, as text: the `torch.export` program lowered to core ATen
        (`aten.convolution` a conv), traced on `device="meta"`. The name is
        the JAX package's (which writes XLA's HLO), kept so that callers of
        either Executor call the same method; the content is not HLO, so the
        default path is `model_dir/forward.export.txt`. Returns the path."""
        model = self._meta_eval_model()
        module = _EvalForward(model, self.compute_dtype)
        with torch.no_grad():
            program = torch.export.export(
                module, (self._meta_images(1),)).run_decompositions()
        path = path or os.path.join(self.model_dir, "forward.export.txt")
        with open(path, "w") as f:
            f.write(str(program))
        return path

    def continuous_evaluate(self, sleep_time: int = 60,
                            max_iterations: Optional[int] = None):
        """Poll for new checkpoints and evaluate each, until one reaches
        `train_steps`."""
        current = None
        iterations = 0
        while max_iterations is None or iterations < max_iterations:
            latest = self.latest_checkpoint_step()
            if latest is not None and latest != current:
                self._restore_checkpoint(step=latest)
                self.evaluate()
                current = latest
            if int(self.state.step) >= self.train_steps:
                return
            iterations += 1
            log.info("Sleeping %ds before checking for a new checkpoint",
                     sleep_time)
            time.sleep(sleep_time)
