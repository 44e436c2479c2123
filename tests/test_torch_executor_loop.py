"""The port's Executor and CLI on the CPU, on their own: checkpoints and
resume, inflection rewind, SIGTERM preemption, the evaluation's bounds,
the steps_per_execution cadence, EMA swap, pretrained loading, the
profiler window, and `python -m retinanet_torch` in process."""

import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch import __main__ as cli  # noqa: E402
from retinanet_torch.core import config as cfg  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords)
from retinanet_torch.train import executor as executor_mod  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402

from test_torch_executor import tiny_tree  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_synthetic_tfrecords(
        str(tmp_path_factory.mktemp("data")), "train", num_shards=2,
        samples_per_shard=8, num_classes=6, write_annotations=True)


def _params(tmp_path, data, **kw):
    pattern, ann = data
    return cfg.from_dict(tiny_tree(tmp_path / "models", pattern, ann, **kw))


def _executor(params, run_mode="train", train_fn=None, **kw):
    # two decode threads: the tests share the CPU with the torch step
    return Executor(
        params, run_mode=run_mode,
        train_input_fn=train_fn or (lambda: InputPipeline(
            "train", params, max_boxes=20, num_workers=2)),
        val_input_fn=lambda: InputPipeline("val", params, num_workers=2),
        device="cpu", **kw)


def _records(tmp_path):
    path = tmp_path / "models" / "exec_test" / "logs" / "train_metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_checkpoint_resume(tmp_path, data):
    params = _params(tmp_path, data, train_steps=6, save_every=3)
    ex = _executor(params)
    assert ex.train()
    assert ex.state.step == 6
    assert ex.all_checkpoint_steps() == [3, 6]
    ckpt = torch.load(str(tmp_path / "models" / "exec_test" / "checkpoints"
                          / "6.pt"), weights_only=True)
    assert sorted(ckpt) == ["ema_params", "model", "normalizer_ema",
                            "optimizer", "step"]
    assert ckpt["step"] == 6 and ckpt["optimizer"]["count"] == 6
    assert [r["step"] for r in _records(tmp_path)] == [1, 2, 3, 4, 5, 6]
    assert (tmp_path / "models" / "exec_test" / "exec_test.json").exists()
    ex.close()

    # a fresh executor resumes from step 6 and does nothing
    ex2 = _executor(params)
    assert ex2.state.step == 6 and ex2.state.optimizer.count == 6
    for name, value in ex2.model.state_dict().items():
        assert torch.equal(value, ex.model.state_dict()[name]), name
    assert ex2.train()
    assert len(_records(tmp_path)) == 6
    ex2.close()


def test_keeps_the_newest_checkpoints(tmp_path, data, monkeypatch):
    assert executor_mod.MAX_CHECKPOINTS == 10
    monkeypatch.setattr(executor_mod, "MAX_CHECKPOINTS", 3)
    params = _params(tmp_path, data, train_steps=5, save_every=1)
    ex = _executor(params)
    assert ex.train()
    assert ex.all_checkpoint_steps() == [3, 4, 5]
    ex.close()


def test_inflection_rewinds_one_save_interval(tmp_path, data, monkeypatch):
    params = _params(tmp_path, data, train_steps=6, save_every=2)
    params.training.recovery.use_inflection_detector = True
    params.training.recovery.metric_key = "total-loss"
    ex = _executor(params)
    calls = []

    def anomalous(value):
        calls.append(value)
        return len(calls) == 5  # at step 5: latest checkpoint 4, rewind 2

    monkeypatch.setattr(ex._inflection, "is_value_anomalous", anomalous)
    assert ex.train()
    assert ex._current_trial == 2
    steps = [r["step"] for r in _records(tmp_path)]
    assert steps == [1, 2, 3, 4, 5, 3, 4, 5, 6]
    assert ex.state.step == 6
    ex.close()


def test_inflection_detector_samples_every_step(tmp_path, data):
    params = _params(tmp_path, data, train_steps=4, save_every=2)
    params.training.recovery.use_inflection_detector = True
    params.training.recovery.metric_key = "total-loss"
    params.training.recovery.threshold = 1e9  # never triggers
    params.training.log_every = 20
    ex = _executor(params)
    assert ex.train()
    assert len(ex._inflection.data) == 4
    ex.close()


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path, data):
    params = _params(tmp_path, data, train_steps=500, save_every=10_000)

    def signalling_input():
        for i, batch in enumerate(InputPipeline("train", params,
                                                max_boxes=20, num_workers=2)):
            if i == 3:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    ex = _executor(params, train_fn=signalling_input)
    assert ex.train()  # a clean return, not a crash
    step = ex.latest_checkpoint_step()
    assert step is not None and 0 < step < 500, step
    # the trap put the previous SIGTERM disposition back
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    ex.close()

    params.training.train_steps = step + 2
    ex2 = _executor(params)
    assert ex2.state.step == step
    assert ex2.train()
    assert ex2.state.step == step + 2
    ex2.close()


@pytest.mark.parametrize("samples,batches", [(8, 1), (-1, 2)],
                         ids=["bounded", "all"])
def test_evaluation_bounds_and_accumulates_each_image_once(
        tmp_path, data, monkeypatch, samples, batches):
    params = _params(tmp_path, data, validation_samples=samples)
    seen = []
    real = executor_mod.COCOEvaluator

    class Spy(real):
        def accumulate_results(self, results, **kw):
            seen.append(np.asarray(results["image_id"]))
            return super().accumulate_results(results, **kw)

    monkeypatch.setattr(executor_mod, "COCOEvaluator", Spy)
    ex = _executor(params, run_mode="val")
    scores = ex.run()
    assert len(seen) == batches
    ids = np.concatenate(seen)
    assert len(ids) == len(np.unique(ids)) == 8 * batches
    assert set(scores) == {"AP-IoU=0.50:0.95", "AP-IoU=0.50", "AP-IoU=0.75",
                           "AR-(all)-IoU=0.50:0.95", "AR-(L)-IoU=0.50:0.95"}
    assert ex.last_eval_timing["n_batches"] == batches
    for leg in ("host_decode_s", "h2d_s", "staged_wait_s", "dispatch_s",
                "gather_s", "accumulate_s", "cocoeval_s", "total_s"):
        assert ex.last_eval_timing[leg] >= 0.0, leg
    record = _records(tmp_path)[-1]
    assert record["eval-timing/n_batches"] == batches
    assert (tmp_path / "models" / "exec_test" / "predictions.json").exists()
    ex.close()


def test_steps_per_execution_is_a_cadence(tmp_path, data):
    params = _params(tmp_path, data, train_steps=6, save_every=3,
                     steps_per_execution=3)
    ex = _executor(params)
    shapes = []
    step = ex._train_step

    def recording(state, batch):
        shapes.append(tuple(batch["image"].shape))
        return step(state, batch)

    ex._train_step = recording
    assert ex.train()
    # one batch a step, never a stack of three
    assert shapes == [(8, 64, 64, 3)] * 6
    assert ex.all_checkpoint_steps() == [3, 6]
    assert [r["step"] for r in _records(tmp_path)] == [3, 6]
    ex.close()


def test_device_prefetch_is_at_least_one_batch(tmp_path, data, monkeypatch):
    """Training and evaluation both stage through the prefetcher, one batch
    deep at least, whatever `training.device_prefetch` says."""
    depths = []
    real = executor_mod.DevicePrefetcher

    def spy(make_batch, depth, **kw):
        depths.append(depth)
        return real(make_batch, depth, **kw)

    monkeypatch.setattr(executor_mod, "DevicePrefetcher", spy)
    params = _params(tmp_path, data, train_steps=1, save_every=1,
                     validation_freq=-1)
    params.training["device_prefetch"] = 0
    ex = _executor(params, run_mode="train_val")
    assert ex.train() and ex.state.step == 1
    ex.close()
    assert depths == [1, 1]


def test_train_val_evaluates_at_validation_freq(tmp_path, data):
    params = _params(tmp_path, data, train_steps=4, save_every=2,
                     validation_freq=2, steps_per_execution=2)
    ex = _executor(params, run_mode="train_val")
    assert ex.run()
    evals = [r["step"] for r in _records(tmp_path)
             if "evaluation/AP-IoU=0.50" in r]
    assert evals == [2, 4]
    ex.close()


def test_ema_swap_leaves_the_model_as_it_was(tmp_path, data):
    params = _params(tmp_path, data, train_steps=2, save_every=2)
    params.training.optimizer.use_moving_average = True
    params.training.optimizer.moving_average_decay = 0.99
    ex = _executor(params, run_mode="train_val")
    assert ex.train()
    before = {k: v.clone() for k, v in ex.model.state_dict().items()}
    ema = {k: v.clone() for k, v in ex.state.ema_params.items()}
    assert any(not torch.equal(ema[k], before[k]) for k in ema)
    ex.evaluate()
    for name, value in ex.model.state_dict().items():
        assert torch.equal(value, before[name]), name
    assert ex.model.training
    ex.close()
    ex2 = _executor(params)  # the EMA goes through the checkpoint
    for name, value in ex2.state.ema_params.items():
        assert torch.equal(value, ema[name]), name
    ex2.close()


def test_pretrained_backbone_by_name(tmp_path, data):
    params = _params(tmp_path, data, train_steps=1, save_every=1)
    ex = _executor(params)
    assert ex.train()
    ex.close()
    src = tmp_path / "models" / "exec_test" / "checkpoints" / "1.pt"
    other = _params(tmp_path / "b", data)
    other.architecture.backbone.checkpoint = str(src)
    other.training.restore_checkpoint = False
    ex2 = _executor(other)
    trained = torch.load(str(src), weights_only=True)["model"]
    for name, value in ex2.model.state_dict().items():
        if name.startswith("backbone."):
            assert torch.equal(value, trained[name]), name
    assert not torch.equal(ex2.model.get_parameter(
        "class_head.prediction.conv.weight"),
        trained["class_head.prediction.conv.weight"])
    ex2.close()


def test_flax_msgpack_pretrained_raises(tmp_path, data):
    params = _params(tmp_path, data)
    params.fine_tuning.fine_tune = True
    params.fine_tuning.pretrained_checkpoint = str(
        tmp_path / "weights" / "params.msgpack")
    # Flax weights are read (`_load_flax_pretrained`); a file
    # that is not there raises, as in the JAX Executor
    with pytest.raises(FileNotFoundError, match="params.msgpack"):
        _executor(params)


def test_profiler_window(tmp_path, data, monkeypatch):
    monkeypatch.setenv("PROFILE_START_STEP", "1")
    monkeypatch.setenv("PROFILE_END_STEP", "2")
    params = _params(tmp_path, data, train_steps=3, save_every=3)
    ex = _executor(params)
    assert ex.train()
    assert (tmp_path / "models" / "exec_test" / "profile"
            / "trace.json").exists()
    ex.close()


def test_continuous_evaluation_scores_the_latest_checkpoint(tmp_path, data):
    params = _params(tmp_path, data, train_steps=2, save_every=2)
    ex = _executor(params)
    assert ex.train()
    ex.close()
    ev = _executor(params, run_mode="continuous_eval")
    ev.continuous_evaluate(sleep_time=0, max_iterations=1)
    assert [r["step"] for r in _records(tmp_path)
            if "evaluation/AP-IoU=0.50" in r] == [2]
    ev.close()


@pytest.mark.parametrize("change,error,match", [
    ({"run_mode": "export"}, ValueError, "not supported for mode export"),
    ({"run_mode": "serve"}, ValueError, "run_mode"),
    ({"strategy": "multi_gpu"}, RuntimeError, "no process group"),
    ({"strategy": "fpga"}, ValueError, "strategy"),
    # one process cannot hold a spatial group of two
    ({"spatial_partition": 2}, ValueError, "not divisible by spatial=2"),
    ({"grad_accum_steps": 3}, ValueError, "grad_accum"),
], ids=["export", "unknown", "multi_gpu", "bad_strategy",
        "spatial", "grad_accum"])
def test_refused_settings(tmp_path, data, change, error, match):
    params = _params(tmp_path, data)
    if "strategy" in change:
        params.training.strategy = {"type": change["strategy"]}
    for key in ("spatial_partition", "grad_accum_steps"):
        if key in change:
            params.training[key] = change[key]
    # export builds (`python -m retinanet_torch.export`); its run() raises
    with pytest.raises(error, match=match):
        Executor(params, run_mode=change.get("run_mode", "train"),
                 device="cpu").run()


def test_cli_train_val_in_process(tmp_path, data):
    pattern, ann = data
    tree = tiny_tree(tmp_path / "models", pattern, ann, train_steps=2,
                     save_every=2, validation_freq=-1)
    tree["experiment"]["run_mode"] = "train_val"
    config = tmp_path / "config.json"
    config.write_text(json.dumps(tree))
    assert cli.main(["--config_path", str(config), "--device", "cpu",
                     "--noxla", "--debug=false", "--global_seed", "3",
                     "--log_dir", str(tmp_path / "log")]) is True
    model_dir = tmp_path / "models" / "exec_test"
    assert sorted(os.listdir(model_dir / "checkpoints")) == ["2.pt"]
    assert (tmp_path / "log" / "retinanet_torch.log").exists()
    evals = [r for r in _records(tmp_path) if "evaluation/AP-IoU=0.50" in r]
    assert [r["step"] for r in evals] == [2]
    scores = cli.main(["--config_path", str(config), "--device", "cpu",
                       "--run_evaluation"])
    assert set(scores) >= {"AP-IoU=0.50", "AP-IoU=0.50:0.95"}


def test_cli_multi_host_raises(tmp_path, data, monkeypatch):
    # outside torchrun there is no group to join: it raises, and nothing
    # falls back to one process
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    pattern, ann = data
    config = tmp_path / "config.json"
    config.write_text(json.dumps(tiny_tree(tmp_path / "models", pattern,
                                           ann)))
    with pytest.raises(RuntimeError, match="no process group"):
        cli.main(["--config_path", str(config), "--device", "cpu",
                  "--is_multi_host"])


@pytest.mark.parametrize("argv,expected", [
    ([], False), (["--run_evaluation"], True),
    (["--run_evaluation=true"], True), (["--run_evaluation=false"], False),
    (["--norun_evaluation"], False), (["--run_evaluation=1"], True)],
    ids=["default", "flag", "eq_true", "eq_false", "no", "eq_1"])
def test_cli_boolean_flags(argv, expected):
    args = cli.build_parser().parse_args(["--config_path", "c.json"] + argv)
    assert args.run_evaluation is expected
    assert args.xla is True and args.device is None
    assert args.global_seed == 1337
