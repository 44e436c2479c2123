"""Data parallelism over processes (`retinanet_torch/parallel/`) on the CPU:
two processes over gloo against one process at the same global batch.

One spawn of two ranks runs every two-rank check of this file (module
fixture); the one-process references run here. Bounds: synced BatchNorm's
statistics and output to 1e-6 relative, dx, dgamma and dbeta to 1e-5
relative (in bfloat16, y and dx within one bfloat16 rounding more); an
Executor's inflection rewind under a stale non-chief listing lands on the
chief's step on both ranks; the train step (ResNet10-narrow, 64x64, float32, 2 steps) at
K = 1 and K = 2 micro-batches, losses rtol 1e-5 and every parameter and
running statistic within 1e-5 of its tensor's largest magnitude (plus 1e-9
for the rounding noise of the biases in front of a BatchNorm). Across the
ranks everything is bit-equal.
"""

import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.core import config as cfg  # noqa: E402
from retinanet_torch.core.device import resolve_device  # noqa: E402
from retinanet_torch.core.strategy import resolve_strategy  # noqa: E402
from retinanet_torch.data.synthetic import synthetic_train_batch  # noqa: E402
from retinanet_torch.models.layers import BatchNorm  # noqa: E402
from retinanet_torch.parallel import distributed  # noqa: E402
from retinanet_torch.tools.multiprocess_smoke import run_group  # noqa: E402
from retinanet_torch.train import step as step_lib  # noqa: E402
from retinanet_torch.train.executor import (  # noqa: E402
    Executor, agree_preemption)
from retinanet_torch.train.trainer import build_trainer  # noqa: E402

WORLD = 2
SIZE = (64, 64)
GLOBAL_BATCH = 4
STEPS = 2
LOSS_KEYS = ("box-loss", "class-loss", "weighted-loss", "l2-regularization",
             "total-loss", "num-anchors-matched", "iou-prediction-loss",
             "gradient-norm", "learning-rate")


def step_tree(accum=1):
    return {
        "experiment": {"name": "torch_dist"},
        "input": {"input_shape": list(SIZE), "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5,
                               "use_balanced_features": True},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "training": {
            "train_steps": 100,
            "batch_size": {"train": GLOBAL_BATCH, "val": GLOBAL_BATCH},
            "grad_accum_steps": accum,
            "use_weight_decay": True,
            "weight_decay_alpha": 1e-4,
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "nesterov": False,
                "clipnorm": 10.0,
                "lr_params": {
                    "schedule_type": "piecewise_constant_decay",
                    "warmup_learning_rate": 0.002, "warmup_steps": 2,
                    "values": [0.02, 0.002], "boundaries": [50]}},
        },
    }


def global_batches(steps=STEPS):
    return [synthetic_train_batch(GLOBAL_BATCH, SIZE, 20, 5, seed=i)
            for i in range(steps)]


def rank_batch(batch, rank, world, accum):
    """A process's batch, as JAX lays it out: its contiguous slice of the
    global batch, then folded into [K, B_local / K]."""
    local = {k: distributed.process_slice(v, rank, world)
             for k, v in batch.items()}
    return step_lib.fold_micro_batches(local, accum) if accum > 1 else local


def one_process_batch(batch, world, accum):
    """The global batch a one-process step takes for the same arithmetic:
    micro-batch i is the union of every process's micro-batch i."""
    if accum == 1:
        return batch
    parts = [rank_batch(batch, r, world, accum) for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts], axis=1)
            for k in batch}


def randomize_batch_norms(model, seed=0):
    """Seeded BatchNorm scales and offsets, so that no residual branch is
    zero; the same in every process."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.bn.weight.shape[0]
                m.bn.weight.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bn.bias.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, c).astype(np.float32)))


def run_steps(batches, tree, rank=0, world=1, weights=None):
    """One step a batch of `batches` from the same weights (`weights`, a
    state_dict, or the seeded ones); (metrics per step, state_dict)."""
    state, step = build_trainer(cfg.from_dict(tree), device="cpu")
    if weights is None:
        randomize_batch_norms(state.model)
    else:
        state.model.load_state_dict(weights)
    accum = int(tree["training"]["grad_accum_steps"])
    history = []
    for batch in batches:
        state, metrics = step(state, rank_batch(batch, rank, world, accum)
                              if world > 1 else batch)
        history.append({k: float(metrics[k]) for k in LOSS_KEYS})
    return history, {k: v.clone() for k, v in
                     state.model.state_dict().items()}


def decayed_gradients(rank=0, world=1):
    """The gradients that reach the optimizer (summed over the processes)
    in one step with weight_decay_alpha 1: the penalty's gradient, alpha * w,
    then outweighs the loss's, so that a penalty counted on every process
    would show at once above the float32 noise."""
    tree = step_tree()
    tree["training"]["weight_decay_alpha"] = 1.0
    state, step = build_trainer(cfg.from_dict(tree), device="cpu")
    randomize_batch_norms(state.model)
    seen = {}
    apply = state.optimizer.step

    def capture():
        seen.update({n: p.grad.clone() for n, p in
                     state.model.named_parameters() if p.grad is not None})
        return apply()

    state.optimizer.step = capture
    step(state, rank_batch(global_batches(1)[0], rank, world, 1)
         if world > 1 else global_batches(1)[0])
    return seen


# the BatchNorm's input and output dtypes: float32, and the configs' mixed
# bfloat16 (bfloat16 activations, float32 statistics and parameters)
BN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bn_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (8, 5, 5, 6)).astype(np.float32)  # NHWC
    dy = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta = rng.normal(0.0, 0.1, 6).astype(np.float32)
    return x, dy, gamma, beta


def run_batch_norm(x, dy, gamma, beta, dtype="float32"):
    """One training-mode BatchNorm forward and backward on NHWC `x` viewed
    as channels-last NCHW, as the model's tensors are, with x, dy, y and dx
    in `dtype`; dgamma and dbeta summed over the processes, as the train
    step sums every gradient. Tensors come back in float32."""
    dtype = BN_DTYPES[dtype]
    bn = BatchNorm(6, momentum=0.9, dtype=dtype).train()
    with torch.no_grad():
        bn.bn.weight.copy_(torch.from_numpy(gamma))
        bn.bn.bias.copy_(torch.from_numpy(beta))
        bn.bn.running_mean.zero_()
        bn.bn.running_var.fill_(1.0)
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    assert y.dtype == dtype
    y.backward(torch.from_numpy(dy).to(dtype).permute(0, 3, 1, 2))
    assert xt.grad.dtype == dtype
    grads = distributed.all_reduce_sum_(
        torch.cat([bn.bn.weight.grad, bn.bn.bias.grad]))
    return {"y": y.detach().float().permute(0, 2, 3, 1).numpy(),
            "dx": xt.grad.float().permute(0, 2, 3, 1).numpy(),
            "dgamma": grads[:6].numpy(), "dbeta": grads[6:].numpy(),
            "mean": bn.bn.running_mean.numpy().copy(),
            "var": bn.bn.running_var.numpy().copy()}


def rewind_tree(model_dir):
    """`step_tree` in an Executor that saves every REWIND_SAVE_EVERY steps
    and may take a second trial."""
    tree = step_tree()
    tree["experiment"]["model_dir"] = model_dir
    tree["training"].update(
        train_steps=REWIND_STEPS, save_every=REWIND_SAVE_EVERY, log_every=1,
        recovery={"use_inflection_detector": True,
                  "metric_key": "total-loss", "threshold": 1.0,
                  "max_trials": 2})
    return tree


REWIND_STEPS = 8
REWIND_SAVE_EVERY = 2
REWIND_ANOMALY_AT = 7   # the 7th logged value: steps 2, 4, 6 are on disk
REWIND_TARGET = 4       # one save interval before the latest, 6


class _OneAnomaly:
    """An inflection detector that flags the REWIND_ANOMALY_AT-th value of
    its first trial, and nothing after (the same on every process, as the
    logged losses are)."""
    name = "total-loss"

    def __init__(self):
        self.data, self.fired = [], False

    def is_value_anomalous(self, value):
        self.data.append(value)
        if not self.fired and len(self.data) == REWIND_ANOMALY_AT:
            self.fired = True
            return True
        return False

    def reset(self):
        self.data = []


def rewind_under_group(model_dir):
    """An Executor's inflection rewind in each process of a group, where
    every process but the chief lists the checkpoint directory as it stood
    after the first save (a shared filesystem that caches listings). The
    chief's listing must decide: (steps restored, final step, state)."""
    rank, world = distributed.process_index(), distributed.process_count()
    batches = [rank_batch(b, rank, world, 1) for b in global_batches()]
    ex = Executor(cfg.from_dict(rewind_tree(model_dir)), "train",
                  train_input_fn=lambda: itertools.cycle(batches),
                  device="cpu")
    if rank != 0:
        listing = ex.all_checkpoint_steps
        ex.all_checkpoint_steps = lambda: [
            s for s in listing() if s <= REWIND_SAVE_EVERY]
    ex._inflection = _OneAnomaly()
    restored, restore = [], ex._restore_checkpoint

    def recording(step):
        restored.append(step)
        restore(step)

    ex._restore_checkpoint = recording
    done = ex.train()
    ex.close()
    return {"done": done, "restored": restored, "step": int(ex.state.step),
            "state": {k: v.clone() for k, v in
                      ex.model.state_dict().items()}}


def _rank_checks(out_dir):
    """Every two-rank check of this file, in one process of the group."""
    rank, world = distributed.process_index(), distributed.process_count()
    x, dy, gamma, beta = bn_inputs()
    results = {f"bn_{dtype}": run_batch_norm(
        distributed.process_slice(x, rank, world),
        distributed.process_slice(dy, rank, world), gamma, beta, dtype)
        for dtype in BN_DTYPES}
    batches = global_batches()
    for accum in (1, 2):
        results[f"step_k{accum}"] = run_steps(batches, step_tree(accum),
                                              rank, world)
    results["decayed"] = decayed_gradients(rank, world)
    results["agree_one"] = agree_preemption(rank == world - 1)
    results["agree_none"] = agree_preemption(False)
    results["gathered"] = distributed.gather_to_chief(
        list(range(rank * 3, rank * 3 + 3)))
    results["broadcast"] = distributed.broadcast_from_chief(f"rank{rank}")
    results["rewind"] = rewind_under_group(f"{out_dir}/rewind")
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def rank_steps(out_dir, tree, weights_path, steps):
    """In each process of a group: `steps` steps on its share of the
    seeded global batches, from the weights at `weights_path`."""
    rank, world = distributed.process_index(), distributed.process_count()
    torch.save(run_steps(global_batches(steps), tree, rank, world,
                         torch.load(weights_path)),
               f"{out_dir}/steps{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    run_group(_rank_checks, WORLD, out, args=(str(out),), timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _within_bf16_rounding(got, want, rtol):
    """Each element within one bfloat16 rounding (2^-8 of its magnitude,
    half an ulp on either side) of the other's, plus `rtol` of the largest
    magnitude: the float32 sums before the rounding differ by that."""
    scale = max(float(np.abs(want).max()), 1e-12)
    bound = 2.0 ** -8 * np.maximum(np.abs(got), np.abs(want)) + rtol * scale
    assert np.all(np.abs(got - want) <= bound), float(
        (np.abs(got - want) - bound).max())


@pytest.mark.parametrize("dtype", list(BN_DTYPES))
def test_synced_batch_norm_matches_one_process(ranks, dtype):
    """In float32: statistics and output to 1e-6 relative, dx, dgamma and
    dbeta to 1e-5. In bfloat16 the statistics, dgamma and dbeta are float32
    sums of the same bfloat16 values and keep those bounds; y and dx are
    rounded to bfloat16 last, on one process by ATen's fused kernels and
    under the group by plain float32 ops, so they may differ by one
    rounding of each element."""
    x, dy, gamma, beta = bn_inputs()
    ref = run_batch_norm(x, dy, gamma, beta, dtype)
    per = x.shape[0] // WORLD
    for rank, res in enumerate(ranks):
        bn = res[f"bn_{dtype}"]
        rows = slice(rank * per, (rank + 1) * per)
        for key in ("mean", "var"):
            np.testing.assert_allclose(bn[key], ref[key], rtol=1e-6,
                                       err_msg=key)
            np.testing.assert_array_equal(bn[key],
                                          ranks[0][f"bn_{dtype}"][key])
        if dtype == "float32":
            _close(bn["y"], ref["y"][rows], 1e-6)
            _close(bn["dx"], ref["dx"][rows], 1e-5)
        else:
            _within_bf16_rounding(bn["y"], ref["y"][rows], 1e-6)
            _within_bf16_rounding(bn["dx"], ref["dx"][rows], 1e-5)
        for key in ("dgamma", "dbeta"):
            _close(bn[key], ref[key], 1e-5)


@pytest.mark.parametrize("accum", [1, 2], ids=["k1", "k2"])
def test_train_step_matches_one_process(ranks, accum):
    batches = [one_process_batch(b, WORLD, accum) for b in global_batches()]
    ref_history, ref_state = run_steps(batches, step_tree(accum))
    for res in ranks:
        history, state = res[f"step_k{accum}"]
        for got, want in zip(history, ref_history):
            for key in LOSS_KEYS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           atol=1e-7, err_msg=key)
        # a conv bias in front of a BatchNorm has a gradient of exactly 0
        # in theory and of rounding noise (~1e-10) in practice, hence the
        # absolute term
        for name, want in ref_state.items():
            scale = float(want.abs().max())
            diff = float((state[name] - want).abs().max())
            assert diff <= 1e-5 * scale + 1e-9, (name, diff, scale)
    # the same bits on every process
    h0, s0 = ranks[0][f"step_k{accum}"]
    for res in ranks[1:]:
        h, s = res[f"step_k{accum}"]
        assert h == h0
        assert all(torch.equal(s[k], s0[k]) for k in s0)
    # and the weights moved
    assert not torch.equal(s0["backbone.stem.conv.weight"],
                           build_trainer(cfg.from_dict(step_tree(accum)),
                                         device="cpu")[0].model
                           .state_dict()["backbone.stem.conv.weight"])


def test_weight_decay_counts_once(ranks):
    want = decayed_gradients()
    for res in ranks:
        got = res["decayed"]
        assert sorted(got) == sorted(want)
        for name in want:
            if name.endswith("conv.weight"):
                _close(got[name].numpy(), want[name].numpy(), 1e-4)


def test_agreement_and_gathers(ranks):
    for res in ranks:
        assert res["agree_one"] is True   # raised on the last rank only
        assert res["agree_none"] is False
        assert res["broadcast"] == "rank0"
    assert ranks[0]["gathered"] == [[0, 1, 2], [3, 4, 5]]
    assert all(res["gathered"] is None for res in ranks[1:])


def test_rewind_takes_the_chiefs_listing(ranks):
    """The non-chief's listing lags behind (steps <= 2); both processes
    still rewind to step 4, one interval before the chief's latest, 6, and
    end bit-equal."""
    for res in ranks:
        assert res["rewind"]["done"] is True
        assert res["rewind"]["restored"] == [REWIND_TARGET]
        assert res["rewind"]["step"] == REWIND_STEPS
    s0 = ranks[0]["rewind"]["state"]
    for res in ranks[1:]:
        assert all(torch.equal(res["rewind"]["state"][k], s0[k]) for k in s0)


@pytest.mark.parametrize("global_batch,count", [
    (64, 1), (64, 2), (64, 4), (256, 32), (8, 8), (6, 4)],
    ids=["64/1", "64/2", "64/4", "256/32", "8/8", "6/4"])
def test_local_batch_size_matches_jax(monkeypatch, global_batch, count):
    from retinanet_tpu.parallel import mesh
    monkeypatch.setattr(mesh.jax, "process_count", lambda: count)
    try:
        want = mesh.local_batch_size(global_batch)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            distributed.local_batch_size(global_batch, count)
        return
    assert distributed.local_batch_size(global_batch, count) == want


@pytest.mark.parametrize("rows,index,count", [
    (8, 0, 2), (8, 1, 2), (12, 2, 3), (4, 3, 4), (5, 0, 2)],
    ids=["8-0of2", "8-1of2", "12-2of3", "4-3of4", "5-0of2"])
def test_process_slice_matches_jax(rows, index, count):
    from retinanet_tpu.parallel import mesh
    x = np.arange(rows * 3).reshape(rows, 3)
    try:
        want = mesh.process_slice(x, index, count)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            distributed.process_slice(x, index, count)
        return
    np.testing.assert_array_equal(distributed.process_slice(x, index, count),
                                  want)


@pytest.mark.parametrize("backend,device,error,match", [
    ("nccl", "cpu", ValueError, "NCCL carries CUDA tensors only"),
    ("nccl", "cuda", RuntimeError, "not available"),
    ("mpi", "cpu", ValueError, "backend must be one of"),
    (None, None, RuntimeError, "'nccl' is not available"),
    ("gloo", "cuda", RuntimeError, "no CUDA device"),
], ids=["nccl-cpu", "nccl-missing", "unknown", "card-default",
        "gloo-cuda"])
def test_missing_backend_or_card_raises(backend, device, error, match):
    # on this CPU-only torch: no NCCL and no card, and nothing falls back
    if torch.cuda.is_available() and device != "cpu":
        pytest.skip("this case is about a machine without a card")
    with pytest.raises(error, match=match):
        distributed.initialize_distributed(
            backend=backend, device=device, world_size=1, rank=0,
            init_method="file:///nonexistent/never-used")
    assert not distributed.is_initialized()


def test_world_of_one_is_the_one_process_step(tmp_path):
    """Under a group of one, the step is bit for bit the step without a
    group; `multi_gpu` resolves, and the device is not guessed."""
    batches = global_batches()
    want_history, want_state = run_steps(batches, step_tree())
    tree = step_tree()
    tree["training"]["strategy"] = {"type": "multi_gpu"}
    with pytest.raises(RuntimeError, match="no process group"):
        resolve_strategy(cfg.from_dict(tree).training, torch.device("cpu"))
    distributed.initialize_distributed(
        device="cpu", init_method=f"file://{tmp_path / 'store'}",
        world_size=1, rank=0)
    try:
        assert distributed.process_count() == 1 and distributed.is_chief()
        resolve_strategy(cfg.from_dict(tree).training, torch.device("cpu"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="No CUDA device"):
                resolve_device(None)
        history, state = run_steps(batches, step_tree())
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
    assert history == want_history
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)


def test_out_of_memory_names_grad_accum_steps(tmp_path):
    tree = step_tree(accum=2)
    tree["experiment"]["model_dir"] = str(tmp_path)
    tree["training"].update(train_steps=1, save_every=1)
    params = cfg.from_dict(tree)
    batch = synthetic_train_batch(GLOBAL_BATCH, SIZE, 20, 5, seed=0)
    ex = Executor(params, "train", train_input_fn=lambda: iter([batch] * 4),
                  device="cpu")

    def no_memory(state, batch):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    ex._train_step = no_memory
    with pytest.raises(torch.OutOfMemoryError) as info:
        ex.train()
    ex.close()
    message = str(info.value)
    assert "torch_dist" in message                 # the config
    assert "micro-batch of 2 images" in message    # 4 / K = 2
    assert "peak not measured" in message          # no card here
    assert "Raise training.grad_accum_steps" in message
    assert "Tried to allocate" in message          # the original error
    assert not (tmp_path / "torch_dist" / "checkpoints" / "1.pt").exists()
    assert json.loads((tmp_path / "torch_dist" / "torch_dist.json")
                      .read_text())["training"]["grad_accum_steps"] == 2
