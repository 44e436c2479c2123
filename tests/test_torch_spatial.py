"""Spatial partitioning (`retinanet_torch/parallel/spatial.py`) over
processes on the CPU: a (data, spatial) grid of D x S gloo ranks against
one process at the same global batch. This file spawns the (1, 2) grid;
`test_torch_spatial_grid.py` the (2, 2) one, with the same rank function.

Each spawn runs every check of its grid in one go (module fixture), and the
one-process references run here:
  * the train step, ResNet10-narrow + FPN + balanced features at 64x64 in
    float32, 2 steps at K = 1 and K = 2 micro-batches, and at K = 1 with
    `backbone.remat` (each block's exchanges made again in the backward
    pass, in the same order on every rank); EfficientNet-b0
    narrow (squeeze-excite, depthwise convs) + multi-level attention fusion
    (its means over H, W) + the auxiliary head, up to P6, whose one row at
    64 leaves the first spatial rank of a group without a row of its own;
  * EfficientNet-b0 narrow alone in training mode, its BatchNorms on their
    running statistics, with drop-connect drawn from a seeded generator:
    each band of an image must get the draw one process gives that image;
  * the bands of a spatial group reassemble the one-process image batch.
Bounds as `test_torch_distributed.py` states them: losses rtol 1e-5, and
every parameter, running statistic, output and gradient within 1e-5 of its
tensor's largest magnitude (plus 1e-9 for the rounding noise of the biases
in front of a BatchNorm). The train steps add to that twice the one
process's own move when its micro-batches' images come in another order
(`check_steps`). Across the ranks the replicated tensors are bit-equal.

The (1, 2) spawn also runs an Executor train_val (2 steps, one evaluation
of 16 images) under the grid, against one process on the same files: the
same checkpoint, the same COCO summary, and every image counted once; and
`spatial_partition=3` at a world of 2 raises ValueError.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.core import config as cfg  # noqa: E402
from retinanet_torch.core.config import Config  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.models.efficientnet import EfficientNet  # noqa: E402
from retinanet_torch.models.layers import (  # noqa: E402
    BatchNorm, init_parameters, map_hw, spatial_partition)
from retinanet_torch.parallel import distributed  # noqa: E402
from retinanet_torch.parallel.spatial import (  # noqa: E402
    band_rows, image_band, partition_for)
from retinanet_torch.tools import multiprocess_smoke  # noqa: E402
from retinanet_torch.tools.multiprocess_smoke import run_group  # noqa: E402
from retinanet_torch.train import executor as executor_mod  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    GLOBAL_BATCH, global_batches, one_process_batch, randomize_batch_norms,
    rank_batch, run_steps, step_tree)
from test_torch_threads import one_thread  # noqa: E402,F401


STEP_MODELS = ("resnet", "resnet_remat", "efficientnet")
ACCUMS = {"resnet": (1, 2), "resnet_remat": (1,), "efficientnet": (1,)}
EFFICIENTNET = {"width_coefficient": 0.25, "depth_coefficient": 0.25}
DROP_SURVIVAL = 0.5     # drop-connect drops about half the branches
EXECUTOR_STEPS = 2
VAL_IMAGES = multiprocess_smoke.VAL_IMAGES


def model_tree(model, accum):
    tree = step_tree(accum)
    if model == "resnet_remat":
        tree["architecture"]["backbone"]["remat"] = True
    if model == "efficientnet":
        tree["architecture"].update({
            "backbone": {"type": "efficientnet-b0",
                         "override_params": dict(EFFICIENTNET)},
            "feature_fusion": {"type": "multi_level_attention",
                               "filters": 16, "min_level": 3,
                               "max_level": 6, "backbone_max_level": 5,
                               "use_channel_attention": True,
                               "use_balanced_features": False},
            "auxillary_head": {"use_auxillary_head": True, "num_convs": 1,
                               "filters": 16}})
    return tree


def grid_steps(tree, grid):
    """`run_steps` on this process's data slice of the seeded global
    batches (folded when K > 1), under the grid."""
    accum = int(tree["training"]["grad_accum_steps"])
    batches = [rank_batch(b, grid.data_index, grid.data_count, accum)
               for b in global_batches()]
    return run_steps([{k: v for k, v in b.items()} for b in batches], tree,
                     rank=0, world=1)


def backbone_pass(grid=None, survival=DROP_SURVIVAL):
    """EfficientNet-b0 narrow in training mode with drop-connect, forward
    and backward on this process's data slice and band of a seeded image
    batch; the endpoints and the gradients (summed over the processes, as
    the train step sums them)."""
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.normal(
        0, 1, (GLOBAL_BATCH, 3, 64, 64)).astype(np.float32))
    # depth 0.5 repeats blocks, and only a repeated block (stride 1, the
    # same width in and out) has a skip for drop-connect to drop
    net = EfficientNet.from_name(
        "efficientnet-b0", override_params=dict(
            EFFICIENTNET, depth_coefficient=0.5, survival_prob=survival))
    init_parameters(net, torch.Generator().manual_seed(0))
    randomize_batch_norms(net)
    net.train()
    # BatchNorm on its running statistics (the train steps hold the synced
    # batch statistics): what is left to compare is the convs on bands, the
    # squeeze-excite means and drop-connect's draws
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.frozen = True
    part = None
    if grid is not None:
        per = GLOBAL_BATCH // grid.data_count
        images = images[grid.data_index * per:(grid.data_index + 1) * per]
        part = partition_for(grid, (64, 64))
        images = image_band(images.permute(0, 2, 3, 1), part).permute(
            0, 3, 1, 2)
    with spatial_partition(part):
        outputs = net(images, torch.Generator().manual_seed(7))
        loss = 0.0
        for key in sorted(outputs):
            y = outputs[key]
            h, w = map_hw(y)
            dy = torch.from_numpy(np.random.default_rng(int(key)).normal(
                0, 1, (GLOBAL_BATCH, y.shape[1], h, w)).astype(np.float32))
            if grid is not None:
                dy = dy[grid.data_index * per:(grid.data_index + 1) * per]
                lo, hi = part.band(h)
                dy = dy[:, :, lo:hi]
            loss = loss + (y * dy).sum()
    loss.backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    if grid is not None:
        for g in grads.values():
            distributed.all_reduce_sum_(g)
    return {"outputs": {k: v.detach() for k, v in outputs.items()},
            "grads": grads}


def executor_tree(workdir: Path, spatial: int) -> dict:
    tree = json.loads((workdir / "config.json").read_text())
    tree["experiment"]["run_mode"] = "train_val"
    tree["experiment"]["model_dir"] = str(workdir / f"models_s{spatial}")
    tree["training"].update(train_steps=EXECUTOR_STEPS,
                            save_every=EXECUTOR_STEPS, log_every=1,
                            validation_freq=-1, spatial_partition=spatial)
    return tree


def executor_run(workdir: Path, spatial: int) -> dict:
    """A train_val run of the Executor on the files under `workdir`: the
    final state, the COCO summary and the image ids the chief scored."""
    params = cfg.from_dict(executor_tree(workdir, spatial))

    def train_fn():
        return InputPipeline(
            "train", params, is_multi_host=distributed.is_initialized(),
            process_index=distributed.data_index(),
            process_count=distributed.data_count(), seed=7)

    def val_fn():
        return InputPipeline(
            "val", params, batch_size=distributed.local_batch_size(
                int(params.training.batch_size.val)), seed=7,
            val_shard_index=distributed.data_index(),
            val_shard_count=distributed.data_count())

    ex = Executor(params, run_mode="train_val", train_input_fn=train_fn,
                  val_input_fn=val_fn, device="cpu")
    seen, accumulate = [], executor_mod.COCOEvaluator.accumulate_results

    def counting(evaluator, results):
        seen.extend(int(i) for i in np.asarray(results["image_id"])
                    if i >= 0)
        return accumulate(evaluator, results)

    executor_mod.COCOEvaluator.accumulate_results = counting
    try:
        ex.run()
    finally:
        executor_mod.COCOEvaluator.accumulate_results = accumulate
        ex.close()
    checkpoint = torch.load(Path(ex.ckpt_dir) / f"{EXECUTOR_STEPS}.pt",
                            weights_only=False)
    records = [json.loads(line) for line in
               (Path(ex.model_dir) / "logs" / "train_metrics.jsonl")
               .read_text().splitlines()] if distributed.is_chief() else []
    return {"step": int(ex.state.step),
            "model": checkpoint["model"],
            "summary": {k: v for r in records for k, v in r.items()
                        if k.startswith("evaluation/")},
            "seen": sorted(seen)}


def pipeline_digest(workdir: Path, grid) -> list:
    """The first two train batches this process's pipeline yields."""
    params = Config(str(workdir / "config.json")).params
    pipe = InputPipeline("train", params, is_multi_host=True,
                         process_index=grid.data_index,
                         process_count=grid.data_count, seed=7)
    return [{k: np.asarray(v).copy() for k, v in batch.items()}
            for batch in itertools.islice(iter(pipe), 2)]


def rank_checks(out_dir: str, spatial: int, with_executor: bool) -> None:
    """Every check of a grid, in one process of it."""
    rank, world = distributed.process_index(), distributed.process_count()
    results = {}
    if with_executor:
        try:
            distributed.make_grid(3)
            results["raised"] = ""
        except ValueError as error:
            results["raised"] = str(error)
    grid = distributed.make_grid(spatial)
    results["grid"] = (grid.data_index, grid.data_count, grid.spatial_index,
                       grid.spatial_count)
    for model in STEP_MODELS:
        for accum in ACCUMS[model]:
            results[f"{model}_k{accum}"] = grid_steps(
                model_tree(model, accum), grid)
    results["backbone"] = backbone_pass(grid)
    batch = global_batches(1)[0]
    local = rank_batch(batch, grid.data_index, grid.data_count, 1)
    results["band"] = image_band(torch.from_numpy(local["image"]),
                                 partition_for(grid, (64, 64))).numpy()
    workdir = Path(out_dir)
    results["pipeline"] = pipeline_digest(workdir, grid)
    if with_executor:
        results["executor"] = executor_run(workdir, spatial)
    torch.save(results, workdir / f"rank{rank}_of{world}.pt")


def spawn_grid(tmp_path_factory, data: int, spatial: int,
               with_executor: bool):
    out = tmp_path_factory.mktemp(f"grid{data}x{spatial}")
    multiprocess_smoke.prepare(out)
    world = data * spatial
    run_group(rank_checks, world, out,
              args=(str(out), spatial, with_executor), timeout=600)
    return out, [torch.load(out / f"rank{r}_of{world}.pt",
                            weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return spawn_grid(tmp_path_factory, 1, 2, with_executor=True)


def _close(got, want, rtol=1e-5, atol=1e-9, name=""):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    assert diff <= rtol * scale + atol, (name, diff, scale)


def reassemble(per_rank, spatial):
    """Stack the bands of each spatial group along H (axis 2 of NCHW), then
    the data indices along N."""
    groups = [per_rank[d * spatial:(d + 1) * spatial]
              for d in range(len(per_rank) // spatial)]
    return torch.cat([torch.cat([torch.as_tensor(r) for r in g], dim=2)
                      for g in groups], dim=0)


# Reorderings of each one-process micro-batch (the same images, so the same
# step in exact arithmetic): reversed, and rolled by half
REORDERINGS = ("reversed", "rolled")


def reordered(batch, order, accum):
    """`batch` (folded when accum > 1) with the images of each micro-batch
    in another order."""
    axis = 1 if accum > 1 else 0
    n = batch["image"].shape[axis]
    rows = (np.arange(n)[::-1] if order == "reversed"
            else np.roll(np.arange(n), n // 2))
    return {k: np.take(v, rows, axis=axis) for k, v in batch.items()}


def check_steps(ranks, spatial):
    """Every loss and tensor of the ranks against one process: within the
    stated bound (rtol 1e-5 for losses; 1e-5 of the tensor's largest
    magnitude plus 1e-9) plus twice the largest move of the one process's
    own result under the REORDERINGS of its micro-batches. That move is 0
    wherever the step is well conditioned, and there the stated bound holds
    alone; a value near zero before a ReLU or a max pool can change side
    under a reordered sum and send a gradient elsewhere, and then the one
    process moves too (measured at K = 2: up to 4e-4 of a tensor's
    magnitude)."""
    data = len(ranks) // spatial
    for model in STEP_MODELS:
        for accum in ACCUMS[model]:
            key = f"{model}_k{accum}"
            tree = model_tree(model, accum)
            batches = [one_process_batch(b, data, accum)
                       for b in global_batches()]
            ref_history, ref_state = run_steps(batches, tree)
            moves = [run_steps([reordered(b, order, accum)
                                for b in batches], tree)
                     for order in REORDERINGS]
            for res in ranks:
                history, state = res[key]
                for i, (got, want) in enumerate(zip(history, ref_history)):
                    for name in want:
                        move = max(abs(h[i][name] - want[name])
                                   for h, _ in moves)
                        bound = 1e-5 * abs(want[name]) + 1e-7 + 2 * move
                        assert abs(got[name] - want[name]) <= bound, (
                            key, i, name, got[name], want[name], move)
                for name, want in ref_state.items():
                    move = max(float((s[name] - want).abs().max())
                               for _, s in moves)
                    _close(state[name], want, atol=1e-9 + 2 * move,
                           name=f"{key} {name}")
            h0, s0 = ranks[0][key]
            for res in ranks[1:]:
                h, s = res[key]
                assert h == h0, key
                assert all(torch.equal(s[k], s0[k]) for k in s0), key


def check_backbone(ranks, spatial):
    ref = backbone_pass()
    # drop-connect drops: without its draws the endpoints differ
    no_drop = backbone_pass(survival=None)
    assert not all(torch.equal(no_drop["outputs"][k], ref["outputs"][k])
                   for k in ref["outputs"])
    for key, want in ref["outputs"].items():
        got = reassemble([r["backbone"]["outputs"][key] for r in ranks],
                         spatial)
        _close(got, want, name=f"endpoint {key}")
    for res in ranks:
        for name, want in ref["grads"].items():
            _close(res["backbone"]["grads"][name], want, name=name)


def check_bands(ranks, spatial):
    batch = global_batches(1)[0]["image"]
    # NHWC: the bands are rows of axis 1; stack them there, then the data
    # indices along N
    groups = [ranks[d * spatial:(d + 1) * spatial]
              for d in range(len(ranks) // spatial)]
    got = np.concatenate([np.concatenate([r["band"] for r in g], axis=1)
                          for g in groups], axis=0)
    np.testing.assert_array_equal(got, batch)
    for d, g in enumerate(groups):
        for s, res in enumerate(g):
            assert res["grid"] == (d, len(groups), s, spatial)
            lo, hi = band_rows(64, spatial, s)
            assert res["band"].shape[1] == hi - lo


def check_pipelines(ranks, spatial):
    """The S processes of a data index yield identical batches; two data
    indices read different files."""
    groups = [ranks[d * spatial:(d + 1) * spatial]
              for d in range(len(ranks) // spatial)]
    for g in groups:
        for res in g[1:]:
            for got, want in zip(res["pipeline"], g[0]["pipeline"]):
                assert sorted(got) == sorted(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    if len(groups) > 1:
        a, b = groups[0][0]["pipeline"][0], groups[1][0]["pipeline"][0]
        assert not np.array_equal(a["image"], b["image"])


def test_train_steps_match_one_process(grid):
    check_steps(grid[1], 2)


def test_drop_connect_backbone_matches_one_process(grid):
    check_backbone(grid[1], 2)


def test_bands_reassemble_the_batch(grid):
    check_bands(grid[1], 2)


def test_pipelines_of_a_spatial_group_agree(grid):
    check_pipelines(grid[1], 2)


def test_spatial_three_at_a_world_of_two_raises(grid):
    for res in grid[1]:
        assert "2 processes not divisible by spatial=3" in res["raised"]


def test_executor_train_val_matches_one_process(grid):
    workdir, ranks = grid
    ref = executor_run(workdir, 1)
    assert ref["seen"] == list(range(VAL_IMAGES))
    chief = ranks[0]["executor"]
    assert chief["seen"] == list(range(VAL_IMAGES))   # each image once
    assert all(not res["executor"]["seen"] for res in ranks[1:])
    assert chief["summary"] and set(chief["summary"]) == set(ref["summary"])
    for key, want in ref["summary"].items():
        assert chief["summary"][key] == pytest.approx(want, abs=1e-6), key
    for res in ranks:
        assert res["executor"]["step"] == EXECUTOR_STEPS
        for name, want in ref["model"].items():
            _close(res["executor"]["model"][name], want, name=name)
        assert all(torch.equal(res["executor"]["model"][k],
                               chief["model"][k]) for k in chief["model"])


def test_one_process_refuses_a_spatial_group():
    with pytest.raises(ValueError, match="1 processes not divisible"):
        distributed.make_grid(2)
    assert distributed.grid().spatial_count == 1


def rank_one_step(out_dir: str, tree: dict, weights_path: str,
                  batch_path: str, spatial: int) -> None:
    """One train step under a grid of `spatial`, from the weights at
    `weights_path`, on this process's data slice of the batch at
    `batch_path`: the metrics and the state_dict."""
    from retinanet_torch.train.trainer import build_trainer
    grid = distributed.make_grid(spatial)
    batch = dict(np.load(batch_path))
    state, step = build_trainer(cfg.from_dict(tree), device="cpu")
    state.model.load_state_dict(torch.load(weights_path))
    state, metrics = step(state, rank_batch(batch, grid.data_index,
                                            grid.data_count, 1))
    torch.save(({k: float(v) for k, v in metrics.items()},
                {k: v.clone() for k, v in state.model.state_dict().items()}),
               f"{out_dir}/step{distributed.process_index()}.pt")
