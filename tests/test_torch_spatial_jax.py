"""The port's spatially partitioned train step against the JAX package's
step on its (data, spatial) mesh, on the CPU.

JAX side: `tests/test_multi_step.py:_setup` (ResNet10, FPN of 16 filters,
P3-P5, 64x64, float32, SGD) stepped once on `create_mesh(spatial=2)` over
the conftest's 8 CPU devices, a (4, 2) mesh: GSPMD shards each image's rows
over the spatial axis and inserts the halo exchanges. Port side: two gloo
ranks on a (1, 2) grid, each the whole batch and a band of its rows, from
the same weights carried by `retinanet_torch.convert`. The batch is JAX's
`synthetic_train_batch(8, (64, 64), 10, 4, seed=3)`. Bounds are JAX's own
test's (`tests/test_spatial_partition.py`): total-loss rel 1e-5,
num-anchors-matched equal, every parameter within 1e-5. One JAX compile.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from retinanet_tpu.data.synthetic import synthetic_train_batch  # noqa: E402
from retinanet_tpu.parallel import mesh as mesh_lib  # noqa: E402
from retinanet_torch.convert import (  # noqa: E402
    load_flax_variables, torch_to_flax)
from retinanet_torch.core import config as cfg  # noqa: E402
from retinanet_torch.tools.multiprocess_smoke import run_group  # noqa: E402
from retinanet_torch.train.trainer import build_trainer  # noqa: E402
from test_multi_step import _setup  # noqa: E402
from test_torch_spatial import rank_one_step  # noqa: E402
from test_torch_train_step import _flat  # noqa: E402

SPATIAL = 2


def port_tree():
    """`_setup`'s config, with its step's arguments as config keys."""
    return {
        "experiment": {"name": "ms"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 4,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {
            "train_steps": 100, "save_every": 50,
            "batch_size": {"train": 8, "val": 8},
            "use_weight_decay": False, "weight_decay_alpha": 0.0,
            "spatial_partition": SPATIAL,
            "optimizer": {
                "name": "sgd", "momentum": 0.9,
                "lr_params": {"schedule_type": "piecewise_constant_decay",
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 2, "values": [0.01],
                              "boundaries": []}},
        },
    }


def test_spatial_step_matches_the_jax_mesh(tmp_path):
    state, step = _setup()
    batch = {k: np.asarray(v) for k, v in synthetic_train_batch(
        8, (64, 64), 10, 4, seed=3).items()}
    variables = jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        {"params": state.params, "batch_stats": state.batch_stats})
    tstate, _ = build_trainer(cfg.from_dict(port_tree()), device="cpu")
    load_flax_variables(tstate.model, variables)
    torch.save(tstate.model.state_dict(), tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    run_group(rank_one_step, SPATIAL, tmp_path,
              args=(str(tmp_path), port_tree(), str(tmp_path / "weights.pt"),
                    str(tmp_path / "batch.npz"), SPATIAL), timeout=240)

    mesh = mesh_lib.create_mesh(spatial=SPATIAL)
    assert mesh.shape == {"data": 4, "spatial": SPATIAL}
    sharded = mesh_lib.shard_batch(batch, mesh)
    assert {s.data.shape for s in sharded["image"].addressable_shards} == {
        (2, 32, 64, 3)}
    new_state, metrics = jax.jit(step)(state, sharded)
    want = _flat(jax.tree_util.tree_map(np.asarray, new_state.params))

    results = [torch.load(tmp_path / f"step{r}.pt", weights_only=False)
               for r in range(SPATIAL)]
    for got_metrics, got_state in results:
        assert got_metrics["total-loss"] == pytest.approx(
            float(metrics["total-loss"]), rel=1e-5)
        assert got_metrics["num-anchors-matched"] == float(
            metrics["num-anchors-matched"])
        got = _flat(torch_to_flax(got_state)["params"])
        assert sorted(got) == sorted(want)
        diffs = {name: float(np.abs(got[name] - ref).max())
                 for name, ref in want.items()}
        assert max(diffs.values()) < 1e-5, max(diffs.items(),
                                               key=lambda kv: kv[1])
    assert results[0][0] == results[1][0]
