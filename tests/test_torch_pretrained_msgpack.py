"""Flax pretrained weights (`params.msgpack`, written in process by
`flax.serialization.to_bytes`) loaded by the port's Executor against the
JAX Executor's merge of the same file (`_maybe_load_pretrained`): full
fine-tuning from a `.msgpack` path, from an artifact directory of a model
of another class count (the class head's prediction leaves skipped), and
`architecture.backbone.checkpoint` from a whole model's file and from a
backbone-only file. Every tensor that JAX loads is equal to JAX's, every
other one is the port's own initial value, and the matched and skipped
counts equal those JAX logs."""

import functools
import logging
import re

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models.retinanet import build_model as jax_build  # noqa: E402
from retinanet_tpu.train.executor import Executor as JaxExecutor  # noqa: E402
from retinanet_torch.convert import torch_to_flax  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


def _tree(model_dir, num_classes=6, **changes):
    tree = {
        "experiment": {"name": "pretrained", "model_dir": str(model_dir),
                       "seed": 0},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16,
                               "min_level": 3, "max_level": 5,
                               "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16,
                     "num_classes": num_classes, "num_anchors": 9},
        },
        "training": {
            "train_steps": 1, "batch_size": {"train": 2, "val": 2},
            "optimizer": {
                "name": "sgd", "momentum": 0.9,
                "lr_params": {"schedule_type": "piecewise_constant_decay",
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 1, "values": [0.01, 0.001],
                              "boundaries": [4]}}},
        "dataloader_params": {"tfrecords": {"train": "", "val": ""}},
    }
    for path, value in changes.items():
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@functools.lru_cache(maxsize=None)
def _flax_variables(num_classes, seed):
    """Seeded weights of the tiny model, with random BatchNorm statistics."""
    model = jax_build(jax_cfg.from_dict(_tree("unused", num_classes)))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(
            np.float32), jax.device_get(variables))
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map(
                np.abs, variables["batch_stats"])}


def _write_flax_weights(path, num_classes, seed, backbone_only=False):
    """`_flax_variables` as flax writes them."""
    variables = _flax_variables(num_classes, seed)
    if backbone_only:
        variables = {k: v["backbone"] for k, v in variables.items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(flax.serialization.to_bytes(variables))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_COUNTS = re.compile(r"(\d+) tensors matched, (\d+) skipped")


@pytest.fixture(scope="module")
def port_init(tmp_path_factory):
    """The port's own initial state of the tiny model (same seed)."""
    ex = Executor(torch_cfg.from_dict(_tree(tmp_path_factory.mktemp(
        "init"))), run_mode="train", device="cpu")
    state = _flat(torch_to_flax(ex.model.state_dict()))
    ex.close()
    return state


@pytest.mark.parametrize("case", [
    "fine_tune_file", "other_class_count", "backbone_from_whole_model",
    "backbone_only_file"])
def test_executor_loads_flax_weights_as_jax(tmp_path, caplog, port_init,
                                            case):
    src_classes = 3 if case == "other_class_count" else 6
    if case == "fine_tune_file":
        weights = tmp_path / "weights" / "model.msgpack"
    else:
        weights = tmp_path / "artifact" / "params.msgpack"
    _write_flax_weights(weights, src_classes, seed=3,
                        backbone_only=case == "backbone_only_file")
    src = str(weights if case == "fine_tune_file" else weights.parent)
    if case.startswith("backbone"):
        changes = {"architecture.backbone.checkpoint": src}
    else:
        changes = {"fine_tuning.fine_tune": True,
                   "fine_tuning.pretrained_checkpoint": src}

    caplog.set_level(logging.INFO)
    jex = JaxExecutor(jax_cfg.from_dict(_tree(tmp_path / "jax", **changes)),
                      run_mode="train", enable_tensorboard=False)
    jax_log = [r.getMessage() for r in caplog.records
               if "Loaded pretrained weights" in r.getMessage()]
    tex = Executor(torch_cfg.from_dict(_tree(tmp_path / "port", **changes)),
                   run_mode="train", device="cpu")
    try:
        assert len(jax_log) == 1
        want = tuple(int(n) for n in _COUNTS.search(jax_log[0]).groups())
        path, matched, skipped = tex.pretrained
        assert (matched, skipped) == want
        assert path == str(weights)
        assert matched > 0
        if case == "fine_tune_file":
            assert skipped == 0
        if case == "other_class_count":
            assert skipped == 2  # the class prediction conv's kernel, bias

        ours = _flat(torch_to_flax(tex.model.state_dict()))
        theirs = _flat(jax.device_get({"params": jex.state.params,
                                       "batch_stats": jex.state.batch_stats}))
        assert sorted(ours) == sorted(theirs)
        # the leaves JAX took from the file, by their path in the model
        loaded = _flat(flax.serialization.msgpack_restore(
            weights.read_bytes()))
        if case == "backbone_only_file":
            loaded = {f"{k.split('/')[0]}/backbone/{k.split('/', 1)[1]}": v
                      for k, v in loaded.items()}
        taken = {name for name, value in theirs.items()
                 if name in loaded and loaded[name].shape == value.shape}
        if case.startswith("backbone"):
            taken = {n for n in taken if n.split("/")[1] == "backbone"}
        assert len(taken) == matched
        for name, value in theirs.items():
            if name in taken:
                np.testing.assert_array_equal(value, loaded[name], name)
                np.testing.assert_array_equal(ours[name], value, name)
            else:
                np.testing.assert_array_equal(ours[name], port_init[name],
                                              name)
    finally:
        tex.close()


def test_missing_weights_raise(tmp_path):
    changes = {"fine_tuning.fine_tune": True,
               "fine_tuning.pretrained_checkpoint": str(tmp_path / "none")}
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError, match="params.msgpack"):
        Executor(torch_cfg.from_dict(_tree(tmp_path / "port", **changes)),
                 run_mode="train", device="cpu")
