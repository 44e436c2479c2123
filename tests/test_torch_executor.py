"""The port's Executor against the JAX package's on the CPU: a tiny f32
config (ResNet10, 64x64), the same initial weights carried across with
`retinanet_torch.convert`, the same JAX-written tfrecords.

Bounds: per-step `total-loss` rtol 1e-4 (the bound of
tests/test_torch_train_step.py: the two packages sum convolutions and
reductions in different orders) and, after 3 steps, every parameter within
1e-4 of its leaf's largest magnitude plus 1e-5. The absolute term is for
the leaves that start at zero here (BatchNorm and conv biases): after
three steps they hold only three small updates, whose gradients are sums
that mostly cancel, so their rounding differences (up to ~2e-6, varying
with the thread count of the CPU kernels) are large against the leaf and
tiny against the weights. Evaluation on the same weights, with the
class-head bias at 0 so that detections exist: the same image ids and
classes, int boxes within 1 px (truncation of coordinates that differ in
the last bits), scores within 1e-5, AP within 1e-3."""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data.pipeline import InputPipeline as JaxPipeline  # noqa: E402
from retinanet_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords as jax_write)
from retinanet_tpu.train.executor import Executor as JaxExecutor  # noqa: E402
from retinanet_torch.convert import load_flax_variables, torch_to_flax  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


CLASS_BIAS = "class_head.prediction.conv.bias"


def tiny_tree(model_dir, pattern, ann="", train_steps=3, save_every=3,
              bs=8, **training):
    return {
        "experiment": {"name": "exec_test", "model_dir": str(model_dir)},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16,
                               "min_level": 3, "max_level": 5,
                               "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {
            "train_steps": train_steps, "save_every": save_every,
            "log_every": 1,
            "batch_size": {"train": bs, "val": bs},
            "annotation_file_path": ann,
            "optimizer": {
                "name": "sgd", "momentum": 0.9, "clipnorm": 10.0,
                "lr_params": {"schedule_type": "piecewise_constant_decay",
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 2,
                              "values": [0.01, 0.001], "boundaries": [4]}},
            **training,
        },
        "dataloader_params": {
            "tfrecords": {"train": pattern, "val": pattern},
            "shuffle_buffer_size": 8},
        "inference": {"pre_nms_top_k": 200, "max_detections": 10,
                      "use_approx_top_k": False},
    }


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return jax_write(str(tmp_path_factory.mktemp("data")), "train",
                     num_shards=2, samples_per_shard=8, num_classes=6,
                     write_annotations=True)


def _records(model_dir):
    path = model_dir / "exec_test" / "logs" / "train_metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory, data):
    """Both executors after 3 train steps from the same weights."""
    pattern, ann = data
    root = tmp_path_factory.mktemp("lockstep")
    jparams = jax_cfg.from_dict(tiny_tree(root / "jax", pattern, ann))
    tparams = torch_cfg.from_dict(tiny_tree(root / "port", pattern, ann))
    jex = JaxExecutor(
        jparams, run_mode="train",
        train_input_fn=lambda: JaxPipeline("train", jparams, max_boxes=20),
        val_input_fn=lambda: JaxPipeline("val", jparams),
        enable_tensorboard=False)
    tex = Executor(
        tparams, run_mode="train",
        train_input_fn=lambda: InputPipeline("train", tparams, max_boxes=20),
        val_input_fn=lambda: InputPipeline("val", tparams), device="cpu")
    load_flax_variables(tex.model, jax.device_get(
        {"params": jex.state.params, "batch_stats": jex.state.batch_stats}))
    assert jex.train() and tex.train()
    yield root, jex, tex
    tex.close()


def test_lockstep_three_steps(lockstep):
    root, jex, tex = lockstep
    jrec = [r for r in _records(root / "jax") if "total-loss" in r]
    trec = [r for r in _records(root / "port") if "total-loss" in r]
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [1, 2, 3]
    for j, t in zip(jrec, trec):
        for key in ("total-loss", "box-loss", "class-loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {t['step']} {key}")
    assert tex.state.step == int(jex.state.step) == 3
    ours = _flat(torch_to_flax(tex.model.state_dict())["params"])
    theirs = _flat(jax.device_get(jex.state.params))
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(ours[name] - ref).max()) <= (
            1e-4 * scale + 1e-5), name


def test_evaluation_same_weights(lockstep):
    root, jex, tex = lockstep
    with torch.no_grad():
        tex.model.get_parameter(CLASS_BIAS).zero_()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jex.state.params))
    params["class_head"]["prediction"]["conv"]["bias"] = np.zeros_like(
        params["class_head"]["prediction"]["conv"]["bias"])
    jex.state = jex.state.replace(params=jax.device_put(params))
    load_flax_variables(tex.model, jax.device_get(
        {"params": jex.state.params, "batch_stats": jex.state.batch_stats}))
    jscores, tscores = jex.evaluate(), tex.evaluate()

    def detections(sub):
        dets = json.loads((root / sub / "exec_test" / "predictions.json")
                          .read_text())
        return sorted(dets, key=lambda d: (d["image_id"], d["category_id"],
                                           -d["score"]))

    ours, theirs = detections("port"), detections("jax")
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-5
        assert max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])) <= 1
    assert sorted(tscores) == sorted(jscores)
    for key in jscores:
        assert abs(tscores[key] - jscores[key]) <= 1e-3, key
    # the evaluation left the model as it found it: training mode
    assert tex.model.training
