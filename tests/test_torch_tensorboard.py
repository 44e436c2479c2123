"""TensorBoard event files written by the port without TensorFlow
(`retinanet_torch/train/event_file.py`, `train/diagnostics.py:
MetricsLogger`) against the JAX package's `MetricsLogger`, which writes
through `tf.summary`. Both packages' files are read back by TF's own
`tf.compat.v1.train.summary_iterator`: tags, steps, plugin names, dtypes
and shapes equal, scalars equal at float32, histogram counts equal
exactly and edges within 1e-12 of the histogram's largest edge magnitude
(the edges are float64; an edge near zero has no useful relative error).
TF and tensorboard are imported by this test only."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorflow as tf

torch = pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.models.retinanet import build_model as jax_build  # noqa: E402
from retinanet_tpu.train.diagnostics import (  # noqa: E402
    MetricsLogger as JaxMetricsLogger)
from retinanet_tpu.train.executor import Executor as JaxExecutor  # noqa: E402
from retinanet_torch import convert  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords)
from retinanet_torch.train import event_file  # noqa: E402
from retinanet_torch.train.diagnostics import MetricsLogger  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402

from test_torch_executor import tiny_tree  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


EDGE_TOL = 1e-12


def _tf_values(logdir):
    """{(step, tag): (plugin, dtype name, shape, array)} of every summary
    value of the one event file under `logdir`, read by TF."""
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    out = {}
    for event in tf.compat.v1.train.summary_iterator(files[0]):
        for value in event.summary.value:
            array = tf.make_ndarray(value.tensor)
            out[(event.step, value.tag)] = (
                value.metadata.plugin_data.plugin_name,
                tf.dtypes.as_dtype(value.tensor.dtype).name,
                tuple(array.shape), array)
    return out


def _seeded_tensors():
    rng = np.random.default_rng(12)
    return {
        "h/normal": rng.normal(0.0, 0.3, (3, 3, 16, 32)).astype(np.float32),
        "h/uniform": rng.uniform(-2, 5, (4096,)).astype(np.float32),
        # values on the bucket edges: floor() decides every one of them
        "h/edges": np.arange(31, dtype=np.float32),
        "h/single": np.full((7, 5), 0.25, np.float32),
        "h/one": np.asarray([-3.5], np.float32),
        "h/empty": np.zeros((0,), np.float32),
    }


def _assert_same(port, ref):
    assert sorted(port) == sorted(ref)
    for key, (plugin, dtype, shape, array) in ref.items():
        p_plugin, p_dtype, p_shape, p_array = port[key]
        assert (p_plugin, p_dtype, p_shape) == (plugin, dtype, shape), key
        if plugin == "scalars":
            assert p_array.dtype == np.float32
            assert p_array == array, key
        else:
            np.testing.assert_array_equal(p_array[:, 2], array[:, 2],
                                          err_msg=str(key))
            scale = max(np.abs(array[:, :2]).max(), 1e-300)
            np.testing.assert_allclose(p_array[:, :2], array[:, :2], rtol=0,
                                       atol=EDGE_TOL * scale,
                                       err_msg=str(key))


def test_loggers_write_what_jax_writes(tmp_path):
    scalars = {"losses/total-loss": 1.2345678901, "learning-rate": 0.01,
               "images-per-second": 81.24, "negative": -3e-7}
    tensors = _seeded_tensors()
    jax_log = JaxMetricsLogger(str(tmp_path / "jax"), "train")
    assert jax_log.has_tensorboard
    port = MetricsLogger(str(tmp_path / "port"), "train")
    assert port.has_tensorboard
    for step in (1, 20, 7):
        jax_log.log(step, scalars)
        port.log(step, scalars)
    jax_log.log_histograms(50, tensors)
    port.log_histograms(50, {k: torch.from_numpy(v)
                             for k, v in tensors.items()})
    jax_log.close()
    port.close()

    ref = _tf_values(str(tmp_path / "jax" / "train"))
    got = _tf_values(str(tmp_path / "port" / "train"))
    _assert_same(got, ref)
    assert {k for k in ref if ref[k][0] == "histograms"} == {
        (50, tag) for tag in tensors}
    # the single-value and empty cases as TF writes them
    single = got[(50, "h/single")][3]
    assert (single[:, :2] == 0.25).all() and single[-1, 2] == 35
    assert not got[(50, "h/empty")][3].any()
    # JSONL is unchanged beside the events
    lines = (tmp_path / "port" / "train_metrics.jsonl").read_text()
    assert [json.loads(x)["step"] for x in lines.splitlines()] == [1, 20, 7]


def test_decoder_reads_its_own_files(tmp_path):
    tensors = _seeded_tensors()
    port = MetricsLogger(str(tmp_path), "train")
    port.log(3, {"a/b": 0.5, "c": -2.0})
    port.log_histograms(4, {k: torch.from_numpy(v)
                            for k, v in tensors.items()})
    port.close()
    (path,) = event_file.event_files(str(tmp_path / "train"))
    assert os.path.basename(path).startswith("events.out.tfevents.")
    assert path.endswith(".v2")
    events = list(event_file.read_events(path))
    assert events[0].file_version == event_file.FILE_VERSION
    values = {(e.step, v.tag): v for e in events[1:] for v in e.values}
    assert values[(3, "a/b")].plugin_name == "scalars"
    assert values[(3, "a/b")].tensor.numpy() == np.float32(0.5)
    assert values[(3, "c")].tensor.numpy().shape == ()
    ref = _tf_values(str(tmp_path / "train"))
    for (step, tag), value in values.items():
        assert value.plugin_name == ref[(step, tag)][0]
        np.testing.assert_array_equal(value.tensor.numpy(),
                                      ref[(step, tag)][3])
    # the buckets are the decoded rows, also straight from the device path
    rows = event_file.histogram_buckets(
        [torch.from_numpy(v) for v in tensors.values()])
    assert rows.shape == (len(tensors), 30, 3) and rows.dtype == np.float64
    for row, (tag, v) in zip(rows, tensors.items()):
        np.testing.assert_array_equal(row, values[(4, tag)].tensor.numpy())
        assert row[:, 2].sum() == v.size


def test_disabled_logger_writes_nothing(tmp_path):
    off = MetricsLogger(str(tmp_path / "off"), "train", enabled=False)
    off.log(1, {"x": 1.0})
    off.log_histograms(1, {"h": torch.ones(3)})
    off.close()
    assert not (tmp_path / "off").exists()
    no_tb = MetricsLogger(str(tmp_path / "no_tb"), "train",
                          use_tensorboard=False)
    no_tb.log(1, {"x": 1.0})
    no_tb.log_histograms(1, {"h": torch.ones(3)})
    no_tb.close()
    assert os.listdir(tmp_path / "no_tb") == ["train_metrics.jsonl"]


def test_unwritable_directory_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        MetricsLogger(str(tmp_path / "logs"), "train",
                      tensorboard_dir=str(blocker / "tb"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_synthetic_tfrecords(
        str(tmp_path_factory.mktemp("data")), "train", num_shards=2,
        samples_per_shard=8, num_classes=6, write_annotations=True)


def test_executor_writes_under_tensorboard_dir(tmp_path, data):
    pattern, ann = data
    tree = tiny_tree(tmp_path / "models", pattern, ann, train_steps=2,
                     save_every=2, bs=2)
    tree["experiment"]["tensorboard_dir"] = str(tmp_path / "tb")
    params = torch_cfg.from_dict(tree)
    ex = Executor(params, run_mode="train",
                  train_input_fn=lambda: InputPipeline(
                      "train", params, max_boxes=20, num_workers=2),
                  device="cpu")
    assert ex.train()
    ex.close()
    logdir = tmp_path / "tb" / "exec_test" / "train"
    values = _tf_values(str(logdir))
    lines = [json.loads(x) for x in (
        tmp_path / "models" / "exec_test" / "logs" /
        "train_metrics.jsonl").read_text().splitlines()]
    expected = {(r["step"], k): np.float32(v) for r in lines
                for k, v in r.items() if k != "step"}
    assert {k: v[3] for k, v in values.items()} == expected
    assert not glob.glob(str(tmp_path / "models" / "exec_test" / "logs" /
                             "train" / "*"))

    # enable_tensorboard=False: the JSONL alone
    tree["experiment"]["name"] = "no_tb"
    params = torch_cfg.from_dict(tree)
    ex = Executor(params, run_mode="train",
                  train_input_fn=lambda: InputPipeline(
                      "train", params, max_boxes=20, num_workers=2),
                  enable_tensorboard=False, device="cpu")
    assert ex.train()
    ex.close()
    assert not (tmp_path / "tb" / "no_tb").exists()
    assert (tmp_path / "models" / "no_tb" / "logs" /
            "train_metrics.jsonl").exists()


def _intro_tree(model_dir):
    return {
        "experiment": {"name": "hist", "model_dir": str(model_dir)},
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
            "train_steps": 2, "save_every": 2, "restore_checkpoint": False,
            "batch_size": {"train": 2, "val": 2},
            "optimizer": {
                "name": "sgd",
                "lr_params": {"schedule_type": "piecewise_constant_decay",
                              "warmup_learning_rate": 0.001,
                              "warmup_steps": 1, "values": [0.01],
                              "boundaries": []}},
        },
    }


def test_weights_histograms_equal_jax(tmp_path):
    """Seeded Flax weights, carried to the port by `convert.py`: the
    `weights-hist/*` and `weights/*` of both Executors' `_write_weights_info`
    are the same."""
    tree = _intro_tree(tmp_path / "jax")
    model = jax_build(jax_cfg.from_dict(tree))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(
            np.float32), jax.device_get(variables))
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])

    jex = JaxExecutor(jax_cfg.from_dict(tree), run_mode="export")
    assert jex.metrics.has_tensorboard
    jex.state = jex.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    jex._write_weights_info(50)
    jex.metrics.close()

    tex = Executor(torch_cfg.from_dict(_intro_tree(tmp_path / "port")),
                   run_mode="export", device="cpu")
    convert.load_flax_variables(tex.model, variables)
    tex._write_weights_info(50)
    tex.close()

    ref = _tf_values(str(tmp_path / "jax" / "hist" / "logs" / "train"))
    got = _tf_values(str(tmp_path / "port" / "hist" / "logs" / "train"))
    hist = {k for k in ref if k[1].startswith("weights-hist/")}
    assert len(hist) == sum(1 for _ in tex.model.parameters())
    assert {k for k in got if k[1].startswith("weights-hist/")} == hist
    _assert_same({k: got[k] for k in hist}, {k: ref[k] for k in hist})
    norms = {k for k in ref if k[1].startswith("weights/")}
    assert {k for k in got if k[1].startswith("weights/")} == norms
    for key in norms:
        # float32 sums of up to 10^5 squares, in another order on each side
        np.testing.assert_allclose(got[key][3], ref[key][3], rtol=1e-4)
