"""The port's input pipeline against the JAX package's `InputPipeline` on
the CPU (same files, same seed: the same batches in the same order), and
the contract of the port's `DevicePrefetcher`, mirroring
tests/test_prefetch.py."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data.pipeline import InputPipeline as JaxPipeline  # noqa: E402
from retinanet_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords as jax_write)
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data.pipeline import InputPipeline  # noqa: E402
from retinanet_torch.data.prefetch import DevicePrefetcher  # noqa: E402


@pytest.fixture(scope="module")
def pattern(tmp_path_factory):
    # 2 shards x 7 records: 14 samples, so val batches of 4 and 6 end with
    # sentinel padding
    return jax_write(str(tmp_path_factory.mktemp("data")), "train",
                     num_shards=2, samples_per_shard=7, num_classes=6,
                     seed=3)


def _tree(pattern, bs=4, aug=True):
    return {
        "experiment": {"name": "pipe"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                     "num_anchors": 9}},
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {"batch_size": {"train": bs, "val": bs},
                     "train_steps": 10, "save_every": 5,
                     "optimizer": {"name": "sgd", "lr_params": {
                         "schedule_type": "piecewise_constant_decay",
                         "warmup_learning_rate": 0.001, "warmup_steps": 1,
                         "values": [0.01], "boundaries": []}}},
        "dataloader_params": {
            "tfrecords": {"train": pattern, "val": pattern},
            "augmentations": {"use_augmentation": aug,
                              "horizontal_flip": aug},
            "shuffle_buffer_size": 8},
    }


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("seed", [1337, 7])
def test_first_train_batches_equal_jax(pattern, seed):
    tree = _tree(pattern)
    ours = InputPipeline("train", torch_cfg.from_dict(tree), max_boxes=20,
                         seed=seed, num_workers=4)
    theirs = JaxPipeline("train", jax_cfg.from_dict(tree), max_boxes=20,
                         seed=seed, num_workers=4)
    assert ours.files == theirs.files
    # 3 batches of 4 from 14 samples: the shuffle buffer and the second
    # epoch's file order are both exercised
    _assert_batches_equal(_take(ours, 3), _take(theirs, 3))


@pytest.mark.parametrize("bs,index,count,padded", [
    (4, 0, 1, True), (6, 0, 1, True), (4, 0, 2, False), (4, 1, 2, True)],
    ids=["bs4", "bs6", "shard0of2", "shard1of2"])
def test_whole_val_epoch_equal_jax(pattern, bs, index, count, padded):
    tree = _tree(pattern, bs=bs)
    kw = dict(batch_size=bs, val_shard_index=index, val_shard_count=count)
    got = list(InputPipeline("val", torch_cfg.from_dict(tree), **kw))
    want = list(JaxPipeline("val", jax_cfg.from_dict(tree), **kw))
    _assert_batches_equal(got, want)
    ids = np.concatenate([b["image_id"] for b in got])
    assert (ids == -1).any() == padded  # sentinel padding of the last batch


def test_val_shards_cover_every_image_once(pattern):
    tree = torch_cfg.from_dict(_tree(pattern))
    ids = np.concatenate([
        b["image_id"] for i in range(2) for b in InputPipeline(
            "val", tree, batch_size=4, val_shard_index=i,
            val_shard_count=2)])
    assert sorted(ids[ids >= 0].tolist()) == list(range(14))


def test_multi_host_file_sharding(pattern):
    tree = torch_cfg.from_dict(_tree(pattern))
    p0 = InputPipeline("train", tree, is_multi_host=True, process_index=0,
                       process_count=2)
    p1 = InputPipeline("train", tree, is_multi_host=True, process_index=1,
                       process_count=2)
    assert sorted(p0.files + p1.files) == sorted(
        InputPipeline("train", tree).files)
    assert not set(p0.files) & set(p1.files)


def test_bad_run_mode_and_shard_args(pattern):
    tree = torch_cfg.from_dict(_tree(pattern))
    with pytest.raises(ValueError):
        InputPipeline("test", tree)
    with pytest.raises(ValueError):
        InputPipeline("train", tree, val_shard_count=2)


def test_decode_error_surfaces_at_consumer(tmp_path, pattern):
    from retinanet_torch.data import tfrecord as tfr
    path = tmp_path / "bad-0000.tfrecord"
    with tfr.RecordWriter(str(path)) as w:
        w.write(tfr.make_detection_example(
            b"not a jpeg", 0, np.zeros((0, 4), np.float32),
            np.zeros(0, np.int64)))
    tree = torch_cfg.from_dict(_tree(str(tmp_path / "bad-*"), bs=1))
    with pytest.raises(ValueError, match="JPEG"):
        list(InputPipeline("val", tree))


# -- DevicePrefetcher (the JAX test's cases, and the staging on a device) --

def test_prefetch_yields_in_production_order():
    it = iter(range(50))
    pf = DevicePrefetcher(lambda: next(it), depth=4)
    assert [next(pf) for _ in range(50)] == list(range(50))
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_exception_propagates_to_consumer():
    calls = {"n": 0}

    def make():
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("boom")
        return calls["n"]

    pf = DevicePrefetcher(make, depth=1)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    pf.close()


def test_prefetch_close_unblocks_full_queue_producer():
    produced = []

    def make():
        produced.append(len(produced))
        return produced[-1]

    pf = DevicePrefetcher(make, depth=2)
    next(pf)
    time.sleep(0.3)  # the producer fills the queue and blocks on put
    pf.close()
    assert not pf._thread.is_alive()
    assert len(produced) <= 4


def test_prefetch_close_is_idempotent_and_stops_iteration():
    it = iter(range(10))
    pf = DevicePrefetcher(lambda: next(it), depth=2)
    next(pf)
    pf.close()
    pf.close()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_runs_ahead_of_consumer():
    staged = threading.Event()
    n = {"v": 0}

    def make():
        n["v"] += 1
        if n["v"] >= 3:  # the first consumed + 2 staged ahead
            staged.set()
        return n["v"]

    pf = DevicePrefetcher(make, depth=2)
    next(pf)
    assert staged.wait(timeout=5.0), "producer did not run ahead"
    pf.close()


def test_prefetch_stages_named_keys_on_the_device():
    batches = iter([{"image": np.full((2, 3), i, np.uint8), "image_id": i}
                    for i in range(3)])
    with DevicePrefetcher(lambda: next(batches), depth=2, device="cpu",
                          keys=("image",)) as pf:
        got = list(pf)
    assert [b["image_id"] for b in got] == [0, 1, 2]
    for i, b in enumerate(got):
        assert isinstance(b["image"], torch.Tensor)
        assert b["image"].dtype == torch.uint8
        assert torch.equal(b["image"], torch.full((2, 3), i,
                                                  dtype=torch.uint8))
    assert pf.stage_seconds >= 0.0


def test_prefetch_rejects_zero_depth():
    with pytest.raises(ValueError):
        DevicePrefetcher(lambda: 0, depth=0)


def test_prefetch_staging_failure_surfaces_at_consumer(monkeypatch):
    """A failure outside `make_batch` (staging, device selection) ends the
    stream with its error instead of leaving the consumer waiting."""
    def failing_stage(self, batch):
        raise TypeError("cannot stage")

    monkeypatch.setattr(DevicePrefetcher, "_stage", failing_stage)
    pf = DevicePrefetcher(lambda: {"image": np.zeros(2)}, depth=2,
                          device="cpu")
    with pytest.raises(TypeError, match="cannot stage"):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("run_mode", ["train", "val"])
def test_pipeline_reads_through_the_native_reader(pattern, monkeypatch,
                                                  run_mode):
    """Records are indexed and parsed by the C++ reader, never by the
    Python codec, and every stage's seconds are counted."""
    from retinanet_torch.data import tfrecord

    def refuse(*args, **kwargs):
        raise AssertionError("the Python codec ran on the pipeline's path")

    monkeypatch.setattr(tfrecord, "read_records", refuse)
    monkeypatch.setattr(tfrecord, "parse_detection_example", refuse)
    pipe = InputPipeline(run_mode, torch_cfg.from_dict(_tree(pattern)),
                         num_workers=2)
    it = iter(pipe)
    batches = [next(it) for _ in range(3)]
    it.close()
    assert len(batches) == 3
    assert pipe.stage_samples >= 12
    assert all(v > 0 for v in pipe.stage_seconds.values()), \
        pipe.stage_seconds
