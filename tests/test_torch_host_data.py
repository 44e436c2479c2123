"""The port's host-side data path against the JAX package's on the CPU:
JPEG decode (both through libjpeg here, so exact), the fused resampler,
`HostPreprocessor` (train with flip and jitter from the same seeded rng,
and resize-with-pad: bit-equal images, equal boxes, classes and valid
flags), the preprocessing goldens at the JAX test's tolerance, and the
synthetic dataset writer."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import tfrecord as jax_tfr  # noqa: E402
from retinanet_tpu.data.pipeline import decode_jpeg as jax_decode  # noqa: E402
from retinanet_tpu.data.preprocessing import (  # noqa: E402
    HostPreprocessor as JaxPre)
from retinanet_tpu.data.synthetic import (  # noqa: E402
    synthetic_train_iterator as jax_iterator,
    write_synthetic_tfrecords as jax_write)
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import host_codec  # noqa: E402
from retinanet_torch.data import tfrecord as tfr  # noqa: E402
from retinanet_torch.data.preprocessing import HostPreprocessor  # noqa: E402
from retinanet_torch.data.synthetic import (  # noqa: E402
    synthetic_train_iterator, write_synthetic_tfrecords)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "preprocessing_goldens.npz")
LSB = 1.0 / 128.0  # one uint8 step after normalization (stddev 128)


def _tree(target=96, aug=True, jitter=(0.5, 1.8), mean=(127.0,) * 3,
          stddev=(128.0,) * 3, pixel_scale=1.0):
    return {
        "experiment": {"name": "pp"},
        "input": {"input_shape": [target, target], "channels": 3},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                     "num_anchors": 9}},
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "training": {"batch_size": {"train": 1, "val": 1},
                     "train_steps": 1, "save_every": 1,
                     "optimizer": {"name": "sgd", "lr_params": {
                         "schedule_type": "piecewise_constant_decay",
                         "warmup_learning_rate": 0.001, "warmup_steps": 1,
                         "values": [0.01], "boundaries": []}}},
        "dataloader_params": {
            "preprocessing": {"mean": list(mean), "stddev": list(stddev),
                              "pixel_scale": pixel_scale},
            "augmentations": {"use_augmentation": aug,
                              "horizontal_flip": aug,
                              "scale_jitter": {"min_scale": jitter[0],
                                               "max_scale": jitter[1]}}},
    }


def _pair(tree, max_boxes=20):
    # the JAX preprocessor's default lane is uint8, the port's only one
    return (HostPreprocessor(torch_cfg.from_dict(tree), max_boxes),
            JaxPre(jax_cfg.from_dict(tree), max_boxes))


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    pattern = jax_write(str(tmp_path_factory.mktemp("jaxdata")), "train",
                        num_shards=1, samples_per_shard=6, num_classes=6,
                        seed=2)
    return [jax_tfr.parse_detection_example(r) for path in
            jax_tfr.list_files(pattern) for r in jax_tfr.read_records(path)]


def test_jpeg_route_is_libjpeg_here():
    # the JAX package decodes with libjpeg, so a machine that runs its tests
    # has it, and the port takes the same route: equal pixels, bit for bit
    assert host_codec.jpeg_route() == "libjpeg"


def test_decode_equals_jax_on_jax_written_images(jax_records):
    for sample in jax_records:
        ours = host_codec.decode_jpeg(sample["image"])
        theirs = jax_decode(sample["image"])
        assert ours.dtype == np.uint8 and ours.flags.c_contiguous
        np.testing.assert_array_equal(ours, theirs)


def test_encode_decode_round_trip():
    rng = np.random.default_rng(0)
    img = np.full((75, 131, 3), 30, np.uint8) + rng.integers(
        0, 20, (75, 131, 3), dtype=np.uint8)
    img[10:40, 20:90] = (200, 60, 120)
    data = host_codec.encode_jpeg(img)
    assert data[:2] == b"\xff\xd8"
    out = host_codec.decode_jpeg(data)
    assert out.shape == img.shape
    # quality 95: the flat regions come back within a few levels
    assert np.abs(out.astype(int) - img).mean() < 4
    np.testing.assert_array_equal(out, jax_decode(data))


def test_decode_rejects_non_jpeg():
    with pytest.raises(ValueError):
        host_codec.decode_jpeg(b"\x89PNG\r\n\x1a\n junk")
    with pytest.raises(ValueError):
        host_codec.decode_jpeg(b"")


# `dtype` is the dtype the image arrives in: a float image is cast to uint8
# at entry, as the JAX preprocessor casts it
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("seed", range(6))
def test_train_preprocessing_bit_equal(jax_records, seed, dtype):
    ours, theirs = _pair(_tree())
    sample = jax_records[seed % len(jax_records)]
    image = jax_decode(sample["image"]).astype(dtype)
    got = ours(image, sample["boxes"], sample["classes"],
               np.random.default_rng(seed))
    want = theirs(image, sample["boxes"], sample["classes"],
                  np.random.default_rng(seed))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("target", [64, 160])
def test_resize_with_pad_bit_equal(jax_records, target):
    ours, theirs = _pair(_tree(target=target, aug=False))
    for sample in jax_records:
        image = jax_decode(sample["image"])
        got, got_scale = ours.resize_with_pad(image)
        want, want_scale = theirs.resize_with_pad(image)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_scale, want_scale)


def test_resample_refuses_bad_geometry():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        host_codec.resample_bilinear(img, (8, 8), (9, 8), (1.0, 1.0),
                                     (0, 0), False, np.zeros(3, np.float32))
    for dtype in (np.int32, np.float32):  # the resampler is uint8 only
        with pytest.raises(TypeError):
            host_codec.resample_bilinear(img.astype(dtype), (8, 8), (4, 4),
                                         (1.0, 1.0), (0, 0), False,
                                         np.zeros(3, np.float32))


# -- goldens of the executed reference pipeline (tests/goldens), at the
#    tolerances of tests/test_preprocessing_parity.py ------------------------

@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDENS, allow_pickle=False).items())


def _golden_pre(g, aug):
    tree = _tree(target=int(g["target"]), aug=aug,
                 jitter=tuple(float(v) for v in g["jitter"]),
                 mean=tuple(float(m) for m in g["mean"]),
                 stddev=tuple(float(s) for s in g["stddev"]),
                 pixel_scale=float(g["pixel_scale"]))
    return HostPreprocessor(torch_cfg.from_dict(tree), 20)


def _normalize(img, g):
    return ((img.astype(np.float32) / float(g["pixel_scale"])
             - g["mean"].reshape(1, 1, 3)) / g["stddev"].reshape(1, 1, 3))


class _PinnedRng:
    """Replays the reference's pinned draws (flip, scale, offset pair)."""

    def __init__(self, draws):
        flip, scale, oy, ox = [float(d) for d in draws]
        self._queue = [np.float64(flip), np.float64(scale),
                       np.array([oy, ox], np.float64)]

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._queue.pop(0)


# the preprocessor's one lane, uint8, at the JAX test's uint8 tolerance
GOLDEN_LSB = 3


@pytest.mark.parametrize("lane", ["uint8"])
def test_val_goldens(g, lane):
    pre = _golden_pre(g, False)
    for i in range(10):
        img = g[f"val{i}_img_u8"]
        out, scale = pre.resize_with_pad(img)
        np.testing.assert_allclose(scale, g[f"val{i}_scale"], rtol=1e-6)
        err = np.abs(_normalize(out, g) - g[f"val{i}_image"])
        assert err.max() <= GOLDEN_LSB * LSB + 1e-5, (i, err.max() / LSB)


@pytest.mark.parametrize("lane", ["uint8"])
def test_train_goldens(g, lane):
    pre = _golden_pre(g, True)
    for i in range(10):
        img = g[f"tr{i}_img_u8"]
        out = pre(img, g[f"tr{i}_boxes_norm"], g[f"tr{i}_cls_in"],
                  _PinnedRng(g[f"tr{i}_draws"]))
        n = int(out["valid"].sum())
        assert n == len(g[f"tr{i}_boxes"]), i
        np.testing.assert_allclose(out["boxes"][:n], g[f"tr{i}_boxes"],
                                   rtol=1e-5, atol=2e-3)
        np.testing.assert_array_equal(out["classes"][:n], g[f"tr{i}_cls"])
        err = np.abs(_normalize(out["image"], g) - g[f"tr{i}_image"])
        assert err.max() <= GOLDEN_LSB * LSB + 1e-5, (i, err.max() / LSB)


def test_synthetic_writer_matches_jax_scenes(tmp_path):
    """The same seed gives the same ids, sizes, boxes, classes and
    annotations as the JAX writer; only the JPEG encoder differs."""
    ours, ours_ann = write_synthetic_tfrecords(
        str(tmp_path / "port"), "train", num_shards=2, samples_per_shard=2,
        num_classes=6, seed=5, write_annotations=True)
    theirs, theirs_ann = jax_write(
        str(tmp_path / "jax"), "train", num_shards=2, samples_per_shard=2,
        num_classes=6, seed=5, write_annotations=True)
    with open(ours_ann) as f, open(theirs_ann) as h:
        assert json.load(f) == json.load(h)
    got = [tfr.parse_detection_example(r) for p in tfr.list_files(ours)
           for r in tfr.read_records(p, verify_crc=True)]
    want = [jax_tfr.parse_detection_example(r)
            for p in jax_tfr.list_files(theirs)
            for r in jax_tfr.read_records(p)]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["classes"], b["classes"])
        assert (host_codec.decode_jpeg(a["image"]).shape
                == jax_decode(b["image"]).shape)


def test_synthetic_iterator_equals_jax():
    ours = list(synthetic_train_iterator(2, (64, 48), 10, 6, seed=3,
                                         num_batches=3))
    theirs = list(jax_iterator(2, (64, 48), 10, 6, seed=3, num_batches=3))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
