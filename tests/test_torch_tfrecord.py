"""The port's TFRecord and tf.train.Example I/O against the JAX package's
on the CPU: byte-identical records and files for the same examples, equal
crc32c, and the port reads and parses what the JAX package wrote."""

import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_tpu.data import tfrecord as jax_tfr  # noqa: E402
from retinanet_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_tfrecords as jax_write)
from retinanet_torch.data import tfrecord as tfr  # noqa: E402


def _example(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 6))
    x1 = rng.uniform(0, 0.7, n)
    y1 = rng.uniform(0, 0.7, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.01, 0.3, n),
                      y1 + rng.uniform(0.01, 0.3, n)], -1).astype(np.float32)
    classes = rng.integers(0, 80, n)
    image = rng.integers(0, 256, int(rng.integers(1, 300)),
                         dtype=np.uint8).tobytes()
    return image, int(rng.integers(0, 1 << 40)), boxes, classes


@pytest.mark.parametrize("length", [0, 1, 7, 64, 1000])
def test_crc32c_equal(length):
    data = np.random.default_rng(length).integers(
        0, 256, length, dtype=np.uint8).tobytes()
    assert tfr.crc32c(data) == jax_tfr.crc32c(data)
    assert tfr.masked_crc32c(data) == jax_tfr.masked_crc32c(data)


def test_crc32c_known_value():
    # the CRC-32C check value of the ASCII digits 1-9
    assert tfr.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("seed", range(4))
def test_detection_example_bytes_identical(seed):
    image, image_id, boxes, classes = _example(seed)
    ours = tfr.make_detection_example(image, image_id, boxes, classes)
    assert ours == jax_tfr.make_detection_example(image, image_id, boxes,
                                                  classes)
    parsed = tfr.parse_detection_example(ours)
    assert parsed["image"] == image and parsed["image_id"] == image_id
    np.testing.assert_array_equal(parsed["boxes"], boxes.reshape(-1, 4))
    np.testing.assert_array_equal(parsed["classes"], classes)


def test_encode_example_mixed_features_identical():
    feats = {"b": [b"x", b"", b"yz"], "f": np.array([1.5, -2.0], np.float32),
             "i": np.array([-3, 0, 1 << 40], np.int64), "one": 7,
             "s": b"bytes"}
    ours = tfr.encode_example(feats)
    assert ours == jax_tfr.encode_example(feats)
    got, want = tfr.decode_example(ours), jax_tfr.decode_example(ours)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_record_files_byte_identical(tmp_path):
    records = [tfr.make_detection_example(*_example(s)) for s in range(5)]
    records += [b"", b"a" * 1000]
    for mod, name in ((tfr, "port"), (jax_tfr, "jax")):
        with mod.RecordWriter(str(tmp_path / f"{name}.tfrecord")) as w:
            for r in records:
                w.write(r)
    ours = (tmp_path / "port.tfrecord").read_bytes()
    assert ours == (tmp_path / "jax.tfrecord").read_bytes()
    assert list(tfr.read_records(str(tmp_path / "port.tfrecord"),
                                 verify_crc=True)) == records


def test_corrupt_crc_raises(tmp_path):
    path = tmp_path / "x.tfrecord"
    with tfr.RecordWriter(str(path)) as w:
        w.write(b"payload")
    data = bytearray(path.read_bytes())
    data[14] ^= 0xFF  # a byte of the payload
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match="data crc"):
        list(tfr.read_records(str(path), verify_crc=True))


def test_reads_jax_written_records(tmp_path):
    pattern = jax_write(str(tmp_path), "train", num_shards=2,
                        samples_per_shard=3, num_classes=6, seed=4)
    files = tfr.list_files(pattern)
    assert files == jax_tfr.list_files(pattern)
    for path in files:
        ours = list(tfr.read_records(path, verify_crc=True))
        theirs = list(jax_tfr.read_records(path))
        assert ours == theirs and len(ours) == 3
        for record in ours:
            got = tfr.parse_detection_example(record)
            want = jax_tfr.parse_detection_example(record)
            assert got["image"] == want["image"]
            assert got["image_id"] == want["image_id"]
            np.testing.assert_array_equal(got["boxes"], want["boxes"])
            np.testing.assert_array_equal(got["classes"], want["classes"])


def test_remote_paths_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        tfr.list_files("gs://bucket/train*")
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        list(tfr.read_records("gs://bucket/train-0"))


def test_no_match_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tfr.list_files(str(tmp_path / "nothing*"))
