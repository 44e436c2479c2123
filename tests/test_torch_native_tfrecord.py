"""The port's C++ TFRecord reader (`data/host_codec.py:read_records`,
`parse_detection_example`, `csrc/host/tfrecord_native.cpp`) against its
spec, the port's Python codec (`data/tfrecord.py`): equal results, or the
same exception where the codec raises. Covers the cases where the JAX
package's C++ reader departs from its own Python codec (more than 512
boxes, unequal or missing lists, unpacked values, a missing image_id, an
implausible length), and records the JAX package writes."""

import io
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_torch.data import host_codec, tfrecord  # noqa: E402
from retinanet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from retinanet_tpu.data import tfrecord as jax_tfrecord  # noqa: E402

W = tfrecord  # the wire-format writers


class _Raised(tuple):
    """(exception type, the missing key for a KeyError)."""


def _outcome(fn, *args):
    """fn's result, or what it raised."""
    try:
        return fn(*args)
    except KeyError as e:
        return _Raised((KeyError, e.args))
    except (ValueError, IndexError, IOError) as e:
        return _Raised((type(e), ()))


def _assert_same_parse(record: bytes):
    want = _outcome(tfrecord.parse_detection_example, record)
    got = _outcome(host_codec.parse_detection_example, record)
    if isinstance(want, _Raised):
        assert got == want
        return want
    assert not isinstance(got, _Raised), got
    assert got["image"] == want["image"]
    assert got["image_id"] == want["image_id"]
    for key in ("boxes", "classes"):
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key])
    return want


def _seeded(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return tfrecord.make_detection_example(
        rng.bytes(int(rng.integers(1, 4000))), int(rng.integers(-5, 10**12)),
        rng.random((n, 4)).astype(np.float32),
        rng.integers(-3, 1 << 40, n))


@pytest.mark.parametrize("n", [0, 1, 100, 600])
def test_seeded_records_parse_as_the_codec(n):
    want = _assert_same_parse(_seeded(n, seed=n))
    assert want["boxes"].shape == (n, 4)  # no cap at 512


# -- hand-built examples: feature bodies written field by field --------------

def _floats_packed(values) -> bytes:
    out = io.BytesIO()
    W._write_len_delimited(out, 1, np.asarray(values, "<f4").tobytes())
    return out.getvalue()


def _floats_unpacked(values) -> bytes:
    out = io.BytesIO()
    for v in values:
        W._write_tag(out, 1, 5)
        out.write(struct.pack("<f", v))
    return out.getvalue()


def _ints_packed(values) -> bytes:
    body = io.BytesIO()
    for v in values:
        W._write_varint(body, v & 0xFFFFFFFFFFFFFFFF)
    out = io.BytesIO()
    W._write_len_delimited(out, 1, body.getvalue())
    return out.getvalue()


def _ints_unpacked(values) -> bytes:
    out = io.BytesIO()
    for v in values:
        W._write_tag(out, 1, 0)
        W._write_varint(out, v & 0xFFFFFFFFFFFFFFFF)
    return out.getvalue()


def _feature(kind: int, list_body: bytes) -> bytes:
    out = io.BytesIO()
    W._write_len_delimited(out, kind, list_body)
    return out.getvalue()


def _example(entries) -> bytes:
    """entries: [(key, feature bytes)] in order (a key may repeat)."""
    feats = io.BytesIO()
    for key, feature in entries:
        entry = io.BytesIO()
        W._write_len_delimited(entry, 1, key.encode())
        W._write_len_delimited(entry, 2, feature)
        W._write_len_delimited(feats, 1, entry.getvalue())
    out = io.BytesIO()
    W._write_len_delimited(out, 1, feats.getvalue())
    return out.getvalue()


def _image(data=b"\xff\xd8jpeg"):
    out = io.BytesIO()
    W._write_len_delimited(out, 1, data)
    return _feature(1, out.getvalue())


def _base(n=3, corners=None):
    rng = np.random.default_rng(n)
    boxes = rng.random((n, 4)).astype(np.float32)
    corners = corners or {}
    entries = [("image", _image()), ("image_id", _feature(3, _ints_packed(
        [42])))]
    for i, key in enumerate(("xmins", "ymins", "xmaxs", "ymaxs")):
        entries.append((key, corners.get(key, _feature(
            2, _floats_packed(boxes[:, i])))))
    entries.append(("classes", _feature(3, _ints_packed(range(n)))))
    return entries


def _with(entries, key, feature):
    return [(k, feature if k == key else f) for k, f in entries]


def _without(entries, key):
    return [(k, f) for k, f in entries if k != key]


CASES = {
    "unequal_ymins": _with(_base(3), "ymins", _feature(
        2, _floats_packed([0.1, 0.2]))),
    "longer_xmins": _with(_base(3), "xmins", _feature(
        2, _floats_packed([0.1, 0.2, 0.3, 0.4]))),
    "empty_xmins_others_full": _with(_base(3), "xmins", _feature(
        2, _floats_packed([]))),
    "empty_ymins": _with(_base(3), "ymins", _feature(2, b"")),
    "no_list_in_feature": _with(_base(3), "ymaxs", b""),
    "fewer_classes": _with(_base(3), "classes", _feature(
        3, _ints_packed([1]))),
    "more_classes": _with(_base(2), "classes", _feature(
        3, _ints_packed([1, 2, 3, 4, 5]))),
    "unpacked_floats": _with(_base(2), "xmins", _feature(
        2, _floats_unpacked([0.25, 0.5]))),
    "packed_and_unpacked_floats": _with(_base(3), "ymaxs", _feature(
        2, _floats_packed([0.5]) + _floats_unpacked([0.6])
        + _floats_packed([0.7]))),
    "unpacked_ints": _with(_base(3), "classes", _feature(
        3, _ints_unpacked([7, -1, 1 << 50]))),
    "unpacked_image_id": _with(_base(1), "image_id", _feature(
        3, _ints_unpacked([-9]))),
    "mixed_ints": _with(_base(3), "classes", _feature(
        3, _ints_packed([1]) + _ints_unpacked([2]) + _ints_packed([3]))),
    "empty_image_id": _with(_base(1), "image_id", _feature(
        3, _ints_packed([]))),
    "empty_image": _with(_base(1), "image", _feature(1, b"")),
    "repeated_key_last_wins": _base(2) + [("image_id", _feature(
        3, _ints_packed([77])))],
    "two_images_first_wins": _with(_base(1), "image", _feature(
        1, b"".join(_image(d)[2:] for d in (b"one", b"two")))),
    "extra_keys": _base(2) + [("image/format", _image(b"jpeg")),
                              ("weights", _feature(2, _floats_packed([1])))],
}
for _key in ("image", "image_id", "xmins", "ymins", "xmaxs", "ymaxs",
             "classes"):
    CASES[f"missing_{_key}"] = _without(_base(2), _key)
CASES["missing_ymins_and_image"] = _without(_without(_base(2), "ymins"),
                                            "image")
CASES["unequal_and_missing_image"] = _without(CASES["unequal_ymins"],
                                              "image")


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_built_examples_parse_as_the_codec(case):
    _assert_same_parse(_example(CASES[case]))


def test_more_than_one_parse_call_when_boxes_exceed_the_first_room():
    n = host_codec._BOXES_CAP + 1
    want = _assert_same_parse(_seeded(n, seed=5))
    assert len(want["classes"]) == n


def test_malformed_message_raises():
    record = _seeded(3, seed=1)
    with pytest.raises(ValueError):
        host_codec.parse_detection_example(record[:-5])


def test_another_kind_than_the_schema_raises():
    entries = _with(_base(2), "classes", _feature(2, _floats_packed([1, 2])))
    with pytest.raises(ValueError, match="classes"):
        host_codec.parse_detection_example(_example(entries))


# -- record framing ----------------------------------------------------------

def _write_file(path, records):
    with tfrecord.RecordWriter(str(path)) as w:
        for r in records:
            w.write(r)


def _same_stream(path, verify_crc):
    want = _outcome(lambda: list(tfrecord.read_records(str(path),
                                                       verify_crc)))
    got = _outcome(lambda: list(host_codec.read_records(str(path),
                                                        verify_crc)))
    assert got == want
    # records before a fault come out before it raises, in both
    assert (list(_prefix(tfrecord.read_records(str(path), verify_crc)))
            == list(_prefix(host_codec.read_records(str(path), verify_crc))))
    return want


def _prefix(stream):
    try:
        yield from stream
    except IOError:
        return


@pytest.mark.parametrize("verify_crc", [False, True])
def test_index_equals_the_codec(tmp_path, verify_crc):
    records = [_seeded(n, seed=n) for n in (0, 1, 100, 600)] + [b""]
    path = tmp_path / "a.tfrecord"
    _write_file(path, records)
    assert _same_stream(path, verify_crc) == records
    for r in records:
        assert host_codec.masked_crc32c(r) == tfrecord.masked_crc32c(r)


def test_many_records_cross_the_index_chunk(tmp_path):
    records = [bytes([i % 251]) * (i % 7) for i in range(
        host_codec._INDEX_CHUNK * 2 + 3)]
    path = tmp_path / "many.tfrecord"
    _write_file(path, records)
    assert list(host_codec.read_records(str(path))) == records


@pytest.mark.parametrize("cut", [1, 7, 8, 11, 12, 20, 23])
def test_truncated_tail_ends_the_stream(tmp_path, cut):
    records = [_seeded(2, seed=2), _seeded(3, seed=3)]
    path = tmp_path / "t.tfrecord"
    _write_file(path, records)
    data = path.read_bytes()
    path.write_bytes(data[:-cut])
    assert _same_stream(path, verify_crc=True) == records[:1]


def test_empty_file(tmp_path):
    path = tmp_path / "empty.tfrecord"
    path.write_bytes(b"")
    assert list(host_codec.read_records(str(path))) == []


def test_implausible_length_raises_after_the_records_before(tmp_path):
    path = tmp_path / "bad.tfrecord"
    _write_file(path, [_seeded(1, seed=1)])
    with open(path, "ab") as f:
        f.write(struct.pack("<Q", (1 << 31) + 1) + b"\0" * 40)
    assert _same_stream(path, verify_crc=False) == (IOError, ())
    with pytest.raises(IOError, match="implausible record length"):
        list(host_codec.read_records(str(path)))


@pytest.mark.parametrize("where", ["header", "data"])
def test_bad_crc_raises_under_verify_crc(tmp_path, where):
    records = [_seeded(1, seed=1), _seeded(2, seed=2), _seeded(3, seed=3)]
    path = tmp_path / "crc.tfrecord"
    _write_file(path, records)
    data = bytearray(path.read_bytes())
    second = 16 + len(records[0])
    data[second + (8 if where == "header" else 12)] ^= 0x40
    path.write_bytes(bytes(data))
    assert _same_stream(path, verify_crc=True) == (IOError, ())
    part = "length" if where == "header" else "data"
    with pytest.raises(IOError, match=f"corrupt {part} crc"):
        list(host_codec.read_records(str(path), verify_crc=True))
    # without verification the flipped bit passes, in both
    _same_stream(path, verify_crc=False)


def test_records_written_by_the_jax_package(tmp_path):
    pattern = jax_synthetic.write_synthetic_tfrecords(
        str(tmp_path), "train", num_shards=2, samples_per_shard=4,
        num_classes=80, seed=0)
    paths = tfrecord.list_files(pattern)
    for path in paths:
        want = list(jax_tfrecord.read_records(path, verify_crc=True))
        assert list(host_codec.read_records(path, verify_crc=True)) == want
        for record in want:
            parsed = _assert_same_parse(record)
            jax = jax_tfrecord.parse_detection_example(record)
            assert parsed["image"] == jax["image"]
            assert parsed["image_id"] == jax["image_id"]
            np.testing.assert_array_equal(parsed["boxes"], jax["boxes"])
            np.testing.assert_array_equal(parsed["classes"], jax["classes"])
