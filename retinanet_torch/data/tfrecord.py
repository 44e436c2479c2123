"""TFRecord and tf.train.Example I/O without TensorFlow (the port's own copy
of `retinanet_tpu/data/tfrecord.py`): the same on-disk format, so a file
written by either package reads in the other, byte for byte.

  TFRecord framing: <uint64 length><uint32 masked-crc32c(length)>
                    <bytes data><uint32 masked-crc32c(data)>

  tf.train.Example proto:
    Example{ features:1 } / Features{ feature:1 map<string,Feature> }
    Feature{ bytes_list:1 | float_list:2 | int64_list:3 }

Detection record schema: image: bytes (jpeg), image_id: int64,
xmins/ymins/xmaxs/ymaxs: float varlen (normalized [0,1] corners),
classes: int64 varlen.

Local paths only: a remote (`gs://`) pattern raises.
"""

from __future__ import annotations

import glob as globlib
import io
import os
import struct
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven; needed to write TF-compatible records.
# ---------------------------------------------------------------------------


def _make_crc_table() -> List[int]:
    poly = 0x82F63B78  # reflected 0x1EDC6F41
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes) -> int:
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives (only what tf.train.Example needs).
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: io.BytesIO, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.write(bytes((bits | 0x80,)))
        else:
            out.write(bytes((bits,)))
            return


def _write_tag(out: io.BytesIO, field: int, wire_type: int) -> None:
    _write_varint(out, (field << 3) | wire_type)


def _write_len_delimited(out: io.BytesIO, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out.write(payload)


# ---------------------------------------------------------------------------
# tf.train.Example encode / decode
# ---------------------------------------------------------------------------

FeatureValue = Union[bytes, List[bytes], float, Sequence[float], int,
                     Sequence[int], np.ndarray]


def _encode_feature(value: FeatureValue) -> bytes:
    inner = io.BytesIO()
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, (list, tuple, np.ndarray)) and len(value) and \
            isinstance(value[0], bytes):
        blist = io.BytesIO()
        for v in value:
            _write_len_delimited(blist, 1, v)
        _write_len_delimited(inner, 1, blist.getvalue())  # bytes_list
        return inner.getvalue()

    arr = np.asarray(value)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if np.issubdtype(arr.dtype, np.floating):
        packed = arr.astype("<f4").tobytes()
        flist = io.BytesIO()
        _write_tag(flist, 1, 2)  # packed repeated float
        _write_varint(flist, len(packed))
        flist.write(packed)
        _write_len_delimited(inner, 2, flist.getvalue())  # float_list
        return inner.getvalue()
    if np.issubdtype(arr.dtype, np.integer):
        ilist = io.BytesIO()
        body = io.BytesIO()
        for v in arr.tolist():
            _write_varint(body, v & 0xFFFFFFFFFFFFFFFF)
        _write_tag(ilist, 1, 2)  # packed repeated int64
        _write_varint(ilist, len(body.getvalue()))
        ilist.write(body.getvalue())
        _write_len_delimited(inner, 3, ilist.getvalue())  # int64_list
        return inner.getvalue()
    raise TypeError(f"Unsupported feature value type: {type(value)}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    feats = io.BytesIO()
    for key, value in features.items():
        entry = io.BytesIO()
        _write_len_delimited(entry, 1, key.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(value))
        _write_len_delimited(feats, 1, entry.getvalue())  # map entry
    example = io.BytesIO()
    _write_len_delimited(example, 1, feats.getvalue())  # Example.features
    return example.getvalue()


def _decode_bytes_list(payload: memoryview) -> List[bytes]:
    out: List[bytes] = []
    p = 0
    while p < len(payload):
        _, p = _read_varint(payload, p)
        ln, p = _read_varint(payload, p)
        out.append(bytes(payload[p:p + ln]))
        p += ln
    return out


def _decode_float_list(payload: memoryview) -> np.ndarray:
    p = 0
    vals: List[np.ndarray] = []
    while p < len(payload):
        t, p = _read_varint(payload, p)
        if t & 7 == 2:  # packed
            ln, p = _read_varint(payload, p)
            vals.append(np.frombuffer(payload[p:p + ln], dtype="<f4"))
            p += ln
        else:  # unpacked single float
            vals.append(np.frombuffer(payload[p:p + 4], dtype="<f4"))
            p += 4
    return np.concatenate(vals) if vals else np.zeros(0, np.float32)


def _decode_int64_list(payload: memoryview) -> np.ndarray:
    p = 0
    ints: List[int] = []
    while p < len(payload):
        t, p = _read_varint(payload, p)
        stop = p + 1
        if t & 7 == 2:  # packed
            ln, p = _read_varint(payload, p)
            stop = p + ln
        while p < stop:
            v, p = _read_varint(payload, p)
            ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            if t & 7 != 2:
                break
    return np.asarray(ints, dtype=np.int64)


def _decode_feature(buf: memoryview) -> Union[List[bytes], np.ndarray]:
    pos = 0
    decoders = {1: _decode_bytes_list, 2: _decode_float_list,
                3: _decode_int64_list}
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        length, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + length]
        pos += length
        if tag >> 3 in decoders:
            return decoders[tag >> 3](payload)
    return []


def _fields(buf: memoryview):
    """(field number, payload) of each length-delimited field."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        length, pos = _read_varint(buf, pos)
        yield tag >> 3, buf[pos:pos + length]
        pos += length


def decode_example(data: bytes) -> Dict[str, Union[List[bytes], np.ndarray]]:
    features: Dict[str, Union[List[bytes], np.ndarray]] = {}
    for field, payload in _fields(memoryview(data)):
        if field != 1:
            continue
        for ffield, entry in _fields(payload):  # Features: map entries
            if ffield != 1:
                continue
            key = value = None
            for efield, body in _fields(entry):
                if efield == 1:
                    key = bytes(body).decode("utf-8")
                elif efield == 2:
                    value = _decode_feature(body)
            if key is not None:
                features[key] = value
    return features


# ---------------------------------------------------------------------------
# TFRecord container
# ---------------------------------------------------------------------------

class RecordWriter:
    """Writes TF-compatible tfrecord files."""

    def __init__(self, path: str):
        _refuse_remote(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_MAX_RECORD_BYTES = 1 << 31  # guards against reading non-tfrecord files


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Stream raw records from one local tfrecord file."""
    _refuse_remote(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            if length > _MAX_RECORD_BYTES:
                raise IOError(
                    f"{path}: implausible record length {length} — not a "
                    "tfrecord file?")
            crc_h = f.read(4)
            data = f.read(length)
            crc_d = f.read(4)
            if len(data) < length or len(crc_d) < 4:
                return  # truncated tail
            if verify_crc:
                if struct.unpack("<I", crc_h)[0] != masked_crc32c(header):
                    raise IOError(f"corrupt length crc in {path}")
                if struct.unpack("<I", crc_d)[0] != masked_crc32c(data):
                    raise IOError(f"corrupt data crc in {path}")
            yield data


def _refuse_remote(path: str) -> None:
    if "://" in path:
        raise NotImplementedError(
            f"{path}: remote (gs://) paths are not ported; ROADMAP Queue 1 "
            "#9 (remote paths)")


def list_files(pattern: str) -> List[str]:
    """Sorted local paths matching `pattern`; raises when none match."""
    _refuse_remote(pattern)
    files = sorted(globlib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"No tfrecords match pattern: {pattern}")
    return files


# ---------------------------------------------------------------------------
# Detection-sample schema
# ---------------------------------------------------------------------------

def parse_detection_example(data: bytes) -> Dict:
    """Returns {image: jpeg bytes, image_id: int, boxes: (N,4) normalized
    corners [x1,y1,x2,y2], classes: (N,) int64}."""
    feats = decode_example(data)
    xmins = np.asarray(feats["xmins"], np.float32)
    ymins = np.asarray(feats["ymins"], np.float32)
    xmaxs = np.asarray(feats["xmaxs"], np.float32)
    ymaxs = np.asarray(feats["ymaxs"], np.float32)
    boxes = np.stack([xmins, ymins, xmaxs, ymaxs], axis=-1) if len(xmins) \
        else np.zeros((0, 4), np.float32)
    return {
        "image": feats["image"][0],
        "image_id": int(np.asarray(feats["image_id"])[0]),
        "boxes": boxes,
        "classes": np.asarray(feats["classes"], np.int64),
    }


def make_detection_example(image_jpeg: bytes, image_id: int,
                           boxes_norm: np.ndarray,
                           classes: np.ndarray) -> bytes:
    """Inverse of parse_detection_example."""
    boxes_norm = np.asarray(boxes_norm, np.float32).reshape(-1, 4)
    return encode_example({
        "image": image_jpeg,
        "image_id": np.asarray([image_id], np.int64),
        "xmins": boxes_norm[:, 0],
        "ymins": boxes_norm[:, 1],
        "xmaxs": boxes_norm[:, 2],
        "ymaxs": boxes_norm[:, 3],
        "classes": np.asarray(classes, np.int64),
    })
