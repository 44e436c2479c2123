"""TensorBoard event files, encoded and decoded by hand (no TensorFlow or
tensorboard package): the sink behind `train/diagnostics.py:MetricsLogger`.

An event file is a TFRecord file (`data/tfrecord.py:RecordWriter`: length,
masked CRC32C, payload, masked CRC32C) of serialized `Event` protos. The
first event carries `file_version` "brain.Event:2"; each later one carries
one `Summary.Value` at a step. What TF2's `tf.summary.scalar` and
`tf.summary.histogram` write, and so what this module writes:
  * a scalar: a float32 `TensorProto` of shape [] under the plugin
    "scalars";
  * a histogram: a float64 `TensorProto` of shape [30, 3], rows of (left
    edge, right edge, count), under the plugin "histograms", bucketed as
    `tensorboard/plugins/histogram/summary_v2.py:_buckets` buckets:
    30 buckets of equal width between the minimum and the maximum, the
    index `floor((x - min) / width)` clamped to the last bucket, the last
    right edge the maximum itself; one distinct value gives 30 buckets
    whose edges are all that value and whose last count is the size; no
    value gives 30 rows of zeros.
`histogram_buckets` computes the buckets on the tensors' own device in
float64. Files are named `events.out.tfevents.<secs>.<host>.<pid>.<n>.v2`,
as TF2's writer names them.

The wire format (protobuf field numbers): Event {1 wall_time double, 2 step
int64, 3 file_version string, 5 summary}; Summary {1 value}; Value {1 tag,
8 tensor, 9 metadata}; SummaryMetadata {1 plugin_data {1 plugin_name,
2 content}}; TensorProto {1 dtype enum, 2 tensor_shape {2 dim {1 size}},
4 tensor_content bytes}.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from retinanet_torch.data import tfrecord

FILE_VERSION = "brain.Event:2"
SCALARS_PLUGIN = "scalars"
HISTOGRAMS_PLUGIN = "histograms"
BUCKET_COUNT = 30
DT_FLOAT = 1
DT_DOUBLE = 2
_NUMPY_DTYPES = {DT_FLOAT: np.dtype("<f4"), DT_DOUBLE: np.dtype("<f8")}
# the writers of this process, numbered as TF2 numbers its files
_FILE_COUNTER = itertools.count()


@dataclasses.dataclass
class TensorProto:
    dtype: int
    shape: tuple
    content: bytes

    def numpy(self) -> np.ndarray:
        return np.frombuffer(self.content,
                             _NUMPY_DTYPES[self.dtype]).reshape(self.shape)

    @classmethod
    def from_numpy(cls, array: np.ndarray) -> "TensorProto":
        dtype = {np.dtype(np.float32): DT_FLOAT,
                 np.dtype(np.float64): DT_DOUBLE}[array.dtype]
        return cls(dtype, tuple(array.shape),
                   np.ascontiguousarray(array, _NUMPY_DTYPES[dtype]).tobytes())


@dataclasses.dataclass
class SummaryValue:
    tag: str
    plugin_name: str
    tensor: TensorProto


@dataclasses.dataclass
class Event:
    wall_time: float
    step: int = 0
    file_version: Optional[str] = None
    values: List[SummaryValue] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------------ encode

def _message(field: int, build) -> bytes:
    out = io.BytesIO()
    build(out)
    framed = io.BytesIO()
    tfrecord._write_len_delimited(framed, field, out.getvalue())
    return framed.getvalue()


def _encode_tensor(out: io.BytesIO, tensor: TensorProto) -> None:
    tfrecord._write_tag(out, 1, 0)
    tfrecord._write_varint(out, tensor.dtype)
    shape = io.BytesIO()
    for size in tensor.shape:
        dim = io.BytesIO()
        tfrecord._write_tag(dim, 1, 0)
        tfrecord._write_varint(dim, int(size))
        tfrecord._write_len_delimited(shape, 2, dim.getvalue())
    tfrecord._write_len_delimited(out, 2, shape.getvalue())
    tfrecord._write_len_delimited(out, 4, tensor.content)


def _encode_value(out: io.BytesIO, value: SummaryValue) -> None:
    tfrecord._write_len_delimited(out, 1, value.tag.encode("utf-8"))
    out.write(_message(8, lambda o: _encode_tensor(o, value.tensor)))
    plugin = io.BytesIO()
    tfrecord._write_len_delimited(plugin, 1, value.plugin_name.encode())
    out.write(_message(9, lambda o: tfrecord._write_len_delimited(
        o, 1, plugin.getvalue())))


def encode_event(event: Event) -> bytes:
    out = io.BytesIO()
    tfrecord._write_tag(out, 1, 1)
    out.write(struct.pack("<d", float(event.wall_time)))
    if event.step:
        tfrecord._write_tag(out, 2, 0)
        tfrecord._write_varint(out, int(event.step) & (2 ** 64 - 1))
    if event.file_version is not None:
        tfrecord._write_len_delimited(out, 3, event.file_version.encode())
    if event.values:
        summary = io.BytesIO()
        for value in event.values:
            summary.write(_message(1, lambda o, v=value: _encode_value(o, v)))
        tfrecord._write_len_delimited(out, 5, summary.getvalue())
    return out.getvalue()


# ------------------------------------------------------------------ decode

def _fields(buf: memoryview) -> Iterator[tuple]:
    """(field number, wire type, value) of each field: an int for varints,
    8 or 4 raw bytes for fixed-width fields, a memoryview for the rest."""
    pos = 0
    while pos < len(buf):
        tag, pos = tfrecord._read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = tfrecord._read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            length, pos = tfrecord._read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _decode_tensor(buf: memoryview) -> TensorProto:
    dtype, shape, content = 0, [], b""
    for field, _, value in _fields(buf):
        if field == 1:
            dtype = value
        elif field == 2:
            for f, _, dim in _fields(value):
                if f == 2:
                    shape.append(next((v for g, _, v in _fields(dim)
                                       if g == 1), 0))
        elif field == 4:
            content = bytes(value)
    return TensorProto(dtype, tuple(shape), content)


def _decode_value(buf: memoryview) -> SummaryValue:
    tag, plugin, tensor = "", "", None
    for field, _, value in _fields(buf):
        if field == 1:
            tag = bytes(value).decode("utf-8")
        elif field == 8:
            tensor = _decode_tensor(value)
        elif field == 9:
            for f, _, data in _fields(value):
                if f == 1:
                    plugin = next((bytes(v).decode() for g, _, v
                                   in _fields(data) if g == 1), "")
    return SummaryValue(tag, plugin, tensor)


def decode_event(data: bytes) -> Event:
    event = Event(wall_time=0.0)
    for field, _, value in _fields(memoryview(data)):
        if field == 1:
            event.wall_time = struct.unpack("<d", value)[0]
        elif field == 2:
            event.step = value - 2 ** 64 if value >= 2 ** 63 else value
        elif field == 3:
            event.file_version = bytes(value).decode()
        elif field == 5:
            event.values += [_decode_value(v)
                             for f, _, v in _fields(value) if f == 1]
    return event


def read_events(path: str) -> Iterator[Event]:
    """Every event of one file, CRCs checked."""
    for record in tfrecord.read_records(path, verify_crc=True):
        yield decode_event(record)


def event_files(logdir: str) -> List[str]:
    return sorted(os.path.join(logdir, name) for name in os.listdir(logdir)
                  if name.startswith("events.out.tfevents."))


# ---------------------------------------------------------------- buckets

def _buckets_of(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().reshape(-1).to(torch.float64)
    out = torch.zeros((BUCKET_COUNT, 3), dtype=torch.float64,
                      device=x.device)
    if x.numel() == 0:
        return out
    lo, hi = torch.aminmax(x)
    span = hi - lo
    width = span / BUCKET_COUNT
    index = torch.floor((x - lo) / width)
    # one distinct value: width 0 makes every index nan; those buckets are
    # replaced below
    index = torch.nan_to_num(index, nan=0.0).clamp_(0, BUCKET_COUNT - 1)
    # a comparison with each bucket and one sum, not bincount (which waits
    # for the device to size its output) or scatter_add (30 addresses
    # under millions of atomics)
    steps = torch.arange(BUCKET_COUNT + 1, dtype=torch.float64,
                         device=x.device)
    counts = (index.unsqueeze(1) == steps[:-1]).sum(0, dtype=torch.float64)
    edges = lo + steps * width
    edges[-1] = hi
    single = span == 0
    last = torch.zeros_like(counts)
    last[-1] = x.numel()
    out[:, 0] = torch.where(single, hi, edges[:-1])
    out[:, 1] = torch.where(single, hi, edges[1:])
    out[:, 2] = torch.where(single, last, counts)
    return out


@torch.no_grad()
def histogram_buckets(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """TF2's histogram buckets of each tensor, computed on the tensor's own
    device in float64 and fetched once: an (n, 30, 3) float64 array."""
    if not tensors:
        return np.zeros((0, BUCKET_COUNT, 3), np.float64)
    stacked = torch.stack([_buckets_of(t) for t in tensors])
    return stacked.cpu().numpy()


# ----------------------------------------------------------------- writer

class EventFileWriter:
    """One event file under `logdir`, started by its file_version event.
    Every write goes straight to the file; an I/O error raises."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{int(now):010d}."
                f"{socket.gethostname()}.{os.getpid()}."
                f"{next(_FILE_COUNTER)}.v2")
        self.path = os.path.join(logdir, name)
        self._writer = tfrecord.RecordWriter(self.path)
        self._writer.write(encode_event(Event(now,
                                              file_version=FILE_VERSION)))
        self.flush()

    def _write(self, step: int, value: SummaryValue) -> None:
        self._writer.write(encode_event(Event(time.time(), int(step),
                                              values=[value])))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for tag, v in scalars.items():
            self._write(step, SummaryValue(tag, SCALARS_PLUGIN,
                                           TensorProto.from_numpy(
                                               np.asarray(v, np.float32))))

    def add_histograms(self, step: int, buckets: Dict[str, np.ndarray]
                       ) -> None:
        """`buckets`: tag -> a (30, 3) float64 array of
        `histogram_buckets`."""
        for tag, rows in buckets.items():
            self._write(step, SummaryValue(tag, HISTOGRAMS_PLUGIN,
                                           TensorProto.from_numpy(rows)))

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
