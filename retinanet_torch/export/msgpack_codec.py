"""Reader and writer of the msgpack that `flax.serialization.to_bytes` and
`from_bytes` use, without the `msgpack` package or flax.

The subset: nested maps with string keys whose leaves are ndarrays (ext
type 1) or numpy scalars (ext type 3), each with the payload flax gives
them: the msgpack of `(shape, dtype name, C-order bytes)`. That covers the
weights of an export artifact (`params.msgpack`: `{"params": ...,
"batch_stats": ...}`) and the `{"q", "scale"}` leaves of
`export/quantize.py:quantize_params` (`params_int8.msgpack`), so an
artifact written by either package is read by the other. (Flax splits a
leaf above 1 GiB into chunks, a form no model here reaches; the reader
returns such a leaf as the map flax wrote.)

Leaves come back as numpy arrays; a bfloat16 leaf, which numpy has no type
for, as a `torch.bfloat16` tensor. `dumps` takes numpy arrays, numpy
scalars and torch tensors (written as their numpy counterparts, bfloat16
under flax's dtype name "bfloat16").
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# -- writing ------------------------------------------------------------------

def _pack_uint(out: bytearray, n: int, small: int, codes: Tuple) -> None:
    """A length or count with the msgpack form that fits it."""
    if n < small:
        out.append(codes[0] | n)
    elif n < 1 << 8 and codes[1] is not None:
        out += bytes((codes[1], n))
    elif n < 1 << 16:
        out += bytes((codes[2],)) + struct.pack(">H", n)
    else:
        out += bytes((codes[3],)) + struct.pack(">I", n)


def _pack_dim(out: bytearray, n: int) -> None:
    """A non-negative integer (an array dimension)."""
    if n < 128:
        out.append(n)
        return
    for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if n < limit:
            out += bytes((code,)) + struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _pack_str(out: bytearray, text: str) -> None:
    data = text.encode("utf-8")
    _pack_uint(out, len(data), 32, (0xA0, 0xD9, 0xDA, 0xDB))
    out += data


def _pack_bin(out: bytearray, data: bytes) -> None:
    _pack_uint(out, len(data), 0, (0, 0xC4, 0xC5, 0xC6))
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out += bytes((0xC8,)) + struct.pack(">H", n)
    else:
        out += bytes((0xC9,)) + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    out = bytearray()
    _pack_uint(out, 3, 16, (0x90, None, 0xDC, 0xDD))
    _pack_uint(out, len(shape), 16, (0x90, None, 0xDC, 0xDD))
    for dim in shape:
        _pack_dim(out, int(dim))
    _pack_str(out, dtype_name)
    _pack_bin(out, data)
    return bytes(out)


def _as_numpy(value: torch.Tensor):
    """(shape, dtype name, bytes) of a tensor, bfloat16 included."""
    value = value.detach().to("cpu").contiguous()
    if value.dtype == torch.bfloat16:
        return (tuple(value.shape), "bfloat16",
                value.view(torch.int16).numpy().tobytes())
    arr = value.numpy()
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _pack(out: bytearray, value: Any) -> None:
    if isinstance(value, dict):
        _pack_uint(out, len(value), 16, (0x80, None, 0xDE, 0xDF))
        for key, item in value.items():
            _pack_str(out, str(key))
            _pack(out, item)
    elif isinstance(value, torch.Tensor):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(*_as_numpy(value)))
    elif isinstance(value, np.ndarray):
        if value.dtype.hasobject or value.dtype.fields is not None:
            raise ValueError(f"cannot serialize dtype {value.dtype}")
        _pack_ext(out, _EXT_NDARRAY, _array_payload(
            value.shape, value.dtype.name, value.tobytes("C")))
    elif isinstance(value, np.generic):
        arr = np.asarray(value)
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(
            arr.shape, arr.dtype.name, arr.tobytes("C")))
    else:
        raise TypeError(f"cannot serialize {type(value).__name__}")


def dumps(tree: Any) -> bytes:
    """msgpack bytes of `tree` that `flax.serialization.msgpack_restore`
    (and so `from_bytes`) reads."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# -- reading ------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key.decode() if isinstance(key, bytes) else key] = \
                self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, dtype_name, data = _Reader(payload).value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            arr = torch.frombuffer(bytearray(data), dtype=torch.bfloat16)
            return arr.reshape(tuple(shape))
        arr = np.frombuffer(bytearray(data), dtype=np.dtype(
            dtype_name)).reshape(tuple(shape))
        return arr[()] if code == _EXT_NPSCALAR else arr


def loads(data: bytes) -> Any:
    """The tree of `flax.serialization.to_bytes` (or of `dumps`)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def read_file(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


def write_file(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))
