"""Host-side native code of the input pipeline: the TFRecord reader and the
detection-example parser, JPEG decode and encode, and the fused bilinear
resampler (counterpart of `retinanet_tpu/data/native.py`).

The C++ sources are the port's own, under `retinanet_torch/csrc/host/`.
`g++` builds each on first use into `retinanet_torch/_build/`, named by a
hash of the source and its headers, the flags and the CPU, and ctypes
loads it; every call runs outside the GIL, so the pipeline's worker
threads parse and decode in parallel. A library that does not build raises
with the compiler's words; nothing falls back to Python. The Python codec
of `data/tfrecord.py` stays the spec that the tests hold the reader to.

JPEG has one route a machine (`jpeg_route()`): libjpeg(-turbo) where the
compiler finds `jpeglib.h`, which is the JAX package's own route, so the
decoded pixels are the same bit for bit; else nvJPEG of the CUDA toolkit
(`csrc/host/jpeg_nvjpeg.cpp`, the same C interface: the card decodes to
the component planes, and the host upsamples and converts them as libjpeg
does, `csrc/host/jpeg_ycc.h`; encode from host memory). Where neither is
there the first JPEG call raises; there is no other decoder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
HOST_SRC_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
# the JAX package's flags: the same compiler flags give the same rounding
# (-march=native lets the compiler contract a*b+c into one FMA)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
JPEG_QUALITY = 95  # cv2.imencode's default, which the JAX writer uses
# nvJPEG's pixels against libjpeg's on the same JPEG (|difference| in uint8
# levels): the bound that tests/test_torch_jpeg_cuda.py and chip_smoke.py
# hold the nvJPEG route to; libjpeg's route is exact. What is left is the
# IDCT's rounding: libjpeg's own float IDCT differs from its integer one by
# as much (max 3, mean <= 0.044 on tests/goldens/jpeg_decode_goldens.npz).
NVJPEG_MAX_ABS_ERR = 3
NVJPEG_MEAN_ABS_ERR = 0.05


def _cpu_model() -> str:
    """The host CPU's model name and flags, as /proc/cpuinfo gives them."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return ""
    return "\n".join(line for line in text.splitlines()[:40]
                     if line.startswith(("model name", "flags")))


class HostLibrary:
    """One C++ source of `csrc/host/`, built with g++ at first use.
    `get()` may be called from several threads at once; a failed build
    raises every time it is asked for."""

    def __init__(self, name: str, link: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None],
                 cflags: Sequence[str] = ()):
        self.name = name
        self.cflags = tuple(cflags)  # after GXX_FLAGS, before the source
        self.source = HOST_SRC_DIR / f"{name}.cpp"
        self.link = tuple(link)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self) -> ctypes.CDLL:
        flags = GXX_FLAGS + self.cflags + self.link
        # -march=native: a library built for another CPU is not reused;
        # the headers beside the source count as the source does
        headers = b"".join(h.read_bytes()
                           for h in sorted(HOST_SRC_DIR.glob("*.h")))
        tag = hashlib.sha256(self.source.read_bytes() + headers
                             + " ".join(flags).encode()
                             + _cpu_model().encode()).hexdigest()[:16]
        path = BUILD_DIR / f"lib{self.name}_{tag}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                # the library to link comes after the source
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, *self.cflags, "-o", tmp,
                     str(self.source), *self.link], capture_output=True,
                    text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed on {self.source}:\n{proc.stdout}"
                        f"{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        self._declare(lib)
        return lib


_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _declare_tfrecord(lib: ctypes.CDLL) -> None:
    lib.tfr_index.restype = ctypes.c_int64
    lib.tfr_index.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P,
        ctypes.c_int64, ctypes.c_int, _I64P, _I32P]
    lib.tfr_parse_detection.restype = ctypes.c_int
    lib.tfr_parse_detection.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _I32P, _I64P, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64]
    lib.tfr_masked_crc32c.restype = ctypes.c_uint32
    lib.tfr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    lib.jpg_dims.restype = ctypes.c_int
    lib.jpg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.jpg_decode_rgb.restype = ctypes.c_int
    lib.jpg_decode_rgb.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _U8, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.jpg_size.restype = ctypes.c_int
    lib.jpg_size.argtypes = lib.jpg_dims.argtypes
    lib.jpg_encode_rgb.restype = ctypes.c_int
    lib.jpg_encode_rgb.argtypes = [
        _U8, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]


def _declare_resample(lib: ctypes.CDLL) -> None:
    lib.resample_bilinear_u8.restype = ctypes.c_int
    lib.resample_bilinear_u8.argtypes = (
        [_U8, ctypes.c_int, ctypes.c_int, _U8] + [ctypes.c_int] * 4
        + [ctypes.c_double] * 4 + [ctypes.c_int, _F32])


resample = HostLibrary("resample_native", [], _declare_resample)
tfrecord_lib = HostLibrary("tfrecord_native", [], _declare_tfrecord)
_CUDA_LIB = str(CUDA_HOME / "lib64")
JPEG_LIBRARIES = {
    "libjpeg": HostLibrary("jpeg_native", ["-ljpeg"], _declare_jpeg),
    "nvjpeg": HostLibrary(
        "jpeg_nvjpeg", ["-L" + _CUDA_LIB, "-Wl,-rpath," + _CUDA_LIB,
                        "-lnvjpeg", "-lcudart"], _declare_jpeg,
        cflags=["-I" + str(CUDA_HOME / "include")]),
}


def _compiler_finds(header: str) -> bool:
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                          input=f"#include <{header}>\n", capture_output=True,
                          text=True, timeout=60)
    return proc.returncode == 0


def jpeg_route() -> str:
    """The machine's JPEG library: "libjpeg" where g++ finds `jpeglib.h`,
    else "nvjpeg" where the CUDA toolkit has `nvjpeg.h`. Raises where
    neither is there."""
    if _compiler_finds("jpeglib.h"):
        return "libjpeg"
    if (CUDA_HOME / "include" / "nvjpeg.h").exists():
        return "nvjpeg"
    raise RuntimeError(
        "no JPEG library to build against: neither libjpeg's jpeglib.h nor "
        f"{CUDA_HOME / 'include' / 'nvjpeg.h'} was found")


@functools.lru_cache(maxsize=None)
def jpeg_library() -> HostLibrary:
    """The JPEG library of this machine's route, chosen once a process."""
    return JPEG_LIBRARIES[jpeg_route()]


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, C-contiguous, through this
    machine's route. Raises ValueError on a payload that is not a JPEG."""
    return decode_jpeg_with(jpeg_library(), data)


def decode_jpeg_with(library: HostLibrary, data: bytes) -> np.ndarray:
    """`decode_jpeg` through the given library of `JPEG_LIBRARIES`."""
    lib = library.get()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.jpg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("not a JPEG image")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpg_decode_rgb(data, len(data), out, out.nbytes,
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"JPEG decode failed ({rc})")
    return out


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of a JPEG whose whole image decodes from `data`,
    through this machine's route; raises ValueError on data that is no
    JPEG, fails to decode, or ends before the image's last scanline (as
    `cv2.imdecode` refuses it)."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if jpeg_library().get().jpg_size(data, len(data), ctypes.byref(w),
                                     ctypes.byref(h)) != 0:
        raise ValueError("not a whole JPEG image")
    return h.value, w.value


def encode_jpeg(rgb: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {rgb.shape}")
    h, w = rgb.shape[:2]
    out = np.empty(2 * rgb.nbytes + 65536, np.uint8)
    n = ctypes.c_long()
    rc = jpeg_library().get().jpg_encode_rgb(
        rgb, w, h, int(quality), out, out.nbytes, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"JPEG encode failed ({rc})")
    return out[:n.value].tobytes()


def resample_bilinear(image: np.ndarray, out_hw: Tuple[int, int],
                      valid_hw: Tuple[int, int],
                      scale_yx: Tuple[float, float],
                      offset_yx: Tuple[float, float], flip: bool,
                      pad_rgb: np.ndarray) -> np.ndarray:
    """tf.image.resize-parity bilinear sample of the uint8 `image` into a
    fresh (out_h, out_w, 3) uint8 canvas: the valid region is the resize,
    cropped at the offset, with the optional horizontal flip folded into
    the sampling coordinates; the rest is `pad_rgb`."""
    if image.dtype != np.uint8:
        raise TypeError(f"resample takes uint8, not {image.dtype}")
    image = np.ascontiguousarray(image)
    out = np.empty((int(out_hw[0]), int(out_hw[1]), 3), np.uint8)
    pad = np.ascontiguousarray(pad_rgb, np.float32)
    rc = resample.get().resample_bilinear_u8(
        image, image.shape[0], image.shape[1],
        out, out.shape[0], out.shape[1],
        int(valid_hw[0]), int(valid_hw[1]),
        float(scale_yx[0]), float(scale_yx[1]),
        float(offset_yx[0]), float(offset_yx[1]),
        1 if flip else 0, pad)
    if rc != 0:
        raise ValueError(
            f"resample refused the geometry: image {image.shape}, out "
            f"{out_hw}, valid {valid_hw}, scale {scale_yx}")
    return out


# -- TFRecord reader and detection-example parser ----------------------------

_INDEX_CHUNK = 4096  # records indexed a native call
_KEYS = ("image", "image_id", "xmins", "ymins", "xmaxs", "ymaxs", "classes")
_MISSING, _NO_VALUE, _EMPTY, _BYTES, _FLOAT, _INT64 = -1, -2, 0, 1, 2, 3
_KIND_NAMES = {_NO_VALUE: "an entry without a value", _BYTES: "a bytes_list",
               _FLOAT: "a float_list", _INT64: "an int64_list"}
_BOXES_CAP = 128  # boxes a first parse call has room for


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Stream the raw records of one local tfrecord file, indexed in C++
    (`data/tfrecord.py:read_records`'s results and errors: a truncated tail
    ends the stream, an implausible length or, under `verify_crc`, a wrong
    checksum raises IOError after the records before it)."""
    from retinanet_torch.data.tfrecord import _refuse_remote
    _refuse_remote(path)
    lib = tfrecord_lib.get()
    with open(path, "rb") as f:
        data = f.read()
    offsets = np.empty(_INDEX_CHUNK, np.int64)
    lengths = np.empty(_INDEX_CHUNK, np.int64)
    pos, nxt, status = 0, ctypes.c_int64(), ctypes.c_int32()
    while True:
        n = lib.tfr_index(data, len(data), pos, offsets.ctypes.data_as(_I64P),
                          lengths.ctypes.data_as(_I64P), _INDEX_CHUNK,
                          int(verify_crc), ctypes.byref(nxt),
                          ctypes.byref(status))
        for off, ln in zip(offsets[:n].tolist(), lengths[:n].tolist()):
            yield data[off:off + ln]
        pos = nxt.value
        if status.value == 0:
            continue
        if status.value == 2:
            length = int.from_bytes(data[pos:pos + 8], "little")
            raise IOError(f"{path}: implausible record length {length} — "
                          "not a tfrecord file?")
        if status.value == 3:
            raise IOError(f"corrupt length crc in {path}")
        if status.value == 4:
            raise IOError(f"corrupt data crc in {path}")
        return


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc32c of `data`, in C++."""
    return int(tfrecord_lib.get().tfr_masked_crc32c(data, len(data)))


def _schema_kind(kinds, k: int, want: int) -> None:
    kind = int(kinds[k])
    if kind not in (want, _EMPTY):
        raise ValueError(
            f"feature {_KEYS[k]!r} is {_KIND_NAMES.get(kind, kind)}, the "
            f"detection schema has {_KIND_NAMES[want]}")


def parse_detection_example(record: bytes) -> Dict:
    """`data/tfrecord.py:parse_detection_example` in C++: {image: jpeg
    bytes, image_id: int, boxes: (N, 4) float32 normalized corners [x1, y1,
    x2, y2], classes: (M,) int64}, every box and class the record holds.
    Raises where the Python codec raises: KeyError on a missing key,
    ValueError on corner lists of unequal lengths, IndexError on an empty
    image or image_id, in the codec's order. A feature of another kind than
    the schema's (which the codec would convert by numpy's rules), or a
    malformed message, raises ValueError."""
    lib = tfrecord_lib.get()
    kinds = np.empty(7, np.int32)
    info = np.empty(10, np.int64)
    cap = _BOXES_CAP
    while True:
        boxes = np.empty((cap, 4), np.float32)
        classes = np.empty(cap, np.int64)
        rc = lib.tfr_parse_detection(
            record, len(record), kinds.ctypes.data_as(_I32P),
            info.ctypes.data_as(_I64P), boxes.ctypes.data,
            classes.ctypes.data, cap)
        if rc != 1:
            break
        cap = int(info[5:].max())
    if rc != 0:
        raise ValueError("malformed detection example")
    # the codec reads the corners, stacks them, then image, image_id and
    # classes: the first fault in that order is the one raised
    for k in (2, 3, 4, 5):
        if kinds[k] == _MISSING:
            raise KeyError(_KEYS[k])
        _schema_kind(kinds, k, _FLOAT)
    n = int(info[5])
    if n and not n == info[6] == info[7] == info[8]:
        raise ValueError(
            "corner lists of unequal lengths: xmins, ymins, xmaxs, ymaxs "
            f"hold {info[5:9].tolist()} values")
    for k, want in ((0, _BYTES), (1, _INT64)):
        if kinds[k] == _MISSING:
            raise KeyError(_KEYS[k])
        _schema_kind(kinds, k, want)
        if info[2 + 2 * k] == 0:
            raise IndexError(f"feature {_KEYS[k]!r} holds no value")
    if kinds[6] == _MISSING:
        raise KeyError("classes")
    _schema_kind(kinds, 6, _INT64)
    image_off, image_len = int(info[0]), int(info[1])
    return {
        "image": record[image_off:image_off + image_len],
        "image_id": int(info[3]),
        "boxes": boxes[:n],
        "classes": classes[:int(info[9])],
    }
