"""The nvJPEG route of `data/host_codec.py` against libjpeg's pixels.

`tests/goldens/jpeg_decode_goldens.npz` holds JPEGs made by the JAX
package's scene writer (and the same scene at every chroma subsampling cv2
writes, and a grayscale one), each beside its pixels as the JAX package
decodes them through libjpeg (`tests/make_jpeg_goldens.py`).

Here, on the CPU: the port's libjpeg route gives those pixels exactly, and
`csrc/host/jpeg_ycc.h`, which turns nvJPEG's component planes into RGB,
finishes libjpeg's own planes into libjpeg's RGB bit for bit
(`tests/jpeg_ycc_check.cpp`). On the card: the nvJPEG route comes within
`host_codec.NVJPEG_MAX_ABS_ERR` and `NVJPEG_MEAN_ABS_ERR` of the goldens,
and decodes without waiting for work on the card's other streams.

Imports nothing of JAX, so that the card tests run on a machine with a card
and no JAX: `python -m pytest --noconftest -m cuda tests/test_torch_jpeg_cuda.py`.
"""

import ctypes
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.data import host_codec  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "jpeg_decode_goldens.npz")


def _goldens():
    g = np.load(GOLDENS)
    n = len([k for k in g.files if k.startswith("jpeg")])
    return [(g[f"jpeg{i}"].tobytes(), g[f"pixels{i}"]) for i in range(n)]


def _nvjpeg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: nvJPEG decodes on it")
    return host_codec.JPEG_LIBRARIES["nvjpeg"]


def test_goldens_equal_the_libjpeg_route():
    for data, pixels in _goldens():
        got = host_codec.decode_jpeg_with(
            host_codec.JPEG_LIBRARIES["libjpeg"], data)
        np.testing.assert_array_equal(got, pixels)


@pytest.fixture(scope="module")
def ycc_check(tmp_path_factory):
    """tests/jpeg_ycc_check.cpp, built with g++ against libjpeg."""
    here = os.path.dirname(os.path.abspath(__file__))
    lib = str(tmp_path_factory.mktemp("ycc") / "libjpeg_ycc_check.so")
    subprocess.run(
        ["g++", *host_codec.GXX_FLAGS, "-I", str(host_codec.HOST_SRC_DIR),
         "-o", lib, os.path.join(here, "jpeg_ycc_check.cpp"), "-ljpeg"],
        check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(lib)


def _rgb_via_planes(ycc_check, data, shape):
    out = np.zeros(shape, np.uint8)
    rc = ycc_check.rgb_via_planes(data, ctypes.c_long(len(data)),
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  ctypes.c_long(out.nbytes))
    assert rc == 0, rc
    return out


@pytest.mark.parametrize("factor", ["420", "444", "422", "440", "411"])
def test_planes_finish_equals_libjpeg(ycc_check, factor):
    """jpeg_ycc.h on libjpeg's own planes gives libjpeg's RGB, at each
    subsampling and at sizes where the chroma planes are 1 or 2 samples
    wide or tall (libjpeg's special cases)."""
    import cv2  # the JPEG writer here; the card machine has none
    rng = np.random.default_rng(int(factor))
    for h, w in ((97, 131), (48, 64), (3, 5), (1, 1), (2, 3), (17, 2)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[h // 3:, :w // 2] = (200, 30, 90)
        ok, enc = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")])
        assert ok
        want = host_codec.decode_jpeg(enc.tobytes())
        got = _rgb_via_planes(ycc_check, enc.tobytes(), want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
    if factor == "420":
        for data, pixels in _goldens():
            np.testing.assert_array_equal(
                _rgb_via_planes(ycc_check, data, pixels.shape), pixels)


def _libjpeg(ycc_check, data, shape, float_dct, fancy):
    out = np.zeros(shape, np.uint8)
    rc = ycc_check.rgb_libjpeg(data, ctypes.c_long(len(data)),
                               out.ctypes.data_as(ctypes.c_void_p),
                               ctypes.c_long(out.nbytes), float_dct, fancy)
    assert rc == 0, rc
    return out


def test_nvjpeg_bound_is_the_idcts_rounding(ycc_check):
    """The stated nvJPEG bound is what libjpeg's own float IDCT gives
    against its integer one on the goldens; libjpeg without fancy
    upsampling (what nvJPEG's own RGB output does) is far outside it."""
    worst = 0
    for i, (data, pixels) in enumerate(_goldens()):
        err = np.abs(_libjpeg(ycc_check, data, pixels.shape, 1, 1)
                     .astype(np.int16) - pixels)
        print(f"image {i} float IDCT: max |err| {err.max()}, mean "
              f"{err.mean():.4f}")
        assert err.max() <= host_codec.NVJPEG_MAX_ABS_ERR, i
        assert err.mean() <= host_codec.NVJPEG_MEAN_ABS_ERR, i
        plain = np.abs(_libjpeg(ycc_check, data, pixels.shape, 0, 0)
                       .astype(np.int16) - pixels)
        print(f"image {i} without fancy upsampling: max |err| "
              f"{plain.max()}, mean {plain.mean():.4f}")
        worst = max(worst, int(plain.max()))
    assert worst > 10 * host_codec.NVJPEG_MAX_ABS_ERR


@pytest.mark.cuda
def test_nvjpeg_decode_within_bound_of_libjpeg():
    lib = _nvjpeg()
    for i, (data, pixels) in enumerate(_goldens()):
        got = host_codec.decode_jpeg_with(lib, data)
        assert got.shape == pixels.shape and got.dtype == np.uint8, i
        err = np.abs(got.astype(np.int16) - pixels.astype(np.int16))
        print(f"image {i} {pixels.shape}: max |err| {err.max()}, "
              f"mean |err| {err.mean():.4f}")
        assert err.max() <= host_codec.NVJPEG_MAX_ABS_ERR, (i, err.max())
        assert err.mean() <= host_codec.NVJPEG_MEAN_ABS_ERR, (i, err.mean())


@pytest.mark.cuda
def test_nvjpeg_decodes_beside_a_busy_card():
    """Thread pools are built and dropped as the pipeline does at every
    trial and evaluation, while a long kernel runs on the consumer's
    stream: every decode equals the first, and none waits for that kernel
    (a cudaFree or any other device-wide synchronisation would)."""
    lib = _nvjpeg()
    samples = _goldens()
    want = [host_codec.decode_jpeg_with(lib, d) for d, _ in samples]
    work = [d for d, _ in samples] * 8

    def decode_all():
        with ThreadPoolExecutor(8) as pool:
            return list(pool.map(
                lambda d: host_codec.decode_jpeg_with(lib, d), work))

    decode_all()  # the pool's contexts and buffers are made here
    torch.cuda.synchronize()
    busy = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    busy.record()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning on the card
    done.record()
    start = time.perf_counter()
    for _ in range(3):
        got = decode_all()
    seconds = time.perf_counter() - start
    still_busy = not done.query()
    torch.cuda.synchronize()
    for i, image in enumerate(got):
        np.testing.assert_array_equal(image, want[i % len(want)])
    assert still_busy, (
        f"the decodes took {seconds:.3f} s and the card's kernel "
        f"({busy.elapsed_time(done):.0f} ms) had ended: they waited for it")


@pytest.mark.cuda
def test_nvjpeg_encode_round_trip():
    lib = _nvjpeg()
    _, pixels = _goldens()[0]
    data = host_codec.encode_jpeg(pixels)
    assert data[:2] == b"\xff\xd8"
    back = host_codec.decode_jpeg_with(lib, data)
    assert back.shape == pixels.shape
    assert np.abs(back.astype(int) - pixels).mean() < 4
