"""The port's image utilities (`utils/image_utils.py`, no cv2 or PIL)
against the JAX package's and against PNG's definition, on the CPU.

  * A JPEG written by `host_codec.encode_jpeg` reads to the pixels of the
    JAX package's `read_image` (cv2), exactly.
  * PNG: the writer's files read back equal; rows under each of the five
    filter types (built here from their definitions) decode exactly; gray
    and RGBA reduce to RGB.
  * `rescale_boxes` equals JAX's; `draw_detections` draws the box outline
    and a label in the class's colour and leaves the rest of the image.
"""

import struct
import zlib

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from retinanet_tpu.utils import image_utils as jax_image_utils  # noqa: E402
from retinanet_torch.data import host_codec  # noqa: E402
from retinanet_torch.utils import image_utils  # noqa: E402


def test_jpeg_reads_as_jax_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    rgb = (rng.uniform(0, 1, (57, 83, 3))
           * np.linspace(30, 255, 83)[None, :, None]).astype(np.uint8)
    path = tmp_path / "a.jpg"
    path.write_bytes(host_codec.encode_jpeg(rgb))
    np.testing.assert_array_equal(image_utils.read_image(str(path)),
                                  jax_image_utils.read_image(str(path)))


def _png(path, pixels, color, filters):
    """A PNG of `pixels` (H, W, channels) with row r under filter
    filters[r % len(filters)], encoded from the PNG definition."""
    h, w, bpp = pixels.shape
    raw = pixels.reshape(h, w * bpp).astype(np.int32)
    prev = np.zeros(w * bpp, np.int32)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        line = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pa = np.abs(prev - up_left)
            pb = np.abs(left - up_left)
            pc = np.abs(left + prev - 2 * up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        rows.append(bytes([kind]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(2, 3), (6, 4), (0, 1)],
                         ids=["rgb", "rgba", "gray"])
def test_png_filters_decode_exactly(tmp_path, color, channels):
    rng = np.random.default_rng(color)
    pixels = rng.integers(0, 256, (11, 7, channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    _png(path, pixels, color, filters=(0, 1, 2, 3, 4))
    got = image_utils.read_image(str(path))
    want = (np.repeat(pixels, 3, axis=2) if channels == 1
            else pixels[:, :, :3])
    np.testing.assert_array_equal(got, want)


def test_png_writer_round_trips(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 256, (23, 31, 3)).astype(
        np.uint8)
    path = tmp_path / "w.png"
    image_utils.write_png(str(path), rgb)
    np.testing.assert_array_equal(image_utils.read_image(str(path)), rgb)
    with pytest.raises(ValueError, match="neither JPEG nor PNG"):
        (tmp_path / "x.bin").write_bytes(b"not an image")
        image_utils.read_image(str(tmp_path / "x.bin"))


def test_rescale_and_draw():
    boxes = np.array([[0.1, 0.2, 0.5, 0.9], [0.0, 0.0, 1.2, 1.0]],
                     np.float32)
    for clip in (None, (50, 70)):
        np.testing.assert_array_equal(
            image_utils.rescale_boxes(boxes, (64, 64), (0.8, 0.9), clip),
            jax_image_utils.rescale_boxes(boxes, (64, 64), (0.8, 0.9),
                                          clip))
    image = np.full((60, 80, 3), 10, np.uint8)
    drawn = image_utils.draw_detections(
        image, np.array([[20, 30, 60, 50]]), np.array([0.87]),
        np.array([2]), class_names=["a", "b", "car"])
    changed = np.any(drawn != image, axis=2)
    assert changed[30, 20:61].all() and changed[50, 20:61].all()   # edges
    assert changed[30:51, 20].all() and changed[30:51, 60].all()
    assert not changed[35:46, 25:56].any()                          # inside
    assert changed[21:28, 20:80].any()                              # label
    assert image_utils.text_mask("CAR:0.87").shape == (7, 8 * 6 - 1)
    assert image_utils.draw_detections(
        image, np.array([[20, 30, 60, 50]]), np.array([0.2]),
        np.array([2]), score_threshold=0.5).tobytes() == image.tobytes()
