"""Host-side image utilities: reading, the serving preprocessing mirror,
drawing, PNG output and a batched folder reader (counterpart of
`retinanet_tpu/utils/image_utils.py`), with no cv2 or PIL.

JPEG goes through `data/host_codec.decode_jpeg` (libjpeg or nvJPEG) and
resizing through its native bilinear resampler; PNG (8-bit gray, RGB or
RGBA, not interlaced) is read and written with `zlib`. Boxes and labels are
drawn in numpy with a built-in 5 x 7 bitmap font (digits, letters, ':',
'.', '-', '_' and space; letters drawn in upper case).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from retinanet_torch.data import host_codec

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# -- reading and writing ----------------------------------------------------

def _unfilter_png(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = data[y, 0], data[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prev) & 0xFF
        elif kind in (1, 3, 4):  # depend on the left neighbour: in order
            row = np.zeros(stride, np.int32)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} is not valid")
        out[y] = row
        prev = row
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit, non-interlaced gray, RGB or RGBA
    PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB or "
                         f"RGBA PNGs are read (depth {depth}, color type "
                         f"{color}, interlace {interlace})")
    pixels = _unfilter_png(zlib.decompress(b"".join(idat)), h, w, channels)
    if channels == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a PNG (filter 0, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_PNG_SIGNATURE):
        return read_png(path)
    if head.startswith(b"\xff\xd8"):
        with open(path, "rb") as f:
            return host_codec.decode_jpeg(f.read())
    raise ValueError(f"{path}: neither JPEG nor PNG")


# -- preprocessing ------------------------------------------------------------

def prepare_image(image: np.ndarray, input_shape: Sequence[int],
                  mean=(127.0, 127.0, 127.0)
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-preserving bilinear resize into the top-left of a canvas of
    `input_shape` padded with `mean`, in the raw pixel domain (the serving
    function normalizes on the card). Returns ((1, H, W, 3) float32,
    resize_scale (2,))."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(np.round(image), 0, 255).astype(np.uint8)
    th, tw = int(input_shape[0]), int(input_shape[1])
    h, w = image.shape[:2]
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = host_codec.resample_bilinear(
        image, (th, tw), (nh, nw), (nh / h, nw / w), (0.0, 0.0), False,
        np.asarray(mean, np.float32))
    return (out.astype(np.float32)[None],
            np.array([nh / h, nw / w], np.float32))


def rescale_boxes(boxes_norm: np.ndarray, input_shape, resize_scale,
                  clip_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Normalized corners -> original-image pixel corners."""
    h, w = float(input_shape[0]), float(input_shape[1])
    sy, sx = float(resize_scale[0]), float(resize_scale[1])
    boxes = np.asarray(boxes_norm, np.float64) * np.array(
        [w, h, w, h]) / np.array([sx, sy, sx, sy])
    if clip_hw is not None:
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, clip_hw[1])
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, clip_hw[0])
    return boxes


# -- drawing ------------------------------------------------------------------

# 5 x 7 glyphs, one 5-bit row each (the high bit is the leftmost pixel)
_GLYPHS = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "A": (0x0E, 0x11, 0x11, 0x11, 0x1F, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1C, 0x12, 0x11, 0x11, 0x11, 0x12, 0x1C),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x11, 0x19, 0x15, 0x13, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x15, 0x0A),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x11, 0x0A, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
    ":": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "_": (0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x1F),
    " ": (0x00,) * 7,
}
GLYPH_H, GLYPH_W = 7, 5


def text_mask(text: str) -> np.ndarray:
    """(7, 6 * len - 1) bool pixels of `text`; a character the font lacks
    is drawn as a blank."""
    cols = []
    for i, ch in enumerate(text.upper()):
        rows = _GLYPHS.get(ch, _GLYPHS[" "])
        glyph = np.array([[(r >> (GLYPH_W - 1 - x)) & 1
                           for x in range(GLYPH_W)] for r in rows], bool)
        if i:
            cols.append(np.zeros((GLYPH_H, 1), bool))
        cols.append(glyph)
    if not cols:
        return np.zeros((GLYPH_H, 0), bool)
    return np.concatenate(cols, axis=1)


def _draw_text(canvas: np.ndarray, text: str, x: int, y: int,
               color) -> None:
    mask = text_mask(text)
    h, w = canvas.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + mask.shape[0], h), min(x + mask.shape[1], w)
    if y1 <= y0 or x1 <= x0:
        return
    region = canvas[y0:y1, x0:x1]
    region[mask[y0 - y:y1 - y, x0 - x:x1 - x]] = color


def _draw_rect(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               color, thickness: int = 2) -> None:
    h, w = canvas.shape[:2]
    x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
    y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
    t = thickness
    canvas[y1:min(y1 + t, y2 + 1), x1:x2 + 1] = color
    canvas[max(y2 - t + 1, y1):y2 + 1, x1:x2 + 1] = color
    canvas[y1:y2 + 1, x1:min(x1 + t, x2 + 1)] = color
    canvas[y1:y2 + 1, max(x2 - t + 1, x1):x2 + 1] = color


def draw_detections(image: np.ndarray,
                    boxes: np.ndarray,
                    scores: np.ndarray,
                    classes: np.ndarray,
                    class_names: Optional[Sequence[str]] = None,
                    score_threshold: float = 0.0) -> np.ndarray:
    """A copy of the RGB `image` with each detection's box (pixel corners)
    and a `label:score` line above it, in a colour of its class."""
    out = np.array(np.asarray(image, np.uint8)[:, :, :3])
    rng = np.random.default_rng(7)
    colors = rng.integers(64, 255, (max(int(np.max(classes, initial=0)) + 1,
                                        1), 3)).astype(np.uint8)
    for box, score, cid in zip(boxes, scores, classes):
        if score < score_threshold or cid < 0:
            continue
        x1, y1, x2, y2 = (int(v) for v in box)
        color = colors[int(cid)]
        _draw_rect(out, x1, y1, x2, y2, color)
        label = class_names[int(cid)] if class_names else str(int(cid))
        _draw_text(out, f"{label}:{score:.2f}", x1,
                   max(y1 - GLYPH_H - 2, 0), color)
    return out


class ImageGenerator:
    """Batched folder reader for calibration and bulk inference: the
    images of `image_dir` in name order, `prepare_image`d, in batches of
    `batch_size` (the last may be smaller)."""

    _EXTS = (".jpg", ".jpeg", ".png")

    def __init__(self, image_dir: str, input_shape, batch_size: int = 8,
                 mean=(127.0, 127.0, 127.0), limit: Optional[int] = None):
        self.paths: List[str] = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if f.lower().endswith(self._EXTS))
        if limit:
            self.paths = self.paths[:limit]
        self.input_shape = input_shape
        self.batch_size = batch_size
        self.mean = mean

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        batch = []
        for path in self.paths:
            img, _ = prepare_image(read_image(path), self.input_shape,
                                   self.mean)
            batch.append(img[0])
            if len(batch) == self.batch_size:
                yield np.stack(batch)
                batch = []
        if batch:
            yield np.stack(batch)
