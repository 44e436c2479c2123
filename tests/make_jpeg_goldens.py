"""Writes `tests/goldens/jpeg_decode_goldens.npz`: a few JPEGs made by the
JAX package's synthetic scene writer (`retinanet_tpu/data/synthetic.py`,
cv2 at quality 95, 4:2:0), one scene again at the other chroma
subsamplings cv2 writes (4:4:4, 4:2:2, 4:4:0, 4:1:1) and a grayscale one,
each beside its pixels as the JAX package decodes them through libjpeg. The port's nvJPEG route is held to
these pixels on the card (`tests/test_torch_jpeg_cuda.py`,
`chip_smoke.py`), where there is no libjpeg to compare with.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_jpeg_goldens.py
"""

import os

import cv2
import numpy as np

from retinanet_tpu.data.pipeline import decode_jpeg
from retinanet_tpu.data.synthetic import _scene_jpeg

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                   "jpeg_decode_goldens.npz")
# (height, width): the writer's own range starts at 240; odd sizes test the
# partial blocks at the right and bottom edges
SIZES = ((240, 320), (97, 131), (48, 64))


def main() -> None:
    rng = np.random.default_rng(0)
    jpegs = []
    for h, w in SIZES:
        n = int(rng.integers(1, 8))
        x1, y1 = rng.uniform(0, 0.7, n), rng.uniform(0, 0.7, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(0.05, 0.3, n),
                          y1 + rng.uniform(0.05, 0.3, n)], -1).clip(0, 1)
        jpegs.append(_scene_jpeg(rng, h, w, boxes, rng.integers(0, 80, n)))
    scene = decode_jpeg(jpegs[1])
    for factor in ("444", "422", "440", "411"):
        ok, enc = cv2.imencode(".jpg", scene, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")])
        assert ok
        jpegs.append(enc.tobytes())
    gray = np.full((72, 88), 60, np.uint8) + rng.integers(
        0, 30, (72, 88), dtype=np.uint8)
    gray[10:50, 20:70] = 210
    ok, enc = cv2.imencode(".jpg", gray)
    assert ok
    jpegs.append(enc.tobytes())
    arrays = {}
    for i, data in enumerate(jpegs):
        arrays[f"jpeg{i}"] = np.frombuffer(data, np.uint8)
        arrays[f"pixels{i}"] = decode_jpeg(data)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(jpegs)} images, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
