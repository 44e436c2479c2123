"""The port's dataset tools (`retinanet_torch/tools/`: the COCO and
Mapillary parsers, the sharded writer, `create_coco_tfrecords`,
`create_mapillary_tfrecords` and `COCOConverter`) against the JAX
package's, on COCO and Mapillary layouts written here: the shards are
byte-identical to those of the JAX tools run in the same test, the
parsers' filtered and remapped samples are equal, and so are the label
maps and the converter's JSON. The COCO corpus holds corrupt files (bytes
that are no JPEG, JPEGs cut short); the port skips exactly the files that
the JAX tool's `cv2.imdecode` refuses."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

pytest.importorskip("torch")

from retinanet_torch.data import host_codec  # noqa: E402
from retinanet_torch.tools import (  # noqa: E402
    coco_converter, coco_parser, create_coco_tfrecords,
    create_mapillary_tfrecords, mapillary_parser, tfrecord_writer)
from retinanet_tpu.tools import coco_converter as jax_converter  # noqa: E402
from retinanet_tpu.tools import coco_parser as jax_coco_parser  # noqa: E402
from retinanet_tpu.tools import mapillary_parser as jax_mapillary  # noqa: E402
from retinanet_tpu.tools import tfrecord_writer as jax_writer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES = [{"id": 18, "name": "dog"}, {"id": 2, "name": "cat"},
              {"id": 7, "name": "train"}, {"id": 44, "name": "bottle"}]


def _jpeg(rng, h, w):
    image = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return host_codec.encode_jpeg(image)


def _write_coco_split(root, split, rng, first_id, n_images, corrupt):
    """Images of several sizes with valid, invalid and crowd boxes, an
    image whose only box is a crowd one, an image with none, and the
    corrupt files named in `corrupt` ({file name: bytes})."""
    (root / f"{split}2017").mkdir(parents=True)
    images, anns = [], []
    for i in range(n_images):
        image_id = first_id + 7 * i
        h, w = int(rng.integers(24, 80)), int(rng.integers(24, 80))
        name = f"{image_id:012d}.jpg"
        (root / f"{split}2017" / name).write_bytes(_jpeg(rng, h, w))
        images.append({"id": image_id, "height": h, "width": w,
                       "file_name": name})
        for _ in range(int(rng.integers(0, 5))):
            bw, bh = (float(v) for v in rng.uniform(1, 30, 2))
            x, y = float(rng.uniform(0, w - 5)), float(rng.uniform(0, h - 5))
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(rng.choice(
                             [c["id"] for c in CATEGORIES])),
                         "bbox": [x, y, bw, bh],  # may overhang: skipped
                         "iscrowd": int(rng.uniform() < 0.15),
                         "area": bw * bh})
    # an image whose one box is a crowd box, and one with a degenerate box
    for bbox, crowd in (([1.0, 1.0, 5.0, 5.0], 1), ([1.0, 1.0, 0.0, 5.0], 0)):
        anns.append({"id": len(anns) + 1, "image_id": images[0]["id"],
                     "category_id": 2, "bbox": bbox, "iscrowd": crowd})
    for name, data in corrupt.items():
        image_id = first_id + 7 * len(images)
        (root / f"{split}2017" / name).write_bytes(data)
        images.append({"id": image_id, "height": 40, "width": 40,
                       "file_name": name})
        anns.append({"id": len(anns) + 1, "image_id": image_id,
                     "category_id": 7, "bbox": [2.0, 2.0, 10.0, 10.0],
                     "iscrowd": 0})
    # annotations in an order other than the images'
    order = rng.permutation(len(anns))
    anns = [anns[i] for i in order]
    (root / "annotations" / f"instances_{split}2017.json").write_text(
        json.dumps({"images": images, "annotations": anns,
                    "categories": CATEGORIES}))


def _corrupt(rng):
    whole = _jpeg(rng, 40, 40)
    sos = whole.find(b"\xff\xda")
    return {"garbage.jpg": rng.bytes(3000), "empty.jpg": b"",
            "half.jpg": whole[:len(whole) // 2],
            "no_scan.jpg": whole[:sos + 14],
            "no_eoi.jpg": whole[:-2],
            "png.jpg": b"\x89PNG\r\n\x1a\n" + rng.bytes(64)}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    _write_coco_split(root, "train", rng, 1000, 23, _corrupt(rng))
    _write_coco_split(root, "val", rng, 5, 9, {"bad.jpg": rng.bytes(10)})
    return root


def _run_jax_tool(module, args, cwd):
    cwd.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _run_port_tool(main, args, cwd, monkeypatch):
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    return main(args)


def _assert_same_tree(ours, theirs):
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names
    assert names
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name


@pytest.mark.parametrize("remap", [False, True], ids=["ids", "remap"])
def test_coco_shards_byte_identical(coco_root, tmp_path, monkeypatch, remap):
    flags = ["--download_path", str(coco_root), "--num_shards", "3"]
    flags += ["--remap_class_ids"] if remap else []
    _run_jax_tool("retinanet_tpu.tools.create_coco_tfrecords",
                  flags + ["--output_dir", str(tmp_path / "jax" / "out")],
                  tmp_path / "jax")
    counts = _run_port_tool(
        create_coco_tfrecords.main,
        flags + ["--output_dir", str(tmp_path / "port" / "out")],
        tmp_path / "port", monkeypatch)
    _assert_same_tree(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    # the label map and the remapping info, in the working directory
    for name in ("coco_label_map.json", "coco_remapping_info.json"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())
    # the corrupt files are exactly those cv2 refuses
    refused = {split: sum(
        cv2.imdecode(np.frombuffer((coco_root / f"{split}2017" / name)
                                   .read_bytes(), np.uint8),
                     cv2.IMREAD_COLOR) is None
        if (coco_root / f"{split}2017" / name).stat().st_size else True
        for name in os.listdir(coco_root / f"{split}2017"))
        for split in ("train", "val")}
    assert refused == {"train": 6, "val": 1}
    assert {s: c["skipped"] for s, c in counts.items()} == refused


def test_coco_cli_as_a_subprocess(coco_root, tmp_path):
    """`python -m retinanet_torch.tools.create_coco_tfrecords`, val only,
    with absl's boolean spelling."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "retinanet_torch.tools.create_coco_tfrecords",
         "--download_path", str(coco_root), "--output_dir", str(out),
         "--only_val=true", "--noremap_class_ids"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Skipped 1 corrupted samples from val" in proc.stderr
    written = int(proc.stderr.split(" samples written")[0].split()[-1])
    # fewer samples than 32 shards: one a shard
    assert written > 1
    assert sorted(os.listdir(out)) == [f"val-{i:04d}.tfrecord"
                                       for i in range(1, written + 1)]


@pytest.mark.parametrize("remap", [False, True], ids=["ids", "remap"])
def test_coco_parser_equal(coco_root, remap):
    ours = coco_parser.CocoParser(str(coco_root), remap_class_ids=remap)
    theirs = jax_coco_parser.CocoParser(str(coco_root), remap_class_ids=remap)
    for split in ("train", "val"):
        a, b = ours.dataset[split], theirs.dataset[split]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["label"]["boxes"],
                                          y["label"]["boxes"])
            assert x["label"]["classes"] == y["label"]["classes"]
            assert ({k: v for k, v in x.items() if k != "label"}
                    == {k: v for k, v in y.items() if k != "label"})
    assert ours._remapping_info == theirs._remapping_info
    assert ours._class_id_to_class_name == theirs._class_id_to_class_name
    assert ours.classes == theirs.classes


def _write_mapillary(root, rng):
    for d in ("annotations", "splits", "images"):
        (root / d).mkdir(parents=True)
    labels = ["regulatory--stop--g1", "warning--curve-left--g2",
              "information--parking--g1", "other-sign"]
    names = {"train": [f"tr{i:03d}" for i in range(17)],
             "val": [f"va{i:03d}" for i in range(6)]}
    for split, split_names in names.items():
        (root / "splits" / f"{split}.txt").write_text(
            "\n".join(reversed(split_names)) + "\n")
        for i, name in enumerate(split_names):
            h, w = int(rng.integers(30, 90)), int(rng.integers(30, 90))
            objects = []
            for _ in range(int(rng.integers(0, 6))):
                x0, y0 = float(rng.uniform(0, w)), float(rng.uniform(0, h))
                objects.append({
                    "bbox": {"xmin": x0, "ymin": y0,
                             "xmax": min(x0 + float(rng.uniform(-2, 20)), w),
                             "ymax": min(y0 + float(rng.uniform(-2, 20)), h)},
                    "label": str(rng.choice(labels)),
                    "properties": {"ambiguous": bool(rng.uniform() < 0.2)}})
            (root / "annotations" / f"{name}.json").write_text(json.dumps(
                {"height": h, "width": w, "objects": objects}))
            if i != 3:  # one image missing: unreadable, skipped
                (root / "images" / f"{name}.jpg").write_bytes(
                    _jpeg(rng, h, w))


@pytest.fixture(scope="module")
def mapillary_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mapillary")
    _write_mapillary(root, np.random.default_rng(1))
    return root


@pytest.mark.parametrize("flags", [[], ["--skip_ambiguous"],
                                   ["--discard_classes"]],
                         ids=["plain", "skip_ambiguous", "discard_classes"])
def test_mapillary_shards_byte_identical(mapillary_root, tmp_path,
                                         monkeypatch, flags):
    flags = ["--download_path", str(mapillary_root), "--num_shards", "4"
             ] + flags
    _run_jax_tool("retinanet_tpu.tools.create_mapillary_tfrecords",
                  flags + ["--output_dir", str(tmp_path / "jax" / "out")],
                  tmp_path / "jax")
    counts = _run_port_tool(
        create_mapillary_tfrecords.main,
        flags + ["--output_dir", str(tmp_path / "port" / "out")],
        tmp_path / "port", monkeypatch)
    _assert_same_tree(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    name = "mapillary_traffic_sign_label_map.json"
    assert ((tmp_path / "port" / name).read_text()
            == (tmp_path / "jax" / name).read_text())
    assert counts["train"]["skipped"] + counts["val"]["skipped"] >= 1


@pytest.mark.parametrize("kw", [{}, {"skip_ambiguous": True},
                                {"discard_classes": True}],
                         ids=["plain", "skip_ambiguous", "discard_classes"])
def test_mapillary_parser_equal(mapillary_root, kw):
    ours = mapillary_parser.MapillaryParser(str(mapillary_root), **kw)
    theirs = jax_mapillary.MapillaryParser(str(mapillary_root), **kw)
    assert ours.dataset == theirs.dataset
    assert ours.dataset["train"] and ours.dataset["val"]
    assert ours._class_name_to_class_id == theirs._class_name_to_class_id
    assert ours._class_id_to_class_name == theirs._class_id_to_class_name


@pytest.mark.parametrize("resize_max_side,only_val",
                         [(0, False), (50, True)], ids=["full", "resized"])
def test_coco_converter_json_equal(mapillary_root, tmp_path, monkeypatch,
                                   resize_max_side, only_val):
    parser = jax_mapillary.MapillaryParser(str(mapillary_root))
    parsed = tmp_path / "parsed.json"
    parsed.write_text(json.dumps({"dataset": parser.dataset}))
    monkeypatch.chdir(tmp_path)
    parser.dump_label_map()
    label_map = tmp_path / "mapillary_traffic_sign_label_map.json"
    for module, out in ((coco_converter, "port"), (jax_converter, "jax")):
        module.COCOConverter(str(parsed), str(label_map),
                             str(tmp_path / out), resize_max_side,
                             only_val).convert()
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    # and through the port's CLI
    coco_converter.main(["--parsed_dataset_json", str(parsed),
                         "--label_map", str(label_map), "--output_dir",
                         str(tmp_path / "cli"), "--resize_max_side",
                         str(resize_max_side), f"--only_val={only_val}"])
    _assert_same_tree(tmp_path / "cli", tmp_path / "jax")


@pytest.mark.parametrize("n,shards", [(7, 3), (3, 5), (12, 4), (1, 1)],
                         ids=["7in3", "3in5", "12in4", "1in1"])
def test_sharded_writer_byte_identical(tmp_path, n, shards):
    rng = np.random.default_rng(n)
    samples = [(rng.bytes(int(rng.integers(1, 50))),
                rng.random((int(rng.integers(0, 4)), 4)).astype(np.float32),
                rng.integers(0, 80, 3), int(rng.integers(0, 1000)))
               for _ in range(n)]
    for module, out in ((tfrecord_writer, "port"), (jax_writer, "jax")):
        writer = module.TFrecordWriter(n_samples=n, n_shards=shards,
                                       output_dir=str(tmp_path / out),
                                       prefix="val")
        for image, boxes, classes, image_id in samples:
            writer.push(image, boxes[:, :], classes[:len(boxes)], image_id)
        writer.flush_last()
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
