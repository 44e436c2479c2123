"""`retinanet_torch/tools/serving_host.py` on the CPU at a tiny config: one
JSON line with the host's dispatch and request times and the call counts
of one request, for the tree it was asked to import."""

import json

import pytest

pytest.importorskip("torch")

from retinanet_torch.tools import serving_host  # noqa: E402

_TREE = {
    "experiment": {"name": "serving_host"},
    "input": {"input_shape": [128, 128], "channels": 3},
    "floatx": {"precision": "float32"},
    "architecture": {
        "backbone": {"type": "resnet", "depth": 10},
        "feature_fusion": {"type": "fpn", "filters": 8, "min_level": 3,
                           "max_level": 7, "backbone_max_level": 5},
        "head": {"num_convs": 2, "filters": 8, "num_classes": 3,
                 "num_anchors": 9}},
    "inference": {"pre_nms_top_k": 50, "max_detections": 10,
                  "use_approx_top_k": False},
}


def test_serving_host_reports_times_and_calls(tmp_path, capsys):
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(_TREE))
    assert serving_host.main(["--config", str(config), "--device", "cpu",
                              "--batches", "1", "2", "--requests", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["tree"] == str(serving_host.REPO)
    for bs in (1, 2):
        row = result[f"batch_{bs}"]
        assert 0 < row["dispatch_ms_least"] <= row["dispatch_ms"]
        assert 0 < row["request_ms_least"] <= row["request_ms"]
        assert row["python_calls"] > 0 and row["aten_calls"] > 0


def test_serving_host_refuses_a_tree_it_did_not_import(tmp_path):
    # the package is already imported from this checkout, so another tree
    # cannot take its place in this process
    with pytest.raises(SystemExit, match="run this file by its path"):
        serving_host.main(["--tree", str(tmp_path), "--device", "cpu"])
