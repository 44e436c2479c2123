"""Every module of `retinanet_torch`, and `chip_smoke.py`, imports without
pulling in JAX, the JAX package, or a library that the machine with the
card lacks."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "retinanet_tpu", "absl", "cv2", "PIL", "orbax",
             "flax", "tensorflow", "msgpack", "etils", "requests",
             "tensorboard", "optax")

_SCRIPT = """
import importlib, json, pkgutil, sys
import retinanet_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    retinanet_torch.__path__, "retinanet_torch."))
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
print(json.dumps({"imported": names,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_no_jax_and_no_missing_library_is_imported():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "retinanet_torch.train.executor" in result["imported"]
    assert "retinanet_torch.__main__" in result["imported"]
    # the export and int8 serving layer, and the port's examples
    for name in ("export.msgpack_codec", "export.serving",
                 "export.calibration", "export.quantize", "export.__main__",
                 "export.evaluate_artifact", "utils.image_utils",
                 "ops.int8_conv", "ops.int8_conv_kernel",
                 "examples.inference_demo",
                 "examples.multi_device_inference"):
        assert f"retinanet_torch.{name}" in result["imported"], name
    assert len(result["imported"]) >= 40
    leaked = sorted(set(FORBIDDEN) & set(result["modules"]))
    assert not leaked, leaked
