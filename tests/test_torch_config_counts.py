"""Every config under `configs/` builds in the port, with the parameter and
BN-statistic counts of the JAX package.

The port counts on `device="meta"` (nothing allocated); JAX counts with
`jax.eval_shape` (nothing computed), once per architecture and process:
configs that differ only in knobs without weights (the activation, the
balanced features) share a count. The backbones alone are also held to
`tests/test_backbones.py`'s reference counts, taken from the reference
implementation.
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.models import efficientnet as torch_eff  # noqa: E402
from retinanet_torch.models import mobiledet as torch_md  # noqa: E402
from retinanet_torch.models import retinanet as torch_retinanet  # noqa: E402

from test_backbones import (  # noqa: E402
    EFFICIENTNET_COUNTS, MOBILEDET_COUNTS)
from test_torch_model import _jax_counts, _torch_counts  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
CONFIG_PATHS = sorted(glob.glob(os.path.join(CONFIGS, "*", "*.json")))
_JAX_COUNTS = {}


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_every_config_is_counted():
    assert len(CONFIG_PATHS) == 15
    kinds = {_load(p)["architecture"]["backbone"]["type"]
             for p in CONFIG_PATHS}
    assert kinds == {"resnet", "efficientnet-b2", "efficientnet-b3",
                     "efficientnet-lite2", "efficientnet-lite3",
                     "mobiledet_cpu", "mobiledet_edge_tpu", "mobiledet_gpu"}


@pytest.mark.parametrize(
    "path", CONFIG_PATHS,
    ids=[os.path.relpath(p, CONFIGS) for p in CONFIG_PATHS])
def test_config_counts_match_jax(path):
    tree = _load(path)
    arch = json.loads(json.dumps(tree["architecture"]))
    arch.pop("activation", None)
    arch["feature_fusion"].pop("use_balanced_features", None)
    key = json.dumps(arch, sort_keys=True)
    if key not in _JAX_COUNTS:
        _JAX_COUNTS[key] = _jax_counts(tree)
    assert _torch_counts(tree) == _JAX_COUNTS[key], path


def _counts(model):
    return (sum(p.numel() for p in model.parameters()),
            sum(b.numel() for b in model.buffers()))


@pytest.mark.parametrize("name", sorted(EFFICIENTNET_COUNTS))
def test_efficientnet_backbone_counts_equal_the_reference(name):
    model = torch_eff.EfficientNet.from_name(name, device="meta")
    assert _counts(model) == EFFICIENTNET_COUNTS[name]


@pytest.mark.parametrize("name", sorted(MOBILEDET_COUNTS))
def test_mobiledet_backbone_counts_equal_the_reference(name):
    assert _counts(torch_md.MobileDet(name, device="meta")) == \
        MOBILEDET_COUNTS[name]


@pytest.mark.parametrize("kind", ["efficientnet-b2", "mobiledet_gpu"])
def test_remat_is_refused_outside_resnet(kind):
    tree = _load(CONFIG_PATHS[0])
    tree["architecture"]["backbone"] = {"type": kind, "remat": True}
    with pytest.raises(ValueError, match="remat"):
        torch_retinanet.build_model(torch_cfg.from_dict(tree), device="meta")
