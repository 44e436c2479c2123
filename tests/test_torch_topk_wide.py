"""Top-k past 8,192 winners (`pre_nms_top_k` / `nms_top_k` past 8,192), on
the CPU: the port's rows against `jax.lax.top_k` and
`approx_max_k_packed` at k = 8,193, 10,000 and k = N; the kernels' sort of
more winners than shared memory holds (`csrc/topk.cu:
bitonic_sort_desc_wide`) walked in numpy from the wrapper's constants; the
row and slab designs walked at k past 8,192; and the post-processing of
both packages at 256 x 256 (A = 12,276 anchors) with pre_nms_top_k =
nms_top_k = 10,000 in the four NMS modes and the skip_nms lane.

Selections are compared exactly (indices and value bits); detections as in
tests/test_torch_topk.py (valid counts and classes exactly, boxes and
scores to 1e-6)."""

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.ops import postprocess as jax_pp  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import anchors as torch_anchors  # noqa: E402
from retinanet_torch.data.preprocessing import \
    make_device_normalizer as torch_normalizer  # noqa: E402
from retinanet_torch.ops import postprocess as torch_pp  # noqa: E402
from retinanet_torch.ops import topk  # noqa: E402
from retinanet_torch.ops import topk_kernel as tk  # noqa: E402
from retinanet_torch.tools.kernel_variants import \
    variant_source  # noqa: E402
from retinanet_torch.tools.topk_experiments import \
    WIDE_VARIANTS  # noqa: E402

from test_torch_postprocess import _JaxStub, _TorchStub  # noqa: E402
from test_torch_topk import (  # noqa: E402
    _assert_covered, _bf16, _bits, _block_sort_desc, _logits,
    _reduction_size, _walk_equals_plain)
from test_torch_topk_slab import _plain, slab_walk  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

N_256 = 12276          # anchors at 256 x 256, levels 3 to 7, 9 a cell


@pytest.mark.parametrize("k", [8193, 10000, N_256], ids=str)
def test_packed_rows_equal_approx_max_k_packed(k):
    rng = np.random.default_rng(k)
    x = _logits(rng, (1, 2, N_256), "quarter")
    t, j = _bf16(x)
    jv, ji = jax.jit(lambda s: jax_pp.approx_max_k_packed(s, k))(j)
    tv, ti = topk.select_top_k(t.transpose(1, 2).contiguous(), k, "packed",
                               dim=1)
    _assert_covered(t.float().numpy().reshape(-1, N_256),
                    ti.numpy().reshape(-1, k),
                    _reduction_size((1, 2, N_256), k))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))


@pytest.mark.parametrize("kind", ["normal", "quarter", "zeros"])
@pytest.mark.parametrize("k", [8193, 10000, N_256], ids=str)
def test_f32_rows_equal_lax_top_k(k, kind):
    rng = np.random.default_rng(k + 1)
    x = _logits(rng, (1, 2, N_256), "quarter" if kind != "normal"
                else "normal")
    if kind == "zeros":    # signed zeros: lax.top_k orders -0.0 below 0.0
        x[..., ::3] = 0.0
        x[..., 1::3] = -0.0
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = topk.select_top_k(torch.from_numpy(x), k, "f32")
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))


def test_rows_of_one_value_at_16384():
    """Every key ties: the unique key (value, then the lower index) gives
    the first 16,384 indices in order."""
    x = torch.zeros((1, 20000, 2), dtype=torch.bfloat16)
    for mode in ("packed", "bf16"):
        values, idx = topk.select_top_k(x, 16384, mode, dim=1)
        assert np.array_equal(idx.numpy(),
                              np.broadcast_to(np.arange(16384),
                                              (1, 2, 16384)))
        assert not values.float().any()


# -- the wide sort, walked --------------------------------------------------


def _wide_sort_desc(keys):
    """csrc/topk.cu:bitonic_sort_desc_wide: the keys padded with 0 to the
    next power of two p, the passes of stride under SORT_BLOCK a block of
    SORT_BLOCK keys at a time (`wide_sort_blocks`: sizes 2 .. SORT_BLOCK
    first, then each size's short strides), the others over all p keys."""
    block = tk.SORT_BLOCK
    p = tk.sort_width(len(keys))
    assert p > tk.SORT_ON_CHIP_MAX and p % block == 0
    v = np.zeros(p, np.uint64)
    v[:len(keys)] = keys

    def exchange(v, base, size, stride):
        t = np.arange(len(v) // 2)
        lo = 2 * t - (t & (stride - 1))
        hi = lo + stride
        swap = (v[lo] < v[hi]) == (((base + lo) & size) == 0)
        v[lo], v[hi] = (np.where(swap, v[hi], v[lo]),
                        np.where(swap, v[lo], v[hi]))

    def blocks(first, last):
        for base in range(0, p, block):
            sk = v[base:base + block].copy()
            size = first
            while size <= last:
                stride = min(size, block) // 2
                while stride:
                    exchange(sk, base, size, stride)
                    stride //= 2
                size *= 2
            v[base:base + block] = sk

    blocks(2, block)
    size = 2 * block
    while size <= p:
        stride = size // 2
        while stride >= block:
            exchange(v, 0, size, stride)
            stride //= 2
        blocks(size, size)
        size *= 2
    return v[:len(keys)]


@pytest.mark.parametrize("k", [16385, 20000, 76725], ids=str)
def test_wide_sort_walk_sorts(k):
    """Unique keys (value << 32 | ~index, as the kernels write them) in
    any order come out descending, as the on-chip network sorts them."""
    rng = np.random.default_rng(k)
    value = rng.integers(0, 1 << 12, k).astype(np.uint64)
    keys = (value << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                       - np.arange(k, dtype=np.uint64))
    keys = keys[rng.permutation(k)]
    got = _wide_sort_desc(keys)
    assert np.array_equal(got, np.sort(keys)[::-1])
    if k <= 20000:
        assert np.array_equal(got, _block_sort_desc(keys))


def test_sort_constants_are_the_kernels():
    source = tk.kernel.source.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kSortOnChipMax") == tk.SORT_ON_CHIP_MAX
    assert constant("kSortBlock") == tk.SORT_BLOCK
    assert "kMaxK" not in source
    # the on-chip sort's keys and a wide sort's block fit a CTA; a wide
    # sort's width (past SORT_ON_CHIP_MAX, a power of two) holds whole
    # blocks
    assert tk.SORT_ON_CHIP_MAX * 8 <= 227 * 1024
    assert tk.SORT_BLOCK * 8 <= 227 * 1024
    assert tk.SORT_BLOCK <= tk.sort_width(tk.SORT_ON_CHIP_MAX + 1)


@pytest.mark.parametrize("k,want", [(1, 1), (100, 128), (8192, 8192),
                                    (8193, 16384), (76725, 131072)], ids=str)
def test_sort_width(k, want):
    assert tk.sort_width(k) == want


@pytest.mark.parametrize("mode,k", [("packed", 8193), ("f32", 10000)],
                         ids=["packed-8193", "f32-10000"])
def test_row_walk_past_8192(mode, k):
    rng = np.random.default_rng(k + 2)
    x = _logits(rng, (1, N_256, 1), "quarter")
    t = torch.from_numpy(x)
    _walk_equals_plain(t if mode == "f32" else t.to(torch.bfloat16), k,
                       mode)


@pytest.mark.parametrize("mode,k", [("packed", 10000), ("f32", N_256)],
                         ids=["packed-10000", "f32-N"])
def test_slab_walk_past_8192(mode, k):
    rng = np.random.default_rng(k + 3)
    x = _logits(rng, (2, N_256, 2), "quarter")
    t = torch.from_numpy(x)
    t = t if mode == "f32" else t.to(torch.bfloat16)
    keys, idx, _ = slab_walk(t, k, mode, grid=3)
    want_keys, want_idx = _plain(t, k, mode)
    assert np.array_equal(idx, want_idx)
    assert np.array_equal(keys, want_keys)


def test_the_kernel_refuses_no_k():
    """k = N = 76,725 is refused for the tensor's device alone, not for k
    (the card's cap of 8,192 is gone)."""
    x = torch.zeros((1, 76725, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.launch(x, 76725, "packed")
    assert tk.topk_design(1, 76725, 2, 76725) == "slab"
    plan = tk.slab_plan(8, 76725, 80, 76725, "packed")
    assert plan.capacity == 76725


# -- the post-processing of both packages -----------------------------------


_WIDE_K = 10000
_LEVELS = {"3": 32, "4": 16, "5": 8, "6": 4, "7": 2}
_CLASSES = 2


def _wide_tree(mode):
    return {
        "experiment": {"name": "torch_port_topk_wide"},
        "input": {"input_shape": [256, 256], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 7, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16,
                     "num_classes": _CLASSES, "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0, 65536.0,
                                    262144.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "inference": {"batch_size": 2, "pre_nms_top_k": _WIDE_K,
                      "nms_top_k": _WIDE_K, "max_detections": 20,
                      "mode": mode,
                      "filter_per_class": not mode.startswith("Global")},
    }


def _wide_outputs():
    """Logits around -3 (a few hundred sigmoid scores a class clear 0.05),
    rounded to quarters in level 4, small box regressions."""
    rng = np.random.default_rng(29)
    preds = {"class-predictions": {}, "box-predictions": {}}
    for level, s in _LEVELS.items():
        cls = rng.normal(-3.0, 1.0, (2, s, s, 9 * _CLASSES)).astype(
            np.float32)
        if level == "4":
            cls = np.round(cls * 4) / 4
        preds["class-predictions"][level] = cls
        preds["box-predictions"][level] = rng.normal(
            0.0, 0.1, (2, s, s, 36)).astype(np.float32)
    return preds


def _both(mode, skip_nms=False):
    tree = _wide_tree(mode)
    preds = _wide_outputs()
    images = np.zeros((2, 256, 256, 3), np.float32)
    jparams = jax_cfg.from_dict(tree)
    janchors = jax_anchors.from_params(jparams)
    assert janchors.boxes.shape[0] == N_256
    want = jax.jit(jax_pp.make_inference_fn(
        _JaxStub(preds), jparams, janchors, jax_normalizer(jparams),
        compute_dtype=jnp.float32, skip_nms=skip_nms))({}, {}, images)
    tparams = torch_cfg.from_dict(tree)
    got = torch_pp.make_inference_fn(
        _TorchStub(preds), tparams, torch_anchors.from_params(tparams),
        torch_normalizer(tparams), compute_dtype=torch.float32,
        skip_nms=skip_nms, device="cpu")(torch.from_numpy(images))
    return got, want


@pytest.mark.parametrize("mode", ["PerClassHardNMS", "PerClassSoftNMS",
                                  "GlobalHardNMS", "GlobalSoftNMS"])
def test_postprocess_at_10000_matches_jax(mode):
    got, want = _both(mode)
    assert int(np.asarray(want["valid_detections"]).sum()) >= 10
    for key in ("valid_detections", "classes"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_skip_nms_lane_at_10000_matches_jax():
    """The export lane selects pre_nms_top_k = 10,000 a class (float32,
    `lax.top_k`)."""
    got, want = _both("PerClassHardNMS", skip_nms=True)
    assert sorted(got) == sorted(want)
    assert got["scores"].shape == (2, _WIDE_K, _CLASSES)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", sorted(WIDE_VARIANTS))
def test_wide_variants_apply_to_the_source(name):
    """Each wide-sort variant of `tools/topk_experiments.py --design wide`
    is one edit of csrc/topk.cu: it must find its text, once."""
    assert (variant_source(tk.kernel, name, WIDE_VARIANTS[name])
            != tk.kernel.source.read_text())
