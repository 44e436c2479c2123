"""The port's selection lanes (`retinanet_torch/ops/topk.py`, the plain
version of `csrc/topk.cu`) against the JAX package on the CPU.

Off the TPU XLA computes `approx_max_k` exactly: a top-L by value, with L
>= k from the recall target (`_reduction_size`), then
`approx_max_k_packed`'s sort of the packed key over those L. The port takes
the exact top-k of the packed key over the whole row. The two agree
whenever the top-L holds every element the port selects, which fails only
when values tie across the L-th place; each comparison asserts that
precondition (`_assert_covered`) and then compares bit for bit, indices and
values. Inputs are bf16 normal logits around the class prior -log(99),
where most logits are negative (drop 1 moves them away from zero) and
neighbouring values tie, and quarter-step logits, which tie heavily.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.models.retinanet import \
    build_model as jax_build_model  # noqa: E402
from retinanet_tpu.ops import postprocess as jax_pp  # noqa: E402
from retinanet_torch.convert import load_flax_variables  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.data import anchors as torch_anchors  # noqa: E402
from retinanet_torch.data.preprocessing import \
    make_device_normalizer as torch_normalizer  # noqa: E402
from retinanet_torch.export.serving import build_serving_fn  # noqa: E402
from retinanet_torch.models.retinanet import build_model  # noqa: E402
from retinanet_torch.ops import postprocess as torch_pp  # noqa: E402
from retinanet_torch.ops import topk  # noqa: E402

from test_torch_postprocess import _JaxStub, _TorchStub  # noqa: E402
from test_torch_serving import _variables  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


PRIOR = -float(np.log(99.0))


def _bf16(a):
    """float32 numpy -> (bf16 torch tensor, bf16 jax array), both rounded
    to nearest even from the same float32 values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(jax.lax.bitcast_convert_type(
                              j, jnp.int16))), "bf16 rounding differs"
    return t, j


def _logits(rng, shape, kind):
    x = rng.normal(PRIOR, 1.5, shape)
    if kind == "quarter":
        x = np.round(x * 4) / 4
    return x.astype(np.float32)


def _bits(x):
    """bf16 / float32 values of either package as int bits (numpy)."""
    if isinstance(x, torch.Tensor):
        view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.contiguous().view(view).numpy()
    view = jnp.int16 if x.dtype == jnp.bfloat16 else jnp.int32
    return np.asarray(jax.lax.bitcast_convert_type(x, view))


def _reduction_size(shape, k, recall_target=0.95):
    """L: how many of a row XLA's approx_max_k keeps before its final
    sort, for rows of this shape."""
    out = jax.eval_shape(
        lambda x: jax.lax.approx_max_k(x, k, recall_target=recall_target,
                                       aggregate_to_topk=False),
        jax.ShapeDtypeStruct(shape, jnp.bfloat16))
    return out[0].shape[-1]


def _assert_covered(rows, idx, size):
    """Every selected element lies strictly above the size-th largest value
    of its row, so that XLA's top-`size` holds it whatever its tie order.
    rows (R, N) float32, idx (R, k)."""
    if size >= rows.shape[-1]:
        return
    for row, sel in zip(rows, idx):
        boundary = np.sort(row)[::-1][size - 1]
        assert row[sel].min() > boundary, "precondition: ties across L"


# ------------------------------------------------------------------- keys


def test_orderable_u16_matches_jax_over_every_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    jb = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    finite = np.isfinite(np.asarray(jb, np.float32))
    tb = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    want = np.asarray(jax_pp._orderable_u16(jb)).astype(np.int64)
    got = topk.orderable_u16(tb).numpy()
    assert np.array_equal(got[finite], want[finite])
    # every code maps back to JAX's bf16
    codes = np.arange(65536)
    back = topk.unorderable_u16(torch.from_numpy(codes.astype(np.int32)))
    jback = jax_pp._unorderable_u16(jnp.asarray(codes.astype(np.uint16)))
    assert np.array_equal(_bits(back), _bits(jback))
    assert np.array_equal(
        topk.unorderable_u16(topk.orderable_u16(tb)).view(torch.int16)
        .numpy(), bits.view(np.int16))


def test_orderable_u32_is_the_total_order():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 10, 4000).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf,
                                  1e-45, -1e-45], np.float32)])
    t = torch.from_numpy(x)
    code = topk.orderable_u32(t).numpy()
    order = np.lexsort((np.signbit(x) == 0, x))   # value, then -0 < +0
    assert np.all(np.diff(code[order]) > 0)
    assert torch.equal(topk.unorderable_u32(topk.orderable_u32(t))
                       .view(torch.int32), t.view(torch.int32))


@pytest.mark.parametrize("n,want", [(1, (1, 0)), (774, (10, 0)),
                                    (3069, (12, 0)), (65536, (16, 0)),
                                    (65537, (17, 1)), (76725, (17, 1)),
                                    (131072, (17, 1))])
def test_packed_layout(n, want):
    assert topk.packed_layout(n) == want


def test_packed_layout_refuses_long_rows():
    with pytest.raises(ValueError):
        topk.packed_layout(131073)
    assert topk.lane_mode(torch.bfloat16, 131073, True) == "bf16"
    assert topk.lane_mode(torch.bfloat16, 131072, True) == "packed"
    assert topk.lane_mode(torch.bfloat16, 100, False) == "bf16"
    assert topk.lane_mode(torch.float32, 100, True) == "f32"


@pytest.mark.parametrize("value", [0.0, -0.1, 1.5, float("nan")])
def test_recall_target_is_checked(value):
    with pytest.raises(ValueError):
        topk.check_recall_target(value)


# ------------------------------------------------------- the three modes


@pytest.mark.parametrize("n,k,kind", [
    (774, 100, "normal"), (774, 256, "quarter"), (3069, 256, "normal"),
    (3069, 1000, "quarter"), (76725, 256, "normal"),
    (76725, 256, "quarter"), (76725, 1000, "normal")])
def test_packed_mode_equals_approx_max_k_packed(n, k, kind):
    rng = np.random.default_rng(n + k)
    x = _logits(rng, (2, 3, n), kind)
    t, j = _bf16(x)
    jv, ji = jax.jit(lambda s: jax_pp.approx_max_k_packed(s, k))(j)
    # the port reads the (B, N, C) layout in place, along N
    tv, ti = topk.select_top_k(t.transpose(1, 2).contiguous(), k, "packed",
                               dim=1)
    _assert_covered(t.float().numpy().reshape(-1, n),
                    ti.numpy().reshape(-1, k),
                    _reduction_size((2, 3, n), k))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))
    drop = topk.packed_layout(n)[1]
    if drop:   # the key kept a value other than the logit
        assert not np.array_equal(_bits(tv), _bits(t.gather(2, ti.long())))


def test_bf16_mode_equals_jax_fallback_above_2_17():
    n, k = 140_000, 256
    rng = np.random.default_rng(3)
    t, j = _bf16(_logits(rng, (1, 2, n), "normal"))
    jv, ji = jax.jit(lambda s: jax_pp.approx_max_k_packed(s, k))(j)
    tv, ti = topk.select_top_k(t, k, "bf16")
    assert np.array_equal(_bits(tv), _bits(jv))
    tv, ti = tv.float().numpy()[0], ti.numpy()[0]
    ji = np.asarray(ji)[0]
    for r in range(2):
        above = tv[r] > tv[r, -1]
        assert above.sum() > 0
        assert set(ti[r][above]) == set(ji[r][above])
        # the port's ties go to the lower index
        for v in np.unique(tv[r]):
            assert np.all(np.diff(ti[r][tv[r] == v]) > 0)


@pytest.mark.parametrize("kind", ["normal", "quarter", "zeros"])
def test_f32_mode_equals_lax_top_k(kind):
    rng = np.random.default_rng(5)
    x = _logits(rng, (3, 5, 1000), kind if kind != "zeros" else "quarter")
    if kind == "zeros":   # signed zeros: lax.top_k orders -0.0 below 0.0
        x[..., ::3] = 0.0
        x[..., 1::3] = -0.0
    jv, ji = jax.lax.top_k(jnp.asarray(x), 50)
    tv, ti = topk.select_top_k(torch.from_numpy(x), 50, "f32")
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))
    values, idx = torch_pp.top_k(torch.from_numpy(x), 50)
    assert idx.dtype == torch.int64
    assert np.array_equal(idx.numpy(), np.asarray(ji))


def test_f32_mode_at_pre_nms_top_k():
    """The skip_nms lane's k = 5000."""
    rng = np.random.default_rng(6)
    x = _logits(rng, (1, 2, 9000), "quarter")
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5000)
    tv, ti = topk.select_top_k(torch.from_numpy(x), 5000, "f32")
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))


def test_select_top_k_refuses():
    x = torch.zeros((2, 10, 3), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        topk.select_top_k(x, 4, "f32", dim=1)
    with pytest.raises(ValueError):
        topk.select_top_k(x, 11, "packed", dim=1)
    with pytest.raises(ValueError):
        topk.select_top_k(x, 4, "exact", dim=1)
    with pytest.raises(ValueError):
        topk.select_top_k(x, 2, "packed", dim=0)


# ----------------------------------------- the kernel's algorithm, walked


def _kernel_walk(keys, k, key_bits, threads=64):
    """A numpy walk of csrc/topk.cu over one row of value keys: radix
    select 8 bits a pass from the top, the ordered compaction in chunks of
    `threads`, then the descending sort of the 64-bit keys."""
    prefix, mask, need = 0, 0, k
    for shift in range(key_bits - 8, -1, -8):
        take = (keys & mask) == prefix
        hist = np.bincount((keys[take] >> shift) & 255, minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= need:
                need -= above
                break
            above += hist[digit]
        prefix |= digit << shift
        mask |= 255 << shift
    kth, above_count = prefix, k - need
    out = np.zeros(k, np.uint64)
    gt_base = eq_base = 0
    for i0 in range(0, len(keys), threads):
        chunk = keys[i0:i0 + threads]
        i = np.arange(i0, i0 + len(chunk))
        packed = (chunk.astype(np.uint64) << np.uint64(32)) | (
            np.uint64(0xFFFFFFFF) - i.astype(np.uint64))
        gt, eq = chunk > kth, chunk == kth
        slots = gt_base + np.cumsum(gt) - 1
        out[slots[gt]] = packed[gt]
        eslots = eq_base + np.cumsum(eq) - 1
        keep = eq & (eslots < need)
        out[above_count + eslots[keep]] = packed[keep]
        gt_base += gt.sum()
        eq_base += eq.sum()
        if gt_base == above_count and eq_base >= need:
            break
    out = np.sort(out)[::-1]
    return (out >> np.uint64(32)).astype(np.int64), (
        np.uint64(0xFFFFFFFF) - (out & np.uint64(0xFFFFFFFF))).astype(
            np.int64)


@pytest.mark.parametrize("mode,n,k,kind", [
    ("packed", 76725, 256, "normal"), ("packed", 3069, 1000, "quarter"),
    ("bf16", 5000, 300, "quarter"), ("f32", 4000, 100, "normal"),
    ("f32", 9000, 5000, "quarter"), ("packed", 500, 1, "zeros"),
    ("bf16", 700, 700, "zeros")])
def test_kernel_walk_equals_plain(mode, n, k, kind):
    rng = np.random.default_rng(n + k)
    x = _logits(rng, (2, n, 1), kind if kind != "zeros" else "normal")
    if kind == "zeros":
        x[:] = 0.0
    t = torch.from_numpy(x)
    if mode != "f32":
        t = t.to(torch.bfloat16)
    values, idx = topk.top_k_rows_plain(t, k, mode)
    keys = topk.value_key(t[..., 0], mode, n).numpy()
    for r in range(2):
        wk, wi = _kernel_walk(keys[r], k, 32 if mode == "f32" else 16)
        assert np.array_equal(wi, idx[r, 0].numpy())
        assert np.array_equal(
            _bits(topk.key_value(torch.from_numpy(wk), mode, n)),
            _bits(values[r, 0]))


# ----------------------------------------------------- filter_top_k lanes


def _filter_inputs(rng, n=774, c=3, kind="normal"):
    logits = _logits(rng, (2, n, c), kind)
    boxes = rng.normal(0, 1, (2, n, 4)).astype(np.float32)
    anchors = rng.uniform(0, 64, (n, 4)).astype(np.float32)
    return logits, boxes, anchors


@pytest.mark.parametrize("per_class", [True, False],
                         ids=["per_class", "global"])
@pytest.mark.parametrize("with_anchors", [False, True],
                         ids=["decode_before", "decode_after"])
@pytest.mark.parametrize("kind", ["normal", "quarter"])
def test_filter_top_k_matches_jax_approx(per_class, with_anchors, kind):
    rng = np.random.default_rng(11)
    logits, boxes, anchors = _filter_inputs(rng, kind=kind)
    t, j = _bf16(logits)
    k = 64
    want = jax_pp.filter_top_k(
        {"scores": j, "boxes": jnp.asarray(boxes)}, k, per_class,
        approx=True, anchor_boxes=jnp.asarray(anchors) if with_anchors
        else None)
    got = torch_pp.filter_top_k(
        {"scores": t, "boxes": torch.from_numpy(boxes)}, k, per_class,
        approx=True, anchor_boxes=torch.from_numpy(anchors) if with_anchors
        else None)
    rows = (t.float().numpy().transpose(0, 2, 1).reshape(-1, 774)
            if per_class else t.float().numpy().reshape(2, -1))
    n = rows.shape[-1]
    sel = (topk.top_k_rows_plain(t, k, "packed")[1] if per_class else
           topk.select_top_k(t.reshape(2, -1), k,
                             topk.lane_mode(t.dtype, n, True))[1])
    _assert_covered(rows, sel.numpy().reshape(rows.shape[0], -1),
                    _reduction_size((2, 3, 774) if per_class else (2, n), k))
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(_bits(got[key]), _bits(want[key])), key


def test_exact_lane_keeps_float32_logits():
    rng = np.random.default_rng(12)
    logits, boxes, _ = _filter_inputs(rng)
    want = jax_pp.filter_top_k(
        {"scores": jnp.asarray(logits), "boxes": jnp.asarray(boxes)}, 64)
    got = torch_pp.filter_top_k(
        {"scores": torch.from_numpy(logits),
         "boxes": torch.from_numpy(boxes)}, 64)
    for key in want:
        assert np.array_equal(_bits(got[key]), _bits(want[key])), key


# ------------------------------------------- the postprocess tail, whole


_MODES = ("CombinedNMS", "GlobalSoftNMS", "GlobalHardNMS",
          "PerClassSoftNMS", "PerClassHardNMS")


def _tail_tree(mode, decode_after, per_class):
    return {
        "experiment": {"name": "torch_port_topk_tail"},
        "input": {"input_shape": [64, 64], "channels": 3},
        "floatx": {"precision": "float32"},
        "architecture": {
            "backbone": {"type": "resnet", "depth": 10},
            "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                               "max_level": 5, "backbone_max_level": 5},
            "head": {"num_convs": 1, "filters": 16, "num_classes": 5,
                     "num_anchors": 9},
        },
        "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
        "inference": {"batch_size": 2, "pre_nms_top_k": 64,
                      "max_detections": 20, "mode": mode,
                      "decode_after_topk": decode_after,
                      "filter_per_class": per_class},
    }


def _head_outputs():
    """Normal logits around -2.5 (tens of sigmoid scores clear 0.05 in each
    class) rounded to quarters in level 4, small box regressions."""
    rng = np.random.default_rng(21)
    preds = {"class-predictions": {}, "box-predictions": {}}
    for level, s in {"3": 8, "4": 4, "5": 2}.items():
        cls = rng.normal(-2.5, 1.0, (2, s, s, 45)).astype(np.float32)
        if level == "4":
            cls = np.round(cls * 4) / 4
        preds["class-predictions"][level] = cls
        preds["box-predictions"][level] = rng.normal(
            0.0, 0.1, (2, s, s, 36)).astype(np.float32)
    return preds


@pytest.mark.parametrize("mode,decode_after,per_class", [
    (m, d, p) for m in _MODES for d in (False, True) for p in (True, False)
    if not (p and m.startswith("Global"))])
def test_default_lane_tail_matches_jax(mode, decode_after, per_class):
    """The same head outputs through JAX's `make_inference_fn` and the
    port's, both in their default lane: the bf16 cast, the packed top-k,
    the float32 sigmoid of the winners, the NMS."""
    tree = _tail_tree(mode, decode_after, per_class)
    preds = _head_outputs()
    images = np.zeros((2, 64, 64, 3), np.float32)
    jparams = jax_cfg.from_dict(tree)
    want = jax.jit(jax_pp.make_inference_fn(
        _JaxStub(preds), jparams, jax_anchors.from_params(jparams),
        jax_normalizer(jparams), compute_dtype=jnp.float32))(
            {}, {}, images)
    tparams = torch_cfg.from_dict(tree)
    got = torch_pp.make_inference_fn(
        _TorchStub(preds), tparams, torch_anchors.from_params(tparams),
        torch_normalizer(tparams), compute_dtype=torch.float32,
        device="cpu")(torch.from_numpy(images))
    assert int(np.asarray(want["valid_detections"]).sum()) >= 10
    for key in ("valid_detections", "classes"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_postprocess_fn_casts_float32_logits():
    """`make_postprocess_fn` in the default lane gives float32 and bf16
    fused logits the same detections: the lane selects on bf16."""
    tree = _tail_tree("PerClassHardNMS", False, True)
    tparams = torch_cfg.from_dict(tree)
    post = torch_pp.make_postprocess_fn(
        tparams, torch_anchors.from_params(tparams), "cpu")
    preds = jax.tree_util.tree_map(torch.from_numpy, _head_outputs())
    f32 = torch_pp.fuse_predictions(preds, 3, 5)
    bf16 = torch_pp.fuse_predictions(preds, 3, 5,
                                     logits_dtype=torch.bfloat16)
    assert bf16["class_logits"].dtype == torch.bfloat16
    a, b = post(f32), post(bf16)
    for key in a:
        assert torch.equal(a[key], b[key]), key


# --------------------------------------- the serving function, whole


_SERVE_TREE = {
    "experiment": {"name": "torch_port_topk_serving"},
    "input": {"input_shape": [128, 128], "channels": 3},
    "floatx": {"precision": "float32"},
    "architecture": {
        "backbone": {"type": "resnet", "depth": 10},
        "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                           "max_level": 7, "backbone_max_level": 5,
                           "use_balanced_features": True},
        "head": {"num_convs": 2, "filters": 16, "num_classes": 5,
                 "num_anchors": 9},
    },
    "inference": {"mode": "PerClassHardNMS", "nms_top_k": 32},
}


def test_serving_fn_default_lane_matches_jax():
    """A small ResNet with the same (converted) weights in both packages,
    both serving functions in their default lane. The two float32 forwards
    differ by ~1e-6, which can flip a bf16 rounding at a boundary; so the
    test first asserts its precondition: every logit at or above one bf16
    step below the k-th of its row rounds to the same bf16 in both
    forwards. The lane then sees the same keys where it decides, and the
    detections must be equal (classes, valid counts; boxes and scores
    within 1e-5, the forwards' own difference)."""
    jparams = jax_cfg.from_dict(_SERVE_TREE)
    jmodel = jax_build_model(jparams)
    variables = _variables(jmodel)
    bias = variables["params"]["class_head"]["prediction"]["conv"]["bias"]
    bias[:] = -1.5
    images = np.random.default_rng(1).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)

    def jax_fn(**kw):
        return jax_pp.make_inference_fn(
            jmodel, jparams, jax_anchors.from_params(jparams),
            jax_normalizer(jparams), compute_dtype=jnp.float32, **kw)

    # one compile: the serving function and its fused float32 logits
    want, fused = jax.jit(lambda *a: (jax_fn()(*a), jax_fn(
        skip_decoding=True)(*a)))(variables["params"],
                                  variables["batch_stats"], images)
    j_logits = np.array(fused["class_logits"])

    tparams = torch_cfg.from_dict(_SERVE_TREE)
    model = build_model(tparams, device="cpu")
    load_flax_variables(model, variables)
    t_logits = build_serving_fn(tparams, mode="onnx", device="cpu",
                                model=model)(torch.from_numpy(images))[
                                    "class_logits"]
    assert t_logits.dtype == torch.float32
    # precondition
    k = 32
    t_rows = t_logits.to(torch.bfloat16).transpose(1, 2)       # (B, C, A)
    j_rows = torch.from_numpy(j_logits).to(torch.bfloat16).transpose(1, 2)
    n = t_rows.shape[-1]
    code_t = topk.value_key(t_rows, "bf16", n)
    code_j = topk.value_key(j_rows, "bf16", n)
    kth = torch.sort(code_t, dim=-1, descending=True).values[..., k - 1:k]
    near = (code_t >= kth - 1) | (code_j >= kth - 1)
    assert int(near.sum()) >= k * t_rows.shape[0] * t_rows.shape[1]
    assert torch.equal(code_t[near], code_j[near]), "precondition"

    got = build_serving_fn(tparams, device="cpu", model=model)(
        torch.from_numpy(images))
    want = jax.tree_util.tree_map(np.asarray, want)
    assert int(want["valid_detections"].sum()) >= 10
    np.testing.assert_array_equal(got["valid_detections"].numpy(),
                                  want["valid_detections"])
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-5, err_msg=key)
