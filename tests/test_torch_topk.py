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
from retinanet_torch.ops import topk_kernel as tk  # noqa: E402

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


def _row_layout(n, c, mode):
    """The row design's layout of a row of n keys (element stride c), as
    csrc/topk.cu:row_select_kernel lays it out on its one CTA: its tiles,
    each a (first index, count) of every thread's run of consecutive keys,
    and whether a run comes by 16-byte loads."""
    plan = tk.row_plan(n, 1, mode)
    v, per = plan.vector, plan.items
    assert per <= tk.ROW_ITEMS
    tiles = []
    for t in range(plan.tiles):
        lo = t * tk.ROW_TILE + np.arange(tk.ROW_THREADS) * per
        hi = min(n, (t + 1) * tk.ROW_TILE)
        tiles.append((lo, np.clip(hi - lo, 0, per)))
    # every key of the row once, in index order; 16-byte loads start on
    # whole vectors (C = 1)
    held = np.concatenate([np.arange(lo, lo + m) for los, cnts in tiles
                           for lo, m in zip(los, cnts)])
    assert np.array_equal(held, np.arange(n))
    assert c != 1 or all(lo % v == 0 for los, _ in tiles for lo in los)
    return tiles


def _select(merged, need):
    """A pass's choice: each thread's bins from the top, the scan of the
    threads' sums (in its warp, then over the warps' totals), and the one
    thread whose bins reach `need` picks the bin. Returns (digit, count in
    the digit's bin, need within it)."""
    per = len(merged) // tk.ROW_THREADS
    v = merged[::-1].reshape(tk.ROW_THREADS, per)   # thread t, from the top
    own = v.sum(1)
    inc = np.cumsum(own.reshape(-1, 32), axis=1)
    lower = np.cumsum(inc[:, -1]) - inc[:, -1]
    above = (lower[:, None] + inc).reshape(-1) - own
    pick = np.flatnonzero((above < need) & (need <= above + own))
    assert len(pick) == 1
    t = int(pick[0])
    acc = above[t]
    for q in range(per):
        if acc < need <= acc + v[t, q]:
            return (len(merged) - 1 - per * t - q, int(v[t, q]),
                    int(need - acc))
        acc += v[t, q]
    raise AssertionError("no bin reaches need")


def _rank_sort_desc(keys):
    """csrc/topk.cu's sort for k <= ROW_RANK_SORT_MAX: winner i goes to the
    place that counts the winners above it (the keys are unique), counted
    by ROW_RANK_LANES lanes, each over every ROW_RANK_LANES-th winner."""
    out = np.zeros_like(keys)
    lanes = tk.ROW_RANK_LANES
    for key in keys:
        pos = sum(int(np.sum(keys[sub::lanes] > key)) for sub in range(lanes))
        assert out[pos] == 0
        out[pos] = key
    return out


def _block_sort_desc(keys):
    """csrc/topk.cu:bitonic_sort_desc over keys padded with 0."""
    p = 1
    while p < len(keys):
        p *= 2
    v = np.zeros(p, np.uint64)
    v[:len(keys)] = keys
    t = np.arange(p // 2)
    size = 2
    while size <= p:
        stride = size // 2
        while stride:
            lo = 2 * t - (t & (stride - 1))
            hi = lo + stride
            swap = (v[lo] < v[hi]) == ((lo & size) == 0)
            v[lo], v[hi] = (np.where(swap, v[hi], v[lo]),
                            np.where(swap, v[lo], v[hi]))
            stride //= 2
        size *= 2
    return v[:len(keys)]


def _kernel_walk(keys, k, mode, c=1):
    """A numpy walk of csrc/topk.cu's row design over one row of value
    keys, step for step from the wrapper's numbers: the row in its CTA's
    threads, radix passes of ROW_DIGIT_BITS (the histogram, the one
    thread's choice, the early stop), the winners into their slots (by the
    scan over the tiles and the threads), then the sort (each winner's
    place by counting up to ROW_RANK_SORT_MAX, the CTA's bitonic network
    above). Returns the k value keys and indices in order."""
    n = len(keys)
    plan = tk.row_plan(n, k, mode)
    tiles = _row_layout(n, c, mode)
    bins = 1 << tk.ROW_DIGIT_BITS

    prefix = pmask = 0
    need, count = k, 0
    for shift, width in plan.digits:
        take = keys[(keys & pmask) == prefix]
        hist = np.bincount((take >> shift) & ((1 << width) - 1),
                           minlength=bins)
        digit, count, need = _select(hist, need)
        prefix |= digit << shift
        pmask |= ((1 << width) - 1) << shift
        if count == need:
            break
    ordered = count != need
    above = k - need
    out = np.full(k, -1, np.int64)      # the slot's element
    gt_base = eq_base = 0
    for los, cnts in tiles:
        ng = np.zeros(tk.ROW_THREADS, np.int64)
        ne = np.zeros(tk.ROW_THREADS, np.int64)
        runs = [np.arange(lo, lo + m) for lo, m in zip(los, cnts)]
        for tid, idx in enumerate(runs):
            kp = keys[idx] & pmask
            ng[tid] = np.sum((kp > prefix) | ((kp == prefix)
                                              & (not ordered)))
            ne[tid] = np.sum((kp == prefix) & ordered)
        # one scan of both counts in index order, after the tiles before
        gslot = gt_base + np.cumsum(ng) - ng
        eslot = eq_base + np.cumsum(ne) - ne
        gt_base += int(ng.sum())
        eq_base += int(ne.sum())
        for tid, idx in enumerate(runs):
            g, e = gslot[tid], eslot[tid]
            for i in idx:
                kp = keys[i] & pmask
                if kp > prefix or (kp == prefix and not ordered):
                    assert out[g] == -1
                    out[g] = i
                    g += 1
                elif kp == prefix:
                    if e < need:
                        assert out[above + e] == -1
                        out[above + e] = i
                    e += 1
    assert gt_base == (above if ordered else k) and np.all(out >= 0)
    e = (keys[out].astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - out.astype(np.uint64))
    if plan.rank_sort:
        e = _rank_sort_desc(e)
    else:
        e = _block_sort_desc(e)
    return (e >> np.uint64(32)).astype(np.int64), (
        np.uint64(0xFFFFFFFF) - (e & np.uint64(0xFFFFFFFF))).astype(
            np.int64)


def _walk_equals_plain(t, k, mode):
    """Every row of t (B, N, C) walked against the plain version."""
    b, n, c = t.shape
    values, idx = topk.top_k_rows_plain(t, k, mode)
    keys = topk.value_key(t.transpose(1, 2), mode, n).numpy()
    for r in range(b):
        for col in range(c):
            wk, wi = _kernel_walk(keys[r, col], k, mode, c)
            assert np.array_equal(wi, idx[r, col].numpy())
            assert np.array_equal(
                _bits(topk.key_value(torch.from_numpy(wk), mode, n)),
                _bits(values[r, col]))


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
    _walk_equals_plain(t, k, mode)


def _survivors(rng, batch, kind, n=8000, c=1, md=100):
    """Rows like the per-class NMS's output flattened for the final top-k
    (`ops/postprocess.py:_per_class_nms`): each class's md slots, its kept
    scores in descending order, then -1.0 fill."""
    if kind == "trained":       # a trained head: a few kept a class
        x = np.full((batch, n, c), -1.0)
        for b in range(batch):
            for col in range(c):
                for start in range(0, n, md):
                    kept = rng.integers(0, 9)
                    x[b, start:start + kept, col] = np.sort(
                        rng.uniform(0.05, 1.0, kept))[::-1]
        assert np.mean(x == -1.0) >= 0.95
    elif kind == "steps":       # chip_smoke.py phase 16's seeded rows
        x = np.where(rng.uniform(size=(batch, n, c)) < 0.3, -1.0,
                     np.round(rng.uniform(0.05, 1.0, (batch, n, c)) * 64)
                     / 64)
    else:                       # nothing kept: all -1.0, ties to index
        x = np.full((batch, n, c), -1.0)
    return x.astype(np.float32)


@pytest.mark.parametrize("batch,kind,n,c", [
    (1, "trained", 8000, 1), (8, "trained", 8000, 1), (1, "steps", 8000, 1),
    (8, "steps", 8000, 1), (1, "fill", 8000, 1), (8, "fill", 8000, 1),
    (2, "steps", 16383, 1), (2, "trained", 8000, 3)])
def test_kernel_walk_on_survivors(batch, kind, n, c):
    """The top-k over the NMS survivors (k = max_detections = 100): rows
    mostly of -1.0, rows of 1/64 steps, rows all -1.0, the longest row on
    one CTA, and rows read in place at stride C = 3."""
    rng = np.random.default_rng(batch * 7 + n + c)
    x = torch.from_numpy(_survivors(rng, batch, kind, n, c))
    assert tk.row_plan(n, 100, "f32").tiles == 1
    _walk_equals_plain(x, 100, "f32")


@pytest.mark.parametrize("kind", ["trained", "steps", "fill"])
def test_survivors_plain_equals_lax_top_k(kind):
    x = _survivors(np.random.default_rng(17), 8, kind)[..., 0]
    jv, ji = jax.lax.top_k(jnp.asarray(x), 100)
    tv, ti = topk.top_k_rows_plain(torch.from_numpy(x)[..., None], 100,
                                   "f32")
    assert np.array_equal(ti[:, 0].numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv[:, 0]), _bits(jv))


def test_row_plan():
    """The row design's numbers for the survivors and the longest rows."""
    plan = tk.row_plan(8000, 100, "f32")
    assert (plan.tiles, plan.items, plan.vector) == (1, 8, 4)
    assert plan.digits == ((21, 11), (10, 11), (0, 10)) and plan.rank_sort
    assert tk.row_plan(16384, 129, "bf16").digits == ((5, 11), (0, 5))
    assert not tk.row_plan(16384, 129, "bf16").rank_sort
    assert tk.row_plan(76725, 256, "packed").digits == ((4, 11), (0, 4))
    assert [tk.row_plan(n, 100, "f32").tiles
            for n in (16383, 16384, 16385, 76725, 10 ** 6)] == [
        1, 1, 2, 5, 62]
    assert tk.row_plan(76725, 100, "f32").items == tk.ROW_ITEMS


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
