"""The top-k kernel's "slab" design (`retinanet_torch/csrc/topk.cu`,
planned by `ops/topk_kernel.py:slab_plan`) walked in numpy, against the
plain version `ops/topk.py:top_k_rows_plain` and the JAX package.

The walk takes the kernel's numbers from `slab_plan` and goes the kernel's
way: each CTA's contiguous range of the (B, N, C) elements, cut at images
and at SLAB_CHUNK_ANCHORS (no 16-bit counter of a chunk's per-class
histogram reaches 65,536: asserted), the histograms (rows for the image's deep rows only) summed into each
row's,
the digit picked from the top, a row ready once its candidates fit its
buffer and written in any order (shuffled here), deep rows read again for
the next digit, then the final radix select inside the candidates (11 bits
a pass) and the sort. It also checks that every active row of a level has
resolved the same bits, the kernel's 32-bit ("narrow") tests against the
64-bit unique key, its hand-out of vectors to threads and its histogram
swizzle. Inputs are seeded numpy logits around the class
prior, quarter steps (ties), rows of one value and signed zeros."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from retinanet_tpu.ops import postprocess as jax_pp  # noqa: E402
from retinanet_torch.ops import topk  # noqa: E402
from retinanet_torch.ops import topk_kernel as tk  # noqa: E402

from test_torch_threads import one_thread  # noqa: E402,F401

PRIOR = -float(np.log(99.0))
DEEP, READY, DONE = 1, 2, 3


def _logits(rng, shape, kind):
    x = rng.normal(PRIOR, 1.5, shape)
    if kind == "quarter":
        x = np.round(x * 4) / 4
    elif kind == "one":
        x = np.full(shape, -2.0)
    elif kind == "zeros":
        x = np.round(x) * 0.0          # +0.0 and -0.0
    elif kind == "sigmoid":            # a skip_nms lane's scores
        x = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 0.3, shape)))
    return x.astype(np.float32)


def _rows(x, mode):
    t = torch.from_numpy(x)
    return t if mode == "f32" else t.to(torch.bfloat16)


def _bits(t):
    view = torch.int32 if t.dtype == torch.float32 else torch.int16
    return t.contiguous().view(view).numpy()


def _u64(v):
    return np.asarray(v, dtype=np.uint64)


def slab_walk(t, k, mode, grid, capacity=None, seed=0):
    """The slab design on x (B, N, C): (value keys (B, C, k) int64, indices
    (B, C, k)), and the rows deep or ready after each level."""
    b, n, c = t.shape
    plan = tk.slab_plan(b, n, c, k, mode, capacity)
    v, i_bits, d, cap = (plan.key_bits, plan.idx_bits, plan.hist_bits,
                         plan.capacity)
    w = v + i_bits
    imask = (1 << i_bits) - 1
    vkey = topk.value_key(t, mode, n).numpy().reshape(-1).astype(np.uint64)
    total, image = b * n * c, n * c
    f = np.arange(total)
    anchor = (f % image) // c
    cls = f % c
    row_of = (f // image) * c + cls
    e_all = (vkey << _u64(i_bits)) | (_u64(imask) - anchor.astype(np.uint64))
    rows = b * c
    state = np.full(rows, DEEP if n > cap else READY)
    prefix = np.zeros(rows, np.uint64)
    done = np.zeros(rows, np.int64)
    need = np.full(rows, k, np.int64)
    m = np.full(rows, n, np.int64)
    ghist = np.zeros((rows, 1 << d), np.int64)
    bufs = [[] for _ in range(rows)]
    per = -(-total // grid)
    per = -(-per // 64) * 64             # a CTA's range, as the kernel's
    rows_active, has_deep = [], n > cap
    for level in range(plan.levels):
        dl = max(1, min(d, w - level * d))
        # every active row of a level has resolved the same bits
        level_done = min(level * d, w) if n > cap else 0
        busy = (state == DEEP) | (state == READY)
        assert np.all(done[busy] == level_done)
        narrow = level_done <= v and (not has_deep or level_done + dl <= v)
        for cta in range(grid):
            lo, hi = cta * per, min(total, cta * per + per)
            s0 = lo
            while s0 < hi:
                img = s0 // image
                img_end = min(hi, (img + 1) * image)
                for c0 in range(s0, img_end, tk.SLAB_CHUNK_ANCHORS * c):
                    sl = slice(c0, min(img_end, c0 + tk.SLAB_CHUNK_ANCHORS
                                       * c))
                    e, r, cl = e_all[sl], row_of[sl], cls[sl]
                    shift = _u64(w - done[r])
                    top = e >> shift
                    deep = (state[r] == DEEP) & (top == prefix[r])
                    digit = ((e >> (shift - _u64(dl)))
                             & _u64((1 << dl) - 1)).astype(np.int64)
                    if narrow and level_done > 0:
                        _check_narrow(vkey[sl], state[r], prefix[r], v,
                                      level_done, dl, digit, top)
                    # the histogram has rows for the image's deep rows
                    # only (hidx, in class order); the stage takes the rest
                    # of the room
                    img_state = state[img * c:(img + 1) * c]
                    deep_cls = np.flatnonzero(img_state == DEEP)
                    hidx = np.cumsum(img_state == DEEP) - 1
                    room = (c << d) // 2
                    used = ((len(deep_cls) << (dl - 1)) + 1) // 2 * 2
                    assert used <= room
                    local = np.bincount(hidx[cl[deep]] * (1 << dl)
                                        + digit[deep],
                                        minlength=len(deep_cls) << dl)
                    assert local.max(initial=0) < 65536, "16-bit counter"
                    ghist[img * c + deep_cls, :1 << dl] += local.reshape(
                        len(deep_cls), 1 << dl)
                    ready = (state[r] == READY) & (top >= prefix[r])
                    for row in np.unique(r[ready]):
                        bufs[row].append(e[ready & (r == row)])
                s0 = img_end
        active = 0
        for r in range(rows):
            if state[r] == READY:
                state[r] = DONE
            elif state[r] == DEEP:
                hist = ghist[r, :1 << dl]
                above = 0
                for digit in range(len(hist) - 1, -1, -1):
                    if above + hist[digit] >= need[r]:
                        break
                    above += hist[digit]
                prefix[r] = (prefix[r] << _u64(dl)) | _u64(digit)
                done[r] += dl
                need[r] -= above
                m[r] = k - need[r] + hist[digit]
                state[r] = READY if m[r] <= cap else DEEP
                ghist[r] = 0
                active += 1
        rows_active.append(active)
        has_deep = bool(np.any(state == DEEP))
        if not active:
            break
    assert active == 0, "levels left rows unfinished"
    rng = np.random.default_rng(seed)
    out_keys = np.zeros((rows, k), np.int64)
    out_idx = np.zeros((rows, k), np.int64)
    for r in range(rows):
        cand = np.concatenate(bufs[r] or [np.zeros(0, np.uint64)])
        rng.shuffle(cand)               # atomics write in any order
        assert len(cand) == m[r] <= cap
        p, dn, nd = prefix[r], int(done[r]), int(need[r])
        bin_count = len(cand) - (k - nd)
        while bin_count != nd:          # the final kernel's radix select
            dl = min(tk.SLAB_FINAL_BITS, w - dn)
            shift = _u64(w - dn)
            match = (cand >> shift) == p
            digits = ((cand[match] >> (shift - _u64(dl)))
                      & _u64((1 << dl) - 1)).astype(np.int64)
            hist = np.bincount(digits, minlength=1 << dl)
            above = 0
            for digit in range(len(hist) - 1, -1, -1):
                if above + hist[digit] >= nd:
                    break
                above += hist[digit]
            p = (p << _u64(dl)) | _u64(digit)
            dn += dl
            nd -= above
            bin_count = hist[digit]
        win = cand[cand >= (p << _u64(w - dn))]
        assert len(win) == k, "exactly k keys at or above the prefix"
        win = np.sort(win)[::-1]
        out_keys[r] = (win >> _u64(i_bits)).astype(np.int64)
        out_idx[r] = imask - (win & _u64(imask)).astype(np.int64)
    return (out_keys.reshape(b, c, k), out_idx.reshape(b, c, k),
            rows_active)


def _check_narrow(vkey, state, prefix, v, done, dl, digit, top):
    """A level whose tests need no index bit ("narrow" in csrc/topk.cu)
    tests on the 32-bit value key alone; it must agree with the unique
    key."""
    sv = _u64(min(v - done, 31))
    vtop = vkey >> sv
    deep = state == DEEP
    assert np.array_equal(vtop[deep] == prefix[deep],
                          top[deep] == prefix[deep])
    same = deep & (vtop == prefix)
    d32 = (vkey[same] >> (sv - _u64(dl))) & _u64((1 << dl) - 1)
    assert np.array_equal(d32.astype(np.int64), digit[same])
    ready = state == READY
    assert np.array_equal(vtop[ready] >= prefix[ready],
                          top[ready] >= prefix[ready])


def _plain(t, k, mode):
    values, idx = topk.top_k_rows_plain(t, k, mode)
    n = t.shape[1]
    return topk.value_key(values, mode, n).numpy(), idx.numpy()


# ---------------------------------------------------------------- design


@pytest.mark.parametrize("shape,k,want", [
    ((8, 76725, 80), 256, "slab"),      # the flagship's per-class lanes
    ((1, 76725, 80), 256, "slab"),      # batch 1
    ((8, 6138000, 1), 256, "slab"),     # the global lane
    ((8, 306900, 80), 5000, "slab"),    # 1280 x 1280, skip_nms
    ((8, 8000, 1), 100, "row"),         # the NMS survivors
    ((8, 16383, 80), 256, "row"),       # shorter than SLAB_MIN_ROW
    ((2, 50000, 321), 256, "row"),      # more classes than the budget
])
def test_topk_design(shape, k, want):
    assert tk.topk_design(*shape, k) == want


@pytest.mark.parametrize("shape,k,mode,want", [
    ((8, 76725, 80), 256, "packed", (15, 17, 10, 16384, 5)),
    ((8, 76725, 80), 256, "f32", (32, 17, 10, 16384, 6)),
    ((8, 76725, 80), 8192, "f32", (32, 17, 10, 16384, 6)),
    ((8, 6138000, 1), 5000, "bf16", (16, 23, 16, 16384, 4)),
    ((8, 37485, 80), 256, "packed", (16, 16, 10, 16384, 5)),
    ((2, 20000, 3), 8192, "f32", (32, 15, 14, 16384, 5)),
    ((2, 20000, 320), 1, "bf16", (16, 15, 8, 16384, 5)),
    ((1, 9000, 2), 256, "bf16", (16, 14, 15, 9000, 3)),   # cap <= n
])
def test_slab_plan(shape, k, mode, want):
    plan = tk.slab_plan(*shape, k, mode)
    assert plan[:5] == want
    b, _, c = shape
    rows = b * c
    assert plan.scratch_bytes >= (rows * plan.capacity * 8
                                  + (rows << plan.hist_bits) * 4 + rows * 32)
    assert all(o % 16 == 0 for o in plan.offsets)
    assert (c << plan.hist_bits) * 2 <= tk.SLAB_HIST_BYTES
    assert plan.levels <= tk.SLAB_MAX_LEVELS


def test_slab_plan_refuses():
    with pytest.raises(ValueError):
        tk.slab_plan(1, 20000, 4, 300, "f32", capacity=299)
    with pytest.raises(ValueError):
        tk.slab_plan(1, 20000, 321, 10, "f32")
    assert tk.slab_plan(1, 500, 4, 300, "f32").capacity == 500   # <= n


# ------------------------------------------------------------- the walk


_WALKS = [
    # mode, batch, n, classes, k, kind, grid, capacity
    ("packed", 2, 70000, 2, 256, "normal", 5, None),     # drop 1
    ("packed", 2, 600, 80, 64, "normal", 7, None),       # C = 80, drop 0
    ("packed", 1, 3000, 80, 256, "quarter", 9, 256),     # overflow
    ("bf16", 1, 140000, 1, 256, "normal", 6, None),      # above 2^17
    ("bf16", 2, 20000, 1, 300, "quarter", 4, 300),       # C = 1, ties
    ("f32", 2, 5000, 3, 100, "zeros", 5, 100),           # -0.0 < 0.0
    ("f32", 1, 30000, 2, 5000, "sigmoid", 3, None),      # k = 5000
    ("packed", 2, 20000, 4, 256, "one", 6, None),        # one value
    ("f32", 1, 3000, 3, 1, "one", 2, None),              # k = 1
    ("bf16", 2, 700, 5, 700, "quarter", 3, None),        # k = n
    ("f32", 1, 65600, 1, 64, "normal", 1, 64),           # chunks of a CTA
]


@pytest.mark.parametrize("case", _WALKS, ids=str)
def test_slab_walk_equals_plain(case):
    mode, b, n, c, k, kind, grid, capacity = case
    rng = np.random.default_rng(n + c + k)
    t = _rows(_logits(rng, (b, n, c), kind), mode)
    keys, idx, active = slab_walk(t, k, mode, grid, capacity)
    want_keys, want_idx = _plain(t, k, mode)
    assert np.array_equal(idx, want_idx)
    assert np.array_equal(keys, want_keys)
    plan = tk.slab_plan(b, n, c, k, mode, capacity)
    if n > plan.capacity and kind in ("one", "quarter", "zeros"):
        # ties across the k-th key overflow a buffer of k or 4,096
        assert len(active) > 2, "rows that overflow read the slab again"


def test_slab_walk_reads_the_slab_twice_on_logits():
    """A row of normal logits is ready after one histogram level: one read
    for the histogram, one for the candidates."""
    rng = np.random.default_rng(1)
    t = _rows(_logits(rng, (1, 76725, 80), "normal"), "packed")
    keys, idx, active = slab_walk(t, 256, "packed", 8)
    assert active == [80, 0]
    want_keys, want_idx = _plain(t, 256, "packed")
    assert np.array_equal(idx, want_idx) and np.array_equal(keys, want_keys)


@pytest.mark.parametrize("vec", [4, 8], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 2, 3, 7, 8, 16, 80, 320])
def test_thread_keeps_its_classes(c, vec):
    """csrc/topk.cu:visit_range hands vectors out with a stride S that is a
    multiple of the class period C / gcd(C, vec): thread t's vector i
    starts at anchor0 + i * apr with the class of its first vector, and
    the classes of a vector follow by one-step increments."""
    period = c // math.gcd(c, vec)
    stride = (tk.SLAB_THREADS // period) * period
    apr = stride * vec // c
    assert stride * vec % c == 0 and stride <= tk.SLAB_THREADS
    for start in (0, 5, 123):
        for tid in (0, 1, 31, stride - 1):
            anchor0, cls0 = divmod(start + tid * vec, c)
            for i in range(3):
                anchor, cls = anchor0 + i * apr, cls0
                for j in range(vec):
                    f = start + (i * stride + tid) * vec + j
                    assert (anchor, cls) == divmod(f, c)
                    cls += 1
                    if cls == c:
                        cls, anchor = 0, anchor + 1


@pytest.mark.parametrize("dl", [1, 2, 6, 10, 16])
@pytest.mark.parametrize("vec_log", [2, 3], ids=["f32", "bf16"])
def test_histogram_swizzle_is_a_bijection(dl, vec_log):
    """csrc/topk.cu:hist_slot: a class's 2^dl counters in 2^(dl-1) words,
    the pair index XOR-ed with cls >> vec_log; the flush undoes it."""
    c = 80
    smask = (1 << (dl - 1)) - 1
    cls = np.repeat(np.arange(c), 1 << dl)
    digit = np.tile(np.arange(1 << dl), c)
    q = ((digit >> 1) ^ (cls >> vec_log)) & smask
    slot = (((cls << (dl - 1)) + q) << 1) | (digit & 1)
    assert np.array_equal(np.sort(slot), np.arange(c << dl))
    word = slot >> 1
    back_cls = word >> (dl - 1)
    back_pair = (word & smask) ^ ((back_cls >> vec_log) & smask)
    assert np.array_equal(back_cls, cls)
    assert np.array_equal(2 * back_pair + (slot & 1), digit)


# --------------------------------------------------- against the package


def _assert_covered(rows, idx, size):
    """Every selected element lies strictly above the size-th largest
    value of its row, so that XLA's approx_max_k (a top-`size` by value,
    then the packed sort) holds it whatever its tie order."""
    for row, sel in zip(rows, idx):
        boundary = np.sort(row)[::-1][size - 1]
        assert row[sel].min() > boundary, "precondition: ties across L"


@pytest.mark.parametrize("n,c,k,grid", [(70000, 2, 256, 5),
                                        (3000, 8, 100, 4)],
                         ids=["drop1", "drop0"])
def test_slab_walk_equals_approx_max_k_packed(n, c, k, grid):
    rng = np.random.default_rng(7 + n)
    x = _logits(rng, (1, n, c), "normal")
    t = _rows(x, "packed")
    j = jnp.asarray(x.transpose(0, 2, 1), jnp.float32).astype(jnp.bfloat16)
    jv, ji = jax.jit(lambda s: jax_pp.approx_max_k_packed(s, k))(j)
    size = jax.eval_shape(
        lambda s: jax.lax.approx_max_k(s, k, recall_target=0.95,
                                       aggregate_to_topk=False),
        jax.ShapeDtypeStruct(j.shape, jnp.bfloat16))[0].shape[-1]
    keys, idx, _ = slab_walk(t, k, "packed", grid, capacity=2 * k)
    rows = t.float().numpy().transpose(0, 2, 1).reshape(c, n)
    if size < n:
        _assert_covered(rows, idx.reshape(c, k), size)
    assert np.array_equal(idx, np.asarray(ji))
    values = topk.key_value(torch.from_numpy(keys), "packed", n)
    assert np.array_equal(_bits(values), np.asarray(
        jax.lax.bitcast_convert_type(jv, jnp.int16)))


@pytest.mark.parametrize("kind", ["quarter", "zeros"])
def test_slab_walk_equals_lax_top_k(kind):
    """f32 mode with heavy ties and signed zeros: lax.top_k orders -0.0
    below 0.0 and ties to the lower index."""
    n, c, k = 6000, 3, 300
    rng = np.random.default_rng(9)
    x = _logits(rng, (1, n, c), kind)
    jv, ji = jax.lax.top_k(jnp.asarray(x.transpose(0, 2, 1)), k)
    keys, idx, _ = slab_walk(torch.from_numpy(x), k, "f32", 3, capacity=k)
    assert np.array_equal(idx, np.asarray(ji))
    values = topk.key_value(torch.from_numpy(keys), "f32", n)
    assert np.array_equal(_bits(values), np.asarray(
        jax.lax.bitcast_convert_type(jv, jnp.int32)))


def test_experiment_edits_apply():
    """Every one-edit variant of `tools/topk_experiments.py` (the slab
    design's, the row design's cuts and its launch floor) still applies to
    csrc/topk.cu exactly once."""
    from retinanet_torch.tools import topk_experiments
    from retinanet_torch.tools.kernel_variants import variant_source
    for name, edits in {**topk_experiments.VARIANTS,
                        **topk_experiments.ROW_CUTS,
                        "launch floor": topk_experiments.LAUNCH_FLOOR
                        }.items():
        assert variant_source(tk.kernel, name, edits) != \
            tk.kernel.source.read_text()
