"""The top-k's sort of more winners than shared memory holds (k past
`SORT_ON_CHIP_MAX`), on the CPU: the radix sort of `csrc/topk.cu`
(`radix_prepare_kernel`, `radix_count_kernel`, `radix_scatter_kernel`)
walked in numpy from the wrapper's constants and `radix_plan` (its digits,
the passes a row skips, the tiles in order, each warp's ranks item by
item, the staging in shared memory, the split of a row over several CTAs)
against `np.sort` and `ops/topk.py:top_k_rows_plain`; the `.cu`'s
constants against the wrapper's; and the port's selections past the cap
against `jax.lax.top_k` and `approx_max_k_packed` on rows of 20,000 to
76,725. Exact: indices and value bits."""

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.ops import postprocess as jax_pp  # noqa: E402
from retinanet_torch.ops import topk  # noqa: E402
from retinanet_torch.ops import topk_kernel as tk  # noqa: E402

from test_torch_topk import (  # noqa: E402
    _assert_covered, _bf16, _bits, _logits, _reduction_size)
from test_torch_threads import one_thread  # noqa: E402,F401

N = 76725              # the flagship's anchors at 640 x 640
N_GLOBAL = 76725 * 80  # its global lane: every (anchor, class)
_WARP_KEYS = 32 * tk.RADIX_ITEMS


def _stable_ranks(d):
    """Each element's count of equal elements before it."""
    order = np.argsort(d, kind="stable")
    ds = d[order]
    ranks = np.empty(len(d), np.int64)
    ranks[order] = np.arange(len(d)) - np.searchsorted(ds, ds, side="left")
    return ranks


def _desc_exclusive(counts):
    """Each bin's start when the bins go in descending order."""
    return np.cumsum(counts[::-1])[::-1] - counts


def _skips(hist_row, k):
    """csrc/topk.cu:radix_skips: bit q when pass q's digit is one bin for
    all k keys."""
    m = 0
    for q, h in enumerate(hist_row):
        m |= int((h == k).any()) << q
    assert m != (1 << len(hist_row)) - 1, "k > 1 unique keys: a pass moves"
    return m


def radix_walk(e, vshift, vbits, ibits, segments=None, stats=None):
    """The radix sort of `csrc/topk.cu` on e (rows, k) uint64 winners in a
    select kernel's layout (any order), kernel by kernel, with the numbers
    of `radix_plan`. Returns the compact keys (rows, k) in the order the
    last pass writes them (descending). `stats` gets the plan and each
    row's passes moved."""
    rows, k = e.shape
    plan = tk.radix_plan(rows, k, vbits + ibits, segments)
    kt = np.uint32 if plan.key_bytes == 4 else np.uint64
    bins, tile = tk.RADIX_BINS, tk.RADIX_TILE
    imask = np.uint64((1 << ibits) - 1)
    # radix_prepare_kernel: compact keys into `alt`, every digit's counts
    compact = ((e >> np.uint64(vshift)) << np.uint64(ibits)) | (e & imask)
    assert int(compact.max()) < 1 << plan.key_bits
    buffers = {"keys": np.zeros((rows, k), kt), "alt": compact.astype(kt)}

    def digit(key, q):
        shift, bits = plan.digits[q]
        return ((key.astype(np.uint64) >> np.uint64(shift))
                & np.uint64((1 << bits) - 1)).astype(np.int64)

    hist = np.stack([np.stack([np.bincount(digit(compact[r], q),
                                           minlength=bins)
                               for q in range(len(plan.digits))])
                     for r in range(rows)])
    passes = len(plan.digits)
    out = np.full((rows, k), -1, np.int64)
    moved_rows = []
    for r in range(rows):
        skips = _skips(hist[r], k)
        moved_rows.append(passes - bin(skips).count("1"))
        for p in range(passes):
            if skips >> p & 1:
                continue
            moved = bin(~skips & ((1 << p) - 1)).count("1")
            src = buffers["keys" if moved & 1 else "alt"][r]
            dst = buffers["alt" if moved & 1 else "keys"][r]
            last = (~skips & ((1 << passes) - 1)) >> (p + 1) == 0
            written = np.zeros(k, bool)
            # radix_count_kernel (segments > 1): each segment's counts
            span = plan.seg_tiles * tile
            counts = np.stack([np.bincount(
                digit(src[s * span:(s + 1) * span], p), minlength=bins)
                for s in range(plan.segments)])
            for s in range(plan.segments):
                # radix_scatter_kernel, CTA (r, s)
                running = _desc_exclusive(hist[r, p]) + counts[:s].sum(0)
                for t in range(s * plan.seg_tiles,
                               min((s + 1) * plan.seg_tiles, plan.tiles)):
                    keys = src[t * tile:(t + 1) * tile]
                    d = digit(keys, p)
                    n_tile = len(keys)
                    # warp w holds keys [w * 32 * ITEMS, ...), item j of
                    # lane l the key (w * ITEMS + j) * 32 + l: ranks in
                    # (item, lane) order are memory order
                    warp = np.arange(n_tile) // _WARP_KEYS
                    rank = np.zeros(n_tile, np.int64)
                    warp_hist = np.zeros((tk.RADIX_THREADS // 32, bins),
                                         np.int64)
                    for w in np.unique(warp):
                        sel = warp == w
                        rank[sel] = _stable_ranks(d[sel])
                        warp_hist[w] = np.bincount(d[sel], minlength=bins)
                    cnt = warp_hist.sum(0)
                    warp_before = np.cumsum(warp_hist, 0) - warp_hist
                    start = _desc_exclusive(cnt)
                    stage = np.full(n_tile, -1, np.int64)
                    pos = start[d] + warp_before[warp, d] + rank
                    assert not (stage[pos] != -1).any()
                    stage[pos] = np.arange(n_tile)
                    assert (stage >= 0).all()
                    staged = keys[stage]
                    sd = digit(staged, p)
                    at = running[sd] + np.arange(n_tile) - start[sd]
                    assert not written[at].any()
                    written[at] = True
                    if last:
                        out[r, at] = staged
                    else:
                        dst[at] = staged
                    running = running + cnt
            assert written.all()
    if stats is not None:
        stats.update(plan=plan, moved=moved_rows)
    return out


def _winners(x, k, mode, design, rng):
    """The k winners of each row of x (B, N, C) as `design`'s select
    kernel writes them for the radix sort (value key at vshift, index part
    in the low ibits), shuffled: the kernels write them in no order."""
    n = x.shape[1]
    vshift, vbits, ibits = tk.radix_layout(n, mode, design)
    _, idx = topk.top_k_rows_plain(x, k, mode)
    key = topk.value_key(x.transpose(1, 2), mode, n)
    vkey = torch.gather(key, -1, idx.long()).reshape(-1, k).numpy()
    idx = idx.reshape(-1, k).numpy().astype(np.uint64)
    low = ((np.uint64(2 ** ibits - 1) if design == "slab"
            else np.uint64(0xFFFFFFFF)) - idx)
    e = (vkey.astype(np.uint64) << np.uint64(vshift)) | low
    for r in range(len(e)):
        e[r] = e[r][rng.permutation(k)]
    return e, (vshift, vbits, ibits)


def _rows(mode, k, kind, n=N, rows=2, seed=0):
    rng = np.random.default_rng(seed + k)
    if kind == "one":
        x = np.full((1, n, rows), -2.0, np.float32)
    else:
        x = _logits(rng, (1, n, rows), kind)
    t = torch.from_numpy(x)
    return t if mode == "f32" else t.to(torch.bfloat16)


def _check_walk(x, k, mode, design="slab", segments=None):
    """The walk of the sort of x's winners equals np.sort of the compact
    keys and the plain version's values and indices."""
    rng = np.random.default_rng(k)
    e, (vshift, vbits, ibits) = _winners(x, k, mode, design, rng)
    stats = {}
    got = radix_walk(e, vshift, vbits, ibits, segments, stats)
    imask = (1 << ibits) - 1
    compact = ((e >> np.uint64(vshift)) << np.uint64(ibits)) | (
        e & np.uint64(imask))
    assert np.array_equal(got.astype(np.uint64),
                          np.sort(compact, axis=1)[:, ::-1])
    want_v, want_i = topk.top_k_rows_plain(x, k, mode)
    b, _, c = x.shape
    idx = imask - (got & imask)
    values = topk.key_value(torch.from_numpy(got >> ibits), mode, x.shape[1])
    assert np.array_equal(idx, want_i.reshape(b * c, k).numpy())
    assert np.array_equal(_bits(values), _bits(want_v.reshape(b * c, k)))
    return stats


@pytest.mark.parametrize("segments", [1, None], ids=["one-cta", "spread"])
@pytest.mark.parametrize("mode,kind", [("packed", "quarter"),
                                       ("bf16", "normal"),
                                       ("f32", "quarter")])
@pytest.mark.parametrize("k", [16385, 30001, N], ids=str)
def test_radix_walk_sorts(k, mode, kind, segments):
    """V = 15 (packed, drop 1: 32-bit keys), 16 (bf16: 33 bits) and 32
    (f32: 49 bits) at I = 17; one CTA a row and the plan's split."""
    x = _rows(mode, k, kind)
    stats = _check_walk(x, k, mode, segments=segments)
    plan = stats["plan"]
    assert plan.key_bytes == (4 if mode == "packed" else 8)
    assert len(plan.digits) == {"packed": 4, "bf16": 5, "f32": 7}[mode]
    if segments is None:       # two rows: every tile on a CTA of its own
        assert plan.segments == plan.tiles == -(-k // tk.RADIX_TILE)


@pytest.mark.parametrize("mode", ["packed", "f32"])
def test_radix_walk_row_design_layout(mode):
    """The row design's winners (value key << 32 | ~index)."""
    _check_walk(_rows(mode, 20000, "quarter", n=40000), 20000, mode,
                design="row", segments=2)


def test_radix_walk_global_lane():
    """A global lane, I = 23 (bf16: 39-bit keys, five passes), k = N."""
    x = torch.from_numpy(_logits(np.random.default_rng(7),
                                 (1, N_GLOBAL, 1), "normal")).to(
        torch.bfloat16)
    stats = _check_walk(x, N, "bf16")
    assert stats["plan"].key_bits == 16 + 23
    assert stats["plan"].segments == stats["plan"].tiles


@pytest.mark.parametrize("mode", ["packed", "f32"])
def test_radix_walk_rows_of_one_value(mode):
    """Every value digit is one bin: those passes are skipped, and so is
    the top index digit when k leaves its bits unused."""
    k = 50000
    stats = _check_walk(_rows(mode, k, "one"), k, mode)
    plan = stats["plan"]
    value_passes = sum(shift >= 17 for shift, _ in plan.digits)
    assert value_passes >= 1
    assert max(stats["moved"]) <= len(plan.digits) - value_passes


def test_radix_walk_moves_every_pass_of_spread_values():
    stats = _check_walk(_rows("f32", 30001, "normal", rows=1), 30001, "f32")
    assert stats["moved"] == [len(stats["plan"].digits)]


@pytest.mark.parametrize("rows,k,bits,want", [
    (640, N, 32, (4, 1, 19, 4)), (640, N, 33, (5, 1, 19, 4)),
    (640, N, 49, (7, 1, 19, 4)), (8, N, 39, (5, 19, 1, 19)),
    (1, N, 55, (7, 19, 1, 19)), (80, 30001, 33, (5, 4, 2, 8)),
    (64, 16385, 33, (5, 5, 1, 5)), (3, 16385, 63, (8, 5, 1, 5)),
    (5000, N, 33, (5, 1, 19, 1))])
def test_radix_plan(rows, k, bits, want):
    """Passes, CTAs a row, tiles a segment and the prepare's CTAs a row
    by shape; the digits cover the key's bits from the bottom, none over
    RADIX_BITS, as even as they come."""
    plan = tk.radix_plan(rows, k, bits)
    assert (len(plan.digits), plan.segments, plan.seg_tiles,
            plan.prep_segments) == want
    widths = [w for _, w in plan.digits]
    assert sum(widths) == bits and max(widths) <= tk.RADIX_BITS
    assert max(widths) - min(widths) <= 1
    assert [s for s, _ in plan.digits] == list(np.cumsum([0] + widths[:-1]))
    assert plan.segments * plan.seg_tiles >= plan.tiles
    assert (plan.segments - 1) * plan.seg_tiles < plan.tiles
    words = rows * len(plan.digits) * tk.RADIX_BINS
    if plan.segments > 1:
        words += rows * plan.segments * tk.RADIX_BINS
    assert plan.scratch_bytes == 4 * words
    forced = tk.radix_plan(rows, k, bits, segments=1000)
    assert forced.segments == forced.tiles and forced.seg_tiles == 1


def test_radix_constants_are_the_kernels():
    source = tk.kernel.source.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kRadixThreads") == tk.RADIX_THREADS
    assert constant("kRadixItems") == tk.RADIX_ITEMS
    assert constant("kRadixBits") == tk.RADIX_BITS
    assert constant("kRadixMaxPasses") == tk.RADIX_MAX_PASSES
    assert constant("kRadixTargetCtas") == tk.RADIX_TARGET_CTAS
    assert constant("kRadixPrepareCtas") == tk.RADIX_PREPARE_CTAS
    assert re.search(r"kSortRadix = (\d+)", source).group(1) == str(
        tk.SORTS["radix"])
    assert re.search(r"kSortBitonic = (\d+)", source).group(1) == str(
        tk.SORTS["bitonic"])
    # one bin a thread; a 64-bit key needs every pass; the scatter's
    # shared memory (warp histograms, a tile of 64-bit keys) fits the 48 KB
    # of static shared memory
    assert tk.RADIX_THREADS == tk.RADIX_BINS
    assert tk.RADIX_MAX_PASSES * tk.RADIX_BITS >= 64
    assert (tk.RADIX_THREADS // 32 * tk.RADIX_BINS * 4 + tk.RADIX_TILE * 8
            + 2 * tk.RADIX_BINS * 4) <= 48 * 1024


@pytest.mark.parametrize("design", tk.DESIGNS)
def test_radix_layout(design):
    assert tk.radix_layout(N, "packed", design) == (
        17 if design == "slab" else 32, 15, 17)
    assert tk.radix_layout(20000, "packed", design)[1:] == (16, 15)
    assert tk.radix_layout(N_GLOBAL, "f32", design)[1:] == (32, 23)


def test_launch_refuses_sorts_it_cannot_take():
    """Before any device: the bitonic network only past SORT_ON_CHIP_MAX,
    the radix sort from k = 2, no other sort; a CPU tensor then."""
    x = torch.zeros((1, 20000, 1), dtype=torch.bfloat16)
    for k, sort in ((tk.SORT_ON_CHIP_MAX, "bitonic"), (1, "radix"),
                    (16385, "heap")):
        with pytest.raises(ValueError, match="sort"):
            tk.launch(x, k, "bf16", sort=sort)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.launch(x, 16385, "bf16")


# -- the port's selections past the cap against JAX --------------------------


@pytest.mark.parametrize("n,k", [(20000, 16385), (20000, 20000),
                                 (N, 16385), (N, N)], ids=str)
def test_packed_rows_past_the_cap_equal_approx_max_k_packed(n, k):
    rng = np.random.default_rng(n + k)
    x = _logits(rng, (1, 2, n), "quarter")
    t, j = _bf16(x)
    jv, ji = jax.jit(lambda s: jax_pp.approx_max_k_packed(s, k))(j)
    tv, ti = topk.select_top_k(t.transpose(1, 2).contiguous(), k, "packed",
                               dim=1)
    _assert_covered(t.float().numpy().reshape(-1, n),
                    ti.numpy().reshape(-1, k),
                    _reduction_size((1, 2, n), k))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))


@pytest.mark.parametrize("n,k", [(30001, 16385), (30001, 30001),
                                 (N, 16385), (N, N)], ids=str)
def test_f32_rows_past_the_cap_equal_lax_top_k(n, k):
    rng = np.random.default_rng(n + k + 1)
    x = _logits(rng, (1, 2, n), "quarter")
    x[..., ::7] = 0.0
    x[..., 1::7] = -0.0
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = topk.select_top_k(torch.from_numpy(x), k, "f32")
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))
