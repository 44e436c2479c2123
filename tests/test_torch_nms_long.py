"""NMS past 1,024 candidates a lane (the exact-parity lane,
`inference.nms_top_k` up to every config's pre_nms_top_k of 5,000), on the
CPU: the plain models of the two designs that take it on the card,
`ops/nms.py:scan_nms_plain` (hard mode, the scan kernel of `csrc/nms.cu`)
and `ops/nms.py:compact_nms_plain` (the soft modes, the compact kernel),
against the round form (`batched_nms`) and the JAX package; numpy walks of
both kernels from the wrapper's constants; and the routes to them.

Against `batched_nms` indices, scores and valid counts are compared bit for
bit (the same float32 arithmetic on the same tensors). Against JAX, and in
the compact walk (numpy's float32 `exp`), indices and valid counts exactly
and scores to rtol 1e-5, atol 1e-6, as in tests/test_torch_nms.py (exp and
division may round differently)."""

import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.ops.nms import nms_select as jax_nms_select  # noqa: E402
from retinanet_tpu.ops.pallas.nms_kernel import pallas_nms  # noqa: E402
from retinanet_torch.ops import nms_kernel  # noqa: E402
from retinanet_torch.ops.nms import (  # noqa: E402
    batched_nms, compact_nms_plain, scan_nms_plain)
from retinanet_torch.ops.nms_kernel import (  # noqa: E402
    COMPACT_MAX_CANDIDATES, COMPACT_QUEUE, COMPACT_WARPS, SCAN_WARPS,
    launch_design, nms_design, nms_lanes)
from test_torch_threads import one_thread  # noqa: E402,F401

SOFT_MODES = {"sigma=0.25": (1.0, 0.25), "sigma=0": (0.5, 0.0)}


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


def _case(name):
    """(boxes (L, k, 4), scores (L, k), max_det, score_thr) for a hard or
    a soft case; the IoU threshold is the mode's."""
    rng = np.random.default_rng(23)
    if name.startswith("k="):
        return (*_lanes(rng, 2, int(name[2:])), 100, 0.05)
    boxes, scores = _lanes(rng, 3, 1500)
    md, thr = 60, 0.05
    if name == "in_order":
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    elif name == "ties":
        scores = np.round(scores * 8) / 8          # nine levels, zeros too
    elif name == "ties_in_order":
        scores = -np.sort(-np.round(scores * 8) / 8, axis=1)
    elif name == "all_equal":
        scores[:] = 0.5
    elif name == "duplicates":
        boxes[:, 750:] = boxes[:, :750]            # IoU exactly 1
        scores[:, 750:] = scores[:, :750]
    elif name == "one_box":
        boxes[:] = boxes[:, :1]
    elif name == "at_threshold":
        scores = np.round(scores * 10) / 10
        thr = float(np.float32(0.3))               # equal is not picked
        assert (scores == np.float32(0.3)).any()
    elif name == "threshold_0":
        scores[:, ::2] = 0.0
        scores[:, 1::4] = -0.0
        thr = 0.0
    elif name == "iou_at_threshold":
        # corners on a grid of eighths: many IoUs exactly 1/2 or 1/3
        xy = rng.integers(0, 6, (3, 1500, 2)) / 8
        wh = rng.integers(1, 4, (3, 1500, 2)) / 8
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    elif name == "trained_like":
        scores = (scores * 0.06).astype(np.float32)  # few clear 0.05
    elif name == "max_det_above_k":
        boxes, scores, md = boxes[:, :1100], scores[:, :1100], 1200
    elif name != "unsorted":
        raise ValueError(name)
    return (np.ascontiguousarray(boxes), np.ascontiguousarray(scores), md,
            thr)


CASES = ["unsorted", "in_order", "ties", "ties_in_order", "all_equal",
         "duplicates", "one_box", "at_threshold", "threshold_0",
         "iou_at_threshold", "trained_like", "max_det_above_k", "k=1025",
         "k=2048", "k=5000"]


def _equal(got, want):
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for label, g, w in zip(("indices", "scores", "valid"), got, want):
        assert g.shape == w.shape, label
        assert torch.equal(g, w), label


def _close(got, want):
    """Indices and valid counts exact, scores to rtol 1e-5, atol 1e-6."""
    got = [np.asarray(t) for t in got]
    want = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CASES + ["signed_zeros",
                                          "threshold_at_suppressed"])
def test_scan_equals_rounds(name):
    if name == "signed_zeros":
        boxes, scores, md, _ = _case("unsorted")
        scores[:, ::2], scores[:, 1::2], thr = 0.0, -0.0, -1.0
    elif name == "threshold_at_suppressed":
        boxes, scores, md, _ = _case("unsorted")
        scores[:, 5], thr = -2e10, -1e10
    else:
        boxes, scores, md, thr = _case(name)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    work = {}
    got = scan_nms_plain(b, s, md, 0.5, thr, chunk=32 * SCAN_WARPS,
                         work=work)
    want = batched_nms(b, s, md, 0.5, thr)
    _equal(got, want)
    valid = got[2]
    # a lane decides at least its picks; each pick is tested against those
    # before it
    assert valid.sum().item() <= work["visited"]
    assert work["pairs"] >= int((valid * (valid - 1) // 2).sum())
    if name == "at_threshold":
        assert (got[1][got[1] > -0.5] > thr).all()
    if name == "max_det_above_k":
        assert (valid <= boxes.shape[1]).all()


@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("name", CASES)
def test_compact_equals_rounds(name, mode):
    boxes, scores, md, thr = _case(name)
    iou_thr, sigma = SOFT_MODES[mode]
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    work = {}
    got = compact_nms_plain(b, s, md, iou_thr, thr, sigma,
                            threads=32 * COMPACT_WARPS, work=work)
    _equal(got, batched_nms(b, s, md, iou_thr, thr, sigma, True))
    assert 0 <= work["decayed"] <= work["alive"]
    assert work["staged"] == int((s > thr).sum())
    if name == "at_threshold":
        assert (got[1][got[1] > -0.5] > thr).all()


def test_plain_models_refuse_their_thresholds():
    """The compact model refuses a threshold under 0; the scan's takes
    every threshold (under -1e10 its tail, tests/test_torch_nms_wide.py)."""
    boxes, scores = (torch.from_numpy(x) for x in
                     _lanes(np.random.default_rng(1), 1, 8))
    for thr in (float("-inf"), -2e10, float("nan")):
        _equal(scan_nms_plain(boxes, scores, 4, 0.5, thr),
               batched_nms(boxes, scores, 4, 0.5, thr))
    for thr in (float("-inf"), -1e-30, float("nan")):
        with pytest.raises(ValueError, match="score_threshold"):
            compact_nms_plain(boxes, scores, 4, 1.0, thr, 0.25)


@functools.lru_cache(maxsize=None)
def _jax_lanes(md, iou_thr, thr, sigma, soft):
    return jax.jit(jax.vmap(functools.partial(
        jax_nms_select, max_detections=md, iou_threshold=iou_thr,
        score_threshold=thr, soft_nms_sigma=sigma, soft=soft)))


@pytest.mark.parametrize("mode", ["hard", "sigma=0.25", "sigma=0"])
@pytest.mark.parametrize("lanes,k", [(2, 1025), (4, 1500), (1, 2048)],
                         ids=["k=1025", "k=1500", "k=2048"])
def test_long_lanes_match_jax(mode, lanes, k):
    """`nms_lanes` on the CPU (`batched_nms`) and the plain model of the
    design the card takes against the JAX package's XLA `nms_select`
    (vmapped) and its Pallas kernel in interpret mode."""
    md = 40
    boxes, scores = _lanes(np.random.default_rng(lanes * k), lanes, k)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    soft = mode != "hard"
    iou_thr, sigma = SOFT_MODES[mode] if soft else (0.5, 0.0)
    got = nms_lanes(b, s, md, iou_thr, 0.05, sigma, soft)
    if soft:
        _equal(compact_nms_plain(b, s, md, iou_thr, 0.05, sigma,
                                 threads=32 * COMPACT_WARPS), got)
    else:
        _equal(scan_nms_plain(b, s, md, iou_thr, 0.05,
                              chunk=32 * SCAN_WARPS), got)
    ref = _jax_lanes(md, iou_thr, 0.05, sigma, soft)(jnp.asarray(boxes),
                                                     jnp.asarray(scores))
    pal = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), md,
                     iou_threshold=iou_thr, score_threshold=0.05,
                     soft_nms_sigma=sigma, soft=soft, interpret=True)
    for want in ((ref.indices, ref.scores, ref.valid), pal):
        _close([t.numpy() for t in got], want)


# -- numpy walks of the two kernels ------------------------------------------


def _over(p, c, iou_thr):
    """IoU > iou_thr of one pick box p (4,) against boxes c (n, 4), in the
    kernels' float32 terms (the IEEE division `over_threshold` answers)."""
    f = np.float32
    iw = np.maximum(np.minimum(p[2], c[:, 2]) - np.maximum(p[0], c[:, 0]),
                    f(0))
    ih = np.maximum(np.minimum(p[3], c[:, 3]) - np.maximum(p[1], c[:, 1]),
                    f(0))
    inter = iw * ih
    uni = np.maximum(_area(p[None])[0] + _area(c) - inter, f(1e-8))
    return inter / uni > f(iou_thr), inter, uni


def _area(b):
    f = np.float32
    return (np.maximum(b[:, 2] - b[:, 0], f(0))
            * np.maximum(b[:, 3] - b[:, 1], f(0)))


def _scan_key(s, j):
    """`scan_key` of csrc/nms.cu: ascending keys are scores descending
    (-0.0 as 0.0), then lower index first."""
    u = (s.astype(np.float32) + np.float32(0)).view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return ((~u).astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64)


def _bitonic(keys):
    """The scan kernel's sort: the same network of compare-exchanges."""
    keys = keys.copy()
    width = keys.size
    size = 2
    while size <= width:
        stride = size // 2
        while stride > 0:
            i = np.arange(width // 2)
            lo = 2 * i - (i & (stride - 1))
            a, b = keys[lo], keys[lo + stride]
            swap = (a > b) == ((lo & size) == 0)
            keys[lo] = np.where(swap, b, a)
            keys[lo + stride] = np.where(swap, a, b)
            stride //= 2
        size *= 2
    return keys


def _walk_scan(boxes, scores, md, iou_thr, thr):
    """`nms_scan_kernel` lane by lane: the vote, the sort of a lane not in
    order, chunks of 32 * SCAN_WARPS ranks tested by their threads against
    the picks before the chunk, then warp 0's resolution of each warp's
    survivors (against the chunk's earlier picks, then leader by leader)."""
    threads = 32 * SCAN_WARPS
    lanes, k = scores.shape
    idx = np.zeros((lanes, md), np.int32)
    out = np.full((lanes, md), -1.0, np.float32)
    valid = np.zeros(lanes, np.int32)
    for lane in range(lanes):
        s, b = scores[lane], boxes[lane]
        n = int((s > np.float32(thr)).sum())
        if bool((s[:-1] >= s[1:]).all()):
            order = np.arange(n)
        else:
            j = np.flatnonzero(s > np.float32(thr))
            width = 1 << max(0, (n - 1).bit_length())
            keys = np.full(width, np.iinfo(np.uint64).max, np.uint64)
            keys[:n] = _scan_key(s[j], j)
            order = (_bitonic(keys)[:n] & np.uint64(0xffffffff)).astype(
                np.int64)
        picks = []
        for base in range(0, n, threads):
            if len(picks) >= md:
                break
            rank = base + np.arange(threads)
            cand = order[np.minimum(rank, n - 1)]
            alive = rank < n
            cb = b[cand]
            for p in picks:
                alive &= ~_over(b[p], cb, iou_thr)[0]
            first = len(picks)
            for w in range(SCAN_WARPS):
                warp = slice(32 * w, 32 * w + 32)
                al = alive[warp].copy()
                for p in picks[first:]:
                    al &= ~_over(b[p], cb[warp], iou_thr)[0]
                while al.any() and len(picks) < md:
                    lead = int(np.argmax(al))
                    picks.append(int(cand[warp][lead]))
                    al[lead] = False
                    al &= ~_over(cb[warp][lead], cb[warp], iou_thr)[0]
        valid[lane] = len(picks)
        idx[lane, :len(picks)] = picks
        out[lane, :len(picks)] = s[picks]
    return idx, out, valid


def _walk_compact(boxes, scores, md, iou_thr, thr, sigma):
    """`nms_compact_kernel` lane by lane: staging in index order (position p
    = slot p // T of thread p % T), each warp's best (score bits, index) to
    the partials, the pick, each warp's slots decayed with its queue
    flushed before it could overflow (scales in numpy's float32 `exp`),
    and, once a quarter of a thread's slots are gone, the candidates gone
    leaving them in order."""
    f = np.float32
    threads = 32 * COMPACT_WARPS
    lanes, k = scores.shape
    slots = -(-k // threads)
    no_overlap = f(0) if iou_thr >= 0 else f(-1)
    idx_out = np.zeros((lanes, md), np.int32)
    out = np.full((lanes, md), -1.0, np.float32)
    valid = np.zeros(lanes, np.int32)
    t_of = np.arange(threads)
    for lane in range(lanes):
        s, b = scores[lane], boxes[lane]
        j = np.flatnonzero(s > f(thr))
        n = j.size
        cap = slots * threads
        box = np.zeros((cap, 4), f)
        sc = np.zeros(cap, f)
        idx = np.zeros(cap, np.int64)
        box[:n], sc[:n], idx[:n] = b[j], s[j], j
        m = np.maximum(0, (n - t_of + threads - 1) // threads)
        for r in range(md):
            # each thread's best: its first slot among equal scores
            held = np.where(np.arange(slots)[:, None] < m[None],
                            sc.reshape(slots, threads), f(0))
            slot = np.argmax(held, axis=0)
            key = held[slot, t_of].view(np.uint32)
            at = slot * threads + t_of
            tops, picks_w = [], []
            for w in range(COMPACT_WARPS):
                kw_, aw = key[32 * w:32 * w + 32], at[32 * w:32 * w + 32]
                top = kw_.max()
                mine = np.where((kw_ == top) & (kw_ != 0), idx[aw],
                                np.iinfo(np.int64).max)
                tops.append(top)
                picks_w.append((mine.min(), aw[np.argmin(mine)]))
            top = max(tops)
            if top == 0:
                break
            pick, where_ = min(picks_w[w] for w in range(COMPACT_WARPS)
                               if tops[w] == top)
            idx_out[lane, r] = pick
            out[lane, r] = np.uint32(top).view(f)
            pbox = box[where_].copy()
            sc[where_] = f(0)                      # the pick leaves
            for w in range(COMPACT_WARPS):
                lanes_w = t_of[32 * w:32 * w + 32]
                queue = []
                for i in range(int(m[lanes_w].max())):
                    if sigma > 0 and len(queue) > COMPACT_QUEUE - 32:
                        _flush(queue, sc, iou_thr, thr, sigma)
                        queue = []
                    a = i * threads + lanes_w
                    hit, inter, uni = _over(pbox, box[a], iou_thr)
                    live = (i < m[lanes_w]) & (sc[a] > 0)
                    if sigma > 0:
                        need = live & (inter > no_overlap)
                        queue += list(zip(inter[need], uni[need], a[need]))
                        assert len(queue) <= COMPACT_QUEUE
                    else:
                        sc[a[live & hit]] = f(0)
                _flush(queue, sc, iou_thr, thr, sigma)
            # once a quarter of a thread's slots are gone, the candidates
            # gone leave them, in order
            grid = np.arange(slots)[:, None] * threads + t_of[None]
            keep = (sc[grid] > 0) & (np.arange(slots)[:, None] < m[None])
            packs = 4 * (m - keep.sum(axis=0)) > m
            for t in np.flatnonzero(packs):
                a = grid[keep[:, t], t]
                to = grid[:a.size, t]
                box[to], sc[to], idx[to] = box[a], sc[a], idx[a]
            m = np.where(packs, keep.sum(axis=0), m)
        valid[lane] = int((out[lane] > -0.5).sum())
    return idx_out, out, valid


def _flush(queue, sc, iou_thr, thr, sigma):
    f = np.float32
    for inter, uni, a in queue:
        q = inter / uni
        scale = np.exp(-(q * q) / f(2.0 * sigma)).astype(f)
        scale = f(0) if q > f(iou_thr) else scale
        v = sc[a] * scale
        sc[a] = v if v > f(thr) else f(0)


@pytest.mark.parametrize("name", ["unsorted", "in_order", "ties",
                                  "ties_in_order", "duplicates",
                                  "iou_at_threshold", "trained_like",
                                  "k=1025", "k=2048"])
def test_scan_walk_equals_rounds(name):
    boxes, scores, md, thr = _case(name)
    got = _walk_scan(boxes, scores, md, 0.5, thr)
    want = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       md, 0.5, thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("name", ["unsorted", "ties", "one_box",
                                  "threshold_0", "trained_like", "k=1025"])
def test_compact_walk_equals_rounds(name, mode):
    boxes, scores, md, thr = _case(name)
    boxes, scores, md = boxes[:1], scores[:1], min(md, 30)
    iou_thr, sigma = SOFT_MODES[mode]
    got = _walk_compact(boxes, scores, md, iou_thr, thr, sigma)
    want = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       md, iou_thr, thr, sigma, True)
    if sigma > 0:
        _close(got, [w.numpy() for w in want])
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def test_wrapper_constants_are_the_kernels():
    """The walks and the plain models take their shapes from
    `ops/nms_kernel.py`; these are csrc/nms.cu's."""
    source = nms_kernel.kernel.source.read_text()

    def constant(pattern):
        return int(re.search(pattern, source).group(1))

    assert constant(r"constexpr int kScanWarps = (\d+);") == SCAN_WARPS
    assert constant(r"constexpr int kCompactWarps = (\d+);") == COMPACT_WARPS
    assert constant(r"static constexpr int kQueue = (\d+);") == COMPACT_QUEUE
    assert (constant(r"constexpr int kCompactMaxCandidates = (\d+);")
            == COMPACT_MAX_CANDIDATES)


@pytest.mark.parametrize("soft,k,thr,want", [
    (False, 1025, 0.05, "scan"),             # nms_top_k over 1,024
    (False, 5000, 0.05, "scan"),             # every config's pre_nms_top_k
    (False, 5000, -1e10, "scan"),            # at the suppression score
    (False, 76725, 0.05, "scan"),            # no cap in hard mode
    (False, 5000, -2e10, "scan"),            # its tail picks at -1e10
    (True, 1025, 0.05, "compact"),
    (True, 5000, 0.0, "compact"),            # exactly 0: +0.0 is not above
    (True, 5000, -0.0, "compact"),
    (True, COMPACT_MAX_CANDIDATES, 0.05, "compact"),
    (True, COMPACT_MAX_CANDIDATES + 1, 0.05, "cluster"),
    (True, 5000, -1e-30, "cluster"),         # negative scores rise to 0
    (True, 5000, float("nan"), "cluster"),
], ids=str)
def test_long_routes(soft, k, thr, want):
    assert nms_design(soft, k, thr) == want


@pytest.mark.parametrize("design,soft,k,thr", [
    ("scan", True, 2000, 0.05),
    ("cluster", False, 2000, -2e10),
    ("compact", False, 2000, 0.05),
    ("compact", True, COMPACT_MAX_CANDIDATES + 1, 0.05),
    ("compact", True, 2000, -0.5),
], ids=str)
def test_launch_design_refuses_what_a_design_does_not_take(design, soft, k,
                                                           thr):
    """Checked before anything touches a device (these tensors lie on the
    CPU)."""
    boxes = torch.zeros((1, k, 4))
    scores = torch.zeros((1, k))
    with pytest.raises(ValueError, match=design):
        launch_design(design, boxes, scores, 10, 0.5, thr, 0.25, soft)


def test_cpu_lanes_past_the_card_cap_take_plain():
    """On the CPU `nms_lanes` is `batched_nms` at any k (on the card every
    k has a design too)."""
    boxes, scores = _lanes(np.random.default_rng(29), 1, 9000)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = nms_kernel.kernel.launches
    got = nms_lanes(b, s, 20, 0.5, 0.05)
    assert nms_kernel.kernel.launches == before
    _equal(got, scan_nms_plain(b, s, 20, 0.5, 0.05, chunk=32 * SCAN_WARPS))
