"""NMS in the lanes that no design took on the card before: the soft modes
past 8,192 candidates and under a negative threshold (the cluster design,
`ops/nms.py:cluster_nms_plain`), and hard mode under a threshold below
-1e10 (the scan's tail, `ops/nms.py:scan_nms_plain`), on the CPU: the plain
models against the round form (`batched_nms`) and the JAX package, numpy
walks of both kernels from the wrapper's constants, and the routes (no
lane goes to the round kernel).

Against `batched_nms` indices, scores and valid counts are compared bit for
bit (the same float32 arithmetic on the same tensors). Against JAX, and in
the cluster walk (numpy's float32 `exp`), indices and valid counts exactly
and scores to rtol 1e-5, atol 1e-6, as in tests/test_torch_nms.py."""

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
    SUPPRESSED, batched_nms, cluster_nms_plain, scan_nms_plain)
from retinanet_torch.ops.nms_kernel import (  # noqa: E402
    CLUSTER_CTA_MAX, CLUSTER_CTA_TARGET, CLUSTER_MAX_CTAS, CLUSTER_QUEUE,
    CLUSTER_WARPS, SCAN_WARPS, cluster_plan, design_takes, nms_design,
    nms_lanes)
from test_torch_nms_long import _over, _walk_scan  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

SOFT_MODES = {"sigma=0.25": (1.0, 0.25), "sigma=0": (0.5, 0.0)}
THRESHOLDS = {"0.05": 0.05, "0": 0.0, "-0.5": -0.5, "-inf": float("-inf")}


def _lanes(rng, lanes, k):
    xy = rng.uniform(0, 0.8, (lanes, k, 2))
    wh = rng.uniform(0.02, 0.3, (lanes, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32).clip(0, 1)
    scores = rng.uniform(0, 1, (lanes, k)).astype(np.float32)
    return boxes, scores


def _soft_case(name):
    """(boxes (L, k, 4), scores (L, k), max_det) of a soft case."""
    rng = np.random.default_rng(41)
    if name.startswith("k="):
        return (*_lanes(rng, 2, int(name[2:])), 20)
    boxes, scores = _lanes(rng, 2, 9000)
    if name == "negative":
        scores = scores - np.float32(0.6)          # most below 0
    elif name == "signed_zeros":
        scores[:, ::3], scores[:, 1::3] = 0.0, -0.0
    elif name == "ties":
        scores = np.round(scores * 8) / 8 - np.float32(0.5)
    elif name == "one_box":
        boxes[:] = boxes[:, :1]
    elif name == "repicks":
        # more rounds than candidates: picked ones (-1e10, scaled towards
        # 0) are picked again under a negative threshold
        boxes, scores = boxes[:, :40], scores[:, :40] - np.float32(0.5)
        return (np.ascontiguousarray(boxes), np.ascontiguousarray(scores),
                120)
    elif name != "unsorted":
        raise ValueError(name)
    return (np.ascontiguousarray(boxes), np.ascontiguousarray(scores), 20)


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


@pytest.mark.parametrize("thr", sorted(THRESHOLDS))
@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("name", ["k=8193", "k=20000", "unsorted",
                                  "negative", "signed_zeros", "ties",
                                  "one_box", "repicks"])
def test_cluster_equals_rounds(name, mode, thr):
    boxes, scores, md = _soft_case(name)
    iou_thr, sigma = SOFT_MODES[mode]
    thr = THRESHOLDS[thr]
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    work = {}
    got = cluster_nms_plain(b, s, md, iou_thr, thr, sigma, work=work)
    _equal(got, batched_nms(b, s, md, iou_thr, thr, sigma, True))
    assert work["staged"] == s.numel()
    assert 0 <= work["decayed"] <= work["alive"]
    if name == "repicks" and (thr == float("-inf") or
                              (sigma == 0.0 and thr < 0)):
        # every round picks, and some candidate more than once: a picked
        # -1e10 is above -inf, and with sigma 0 a suppression makes it -0.0
        assert (got[2] == md).all()
        assert any(len(set(row.tolist())) < md for row in got[0])


def _tail_case(name):
    """(boxes, scores, max_det) of a hard lane under -1e10: every box
    twice, scores of exactly -1e10 and below, more rounds than
    candidates."""
    rng = np.random.default_rng(43)
    boxes, scores = _lanes(rng, 3, 150)
    boxes = np.concatenate([boxes, boxes], 1)
    scores = np.concatenate([scores, scores], 1)
    if name == "mixed":
        scores[0, ::3] = SUPPRESSED
        scores[1, 1::2] = -5e10
        scores[2, 10:] = -2e10
    elif name == "all_below":           # no candidate at or above -1e10
        scores = scores * np.float32(-1e10) - np.float32(2e10)
    elif name == "all_at":
        scores[:] = SUPPRESSED
    elif name == "in_order":
        scores = -np.sort(-scores, axis=1)
        scores[:, 200:] = -4e10
    elif name == "grid":
        # corners on a grid of eighths: many IoUs exactly 1/2
        xy = rng.integers(0, 6, (3, 300, 2)) / 8
        wh = rng.integers(1, 4, (3, 300, 2)) / 8
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        scores[:, ::2] = -3e10
    elif name != "positive":
        raise ValueError(name)
    return (np.ascontiguousarray(boxes, np.float32),
            np.ascontiguousarray(scores, np.float32), 400)


TAIL_CASES = ["positive", "mixed", "all_below", "all_at", "in_order",
              "grid"]
TAIL_THRESHOLDS = {"-inf": float("-inf"), "-3e10": -3e10}


@pytest.mark.parametrize("thr", sorted(TAIL_THRESHOLDS))
@pytest.mark.parametrize("name", TAIL_CASES)
def test_scan_tail_equals_rounds(name, thr):
    boxes, scores, md = _tail_case(name)
    thr = TAIL_THRESHOLDS[thr]
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    work = {}
    got = scan_nms_plain(b, s, md, 0.5, thr, chunk=32 * SCAN_WARPS,
                         work=work)
    want = batched_nms(b, s, md, 0.5, thr)
    _equal(got, want)
    assert md > boxes.shape[1]
    if not (name == "all_below" and thr == -3e10):
        assert (got[2] == md).all()                # re-picks fill the lane
        assert work["tail"] >= 0


def test_nan_threshold_picks_nothing():
    boxes, scores, md = _tail_case("mixed")
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    nan = float("nan")
    _equal(scan_nms_plain(b, s, md, 0.5, nan), batched_nms(b, s, md, 0.5,
                                                           nan))
    assert int(scan_nms_plain(b, s, md, 0.5, nan)[2].sum()) == 0
    for iou_thr, sigma in SOFT_MODES.values():
        _equal(cluster_nms_plain(b, s, md, iou_thr, nan, sigma),
               batched_nms(b, s, md, iou_thr, nan, sigma, True))


@functools.lru_cache(maxsize=None)
def _jax_lanes(md, iou_thr, thr, sigma, soft):
    return jax.jit(jax.vmap(functools.partial(
        jax_nms_select, max_detections=md, iou_threshold=iou_thr,
        score_threshold=thr, soft_nms_sigma=sigma, soft=soft)))


@pytest.mark.parametrize("mode,thr", [
    ("sigma=0.25", 0.05), ("sigma=0", -0.5), ("hard", -3e10)],
    ids=["sigma=0.25-thr=0.05", "sigma=0-thr=-0.5", "hard-thr=-3e10"])
def test_wide_lanes_match_jax(mode, thr):
    """`nms_lanes` on the CPU (`batched_nms`) and the plain model of the
    design the card takes, at k = 9,000, against the JAX package's XLA
    `nms_select` (vmapped) and its Pallas kernel in interpret mode."""
    md, k = 20, 9000
    boxes, scores = _lanes(np.random.default_rng(47), 2, k)
    if mode == "hard":
        scores[0, 100:] = -4e10                    # the tail picks
        md = 120
    elif thr < 0:
        scores = scores - np.float32(0.7)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    soft = mode != "hard"
    iou_thr, sigma = SOFT_MODES[mode] if soft else (0.5, 0.0)
    got = nms_lanes(b, s, md, iou_thr, thr, sigma, soft)
    if soft:
        assert nms_design(True, k, thr) == "cluster"
        _equal(cluster_nms_plain(b, s, md, iou_thr, thr, sigma), got)
    else:
        assert nms_design(False, k, thr) == "scan"
        _equal(scan_nms_plain(b, s, md, iou_thr, thr,
                              chunk=32 * SCAN_WARPS), got)
        assert int(got[2][0]) == md
    ref = _jax_lanes(md, iou_thr, thr, sigma, soft)(jnp.asarray(boxes),
                                                    jnp.asarray(scores))
    pal = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), md,
                     iou_threshold=iou_thr, score_threshold=thr,
                     soft_nms_sigma=sigma, soft=soft, interpret=True)
    for want in ((ref.indices, ref.scores, ref.valid), pal):
        _close([t.numpy() for t in got], want)


# -- numpy walks of the two kernels ------------------------------------------


def _orderable(s):
    """`order_key` of csrc/nms.cu: unsigned keys that order as the floats,
    -0.0 as 0.0."""
    u = (s.astype(np.float32) + np.float32(0)).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint64)


def _walk_cluster(boxes, scores, md, iou_thr, thr, sigma):
    """`nms_cluster_kernel` lane by lane, laid out by `cluster_plan`: CTA r
    holds indices r * per_cta + i * T + t (thread t, slot i); each thread's
    best live slot (the first among equal keys), each warp's (largest key,
    lowest index), the cluster's over the warps' partials, then each
    thread's live slots decayed (with sigma > 0 each warp's intersecting
    pairs queued, at most CLUSTER_QUEUE, and scaled in numpy's float32
    `exp`; with sigma 0 the pairs over the threshold times 0) and the pick
    set to -1e10."""
    f = np.float32
    threads = 32 * CLUSTER_WARPS
    lanes, k = scores.shape
    plan = cluster_plan(k)
    slots = plan.per_cta // threads
    # [cta, slot, thread] -> index, k where the CTA holds none
    grid = (np.arange(plan.ctas)[:, None, None] * plan.per_cta
            + np.arange(slots)[None, :, None] * threads
            + np.arange(threads)[None, None, :])
    grid = np.where(grid < k, grid, k)
    covered = np.sort(grid[grid < k])
    assert np.array_equal(covered, np.arange(k)), "each index once"
    keep_all = not thr >= 0
    no_overlap = f(0) if iou_thr >= 0 else f(-1)
    idx = np.zeros((lanes, md), np.int32)
    out = np.full((lanes, md), -1.0, np.float32)
    valid = np.zeros(lanes, np.int32)
    for lane in range(lanes):
        sc = np.append(scores[lane].astype(f), f(0))
        b = boxes[lane]
        picks = 0
        while picks < md:
            live = (grid < k) & (keep_all | (sc[grid] > f(thr)))
            key = np.where(live, _orderable(sc[grid]), 0)
            slot = np.argmax(key, axis=1)          # [cta, thread]: first
            tkey = np.take_along_axis(key, slot[:, None], 1)[:, 0]
            tidx = np.take_along_axis(grid, slot[:, None], 1)[:, 0]
            tidx = np.where(tkey > 0, tidx, np.iinfo(np.int64).max)
            wkey = tkey.reshape(plan.ctas, CLUSTER_WARPS, 32)
            widx = tidx.reshape(plan.ctas, CLUSTER_WARPS, 32)
            ptop = wkey.max(axis=2)                # the partials
            pidx = np.where(wkey == ptop[..., None], widx,
                            np.iinfo(np.int64).max).min(axis=2)
            top = ptop.max()
            if top == 0:
                break
            pick = int(pidx[ptop == top].min())
            raw = sc[pick]
            if not raw > f(thr):
                break
            idx[lane, picks], out[lane, picks] = pick, raw
            picks += 1
            hit, inter, uni = _over(b[pick], b, iou_thr)
            alive = keep_all | (sc[:k] > f(thr))
            if sigma > 0:
                # each warp's slots in order, its intersecting pairs queued
                # and flushed before the queue could overflow
                need = np.append(alive & (inter > no_overlap), False)
                for cta in range(plan.ctas):
                    for w in range(CLUSTER_WARPS):
                        queue = []
                        for i in range(slots):
                            if len(queue) > CLUSTER_QUEUE - 32:
                                _flush(queue, sc, inter, uni, iou_thr,
                                       sigma)
                                queue = []
                            a = grid[cta, i, 32 * w:32 * w + 32]
                            queue += list(a[need[a]])
                            assert len(queue) <= CLUSTER_QUEUE
                        _flush(queue, sc, inter, uni, iou_thr, sigma)
            else:
                need = alive & hit
                sc[:k][need] = sc[:k][need] * f(0)
            sc[pick] = f(SUPPRESSED)
        valid[lane] = picks
    return idx, out, valid


def _flush(queue, sc, inter, uni, iou_thr, sigma):
    """A warp's queued pairs scaled: numpy's float32 `exp`."""
    f = np.float32
    for a in queue:
        q = inter[a] / uni[a]
        scale = np.exp(-(q * q) / f(2.0 * sigma)).astype(f)
        sc[a] = sc[a] * (f(0) if q > f(iou_thr) else scale)


@pytest.mark.parametrize("thr", ["0.05", "-0.5"])
@pytest.mark.parametrize("mode", sorted(SOFT_MODES))
@pytest.mark.parametrize("name", ["k=8193", "negative", "ties", "repicks"])
def test_cluster_walk_equals_rounds(name, mode, thr):
    boxes, scores, md = _soft_case(name)
    boxes, scores, md = boxes[:1], scores[:1], min(md, 60)
    iou_thr, sigma = SOFT_MODES[mode]
    thr = THRESHOLDS[thr]
    got = _walk_cluster(boxes, scores, md, iou_thr, thr, sigma)
    want = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       md, iou_thr, thr, sigma, True)
    if sigma > 0:
        _close(got, [w.numpy() for w in want])
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def _walk_scan_tail(boxes, scores, md, iou_thr, thr):
    """`nms_scan_kernel` under a threshold below -1e10: the ordered pass
    over the candidates above -1e10 (`_walk_scan`), then a lane with picks
    left: the lowest index at or above -1e10, lowered chunk by chunk of
    32 * SCAN_WARPS indices under it to the lowest one an ordered pick
    suppresses (else, with no ordered pick and no such index, the arg-max,
    the first index of the largest orderable score, at its own score if
    above the threshold), then chunk by chunk under the last pick the
    lowest index it suppresses, else the last pick in every slot left."""
    f = np.float32
    chunk = 32 * SCAN_WARPS
    idx, out, valid = _walk_scan(boxes, scores, md, iou_thr, SUPPRESSED)
    for lane in range(scores.shape[0]):
        s, b = scores[lane], boxes[lane]
        picks = int(valid[lane])
        if picks >= md:
            continue
        at = np.flatnonzero(s >= f(SUPPRESSED))
        if at.size:
            p, ps = int(at[0]), f(SUPPRESSED)
            for j0 in range(0, p, chunk):
                j = np.arange(j0, min(j0 + chunk, p))
                hit = np.zeros(j.size, bool)
                for q in idx[lane, :picks]:
                    hit |= _over(b[q], b[j], iou_thr)[0]
                if hit.any():
                    p = int(j[hit][0])
                    break
        else:
            key = (_orderable(s) << np.uint64(32)) | (
                np.uint64(0xffffffff) - np.arange(s.size, dtype=np.uint64))
            p = int(np.uint64(0xffffffff)
                    - (key.max() & np.uint64(0xffffffff)))
            ps = s[p]
            if not ps > f(thr):
                continue
        while True:
            idx[lane, picks], out[lane, picks] = p, ps
            picks += 1
            ps = f(SUPPRESSED)
            if picks >= md:
                break
            q = None
            for j0 in range(0, p, chunk):
                j = np.arange(j0, min(j0 + chunk, p))
                hit = _over(b[p], b[j], iou_thr)[0]
                if hit.any():
                    q = int(j[hit][0])
                    break
            if q is None:
                idx[lane, picks:], out[lane, picks:] = p, f(SUPPRESSED)
                picks = md
                break
            p = q
        valid[lane] = picks
    return idx, out, valid


@pytest.mark.parametrize("thr", sorted(TAIL_THRESHOLDS))
@pytest.mark.parametrize("name", TAIL_CASES)
def test_scan_tail_walk_equals_rounds(name, thr):
    boxes, scores, md = _tail_case(name)
    thr = TAIL_THRESHOLDS[thr]
    got = _walk_scan_tail(boxes, scores, md, 0.5, thr)
    want = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       md, 0.5, thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_cluster_constants_are_the_kernels():
    """The walk and `cluster_plan` take their numbers from
    `ops/nms_kernel.py`; these are csrc/nms.cu's."""
    source = nms_kernel.kernel.source.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kClusterWarps") == CLUSTER_WARPS
    assert constant("kClusterMaxCtas") == CLUSTER_MAX_CTAS
    assert constant("kClusterCtaTarget") == CLUSTER_CTA_TARGET
    assert constant("kClusterCtaMax") == CLUSTER_CTA_MAX
    assert constant("kClusterQueue") == CLUSTER_QUEUE
    # on chip: 20 B a candidate, the partials and the queues within 227 KB
    assert (CLUSTER_CTA_MAX * 20 + 2 * CLUSTER_WARPS * 32
            + CLUSTER_WARPS * CLUSTER_QUEUE * 12) <= 227 * 1024
    # the flagship's per-class lanes (76,725 anchors) fit on chip
    assert cluster_plan(76725).on_chip


@pytest.mark.parametrize("k,want", [
    (1, (1, 512, True)), (4096, (1, 4096, True)), (4097, (2, 2560, True)),
    (5000, (2, 2560, True)), (8192, (2, 4096, True)),
    (8193, (2, 4608, True)), (10000, (2, 5120, True)),
    (16384, (2, 8192, True)), (16385, (4, 4608, True)),
    (76725, (8, 9728, True)), (81920, (8, 10240, True)),
    (81921, (8, 10752, False)), (306900, (8, 38400, False))], ids=str)
def test_cluster_plan(k, want):
    plan = cluster_plan(k)
    assert tuple(plan) == want
    assert plan.ctas * plan.per_cta >= k
    assert plan.per_cta % (32 * CLUSTER_WARPS) == 0


def test_cluster_plan_takes_a_cluster_size():
    assert tuple(cluster_plan(16384, ctas=4)) == (4, 4096, True)
    assert tuple(cluster_plan(16384, ctas=1)) == (1, 16384, False)
    for ctas in (0, CLUSTER_MAX_CTAS + 1):
        with pytest.raises(ValueError, match="cluster"):
            cluster_plan(100, ctas)


ROUTE_KS = (1, 77, 256, 1024, 1025, 5000, 8192, 8193, 10000, 16384, 76725,
            306900)


@pytest.mark.parametrize("thr", [0.05, 0.0, -0.0, -1e-30, -0.5, -1e10,
                                 -2e10, -3e10, float("-inf"),
                                 float("nan")], ids=str)
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_every_lane_has_a_design_other_than_rounds(soft, thr):
    """For every k a lane can hold (the flagship's 76,725 anchors and
    1280's 306,900 included) and every threshold, `nms_design` names a
    design that takes the lane, never the round kernel: the card raises
    for no k."""
    for k in ROUTE_KS:
        design = nms_design(soft, k, thr)
        assert design != "rounds"
        assert design_takes(design, soft, k, thr), (design, k)
    assert design_takes("rounds", soft, 8192, thr)
    assert not design_takes("rounds", soft, 8193, thr)
