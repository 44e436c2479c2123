"""Greedy (soft-)NMS in plain PyTorch (counterpart of
`retinanet_tpu/ops/nms.py`).

This is the plain version of the CUDA kernel in `ops/nms_kernel.py`: the
CPU path of the wrapper and the yardstick the kernel is held to on the card.

Each of `max_detections` rounds picks the first-index argmax, stops the lane
for good once that score is not above `score_threshold`, takes the IoU of
the pick against every candidate and suppresses:
  * hard: IoU > iou_threshold -> -1e10;
  * soft, sigma > 0: score *= exp(-iou^2 / (2 sigma)), zeroed past the
    threshold (NonMaxSuppressionV5; callers pass sigma/2 and threshold 1.0);
  * soft, sigma = 0: keep only IoU <= iou_threshold;
and finally sets the pick itself to -1e10. The box area is
max(x2-x1, 0) * max(y2-y1, 0) and the union is clamped at 1e-8.

`sweep_nms_plain` is hard mode again as the sweep kernel of `csrc/nms.cu`
computes it: one stable sort, then one pass over the ranks.
`decay_nms_plain` is the soft modes as the decay kernel computes them: the
candidates above the threshold staged in index order over a warp's 32
threads, a candidate that falls to the threshold gone for good, and each
round's pick by (largest score bits, lowest position).
`scan_nms_plain` is hard mode as the scan kernel computes it past 1,024
candidates: the order, then chunks of ranks tested against the picks made
before them and resolved in order. `compact_nms_plain` is the soft modes as
the compact kernel computes them: each thread's slots, a candidate gone
leaving them, the pick by (largest score bits, lowest index). The CPU tests
hold all four against `batched_nms`; nothing on a main path calls them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from retinanet_torch.core.device import device_constant

SUPPRESSED = -1e10  # the score of a suppressed or picked candidate


class NMSResult(NamedTuple):
    indices: torch.Tensor  # (max_det,) int32 into the candidate axis
    scores: torch.Tensor   # (max_det,) float32; -1 for empty slots
    valid: torch.Tensor    # () int32 number of selections


def _areas(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)


def batched_nms(boxes: torch.Tensor,
                scores: torch.Tensor,
                max_detections: int,
                iou_threshold: float = 0.5,
                score_threshold: float = float("-inf"),
                soft_nms_sigma: float = 0.0,
                soft: bool = False) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Greedy NMS over L independent lanes.

    boxes: (L, k, 4) corners; scores: (L, k). Returns (indices (L, max_det)
    int32, -1 padded then clamped to 0; scores (L, max_det) float32, -1
    where empty; valid (L,) int32)."""
    boxes = boxes.to(torch.float32)
    cur = scores.to(torch.float32)
    lanes = cur.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)                          # (L, k)
    area = _areas(boxes)
    # a tensor divisor keeps this an IEEE division on every device (a Python
    # scalar divisor becomes a multiply by its reciprocal on CUDA)
    two_sigma = device_constant((2.0 * soft_nms_sigma,), torch.float32,
                                cur.device)
    out_idx, out_scores = [], []
    for _ in range(max_detections):
        idx = torch.argmax(cur, dim=1, keepdim=True)           # (L, 1)
        best = torch.gather(cur, 1, idx)                       # (L, 1)
        ok = best > score_threshold
        sel = torch.gather(boxes, 1, idx[..., None].expand(lanes, 1, 4))
        sx1, sy1, sx2, sy2 = sel.unbind(-1)                    # (L, 1)
        sarea = _areas(sel)
        iw = torch.clamp_min(torch.minimum(sx2, x2) - torch.maximum(sx1, x1),
                             0.0)
        ih = torch.clamp_min(torch.minimum(sy2, y2) - torch.maximum(sy1, y1),
                             0.0)
        inter = iw * ih
        union = torch.clamp_min(sarea + area - inter, 1e-8)
        iou = inter / union
        if soft:
            if soft_nms_sigma > 0.0:
                scale = torch.exp(-(iou * iou) / two_sigma)
                scale = torch.where(iou > iou_threshold, 0.0, scale)
            else:
                scale = (iou <= iou_threshold).to(torch.float32)
            new = cur * scale
        else:
            new = torch.where(iou > iou_threshold, SUPPRESSED, cur)
        new = new.scatter(1, idx, SUPPRESSED)
        cur = torch.where(ok, new, cur)
        out_idx.append(torch.where(ok, idx, -1))
        out_scores.append(torch.where(ok, best, -1.0))
    indices = torch.cat(out_idx, dim=1).to(torch.int32)
    valid = (indices >= 0).sum(dim=1, dtype=torch.int32)
    return (torch.clamp_min(indices, 0), torch.cat(out_scores, dim=1),
            valid)


def sweep_nms_plain(boxes: torch.Tensor,
                    scores: torch.Tensor,
                    max_detections: int,
                    iou_threshold: float = 0.5,
                    score_threshold: float = 0.0) -> Tuple[torch.Tensor,
                                                           torch.Tensor,
                                                           torch.Tensor]:
    """Hard greedy NMS as a sorted sweep; the results of `batched_nms`.

    Hard NMS visits its candidates in one fixed order, score descending and
    lower index first among equals: a suppressed candidate sits at -1e10 and
    is never picked again, provided `score_threshold >= -1e10` (else this
    raises). So the candidates above the threshold are ordered once, and
    rank after rank a candidate still alive is picked and suppresses the
    later ranks whose IoU with it exceeds `iou_threshold`. IoU is symmetric
    bit for bit, so "against the later ones" decides as "against all"."""
    if not score_threshold >= SUPPRESSED:
        raise ValueError(f"the sweep needs score_threshold >= {SUPPRESSED}, "
                         f"got {score_threshold}")
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    lanes, k = scores.shape
    # + 0.0 turns -0.0 into 0.0, which `argmax` ties with it
    order = torch.sort(scores + 0.0, dim=1, descending=True,
                       stable=True).indices                    # (L, k)
    ranked = torch.gather(scores, 1, order)
    ranked_boxes = torch.gather(boxes, 1,
                                order[..., None].expand(lanes, k, 4))
    x1, y1, x2, y2 = ranked_boxes.unbind(-1)
    area = _areas(ranked_boxes)
    alive = ranked > score_threshold
    count = torch.zeros((lanes,), dtype=torch.int64, device=scores.device)
    out_idx = torch.zeros((lanes, max_detections + 1), dtype=torch.int64,
                          device=scores.device)
    out_scores = torch.full((lanes, max_detections + 1), -1.0,
                            device=scores.device)
    for r in range(k):
        pick = alive[:, r] & (count < max_detections)          # (L,)
        # a lane that does not pick writes to the spare last slot
        slot = torch.where(pick, count, max_detections)[:, None]
        out_idx.scatter_(1, slot, order[:, r:r + 1])
        out_scores.scatter_(1, slot, ranked[:, r:r + 1])
        count = count + pick
        s = slice(r + 1, k)
        iw = torch.clamp_min(torch.minimum(x2[:, r:r + 1], x2[:, s])
                             - torch.maximum(x1[:, r:r + 1], x1[:, s]), 0.0)
        ih = torch.clamp_min(torch.minimum(y2[:, r:r + 1], y2[:, s])
                             - torch.maximum(y1[:, r:r + 1], y1[:, s]), 0.0)
        inter = iw * ih
        union = torch.clamp_min(area[:, r:r + 1] + area[:, s] - inter, 1e-8)
        hit = (inter / union > iou_threshold) & pick[:, None]
        alive[:, s] &= ~hit
    return (out_idx[:, :max_detections].to(torch.int32),
            out_scores[:, :max_detections], count.to(torch.int32))


def _decay(boxes, area, cur, idx, iou_threshold, score_threshold,
           soft_nms_sigma, two_sigma):
    """One round's decay of the alive scores `cur` (L, k), +0.0 for a
    candidate gone, against the picks `idx` (L, 1), as the decay and
    compact kernels take it: `batched_nms`'s arithmetic on the same
    tensors, a score not above the threshold set to +0.0, and a pair with no
    intersection keeping its score (its scale is exactly 1 unless 0 is past
    the IoU threshold). Returns the new scores (the pick at +0.0), the
    alive candidates and those decayed."""
    lanes = cur.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    sel = torch.gather(boxes, 1, idx[..., None].expand(lanes, 1, 4))
    sx1, sy1, sx2, sy2 = sel.unbind(-1)                        # (L, 1)
    sarea = _areas(sel)
    iw = torch.clamp_min(torch.minimum(sx2, x2) - torch.maximum(sx1, x1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(sy2, y2) - torch.maximum(sy1, y1),
                         0.0)
    inter = iw * ih
    union = torch.clamp_min(sarea + area - inter, 1e-8)
    iou = inter / union
    alive = cur > 0
    if soft_nms_sigma > 0.0:
        scale = torch.exp(-(iou * iou) / two_sigma)
        scale = torch.where(iou > iou_threshold, 0.0, scale)
        decayed = cur * scale
        decayed = torch.where(decayed > score_threshold, decayed, 0.0)
        needed = alive & ((inter > 0) | (not iou_threshold >= 0.0))
        new = torch.where(needed, decayed, cur)
    else:
        needed = alive
        new = torch.where(iou > iou_threshold, 0.0, cur)
    return new.scatter(1, idx, 0.0), alive, needed


def decay_nms_plain(boxes: torch.Tensor,
                    scores: torch.Tensor,
                    max_detections: int,
                    iou_threshold: float = 1.0,
                    score_threshold: float = 0.05,
                    soft_nms_sigma: float = 0.0,
                    work: Optional[dict] = None) -> Tuple[torch.Tensor,
                                                          torch.Tensor,
                                                          torch.Tensor]:
    """Soft greedy NMS as the decay kernel computes it; the results of
    `batched_nms(..., soft=True)`.

    Every scale lies in [0, 1], so with `score_threshold >= 0` (else this
    raises) a score that is not above the threshold never rises above it
    again: it is set to +0.0 and leaves the lane. The candidates above the
    threshold are staged in index order at positions 0 .. n-1; thread
    t = p % 32 of the lane's warp holds position p in its slot p // 32. A
    round takes each thread's largest score (the first slot among equals),
    the largest of those by its bits (alive scores are > 0), and the lowest
    position holding it, which is the lowest index. The decay is `_decay`.
    `work`, if given, gains the candidates staged (above the threshold)
    under "staged", the (alive candidate, round) pairs under "alive" and
    those the kernel decays under "decayed"."""
    if not score_threshold >= 0.0:
        raise ValueError(f"the decay design needs score_threshold >= 0, "
                         f"got {score_threshold}")
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    lanes, k = scores.shape
    device = scores.device
    area = _areas(boxes)
    two_sigma = device_constant((2.0 * soft_nms_sigma,), torch.float32,
                                device)
    above = scores > score_threshold
    n = above.sum(dim=1, keepdim=True)                         # (L, 1)
    width = 32 * max(1, -(-k // 32))                           # positions
    # position -> candidate: the ones above the threshold in index order
    order = torch.sort((~above).to(torch.int8), dim=1, stable=True).indices
    order = torch.cat([order, order.new_zeros((lanes, width - k))], 1)
    staged = torch.arange(width, device=device)[None] < n      # (L, width)
    if work is not None:
        work["staged"] = work.get("staged", 0) + int(n.sum())
    position = torch.arange(width, device=device).view(width // 32, 32)
    cur = torch.where(above, scores, 0.0)   # the kernel's scores, by index
    out_idx, out_scores = [], []
    for _ in range(max_detections):
        held = torch.where(staged, torch.gather(cur, 1, order), 0.0)
        held = held.view(lanes, width // 32, 32)               # [slot, t]
        slot = torch.argmax(held, dim=1, keepdim=True)         # first slot
        key = torch.gather(held, 1, slot)[:, 0].view(torch.int32)  # (L, 32)
        top = key.max(dim=1, keepdim=True).values              # (L, 1)
        pos = torch.where(key == top, slot[:, 0] * 32 + position[0],
                          width).min(dim=1, keepdim=True).values
        ok = top > 0
        pos = torch.where(ok, pos, 0)
        idx = torch.gather(order, 1, pos)                      # (L, 1)
        new, alive, needed = _decay(boxes, area, cur, idx, iou_threshold,
                                    score_threshold, soft_nms_sigma,
                                    two_sigma)
        cur = torch.where(ok, new, cur)
        out_idx.append(torch.where(ok, idx, -1))
        out_scores.append(torch.where(ok, top.view(torch.float32), -1.0))
        if work is not None:
            work["alive"] = work.get("alive", 0) + int((alive & ok).sum())
            work["decayed"] = (work.get("decayed", 0)
                               + int((needed & ok).sum()))
    indices = torch.cat(out_idx, dim=1).to(torch.int32)
    valid = (indices >= 0).sum(dim=1, dtype=torch.int32)
    return (torch.clamp_min(indices, 0), torch.cat(out_scores, dim=1),
            valid)


def compact_nms_plain(boxes: torch.Tensor,
                      scores: torch.Tensor,
                      max_detections: int,
                      iou_threshold: float = 1.0,
                      score_threshold: float = 0.05,
                      soft_nms_sigma: float = 0.0,
                      threads: int = 512,
                      work: Optional[dict] = None) -> Tuple[torch.Tensor,
                                                            torch.Tensor,
                                                            torch.Tensor]:
    """Soft greedy NMS as the compact kernel computes it with `threads` a
    lane (`ops/nms_kernel.py:COMPACT_WARPS` * 32); the results of
    `batched_nms(..., soft=True)`.

    As in `decay_nms_plain`, `score_threshold >= 0` (else this raises) and
    a score not above it is +0.0 and gone. The candidates above the
    threshold are staged in index order, position p in slot p // threads
    of thread p % threads. Once a quarter of a thread's slots in use are
    gone, the candidates gone leave them and the others keep their order,
    so a thread's slots hold ascending indices and its first slot among
    equal scores is its lowest index. A round takes each thread's best,
    the largest of those by its bits, and the lowest index holding it.
    The decay is `_decay`. `work` gains "staged", "alive" and "decayed" as
    in `decay_nms_plain` (the function's pairs: the kernel's rounds also
    pass over the gone slots not yet compacted)."""
    if not score_threshold >= 0.0:
        raise ValueError(f"the compact design needs score_threshold >= 0, "
                         f"got {score_threshold}")
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    lanes, k = scores.shape
    device = scores.device
    area = _areas(boxes)
    two_sigma = device_constant((2.0 * soft_nms_sigma,), torch.float32,
                                device)
    above = scores > score_threshold
    n = above.sum(dim=1, keepdim=True)                         # (L, 1)
    slots = max(1, -(-k // threads))
    width = slots * threads
    order = torch.sort((~above).to(torch.int8), dim=1, stable=True).indices
    order = torch.cat([order, order.new_zeros((lanes, width - k))], 1)
    # [L, thread, slot]: each thread's candidates and whether they are held
    held = order.view(lanes, slots, threads).transpose(1, 2).contiguous()
    live = (torch.arange(width, device=device)[None] < n).view(
        lanes, slots, threads).transpose(1, 2).contiguous()
    if work is not None:
        work["staged"] = work.get("staged", 0) + int(n.sum())
    cur = torch.where(above, scores, 0.0)   # the kernel's scores, by index
    out_idx, out_scores = [], []
    for _ in range(max_detections):
        s = torch.where(live, torch.gather(cur, 1, held.view(lanes, -1)
                                           ).view(lanes, threads, slots),
                        0.0)
        slot = torch.argmax(s, dim=2, keepdim=True)            # first slot
        key = torch.gather(s, 2, slot)[..., 0].view(torch.int32)  # (L, T)
        top = key.max(dim=1, keepdim=True).values              # (L, 1)
        idx = torch.where(key == top, torch.gather(held, 2, slot)[..., 0],
                          k).min(dim=1, keepdim=True).values
        ok = top > 0
        idx = torch.where(ok, idx, 0)
        new, alive, needed = _decay(boxes, area, cur, idx, iou_threshold,
                                    score_threshold, soft_nms_sigma,
                                    two_sigma)
        cur = torch.where(ok, new, cur)
        out_idx.append(torch.where(ok, idx, -1))
        out_scores.append(torch.where(ok, top.view(torch.float32), -1.0))
        if work is not None:
            work["alive"] = work.get("alive", 0) + int((alive & ok).sum())
            work["decayed"] = (work.get("decayed", 0)
                               + int((needed & ok).sum()))
        # once a quarter of a thread's slots in use are gone, the
        # candidates gone leave them, in order
        alive_now = live & (torch.gather(cur, 1, held.view(lanes, -1)).view(
            lanes, threads, slots) > 0)
        gone = (live & ~alive_now).sum(dim=2, keepdim=True)
        packs = 4 * gone > live.sum(dim=2, keepdim=True)
        perm = torch.sort((~alive_now).to(torch.int8), dim=2,
                          stable=True).indices
        held = torch.where(packs, torch.gather(held, 2, perm), held)
        live = torch.where(packs, torch.gather(alive_now, 2, perm), live)
    indices = torch.cat(out_idx, dim=1).to(torch.int32)
    valid = (indices >= 0).sum(dim=1, dtype=torch.int32)
    return (torch.clamp_min(indices, 0), torch.cat(out_scores, dim=1),
            valid)


def _over(pbox, parea, cbox, carea, iou_threshold) -> torch.Tensor:
    """IoU > threshold of every (candidate, pick) pair, (L, C, P), from the
    picks (L, P, 4), (L, P) and the candidates (L, C, 4), (L, C):
    `batched_nms`'s terms with the pick as the selected box."""
    px1, py1, px2, py2 = (t[:, None, :] for t in pbox.unbind(-1))
    cx1, cy1, cx2, cy2 = (t[:, :, None] for t in cbox.unbind(-1))
    iw = torch.clamp_min(torch.minimum(px2, cx2) - torch.maximum(px1, cx1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(py2, cy2) - torch.maximum(py1, cy1),
                         0.0)
    inter = iw * ih
    union = torch.clamp_min(parea[:, None, :] + carea[:, :, None] - inter,
                            1e-8)
    return inter / union > iou_threshold


def scan_nms_plain(boxes: torch.Tensor,
                   scores: torch.Tensor,
                   max_detections: int,
                   iou_threshold: float = 0.5,
                   score_threshold: float = 0.0,
                   chunk: int = 128,
                   work: Optional[dict] = None) -> Tuple[torch.Tensor,
                                                         torch.Tensor,
                                                         torch.Tensor]:
    """Hard greedy NMS as the scan kernel computes it with chunks of
    `chunk` ranks (`ops/nms_kernel.py:SCAN_WARPS` * 32); the results of
    `batched_nms`.

    As in `sweep_nms_plain` (and with the same `score_threshold >= -1e10`,
    else this raises) the candidates above the threshold are visited in one
    fixed order, and a candidate is kept iff no pick before it has IoU >
    `iou_threshold` with it. Chunk after chunk of ranks, each candidate is
    tested against the picks made before its chunk, then the chunk's
    survivors are taken in order, each suppressing the later ones of the
    chunk. A lane stops after `max_detections` picks. `work`, if given,
    gains what the function needs: "visited", the candidates decided
    before a lane's last pick, and "pairs", the (candidate, pick) IoUs
    that decide them: a kept candidate against every pick before it, a
    suppressed one up to the first pick that suppresses it."""
    if not score_threshold >= SUPPRESSED:
        raise ValueError(f"the scan needs score_threshold >= {SUPPRESSED}, "
                         f"got {score_threshold}")
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    lanes, k = scores.shape
    device = scores.device
    md = max_detections
    # + 0.0 turns -0.0 into 0.0, which `argmax` ties with it
    order = torch.sort(scores + 0.0, dim=1, descending=True,
                       stable=True).indices                    # (L, k)
    ranked = torch.gather(scores, 1, order)
    rbox = torch.gather(boxes, 1, order[..., None].expand(lanes, k, 4))
    rarea = _areas(rbox)
    n = (ranked > score_threshold).sum(dim=1)                  # (L,)
    rows = torch.arange(lanes, device=device)
    count = torch.zeros((lanes,), dtype=torch.int64, device=device)
    # one spare slot past max_detections for the lanes that do not pick
    pbox = rbox.new_zeros((lanes, md + 1, 4))
    parea = rarea.new_zeros((lanes, md + 1))
    out_idx = torch.zeros((lanes, md + 1), dtype=torch.int64, device=device)
    out_scores = torch.full((lanes, md + 1), -1.0, device=device)
    for base in range(0, k, chunk):
        going = (count < md) & (n > base)
        if not bool(going.any()):
            break
        end = min(base + chunk, k)
        cbox, carea = rbox[:, base:end], rarea[:, base:end]
        rank = torch.arange(base, end, device=device)
        alive = (rank[None] < n[:, None]) & going[:, None]     # (L, C)
        before = count.clone()
        tests = torch.zeros_like(alive, dtype=torch.int64)
        p = int(count.max())
        if p:
            hit = _over(pbox[:, :p], parea[:, :p], cbox, carea,
                        iou_threshold)
            hit &= (torch.arange(p, device=device)[None] < count[:, None]
                    )[:, None, :]
            first = torch.where(hit, torch.arange(p, device=device),
                                p).min(dim=2).values           # (L, C)
            tests = torch.where(first < p, first + 1, before[:, None])
            alive &= first == p
        decided = ~alive & (rank[None] < n[:, None]) & going[:, None]
        for j in range(end - base):
            take = alive[:, j] & (count < md)
            slot = torch.where(take, count, md)
            out_idx[rows, slot] = order[:, base + j]
            out_scores[rows, slot] = ranked[:, base + j]
            pbox[rows, slot] = cbox[:, j]
            parea[rows, slot] = carea[:, j]
            tests[:, j] = torch.where(take, count, tests[:, j])
            decided[:, j] |= take
            if j + 1 < end - base:
                hit = _over(cbox[:, j:j + 1], carea[:, j:j + 1],
                            cbox[:, j + 1:], carea[:, j + 1:],
                            iou_threshold)[..., 0] & take[:, None]
                tests[:, j + 1:] = torch.where(hit & alive[:, j + 1:],
                                               count[:, None] + 1,
                                               tests[:, j + 1:])
                decided[:, j + 1:] |= hit & alive[:, j + 1:]
                alive[:, j + 1:] &= ~hit
            count = count + take
            # past a lane's last pick nothing more is decided
            decided[:, j + 1:] &= (count < md)[:, None]
        if work is not None:
            work["visited"] = work.get("visited", 0) + int(decided.sum())
            work["pairs"] = (work.get("pairs", 0)
                             + int(torch.where(decided, tests, 0).sum()))
    return (out_idx[:, :md].to(torch.int32), out_scores[:, :md],
            count.to(torch.int32))


def nms_select(boxes: torch.Tensor,
               scores: torch.Tensor,
               max_detections: int,
               iou_threshold: float = 0.5,
               score_threshold: float = float("-inf"),
               soft_nms_sigma: float = 0.0,
               soft: bool = False) -> NMSResult:
    """Greedy NMS over one lane: (k, 4) boxes, (k,) scores."""
    idx, sc, valid = batched_nms(boxes[None], scores[None], max_detections,
                                 iou_threshold, score_threshold,
                                 soft_nms_sigma, soft)
    return NMSResult(idx[0], sc[0], valid[0])
