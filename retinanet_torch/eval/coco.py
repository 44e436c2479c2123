"""COCO dataset index and bbox mAP evaluation (the port's own copy of
`retinanet_tpu/eval/coco.py`): the matcher in C++ (`eval/native.py`) by
default, the numpy matcher as its spec.

The pycocotools bbox protocol: greedy per-image matching in score order at
IoU thresholds 0.50:0.05:0.95, crowd handling, area ranges, maxDets, and
101-point interpolated AP, so results match pycocotools' COCOeval for bbox.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


class COCOIndex:
    """Minimal COCO annotation index (the parts COCOeval needs)."""

    def __init__(self, annotation_path_or_dict):
        if isinstance(annotation_path_or_dict, (str,)):
            path = annotation_path_or_dict
            if "://" in path:
                raise NotImplementedError(
                    f"{path}: remote (gs://) paths are not ported; ROADMAP "
                    "Queue 1 #9 (remote paths)")
            with open(path) as f:
                data = json.load(f)
        else:
            data = annotation_path_or_dict
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            if "area" not in ann:
                ann["area"] = float(ann["bbox"][2] * ann["bbox"][3])
            ann.setdefault("iscrowd", 0)
            ann.setdefault("ignore", 0)
            self.img_to_anns[ann["image_id"]].append(ann)

    @property
    def image_ids(self) -> List[int]:
        return list(self.imgs.keys())

    @property
    def category_ids(self) -> List[int]:
        return sorted(self.cats.keys())


def box_iou_xywh(dts: np.ndarray, gts: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """IoU between [x,y,w,h] boxes; crowd GT uses IoA (dt area) like
    pycocotools' maskUtils.iou."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(min=0)
    iy = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(min=0)
    inter = ix * iy
    d_area = (dts[:, 2] * dts[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class COCOEval:
    """Bbox COCOeval. Usage: evaluate() -> accumulate() -> stats."""

    def __init__(self, gt: COCOIndex, detections: Sequence[dict],
                 image_ids: Optional[Sequence[int]] = None):
        self.gt = gt
        self.image_ids = sorted(image_ids if image_ids is not None
                                else gt.image_ids)
        self.cat_ids = gt.category_ids
        self.dts: Dict[tuple, List[dict]] = defaultdict(list)
        for i, dt in enumerate(detections):
            dt = dict(dt)
            dt["id"] = i + 1
            if "area" not in dt:
                dt["area"] = float(dt["bbox"][2] * dt["bbox"][3])
            self.dts[(dt["image_id"], dt["category_id"])].append(dt)
        self.gts: Dict[tuple, List[dict]] = defaultdict(list)
        for img_id in self.image_ids:
            for ann in gt.img_to_anns.get(img_id, []):
                self.gts[(img_id, ann["category_id"])].append(ann)
        self.eval: Dict = {}
        self.stats: np.ndarray = np.zeros(12)

    # -- per image x category ------------------------------------------------

    def _evaluate_img(self, img_id: int, cat_id: int, area_rng,
                      max_det: int) -> Optional[dict]:
        gts = self.gts.get((img_id, cat_id), [])
        dts = self.dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None

        gt_ignore_base = np.array([
            1 if (g["iscrowd"] or g.get("ignore", 0)
                  or g["area"] < area_rng[0] or g["area"] > area_rng[1])
            else 0 for g in gts], dtype=np.float64)
        # sort gts: non-ignored first (stable)
        g_order = np.argsort(gt_ignore_base, kind="mergesort")
        gts = [gts[i] for i in g_order]
        gt_ignore = gt_ignore_base[g_order]
        iscrowd = np.array([g["iscrowd"] for g in gts], dtype=np.int64)

        d_order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in d_order][:max_det]

        ious = box_iou_xywh(
            np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
            np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
            iscrowd)

        T, G, D = len(IOU_THRS), len(gts), len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        dt_ignore = np.zeros((T, D))

        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                iou = min(thr, 1 - 1e-10)
                m = -1
                for g in range(G):
                    if gtm[t, g] > 0 and not iscrowd[g]:
                        continue
                    if m > -1 and gt_ignore[m] == 0 and gt_ignore[g] == 1:
                        break  # past all non-ignored gts
                    if ious[d, g] < iou:
                        continue
                    iou = ious[d, g]
                    m = g
                if m == -1:
                    continue
                # store local index + 1 (0 means unmatched; raw annotation
                # ids may legitimately be 0)
                dt_ignore[t, d] = gt_ignore[m]
                dtm[t, d] = m + 1
                gtm[t, m] = d + 1

        # unmatched dts outside the area range are ignored
        a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1]
                      for d in dts]).reshape(1, -1)
        dt_ignore = np.logical_or(
            dt_ignore, np.logical_and(dtm == 0, np.repeat(a, T, axis=0)))

        return {
            "dt_matches": dtm,
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_ignore": dt_ignore,
            "gt_ignore": gt_ignore,
            "num_gt": int(np.count_nonzero(gt_ignore == 0)),
        }

    # -- evaluate (pack groups, match) -------------------------------------------

    def _pack_groups(self, max_det: int) -> dict:
        """Flatten every (image, category) pair with any gts or dts into the
        group arrays the matcher consumes. Detections are stably sorted by
        descending score and truncated to `max_det` here, so matcher outputs
        stay column-aligned with `dt_scores`."""
        cat_ranges = []
        dt_boxes, dt_areas, dt_scores, pos_in_group = [], [], [], []
        gt_boxes, gt_areas, gt_crowd, gt_igbase = [], [], [], []
        dt_counts, gt_counts = [], []
        group_keys = []
        for cat_id in self.cat_ids:
            start = len(group_keys)
            for img_id in self.image_ids:
                gts = self.gts.get((img_id, cat_id), [])
                dts = self.dts.get((img_id, cat_id), [])
                if not gts and not dts:
                    continue
                d_order = np.argsort([-d["score"] for d in dts],
                                     kind="mergesort")[:max_det]
                dts = [dts[i] for i in d_order]
                dt_boxes.append(np.array(
                    [d["bbox"] for d in dts], np.float64).reshape(-1, 4))
                dt_areas.append(np.array(
                    [d["area"] for d in dts], np.float64))
                dt_scores.append(np.array(
                    [d["score"] for d in dts], np.float64))
                pos_in_group.append(np.arange(len(dts), dtype=np.int64))
                gt_boxes.append(np.array(
                    [g["bbox"] for g in gts], np.float64).reshape(-1, 4))
                gt_areas.append(np.array(
                    [g["area"] for g in gts], np.float64))
                gt_crowd.append(np.array(
                    [g["iscrowd"] for g in gts], np.uint8))
                gt_igbase.append(np.array(
                    [1 if (g["iscrowd"] or g.get("ignore", 0)) else 0
                     for g in gts], np.uint8))
                dt_counts.append(len(dts))
                gt_counts.append(len(gts))
                group_keys.append((img_id, cat_id))
            cat_ranges.append((start, len(group_keys)))

        def cat_(parts, dtype, width=None):
            if not parts:
                return np.zeros((0, width) if width else 0, dtype)
            return np.concatenate(parts).astype(dtype, copy=False)

        return {
            "cat_ranges": cat_ranges,
            "group_keys": group_keys,
            "dt_off": np.concatenate(
                [[0], np.cumsum(dt_counts)]).astype(np.int64),
            "gt_off": np.concatenate(
                [[0], np.cumsum(gt_counts)]).astype(np.int64),
            "dt_boxes": cat_(dt_boxes, np.float64, 4),
            "dt_areas": cat_(dt_areas, np.float64),
            "dt_scores": cat_(dt_scores, np.float64),
            "pos_in_group": cat_(pos_in_group, np.int64),
            "gt_boxes": cat_(gt_boxes, np.float64, 4),
            "gt_areas": cat_(gt_areas, np.float64),
            "gt_iscrowd": cat_(gt_crowd, np.uint8),
            "gt_ignore_base": cat_(gt_igbase, np.uint8),
        }

    def evaluate(self, use_native: Optional[bool] = None) -> None:
        """Match detections to gts for every (image, category, area, IoU
        threshold): through the C++ matcher (`eval/native.py`, one call for
        every group, a group's IoUs computed once) unless `use_native` is
        False, which runs the numpy matcher (`_evaluate_img`), the spec.
        Both give the same arrays; a matcher that does not build raises."""
        max_det = max(MAX_DETS)
        p = self._pack_groups(max_det)
        if use_native is False:
            dt_matched, dt_ignore, num_gt = self._match_numpy(p, max_det)
        else:
            from retinanet_torch.eval import native
            dt_matched, dt_ignore, num_gt = native.match_groups(
                p, np.array([lo for lo, _ in AREA_RNG.values()]),
                np.array([hi for _, hi in AREA_RNG.values()]), IOU_THRS)
        p["dt_matched"] = dt_matched
        p["dt_ignore"] = dt_ignore
        p["num_gt"] = num_gt
        self._packed = p

    def _match_numpy(self, p: dict, max_det: int) -> tuple:
        T = len(IOU_THRS)
        A = len(AREA_RNG)
        sum_d = int(p["dt_off"][-1])
        n_groups = len(p["group_keys"])
        dt_matched = np.zeros((A, T, sum_d), np.uint8)
        dt_ignore = np.zeros((A, T, sum_d), np.uint8)
        num_gt = np.zeros((A, n_groups), np.int32)
        for i, (img_id, cat_id) in enumerate(p["group_keys"]):
            lo, hi = p["dt_off"][i], p["dt_off"][i + 1]
            for a, area_name in enumerate(AREA_RNG):
                e = self._evaluate_img(
                    img_id, cat_id, AREA_RNG[area_name], max_det)
                dt_matched[a, :, lo:hi] = e["dt_matches"] > 0
                dt_ignore[a, :, lo:hi] = e["dt_ignore"]
                num_gt[a, i] = e["num_gt"]
        return dt_matched, dt_ignore, num_gt

    # -- accumulate -----------------------------------------------------------

    def accumulate(self) -> None:
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RNG)
        M = len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))
        p = self._packed
        eps = np.finfo(float).eps

        for k in range(K):
            grp_lo, grp_hi = p["cat_ranges"][k]
            if grp_lo == grp_hi:
                continue  # no image has gts or dts for this category
            col_lo = int(p["dt_off"][grp_lo])
            col_hi = int(p["dt_off"][grp_hi])
            scores_k = p["dt_scores"][col_lo:col_hi]
            pos_k = p["pos_in_group"][col_lo:col_hi]
            # Sort ONCE per category: a stable sort restricted to a subset
            # (pos < max_det) equals the stable sort of that subset, so the
            # per-maxDets orderings are masks of this one.
            order_full = np.argsort(-scores_k, kind="mergesort")
            scores_sorted = scores_k[order_full]
            pos_sorted = pos_k[order_full]
            for a in range(A):
                num_gt = int(p["num_gt"][a, grp_lo:grp_hi].sum())
                if num_gt == 0:
                    continue
                matched_o = p["dt_matched"][a, :, col_lo:col_hi][
                    :, order_full].astype(bool)
                ignored_o = p["dt_ignore"][a, :, col_lo:col_hi][
                    :, order_full].astype(bool)
                for m, max_det in enumerate(MAX_DETS):
                    sel = pos_sorted < max_det
                    nd = int(np.count_nonzero(sel))
                    if nd == 0:
                        recall[:, k, a, m] = 0.0
                        precision[:, :, k, a, m] = 0.0
                        scores[:, :, k, a, m] = 0.0
                        continue
                    ss_sorted = scores_sorted[sel]
                    mt = matched_o[:, sel]
                    ig = ignored_o[:, sel]
                    tp = np.cumsum(mt & ~ig, axis=1, dtype=np.float64)
                    fp = np.cumsum(~mt & ~ig, axis=1, dtype=np.float64)
                    rc = tp / num_gt                          # (T, nd)
                    pr = tp / np.maximum(tp + fp, eps)
                    recall[:, k, a, m] = rc[:, -1]
                    # precision envelope (monotone non-increasing)
                    env = np.maximum.accumulate(
                        pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(T):
                        inds = np.searchsorted(rc[t], REC_THRS, side="left")
                        ok = inds < nd
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        q[ok] = env[t, inds[ok]]
                        ss[ok] = ss_sorted[inds[ok]]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss

        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores}
        self._summarize()

    def _summarize(self) -> None:
        def _ap(iou_thr=None, area="all", max_det=100):
            p = self.eval["precision"]
            a = list(AREA_RNG).index(area)
            m = MAX_DETS.index(max_det)
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                p = p[t]
            p = p[:, :, :, a, m]
            valid = p[p > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        def _ar(iou_thr=None, area="all", max_det=100):
            r = self.eval["recall"]
            a = list(AREA_RNG).index(area)
            m = MAX_DETS.index(max_det)
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                r = r[t]
            r = r[:, :, a, m]
            valid = r[r > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        self.stats = np.array([
            _ap(),                               # AP .50:.95
            _ap(iou_thr=0.5),                    # AP .50
            _ap(iou_thr=0.75),                   # AP .75
            _ap(area="small"),
            _ap(area="medium"),
            _ap(area="large"),
            _ar(max_det=1),
            _ar(max_det=10),
            _ar(max_det=100),
            _ar(area="small"),
            _ar(area="medium"),
            _ar(area="large"),
        ])

    def summarize(self) -> Dict[str, float]:
        names = [
            "AP-IoU=0.50:0.95", "AP-IoU=0.50", "AP-IoU=0.75",
            "AP-(S)", "AP-(M)", "AP-(L)",
            "AR-maxDets=1", "AR-maxDets=10", "AR-(all)-IoU=0.50:0.95",
            "AR-(S)", "AR-(M)", "AR-(L)-IoU=0.50:0.95",
        ]
        return dict(zip(names, self.stats.tolist()))
