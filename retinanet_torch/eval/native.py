"""ctypes binding of the port's C++ COCO matcher
(`csrc/host/cocoeval_native.cpp`; counterpart of
`retinanet_tpu/eval/native.py`).

`g++` builds it at first use into `retinanet_torch/_build/` through
`data/host_codec.py:HostLibrary`, with `-ffp-contract=off` so that the
IoU's float64 arithmetic rounds as numpy's does. A failed build raises
with the compiler's words. The numpy matcher of `eval/coco.py`
(`COCOEval.evaluate(use_native=False)`) stays the spec the tests hold it
to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from retinanet_torch.data.host_codec import HostLibrary


def _declare(lib: ctypes.CDLL) -> None:
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.coco_match_groups.restype = ctypes.c_int
    lib.coco_match_groups.argtypes = [
        ctypes.c_int64, i64, i64,          # n_groups, dt_off, gt_off
        f64, f64,                          # dt boxes, areas
        f64, f64, u8, u8,                  # gt boxes, areas, crowd, ignore
        ctypes.c_int32, f64, f64,          # area ranges
        ctypes.c_int32, f64,               # IoU thresholds
        u8, u8, i32]                       # dt_matched, dt_ignore, num_gt


cocoeval_lib = HostLibrary("cocoeval_native", [], _declare,
                           cflags=["-ffp-contract=off"])


def match_groups(packed: dict, area_lo: np.ndarray, area_hi: np.ndarray,
                 thrs: np.ndarray):
    """Match every group of `COCOEval._pack_groups`'s arrays at once.
    Returns (dt_matched, dt_ignore, num_gt): uint8 [A, T, sumD] twice and
    int32 [A, n_groups]."""
    lib = cocoeval_lib.get()
    n_groups = len(packed["dt_off"]) - 1
    sum_d = int(packed["dt_off"][-1])
    n_area, n_thr = len(area_lo), len(thrs)
    dt_matched = np.zeros((n_area, n_thr, sum_d), np.uint8)
    dt_ignore = np.zeros((n_area, n_thr, sum_d), np.uint8)
    num_gt = np.zeros((n_area, n_groups), np.int32)
    if n_groups == 0:
        return dt_matched, dt_ignore, num_gt

    def f64(key):
        return np.ascontiguousarray(packed[key], np.float64).reshape(-1)

    def u8(key):
        return np.ascontiguousarray(packed[key], np.uint8)

    rc = lib.coco_match_groups(
        n_groups, np.ascontiguousarray(packed["dt_off"], np.int64),
        np.ascontiguousarray(packed["gt_off"], np.int64),
        f64("dt_boxes"), f64("dt_areas"), f64("gt_boxes"), f64("gt_areas"),
        u8("gt_iscrowd"), u8("gt_ignore_base"),
        n_area, np.ascontiguousarray(area_lo, np.float64),
        np.ascontiguousarray(area_hi, np.float64),
        n_thr, np.ascontiguousarray(thrs, np.float64),
        dt_matched, dt_ignore, num_gt)
    if rc != 0:
        raise RuntimeError(f"coco_match_groups returned {rc}")
    return dt_matched, dt_ignore, num_gt
