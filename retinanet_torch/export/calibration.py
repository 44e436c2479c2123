"""Activation calibration for int8 post-training quantization (counterpart
of `retinanet_tpu/export/calibration.py`).

An observer on the port's conv hook (`models/layers.py:conv_hook`) sees the
input of every conv as flax's `nn.Conv` sees it, before any "SAME" padding,
during ordinary forward passes. Two passes over the calibration batches:
  1. the running max of |x| per conv, a max over every call (a head conv
     is called once a level);
  2. a NUM_BINS histogram of |x| over (0, amax) per conv, the bin found as
     `jnp.histogram` finds it: `searchsorted(edges, |x|, side="right")` on
     the float32 edges of `jnp.linspace(0, amax, NUM_BINS + 1)`, the value
     equal to the last edge in the last bin. The counts are int64 (JAX sums
     them in float32, exact below 2^24 a bin).
The statistics stay on the device until the end of a pass. Scale choice
(`compute_scales`): "minmax" (amax / 127), "percentile" (the bin that holds
the given percentile of the mass), or "entropy" (the TRT-style KL sweep of
`_entropy_threshold`), each as the JAX package computes it, in numpy.

The result, {conv path: scale}, keys the int8 lane of `export/quantize.py`
and the artifact's `activation_scales.json`; the paths are flax's, so a
file written by either package keys the other's convs.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from retinanet_torch.export.quantize import conv_paths
from retinanet_torch.models.layers import conv_hook

NUM_BINS = 2048
QUANT_LEVELS = 128  # int8 positive side


def histogram_edges(amax: float) -> np.ndarray:
    """The float32 edges of `jnp.linspace(0, amax, NUM_BINS + 1)`:
    `amax * (i / NUM_BINS)` rounded once, and `amax` itself last."""
    stop = np.float32(amax)
    step = np.arange(NUM_BINS, dtype=np.float32) / np.float32(NUM_BINS)
    return np.append(stop * step, stop).astype(np.float32)


def abs_histogram(a: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """int64 counts of the values of `a` (>= 0) in the NUM_BINS bins of
    `edges`, as `jnp.histogram` bins them; values above the last edge are
    not counted."""
    a = a.reshape(-1)
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], NUM_BINS, idx)
    return torch.bincount(idx, minlength=NUM_BINS + 2)[1:NUM_BINS + 1]


class _Observer:
    """The conv hook of one pass: records |x| of every conv, then runs its
    float path. Without `ranges` the max; with them the histogram over
    (0, ranges[path]) of each conv that has a nonzero range."""

    def __init__(self, paths: Dict, ranges: Optional[Dict[str, float]]):
        self.paths = paths
        self.ranges = ranges
        self.edges: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, torch.Tensor] = {}

    def __call__(self, x, p, stride, pads, dtype, float_conv):
        key = self.paths[p]
        a = x.to(torch.float32).abs()
        prev = self.stats.get(key)
        if self.ranges is None:
            value = a.max()
            self.stats[key] = value if prev is None else torch.maximum(
                prev, value)
        elif self.ranges.get(key):
            edges = self.edges.get(key)
            if edges is None:
                edges = torch.from_numpy(histogram_edges(
                    self.ranges[key])).to(a.device)
                self.edges[key] = edges
            hist = abs_histogram(a, edges)
            self.stats[key] = hist if prev is None else prev + hist
        return float_conv(x)


def _collect(model, batches, ranges, preprocess) -> Dict[str, np.ndarray]:
    """One pass over `batches`: {conv path: merged statistic}."""
    observer = _Observer(conv_paths(model), ranges)
    device = next(model.parameters()).device
    with torch.inference_mode(), conv_hook(observer):
        for images in batches:
            model(preprocess(torch.from_numpy(np.array(images))
                             .to(device)))
    return {k: v.cpu().numpy() for k, v in observer.stats.items()}


def _entropy_threshold(hist: np.ndarray) -> int:
    """TRT-style KL sweep: best bin count i (>=QUANT_LEVELS) such that
    quantizing the first i bins to QUANT_LEVELS levels (with clipping mass
    folded into the last bin) minimizes KL(P || Q)."""
    hist = hist.astype(np.float64)
    best_i, best_kl = len(hist), np.inf
    total = hist.sum()
    if total == 0:
        return len(hist)
    for i in range(QUANT_LEVELS, len(hist) + 1, 16):
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()  # clipped mass
        if p.sum() == 0:
            continue
        # quantize first i bins into QUANT_LEVELS groups
        edges = np.linspace(0, i, QUANT_LEVELS + 1).astype(int)
        q = np.zeros(i)
        ref = hist[:i]
        for b in range(QUANT_LEVELS):
            lo, hi = edges[b], edges[b + 1]
            mass = ref[lo:hi].sum()
            nonzero = (ref[lo:hi] > 0)
            n = nonzero.sum()
            if n:
                q[lo:hi][nonzero] = mass / n
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(
            pn[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def compute_scales(amax: Dict[str, float],
                   hists: Optional[Dict[str, np.ndarray]],
                   mode: str = "entropy",
                   percentile: float = 99.99) -> Dict[str, float]:
    scales: Dict[str, float] = {}
    for key, a in amax.items():
        a = float(a)
        if a <= 0:
            continue
        if mode == "minmax" or hists is None or key not in hists:
            thr = a
        elif mode == "percentile":
            h = hists[key].astype(np.float64)
            c = np.cumsum(h)
            idx = int(np.searchsorted(c, c[-1] * percentile / 100.0))
            thr = (idx + 1) / NUM_BINS * a
        elif mode == "entropy":
            # the zero bin is left out: after a ReLU about half the mass
            # sits exactly at 0, needs no representation, and would drag
            # the KL optimum to a threshold that clips the tail
            h = hists[key].astype(np.float64).copy()
            h[0] = 0.0
            i = _entropy_threshold(h)
            thr = (i + 0.5) / NUM_BINS * a
        else:
            raise ValueError(f"unknown calibration mode: {mode}")
        scales[key] = min(thr, a) / 127.0
    return scales


def calibrate_activations(model, batches: Iterable, mode: str = "entropy",
                          preprocess: Callable = lambda x: x,
                          percentile: float = 99.99) -> Dict[str, float]:
    """{conv path: activation scale} of `model` (in eval mode) over
    `batches` of NHWC images, each `preprocess`ed on the model's device
    first. The batches are read twice unless the mode is "minmax"."""
    batches = list(batches)
    amax = _collect(model, batches, None, preprocess)
    hists = None
    if mode != "minmax":
        ranges = {k: float(v) for k, v in amax.items()}
        hists = _collect(model, batches, ranges, preprocess)
    return compute_scales(amax, hists, mode, percentile)
