"""Log-spaced histogram vocabulary shared by the collectors and the
host-side exporters (copy of ``repro.telemetry.hist``; ``bin_index`` runs in
torch on the tensor's device).

Bin convention (the one convention everything uses):

  a non-negative value ``v`` falls in bin
      b(v) = clip(floor(bins_per_octave * log2(v + 1)), 0, n_bins - 1)
  so bin ``b`` covers the half-open interval
      [ 2^(b / bpo) - 1,  2^((b+1) / bpo) - 1 )

Bin 0 is exactly the values below 2^(1/bpo) - 1 (empty queues, zero
delays); the relative bin width is constant (~9% at 8 bins an octave), so
``percentiles`` reads p50/p95/p99 within a few percent; the default 128
bins x 8 a octave cover [0, 2^16).

``bin_index`` gives the reference's bins to the bit, on the CPU and on the
card alike.  The reference evaluates b(v) in float32 with XLA's CPU log
(log2 is log(u) times the float32 reciprocal of log(2) there, and XLA's
log is the Cephes polynomial with fused multiply-adds), which differs from
torch's log2 in the last bit on many inputs, so a value at a bin edge
could land one bin apart.  b is a
monotone step function of v, so the port evaluates the reference's float32
arithmetic once, on the host, at the f32 values around every edge
(``_xla_bins``), keeps the smallest v of each bin, and bins a tensor with
one ``torch.bucketize`` against those thresholds: the same bins, exactly,
at the cost of one kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_BINS = 128
BINS_PER_OCTAVE = 8

_F32 = np.float32
# XLA's float32 log (Cephes): the mantissa polynomial and log(2) split
_LOG_P = tuple(_F32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _F32(-2.12194440e-4), _F32(0.693359375)
_SQRTHF = _F32(0.707106781186547524)
_INV_LN2 = _F32(1.0) / _F32(np.log(2.0))   # XLA's log2: log times this


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _xla_log(u: np.ndarray) -> np.ndarray:
    """float32 log of u >= 1 as XLA's CPU backend evaluates it."""
    x, e = np.frexp(np.asarray(u, _F32))
    x, e = x.astype(_F32), e.astype(_F32)
    small = x < _SQRTHF
    e = (e - small.astype(_F32)).astype(_F32)
    x = ((x - _F32(1.0)).astype(_F32) + np.where(small, x, _F32(0.0))).astype(_F32)
    x2 = (x * x).astype(_F32)
    x3 = (x2 * x).astype(_F32)
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (_LOG_Q1 * e).astype(_F32))
    x = (x - (x2 * _F32(0.5)).astype(_F32)).astype(_F32)
    return ((x + y).astype(_F32) + (_LOG_Q2 * e).astype(_F32)).astype(_F32)


def _xla_bins(v: np.ndarray, n_bins: int, bins_per_octave: int) -> np.ndarray:
    """The reference's float32 b(v) for float32 v >= 0 (host, numpy)."""
    u = (np.asarray(v, _F32) + _F32(1.0)).astype(_F32)
    l2 = (_xla_log(u) * _INV_LN2).astype(_F32)
    b = np.floor((_F32(bins_per_octave) * l2).astype(_F32))
    return np.clip(b, 0, n_bins - 1).astype(np.int64)


_WINDOW = 1024      # f32 steps searched below and above each edge


@functools.cache
def _thresholds(n_bins: int, bins_per_octave: int) -> np.ndarray:
    """[n_bins - 1] float32: entry k-1 is the smallest float32 v >= 0 whose
    bin is at least k.  Searched among the f32 values around each edge
    2^(k/bpo) - 1, where b must step from k-1 to k exactly once."""
    thr = np.empty(n_bins - 1, _F32)
    steps = np.arange(-_WINDOW, _WINDOW + 1)
    for k in range(1, n_bins):
        edge = _F32(2.0 ** (k / bins_per_octave) - 1.0)
        bits = edge.view(np.int32) + steps.astype(np.int32)
        v = bits.view(_F32)
        b = _xla_bins(v, n_bins, bins_per_octave)
        up = np.flatnonzero(np.diff(b))
        if b[0] != k - 1 or b[-1] != k or len(up) != 1:
            raise AssertionError(f"bin {k}: no single step near its edge")
        thr[k - 1] = v[up[0] + 1]
    return thr


@functools.lru_cache(maxsize=None)
def _thresholds_on(n_bins: int, bins_per_octave: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_thresholds(n_bins, bins_per_octave)).to(device)


def bin_index(v: torch.Tensor, n_bins: int = N_BINS,
              bins_per_octave: int = BINS_PER_OCTAVE) -> torch.Tensor:
    """int64 bin of every value of ``v`` (any shape, on its device), equal
    to the reference's float32 bins: ``v`` is taken as float32, negative
    values fall in bin 0 and large ones in bin n_bins - 1."""
    v = v.to(torch.float32)
    return torch.bucketize(v, _thresholds_on(n_bins, bins_per_octave, v.device),
                           right=True)


def bin_edges(n_bins: int = N_BINS,
              bins_per_octave: int = BINS_PER_OCTAVE) -> np.ndarray:
    """[n_bins + 1] float64 bin edges: edge[b] = 2^(b / bpo) - 1."""
    b = np.arange(n_bins + 1, dtype=np.float64)
    return np.exp2(b / bins_per_octave) - 1.0


def np_hist(values, n_bins: int = N_BINS,
            bins_per_octave: int = BINS_PER_OCTAVE) -> np.ndarray:
    """Host-side histogram of ``values`` under the shared bin convention
    (float64 arithmetic, as the reference's)."""
    v = np.maximum(np.asarray(values, np.float64), 0.0)
    b = np.clip(np.floor(bins_per_octave * np.log2(v + 1.0)), 0,
                n_bins - 1).astype(np.int64)
    return np.bincount(b, minlength=n_bins).astype(np.float64)


def percentiles(hist, ps, bins_per_octave: int = BINS_PER_OCTAVE):
    """Percentile estimates from a histogram of counts.

    hist: [n_bins] counts.  ps: percentiles in [0, 100].  Linear
    interpolation inside the bin.  Returns a list of floats; NaNs when the
    histogram is empty."""
    h = np.asarray(hist, np.float64)
    edges = bin_edges(h.shape[0], bins_per_octave)
    c = np.cumsum(h)
    total = c[-1]
    out = []
    for p in ps:
        if total <= 0:
            out.append(float("nan"))
            continue
        target = (p / 100.0) * total
        b = int(np.searchsorted(c, target, side="left"))
        b = min(b, h.shape[0] - 1)
        prev = c[b - 1] if b > 0 else 0.0
        frac = (target - prev) / max(h[b], 1e-12)
        out.append(float(edges[b] + frac * (edges[b + 1] - edges[b])))
    return out
