"""Feature post-processing on the host: CMVN, the sliding-window CMN,
deltas and splicing (port of `kaldi_tpu/feat/functions.py`, which is
numpy there too).

Parity: transform/cmvn.{h,cc} (stats are a float64 (2, dim+1) matrix:
row 0 the per-dim sums with the frame count in the last column, row 1
the per-dim sums of squares) and feat/feature-functions.cc:54
DeltaFeatures (edge frames replicated) and featbin/splice-feats (edge
frames replicated).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def acc_cmvn_stats(feats: np.ndarray, weights: Optional[np.ndarray] = None,
                   stats: Optional[np.ndarray] = None) -> np.ndarray:
    """Accumulate CMVN stats (float64, the reference's layout)."""
    feats = np.asarray(feats, dtype=np.float64)
    dim = feats.shape[1]
    if stats is None:
        stats = np.zeros((2, dim + 1), dtype=np.float64)
    if weights is None:
        stats[0, :dim] += feats.sum(axis=0)
        stats[1, :dim] += (feats ** 2).sum(axis=0)
        stats[0, dim] += feats.shape[0]
    else:
        w = np.asarray(weights, dtype=np.float64)[:, None]
        stats[0, :dim] += (feats * w).sum(axis=0)
        stats[1, :dim] += (feats ** 2 * w).sum(axis=0)
        stats[0, dim] += w.sum()
    return stats


def apply_cmvn(feats: np.ndarray, stats: np.ndarray,
               norm_vars: bool = False, reverse: bool = False) -> np.ndarray:
    stats = np.asarray(stats, dtype=np.float64)
    dim = stats.shape[1] - 1
    count = stats[0, dim]
    if count < 1.0:
        raise ValueError("insufficient count in CMVN stats")
    mean = stats[0, :dim] / count
    feats = np.asarray(feats, dtype=np.float32)
    mean32 = mean.astype(np.float32)
    if norm_vars:
        var = np.maximum(stats[1, :dim] / count - mean ** 2, 1.0e-20)
        scale = (1.0 / np.sqrt(var)).astype(np.float32)
        if reverse:
            return (feats / scale + mean32).astype(np.float32)
        return ((feats - mean32) * scale).astype(np.float32)
    if reverse:
        return (feats + mean32).astype(np.float32)
    return (feats - mean32).astype(np.float32)


@dataclass
class DeltaFeaturesOptions:
    order: int = field(default=2, metadata={"doc": "Order of delta computation"})
    window: int = field(default=2, metadata={"doc": "Parameter controlling window for delta computation (actual window size is 2*window + 1)"})


def delta_scales(opts: DeltaFeaturesOptions) -> List[np.ndarray]:
    """The convolution kernel of each order (feature-functions.cc:54)."""
    scales = [np.array([1.0], dtype=np.float32)]
    w = opts.window
    for _ in range(opts.order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur = np.zeros(len(prev) + 2 * w, dtype=np.float32)
        cur_offset = prev_offset + w
        normalizer = 0.0
        for j in range(-w, w + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += float(j) * prev[k + prev_offset]
        cur /= normalizer
        scales.append(cur)
    return scales


def compute_deltas(feats: np.ndarray,
                   opts: Optional[DeltaFeaturesOptions] = None) -> np.ndarray:
    """(T, D) -> (T, D*(order+1)) with edge replication."""
    if opts is None:
        opts = DeltaFeaturesOptions()
    feats = np.asarray(feats, dtype=np.float32)
    T = feats.shape[0]
    if T == 0:
        return np.zeros((0, feats.shape[1] * (opts.order + 1)), np.float32)
    outs = []
    for scales in delta_scales(opts):
        max_offset = (len(scales) - 1) // 2
        acc = np.zeros_like(feats)
        for j in range(-max_offset, max_offset + 1):
            s = scales[j + max_offset]
            if s == 0.0:
                continue
            idx = np.clip(np.arange(T) + j, 0, T - 1)
            acc += s * feats[idx]
        outs.append(acc)
    return np.concatenate(outs, axis=1)


def splice_frames(feats: np.ndarray, left_context: int,
                  right_context: int) -> np.ndarray:
    """(T, D) -> (T, D*(l+r+1)) with edge replication (splice-feats)."""
    feats = np.asarray(feats, dtype=np.float32)
    T = feats.shape[0]
    cols = []
    for off in range(-left_context, right_context + 1):
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        cols.append(feats[idx])
    return np.concatenate(cols, axis=1)


@dataclass
class SlidingWindowCmnOptions:
    cmn_window: int = field(default=600, metadata={"doc": "Window in frames for running average CMN computation"})
    min_window: int = field(default=100, metadata={"doc": "Minimum CMN window used at start of decoding"})
    max_warnings: int = 5
    normalize_variance: bool = field(default=False, metadata={"doc": "If true, normalize variance to one"})
    center: bool = field(default=False, metadata={"doc": "If true, use a window centered on the current frame"})


def sliding_window_cmn(feats: np.ndarray,
                       opts: Optional[SlidingWindowCmnOptions] = None
                       ) -> np.ndarray:
    """Sliding-window cepstral mean (and optionally variance)
    normalization (feat/feature-functions.cc SlidingWindowCmn), with the
    reference package's window placement."""
    if opts is None:
        opts = SlidingWindowCmnOptions()
    x = np.asarray(feats, dtype=np.float64)
    T, D = x.shape
    out = np.empty_like(x, dtype=np.float64)
    # prefix sums for O(T) windowed means
    cs = np.vstack([np.zeros((1, D)), np.cumsum(x, axis=0)])
    cs2 = np.vstack([np.zeros((1, D)), np.cumsum(x * x, axis=0)])
    for t in range(T):
        if opts.center:
            lo = t - opts.cmn_window // 2
            hi = lo + opts.cmn_window
        else:
            lo = t - opts.cmn_window
            hi = t + 1
            if hi - lo < opts.min_window:
                hi = min(T, lo + opts.min_window)
                hi = max(hi, t + 1)
        if lo < 0:
            hi = min(T, hi - lo)
            lo = 0
        if hi > T:
            lo = max(0, lo - (hi - T))
            hi = T
        n = hi - lo
        mean = (cs[hi] - cs[lo]) / n
        out[t] = x[t] - mean
        if opts.normalize_variance:
            var = (cs2[hi] - cs2[lo]) / n - mean ** 2
            out[t] /= np.sqrt(np.maximum(var, 1e-10))
    return out.astype(np.float32)
