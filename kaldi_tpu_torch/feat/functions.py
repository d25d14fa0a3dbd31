"""Feature post-processing on the host: CMVN and deltas (the part of
`kaldi_tpu/feat/functions.py` that the streaming features need).

Parity: transform/cmvn.{h,cc} (stats are a float64 (2, dim+1) matrix:
row 0 the per-dim sums with the frame count in the last column, row 1
the per-dim sums of squares) and feat/feature-functions.cc:54
DeltaFeatures (edge frames replicated).

Not carried over yet: `acc_cmvn_stats`, `apply_cmvn`'s reverse mode,
`compute_deltas`, `splice_frames` and the sliding-window CMN.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


def apply_cmvn(feats: np.ndarray, stats: np.ndarray,
               norm_vars: bool = False) -> np.ndarray:
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
        return ((feats - mean32) * scale).astype(np.float32)
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
