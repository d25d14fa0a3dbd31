"""Bandlimited waveform resampling (host numpy copy of
`kaldi_tpu/feat/resample.py`, its dtypes and order of operations kept;
parity: feat/resample.h:95,147 LinearResample / ArbitraryResample).

Filter: windowed sinc — lowpass at `filter_cutoff` with a raised-cosine
(Hanning) window spanning `num_zeros` zero crossings each side, exactly
the reference's FilterFunc. The offline path evaluates all output
samples as one dense gather and dot.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError


def _filter_func(t: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """sinc lowpass * raised-cosine window (resample.cc FilterFunc)."""
    window_width = num_zeros / (2.0 * cutoff)
    window = np.where(np.abs(t) < window_width,
                      0.5 * (1 + np.cos(2 * np.pi * (0.5 / window_width) * t)),
                      0.0)
    # 2*cutoff*sinc(2*cutoff*t)
    x = 2 * np.pi * cutoff * t
    t_safe = np.where(np.abs(t) > 1e-9, t, 1.0)
    sinc = np.where(np.abs(t) > 1e-9, np.sin(x) / (np.pi * t_safe),
                    2 * cutoff)
    return window * sinc


class LinearResample:
    """Resample between two fixed integer-related rates."""

    def __init__(self, samp_rate_in: float, samp_rate_out: float,
                 filter_cutoff: Optional[float] = None, num_zeros: int = 6):
        self.rate_in = float(samp_rate_in)
        self.rate_out = float(samp_rate_out)
        if filter_cutoff is None:
            filter_cutoff = 0.99 * 0.5 * min(samp_rate_in, samp_rate_out)
        if not (0 < filter_cutoff <= 0.5 * min(samp_rate_in, samp_rate_out)):
            raise KaldiTpuError("bad filter cutoff")
        self.cutoff = float(filter_cutoff)
        self.num_zeros = num_zeros
        g = math.gcd(int(samp_rate_in), int(samp_rate_out))
        self.in_step = int(samp_rate_in) // g
        self.out_step = int(samp_rate_out) // g
        # precompute per-phase filters
        self.window_width = num_zeros / (2.0 * self.cutoff)
        self.support = int(math.ceil(self.window_width * self.rate_in))

    def resample(self, wave: np.ndarray) -> np.ndarray:
        wave = np.asarray(wave, np.float64)
        n_in = len(wave)
        # number of output samples in the OPEN interval
        # [0, n_in / rate_in): LinearResample::GetNumOutputSamples
        # (resample.cc:58) with flush=true
        num = n_in * int(self.rate_out)
        den = int(self.rate_in)
        n_out = num // den if num % den == 0 else num // den + 1
        out_times = np.arange(n_out) / self.rate_out
        centers = out_times * self.rate_in  # in input-sample units
        lo = np.floor(centers).astype(int) - self.support
        k = np.arange(2 * self.support + 2)
        idx = lo[:, None] + k[None, :]
        t = out_times[:, None] - idx / self.rate_in
        weights = _filter_func(t, self.cutoff, self.num_zeros) / self.rate_in
        valid = (idx >= 0) & (idx < n_in)
        gathered = np.where(valid, wave[np.clip(idx, 0, n_in - 1)], 0.0)
        return (gathered * weights).sum(axis=1).astype(np.float32)


class ArbitraryResample:
    """Resample at arbitrary given output times (resample.h:95)."""

    def __init__(self, num_samples_in: int, samp_rate_in: float,
                 filter_cutoff: float, sample_points: np.ndarray,
                 num_zeros: int = 6):
        self.n_in = num_samples_in
        self.rate_in = samp_rate_in
        self.cutoff = filter_cutoff
        self.num_zeros = num_zeros
        self.points = np.asarray(sample_points, np.float64)
        self.support = int(math.ceil(num_zeros / (2.0 * filter_cutoff)
                                     * samp_rate_in))

    def resample(self, wave: np.ndarray) -> np.ndarray:
        wave = np.asarray(wave, np.float64)
        centers = self.points * self.rate_in
        lo = np.floor(centers).astype(int) - self.support
        k = np.arange(2 * self.support + 2)
        idx = lo[:, None] + k[None, :]
        t = self.points[:, None] - idx / self.rate_in
        weights = _filter_func(t, self.cutoff, self.num_zeros) / self.rate_in
        valid = (idx >= 0) & (idx < self.n_in)
        gathered = np.where(valid, wave[np.clip(idx, 0, self.n_in - 1)], 0.0)
        return (gathered * weights).sum(axis=1).astype(np.float32)
