"""Mel filterbank, DCT and lifter tables (numpy copy of
`kaldi_tpu/feat/mel.py`; parity with the reference's
feat/mel-computations.cc, the VTLN warp :150-216).  The mel projection
runs as one dense (num_bins x num_fft_bins) matmul, so the bank is built
here as a dense matrix with float32 math matching the reference's
formulas; a VTLN warp factor moves the bins' edges by the piecewise
linear warp before the matrix is built."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from kaldi_tpu_torch.feat.window import FrameExtractionOptions


@dataclass
class MelBanksOptions:
    num_bins: int = field(default=25, metadata={"name": "num-mel-bins"})
    low_freq: float = 20.0
    high_freq: float = 0.0
    vtln_low: float = 100.0     # low inflection point of the VTLN warp
    vtln_high: float = -500.0   # high one (if < 0, offset from Nyquist)
    htk_mode: bool = False


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float32) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel, np.float32) / 1127.0) - 1.0)


def vtln_warp_freq(vtln_low_cutoff: float, vtln_high_cutoff: float,
                   low_freq: float, high_freq: float,
                   vtln_warp_factor: float, freq: np.ndarray) -> np.ndarray:
    """Piecewise-linear VTLN warp, F(low)=low, F(high)=high, slope
    1/warp in the middle (mel-computations.cc:150)."""
    freq = np.asarray(freq, np.float32)
    l = vtln_low_cutoff * max(1.0, vtln_warp_factor)
    h = vtln_high_cutoff * min(1.0, vtln_warp_factor)
    scale = 1.0 / vtln_warp_factor
    fl, fh = scale * l, scale * h
    scale_left = (fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - fh) / (high_freq - h)
    out = np.where(freq < l, low_freq + scale_left * (freq - low_freq),
                   np.where(freq < h, scale * freq,
                            high_freq + scale_right * (freq - high_freq)))
    return np.where((freq < low_freq) | (freq > high_freq), freq, out)


def vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq,
                       warp, mel_freq):
    return mel_scale(vtln_warp_freq(vtln_low, vtln_high, low_freq,
                                    high_freq, warp,
                                    inverse_mel_scale(mel_freq)))


def mel_banks_matrix(opts: MelBanksOptions,
                     frame_opts: FrameExtractionOptions,
                     vtln_warp_factor: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (weights, center_freqs): weights has shape
    (num_bins, num_fft_bins) with num_fft_bins = padded_window/2."""
    num_bins = opts.num_bins
    if num_bins < 3:
        raise ValueError("must have at least 3 mel bins")
    sample_freq = frame_opts.samp_freq
    window_length_padded = frame_opts.padded_window_size()
    assert window_length_padded % 2 == 0
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq

    low_freq = opts.low_freq
    high_freq = (opts.high_freq if opts.high_freq > 0.0
                 else nyquist + opts.high_freq)
    if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist
            and low_freq < high_freq):
        raise ValueError(f"bad mel frequency range [{low_freq}, {high_freq}] "
                         f"vs nyquist {nyquist}")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = float(mel_scale(low_freq))
    mel_high = float(mel_scale(high_freq))
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    vtln_low = opts.vtln_low
    vtln_high = opts.vtln_high
    if vtln_high < 0.0:
        vtln_high += nyquist

    bin_edges = mel_low + np.arange(num_bins + 2, dtype=np.float32) * \
        np.float32(mel_delta)
    left_mel = bin_edges[:-2][:, None]     # (num_bins, 1)
    center_mel = bin_edges[1:-1][:, None]
    right_mel = bin_edges[2:][:, None]
    if vtln_warp_factor != 1.0:
        def warp(m):
            return vtln_warp_mel_freq(vtln_low, vtln_high, low_freq,
                                      high_freq, vtln_warp_factor, m)
        left_mel, center_mel, right_mel = (warp(left_mel), warp(center_mel),
                                           warp(right_mel))
    center_freqs = inverse_mel_scale(center_mel[:, 0])

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float32)
    mel = mel_scale(freqs)[None, :]        # (1, num_fft_bins)
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    weights = np.where(mel <= center_mel, up, down)
    weights = np.where((mel > left_mel) & (mel < right_mel), weights, 0.0)
    if opts.htk_mode and low_freq != 0.0:
        # replicate the HTK bug the reference reproduces for testing
        nz = np.nonzero(weights[0])[0]
        if nz.size:
            weights[0, nz[0]] = 0.0
    return weights.astype(np.float32), center_freqs.astype(np.float32)


def compute_dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Normalized DCT-II matrix (matrix-functions.cc:592)."""
    n = np.arange(num_cols, dtype=np.float64)
    k = np.arange(num_rows, dtype=np.float64)[:, None]
    m = np.sqrt(2.0 / num_cols) * np.cos(np.pi / num_cols * (n + 0.5) * k)
    m[0, :] = np.sqrt(1.0 / num_cols)
    return m.astype(np.float32)


def compute_lifter_coeffs(q: float, dim: int) -> np.ndarray:
    """1 + 0.5*Q*sin(pi*i/Q) (mel-computations.cc:253)."""
    i = np.arange(dim, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(np.pi * i / q)).astype(np.float32)
