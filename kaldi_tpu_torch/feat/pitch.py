"""Kaldi-pitch features (host numpy copy of `kaldi_tpu/feat/pitch.py`:
the same dtypes, products and order of operations, so that a lag
decision between two tied lags falls the same way; numeric parity with
the reference extractor).

Spec: feat/pitch-functions.cc (the Ghahremani et al. 2014 tracker):
the waveform is low-passed and resampled to `resample_freq`
(LinearResample, num_zeros = lowpass_filter_width); per frame the NCCF
is computed at integer lags [ceil(rf/max_f0 - w/2) .. floor(rf/min_f0
+ w/2)] in two variants — ballasted for the Viterbi (ballast =
(signal_variance * window)^2 * nccf_ballast) and un-ballasted for the
POV output (pitch-functions.cc:1136-1143); the NCCF-as-a-function-of-
lag is then band-limited-interpolated (ArbitraryResample at cutoff
rf/2, width upsample_filter_width) onto a geometric lag grid with
ratio (1 + delta_pitch) (SelectLags, :157), and a Viterbi over that
grid picks the lag track with local cost 1 - nccf*(1 - soft_min_f0 *
lag) (eq. 5, :178) and transition cost (i - j)^2 * penalty_factor *
log(1+delta_pitch)^2 (ComputeBacktraces, :306).

Offline operation reproduces the reference's chunked bookkeeping
exactly (ComputeKaldiPitch = AcceptWaveform(whole) + InputFinished,
:1291): the first batch of frames covers the resampler output WITHOUT
the flushed tail and uses the signal variance up to that point for the
ballast; the flush then appends the remaining frames (zero-padded
windows) under the updated variance, and — when the utterance is
shorter than recompute_frame — the early frames' NCCF is rescaled by
sqrt((old_ballast + avg_norm_prod)/(new_ballast + avg_norm_prod)) and
the Viterbi re-run iff the variance moved by more than 1%
(RecomputeBacktraces, :946).

Batched structure: all frames' correlations are one
(T, lags, window) einsum against the base window; the lag upsampling
is one (T, measured) @ (measured, grid) matmul; only the O(T * grid)
Viterbi recursion is sequential (vectorized over the grid per step).

Post-processing (process_pitch) follows OnlineProcessPitch (:1431):
pov feature = pov_scale * ((1.0001 - nccf)^0.15 - 1); normalized log
pitch subtracts the NccfToPov-weighted mean over [t-75, t+76); delta
= standard delta coefficients (window 2) + optional dither;
raw log pitch optional."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from kaldi_tpu_torch.feat.resample import ArbitraryResample, LinearResample


@dataclass
class PitchExtractionOptions:
    samp_freq: float = field(default=16000.0, metadata={"name": "sample-frequency", "doc": "Waveform data sample frequency"})
    frame_shift_ms: float = field(default=10.0, metadata={"name": "frame-shift", "doc": "Frame shift in milliseconds"})
    frame_length_ms: float = field(default=25.0, metadata={"name": "frame-length", "doc": "Frame length in milliseconds"})
    preemph_coeff: float = field(default=0.0, metadata={"name": "preemphasis-coefficient", "doc": "Coefficient for use in signal preemphasis (deprecated)"})
    min_f0: float = field(default=50.0, metadata={"doc": "min. F0 to search for (Hz)"})
    max_f0: float = field(default=400.0, metadata={"doc": "max. F0 to search for (Hz)"})
    soft_min_f0: float = field(default=10.0, metadata={"doc": "Minimum f0, applied in soft way; must not exceed min-f0"})
    penalty_factor: float = field(default=0.1, metadata={"doc": "cost factor for FO change"})
    lowpass_cutoff: float = field(default=1000.0, metadata={"doc": "cutoff frequency for LowPass filter (Hz)"})
    resample_freq: float = field(default=4000.0, metadata={"name": "resample-frequency", "doc": "Frequency that we down-sample the signal to"})
    delta_pitch: float = field(default=0.005, metadata={"doc": "Smallest relative change in pitch that our algorithm measures"})
    nccf_ballast: float = field(default=7000.0, metadata={"doc": "Increasing this factor reduces NCCF for quiet frames"})
    lowpass_filter_width: int = field(default=1, metadata={"doc": "Integer that determines filter width of lowpass filter"})
    upsample_filter_width: int = field(default=5, metadata={"doc": "Integer that determines filter width when upsampling NCCF"})
    recompute_frame: int = field(default=500, metadata={"doc": "Only relevant for online operation or emulation"})
    snip_edges: bool = field(default=True, metadata={"doc": "If this is set to false, the incomplete frames near the ending edge won't be snipped"})

    def nccf_window_size(self) -> int:
        return int(self.resample_freq * 0.001 * self.frame_length_ms)

    def nccf_window_shift(self) -> int:
        return int(self.resample_freq * 0.001 * self.frame_shift_ms)


@dataclass
class ProcessPitchOptions:
    pitch_scale: float = field(default=2.0, metadata={"doc": "Scaling factor for the final normalized log-pitch value"})
    pov_scale: float = field(default=2.0, metadata={"doc": "Scaling factor for final POV (probability of voicing) feature"})
    pov_offset: float = field(default=0.0, metadata={"doc": "This can be used to add an offset to the POV feature"})
    delta_pitch_scale: float = field(default=10.0, metadata={"doc": "Term to scale the final delta log-pitch feature"})
    delta_pitch_noise_stddev: float = field(default=0.005, metadata={"doc": "Standard deviation for noise we add to the delta log-pitch"})
    normalization_left_context: int = field(default=75, metadata={"doc": "Left-context (in frames) for moving window normalization"})
    normalization_right_context: int = field(default=75, metadata={"doc": "Right-context (in frames) for moving window normalization"})
    delta_window: int = field(default=2, metadata={"doc": "Number of frames on each side of central frame, to use for delta window"})
    delay: int = field(default=0, metadata={"doc": "Number of frames by which the pitch information is delayed"})
    add_pov_feature: bool = True
    add_normalized_log_pitch: bool = True
    add_delta_pitch: bool = True
    add_raw_log_pitch: bool = False


def _select_lags(opts: PitchExtractionOptions) -> np.ndarray:
    """Geometric lag grid 1/max_f0 .. 1/min_f0, ratio 1+delta_pitch
    (SelectLags, pitch-functions.cc:157)."""
    lags = []
    lag = 1.0 / opts.max_f0
    max_lag = 1.0 / opts.min_f0
    while lag <= max_lag:
        lags.append(lag)
        lag *= 1.0 + opts.delta_pitch
    return np.asarray(lags, np.float64)


def _num_output_samples(n_in: int, rate_in: float, rate_out: float,
                        cutoff: float, num_zeros: int,
                        flush: bool) -> int:
    """LinearResample::GetNumOutputSamples (resample.cc:58)."""
    tick_freq = int(rate_in * rate_out // math.gcd(int(rate_in),
                                                   int(rate_out)))
    ticks_per_in = tick_freq // int(rate_in)
    interval = n_in * ticks_per_in
    if not flush:
        window_width = num_zeros / (2.0 * cutoff)
        interval -= int(math.floor(window_width * tick_freq))
    if interval <= 0:
        return 0
    ticks_per_out = tick_freq // int(rate_out)
    last = interval // ticks_per_out
    if last * ticks_per_out == interval:
        last -= 1
    return int(last) + 1


def _num_frames(n_samples: int, opts: PitchExtractionOptions,
                nccf_last_lag: int, input_finished: bool) -> int:
    """OnlinePitchFeatureImpl::NumFramesAvailable (:768)."""
    shift = opts.nccf_window_shift()
    length = opts.nccf_window_size()
    if not input_finished:
        length += nccf_last_lag
    if n_samples < length:
        return 0
    if not opts.snip_edges:
        if input_finished:
            return int(n_samples * 1.0 / shift + 0.5)
        return int((n_samples - length / 2) * 1.0 / shift + 0.5)
    return int((n_samples - length) // shift) + 1


def _extract_frames(x: np.ndarray, starts: np.ndarray,
                    full_len: int) -> np.ndarray:
    """Zero-padded frame gather (ExtractFrame, :839): frames may begin
    before 0 (snip_edges=false) or run past the end (flush)."""
    n = len(x)
    idx = starts[:, None] + np.arange(full_len)[None, :]
    valid = (idx >= 0) & (idx < n)
    return np.where(valid, x[np.clip(idx, 0, max(n - 1, 0))], 0.0)


def _nccf_batch(frames: np.ndarray, basic: int, first_lag: int,
                last_lag: int) -> Tuple[np.ndarray, np.ndarray]:
    """ComputeCorrelation (:102) over a frame batch: returns
    (inner_prod, norm_prod), each (T, num_lags).  The whole window is
    mean-shifted by the mean of its FIRST `basic` samples."""
    zm = frames - frames[:, :basic].mean(axis=1, keepdims=True)
    base = zm[:, :basic]                              # (T, basic)
    e1 = np.einsum("tw,tw->t", base, base)
    lags = np.arange(first_lag, last_lag + 1)
    L = len(lags)
    T = zm.shape[0]
    # shifted windows as a strided view: (T, L, basic)
    sh = np.lib.stride_tricks.sliding_window_view(
        zm, basic, axis=1)[:, first_lag:last_lag + 1]
    inner = np.einsum("tw,tlw->tl", base, sh)
    e2 = np.einsum("tlw,tlw->tl", sh, sh)
    return inner, e1[:, None] * e2


def _upsample_weights(opts: PitchExtractionOptions, first_lag: int,
                      num_measured: int, lags: np.ndarray) -> np.ndarray:
    """Dense (num_grid, num_measured) matrix applying the reference's
    ArbitraryResample of NCCF-vs-lag onto the geometric grid."""
    rf = opts.resample_freq
    points = lags - first_lag / rf
    rs = ArbitraryResample(num_measured, rf, rf * 0.5, points,
                           num_zeros=opts.upsample_filter_width)
    eye = np.eye(num_measured)
    return np.stack([rs.resample(eye[:, j]) for j in range(num_measured)],
                    axis=1).astype(np.float64)


def _viterbi(nccf_pitch_rs: np.ndarray, lags: np.ndarray,
             opts: PitchExtractionOptions
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward pass + traceback (ComputeBacktraces :306): transition
    cost (i-j)^2 * penalty * log(1+delta)^2, local cost eq. 5, forward
    costs renormalized per frame.  Returns (best path indices (T,),
    final forward costs)."""
    T, L = nccf_pitch_rs.shape
    inter = np.float32((math.log(1.0 + opts.delta_pitch) ** 2)
                       * opts.penalty_factor)
    # float32 arithmetic in the recursion, mirroring the reference's
    # BaseFloat forward costs (near-tie track decisions depend on it)
    nccf32 = np.asarray(nccf_pitch_rs, np.float32)
    lags32 = np.asarray(lags, np.float32)
    local = ((np.float32(1.0) - nccf32)
             + np.float32(opts.soft_min_f0) * lags32[None, :] * nccf32)
    j = np.arange(L)
    trans = ((j[None, :] - j[:, None]).astype(np.float32) ** 2
             * inter)
    fwd = np.zeros(L, np.float32)
    bp = np.zeros((T, L), np.int32)
    for t in range(T):
        tot = fwd[:, None] + trans              # (from j, to i)
        best_j = np.argmin(tot, axis=0)
        fwd = tot[best_j, j] + local[t]
        fwd = fwd - fwd.min()
        bp[t] = best_j
    path = np.zeros(T, np.int32)
    if T:
        path[-1] = int(np.argmin(fwd))
        for t in range(T - 1, 0, -1):
            path[t - 1] = bp[t, path[t]]
    return path, fwd


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: Optional[PitchExtractionOptions] = None
                        ) -> np.ndarray:
    """ComputeKaldiPitch (offline, frames_per_chunk=0): returns (T, 2)
    float32 [nccf_pov, pitch_hz] per frame."""
    if opts is None:
        opts = PitchExtractionOptions()
    wave = np.asarray(wave, np.float64)
    rf = opts.resample_freq

    rs = LinearResample(opts.samp_freq, rf,
                        filter_cutoff=opts.lowpass_cutoff,
                        num_zeros=opts.lowpass_filter_width)
    x = np.asarray(rs.resample(wave), np.float64)   # flushed signal
    n_flush = len(x)
    n_noflush = _num_output_samples(len(wave), opts.samp_freq, rf,
                                    opts.lowpass_cutoff,
                                    opts.lowpass_filter_width,
                                    flush=False)
    n_noflush = min(n_noflush, n_flush)

    outer_min = 1.0 / opts.max_f0 - opts.upsample_filter_width / (2.0 * rf)
    outer_max = 1.0 / opts.min_f0 + opts.upsample_filter_width / (2.0 * rf)
    first_lag = int(math.ceil(rf * outer_min))
    last_lag = int(math.floor(rf * outer_max))
    num_measured = last_lag + 1 - first_lag
    basic = opts.nccf_window_size()
    shift = opts.nccf_window_shift()
    full_len = basic + last_lag
    lags = _select_lags(opts)

    T1 = _num_frames(n_noflush, opts, last_lag, input_finished=False)
    T = _num_frames(n_flush, opts, last_lag, input_finished=True)
    if T == 0:
        return np.zeros((0, 2), np.float32)
    T1 = min(T1, T)

    if opts.snip_edges:
        starts = np.arange(T, dtype=np.int64) * shift
    else:
        starts = (((np.arange(T, dtype=np.int64) * shift * 2 + shift)
                   // 2) - full_len // 2)
    frames = _extract_frames(x, starts, full_len)
    if opts.preemph_coeff != 0.0:
        pre = frames.copy()
        pre[:, 1:] -= opts.preemph_coeff * frames[:, :-1]
        pre[:, 0] *= 1.0 - opts.preemph_coeff
        frames = pre

    inner, norm = _nccf_batch(frames, basic, first_lag, last_lag)

    def mean_square(n):
        s = x[:n]
        return s.dot(s) / n - (s.sum() / n) ** 2

    ms1 = mean_square(n_noflush) if T1 > 0 else 0.0
    ms2 = mean_square(n_flush)
    ms = np.full(T, ms2)
    ms[:T1] = ms1
    ballast = (ms * basic) ** 2 * opts.nccf_ballast

    denom_pitch = np.sqrt(norm + ballast[:, None])
    denom_pov = np.sqrt(norm)
    with np.errstate(invalid="ignore", divide="ignore"):
        nccf_pitch = np.where(denom_pitch != 0, inner / denom_pitch, 0.0)
        nccf_pov = np.where(denom_pov != 0, inner / denom_pov, 0.0)

    up = _upsample_weights(opts, first_lag, num_measured, lags)
    nccf_pitch_rs = nccf_pitch @ up.T
    nccf_pov_rs = nccf_pov @ up.T

    # RecomputeBacktraces (:946): short utterances re-do the early
    # frames under the final ballast if the variance moved > 1%
    if T <= opts.recompute_frame and T1 > 0 and \
            abs(ms1 - ms2) > 0.01 * abs(ms1):
        old_ballast = (ms1 * basic) ** 2 * opts.nccf_ballast
        new_ballast = (ms2 * basic) ** 2 * opts.nccf_ballast
        avg_norm_prod = norm[:T1].mean(axis=1)
        scale = np.sqrt((old_ballast + avg_norm_prod) /
                        (new_ballast + avg_norm_prod))
        nccf_pitch_rs[:T1] *= scale[:, None]

    path, _ = _viterbi(nccf_pitch_rs, lags, opts)
    pitch_hz = 1.0 / lags[path]
    pov = nccf_pov_rs[np.arange(T), path]
    return np.stack([pov, pitch_hz], axis=1).astype(np.float32)


def _nccf_to_pov(nccf: np.ndarray) -> np.ndarray:
    """NccfToPov (:75): learned log-odds fit -> probability."""
    a = np.abs(np.clip(nccf, -1.0, 1.0))
    r = (-5.2 + 5.4 * np.exp(7.5 * (a - 1.0)) + 4.8 * a
         - 2.0 * np.exp(-10.0 * a) + 4.2 * np.exp(20.0 * (a - 1.0)))
    return 1.0 / (1.0 + np.exp(-r))


def _pov_feature(nccf: np.ndarray) -> np.ndarray:
    """NccfToPovFeature (:44): (1.0001 - n)^0.15 - 1."""
    n = np.clip(nccf, -1.0, 1.0)
    return np.power(1.0001 - n, 0.15) - 1.0


def process_pitch(pitch: np.ndarray,
                  opts: Optional[ProcessPitchOptions] = None,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(T, 2) [nccf, pitch_hz] -> the processed stream (typically
    3-dim: pov-feature, normalized-log-pitch, delta-pitch) —
    OnlineProcessPitch semantics at end-of-utterance."""
    if opts is None:
        opts = ProcessPitchOptions()
    T = pitch.shape[0]
    dim = sum([opts.add_pov_feature, opts.add_normalized_log_pitch,
               opts.add_delta_pitch, opts.add_raw_log_pitch])
    if T == 0:
        return np.zeros((0, dim), np.float32)
    nccf = np.asarray(pitch[:, 0], np.float64)
    log_pitch = np.log(np.asarray(pitch[:, 1], np.float64))
    # pitch information may be delayed (opts.delay): frame t reads
    # source frame max(0, t - delay)
    src = np.maximum(np.arange(T) - opts.delay, 0)
    cols = []
    if opts.add_pov_feature:
        cols.append(opts.pov_scale * _pov_feature(nccf[src])
                    + opts.pov_offset)
    if opts.add_normalized_log_pitch:
        pov = _nccf_to_pov(nccf)
        wsum = np.cumsum(np.concatenate([[0.0], pov]))
        psum = np.cumsum(np.concatenate([[0.0], pov * log_pitch]))
        lo = np.maximum(0, np.arange(T) - opts.normalization_left_context)
        hi = np.minimum(T, np.arange(T)
                        + opts.normalization_right_context + 1)
        avg = (psum[hi] - psum[lo]) / (wsum[hi] - wsum[lo])
        cols.append(opts.pitch_scale * (log_pitch - avg)[src])
    if opts.add_delta_pitch:
        # standard delta (feat/feature-functions.cc ComputeDeltas):
        # coeff_j = j / (2 * sum_{k=1..W} k^2), indices edge-clamped
        W = opts.delta_window
        denom = 2.0 * sum(k * k for k in range(1, W + 1))
        delta = np.zeros(T)
        for j in range(1, W + 1):
            plus = log_pitch[np.minimum(np.arange(T) + j, T - 1)]
            minus = log_pitch[np.maximum(np.arange(T) - j, 0)]
            delta += j * (plus - minus) / denom
        if opts.delta_pitch_noise_stddev != 0.0:
            gen = rng if rng is not None else np.random.default_rng(0)
            delta = delta + gen.normal(
                scale=opts.delta_pitch_noise_stddev, size=T)
        cols.append(opts.delta_pitch_scale * delta[src])
    if opts.add_raw_log_pitch:
        cols.append(log_pitch[src])
    return np.stack(cols, axis=1).astype(np.float32)


def compute_and_process_kaldi_pitch(
        wave: np.ndarray,
        pitch_opts: Optional[PitchExtractionOptions] = None,
        process_opts: Optional[ProcessPitchOptions] = None) -> np.ndarray:
    return process_pitch(compute_kaldi_pitch(wave, pitch_opts),
                         process_opts)
