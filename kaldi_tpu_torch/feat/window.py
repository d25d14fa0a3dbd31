"""Frame extraction: options, frame counting and window functions.

Numpy copy of `kaldi_tpu/feat/window.py` (parity with the reference's
feat/feature-window.{h,cc}: FrameExtractionOptions, NumFrames,
FirstSampleOfFrame, FeatureWindowFunction) and the reference's
reflection of frame indices about the utterance's edges, which frames
with `snip_edges=False`, as PyTorch ops on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def round_up_to_nearest_power_of_two(n: int) -> int:
    assert n > 0
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class FrameExtractionOptions:
    # metadata "name": the command-line option of the reference's tools
    samp_freq: float = field(default=16000.0,
                             metadata={"name": "sample-frequency"})
    frame_shift_ms: float = field(default=10.0,
                                  metadata={"name": "frame-shift"})
    frame_length_ms: float = field(default=25.0,
                                   metadata={"name": "frame-length"})
    dither: float = 1.0
    preemph_coeff: float = field(
        default=0.97, metadata={"name": "preemphasis-coefficient"})
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return round_up_to_nearest_power_of_two(self.window_size())
        return self.window_size()


def first_sample_of_frame(frame: int, opts: FrameExtractionOptions) -> int:
    shift = opts.window_shift()
    if opts.snip_edges:
        return frame * shift
    midpoint = shift * frame + shift // 2
    return midpoint - opts.window_size() // 2


def num_frames(num_samples: int, opts: FrameExtractionOptions,
               flush: bool = True) -> int:
    shift = opts.window_shift()
    length = opts.window_size()
    if opts.snip_edges:
        if num_samples < length:
            return 0
        return 1 + (num_samples - length) // shift
    n = (num_samples + shift // 2) // shift
    if flush:
        return n
    end_of_last = first_sample_of_frame(n - 1, opts) + length
    while n > 0 and end_of_last > num_samples:
        n -= 1
        end_of_last -= shift
    return n


def feature_window_function(opts: FrameExtractionOptions) -> np.ndarray:
    """The window vector (float64 math then f32, like the reference)."""
    m = opts.window_size()
    a = 2.0 * np.pi / (m - 1)
    i = np.arange(m, dtype=np.float64)
    wt = opts.window_type
    if wt == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif wt == "sine":
        w = np.sin(0.5 * a * i)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif wt == "povey":
        w = np.power(0.5 - 0.5 * np.cos(a * i), 0.85)
    elif wt == "rectangular":
        w = np.ones(m)
    elif wt == "blackman":
        w = (opts.blackman_coeff - 0.5 * np.cos(a * i)
             + (0.5 - opts.blackman_coeff) * np.cos(2 * a * i))
    else:
        raise ValueError(f"invalid window type {wt!r}")
    return w.astype(np.float32)


def frame_indices(max_frames: int, wave_len: int,
                  opts: FrameExtractionOptions) -> np.ndarray:
    """Index matrix (max_frames, window_size) into a zero-padded waveform
    buffer of length `wave_len`."""
    starts = np.array([first_sample_of_frame(f, opts)
                       for f in range(max_frames)], dtype=np.int32)
    offs = np.arange(opts.window_size(), dtype=np.int32)
    return starts[:, None] + offs[None, :]


def reflect_indices(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect indices into [0, n) about the edges (feature-window.cc:205
    convention: -1 -> 0, n -> n-1).  Two passes and then a clip, as the
    reference does (not Kaldi's unbounded loop): enough while a window
    is at most twice the utterance."""
    for _ in range(2):
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return torch.minimum(torch.clamp_min(idx, 0), n - 1)
