"""Energy-based VAD (port of `VadEnergyOptions` and `compute_vad_energy`
of `kaldi_tpu/ivector/vad.py`; parity: ivector/voice-activity-detection.h
ComputeVadEnergy): a frame is voiced if its log-energy (the features'
C0) exceeds a threshold, optionally relative to the utterance mean, with
a context-proportion smoothing.  Host numpy: one comparison a frame."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class VadEnergyOptions:
    vad_energy_threshold: float = field(default=5.0, metadata={"doc": "Constant term in energy threshold for MFCC0 for VAD"})
    vad_energy_mean_scale: float = field(default=0.5, metadata={"doc": "If this is set to s, to get the actual threshold we let m be the mean log-energy of the file, and use s*m + vad-energy-threshold"})
    vad_frames_context: int = field(default=0, metadata={"doc": "Number of frames of context on each side of central frame, in window for which energy is monitored"})
    vad_proportion_threshold: float = field(default=0.6, metadata={"doc": "Parameter controlling the proportion of frames within the window that need to have more energy than the threshold"})


def compute_vad_energy(opts: VadEnergyOptions,
                       feats: np.ndarray) -> np.ndarray:
    """feats: (T, D) with log-energy in column 0. Returns (T,) 0/1."""
    log_energy = np.asarray(feats, np.float64)[:, 0]
    T = len(log_energy)
    thresh = opts.vad_energy_threshold
    if opts.vad_energy_mean_scale != 0.0:
        thresh += opts.vad_energy_mean_scale * log_energy.mean()
    above = (log_energy > thresh).astype(np.float64)
    ctx = opts.vad_frames_context
    if ctx == 0:
        return above.astype(np.float32)
    out = np.zeros(T, np.float32)
    csum = np.concatenate([[0.0], np.cumsum(above)])
    for t in range(T):
        lo = max(0, t - ctx)
        hi = min(T, t + ctx + 1)
        num = csum[hi] - csum[lo]
        out[t] = 1.0 if num >= opts.vad_proportion_threshold * (hi - lo) \
            else 0.0
    return out
