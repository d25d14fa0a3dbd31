"""Data augmentation: speed/volume perturbation and reverberation/noise
(host numpy copy of `kaldi_tpu/feat/perturb.py`; parity:
utils/perturb_data_dir_speed.sh + featbin/wav-reverberate.cc,
and the sox-based volume perturbation).

Speed perturbation is bandlimited resampling with a modified target
rate (sox speed semantics: both pitch and tempo scale); reverberation
is FFT convolution with an impulse response plus optional additive
noise at a given SNR — all batched-friendly array code."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from kaldi_tpu_torch.feat.resample import LinearResample


def speed_perturb(wave: np.ndarray, samp_freq: float,
                  factor: float) -> np.ndarray:
    """sox speed <factor>: resample so duration scales by 1/factor
    (pitch shifts accordingly), output at the original sample rate."""
    if abs(factor - 1.0) < 1e-9:
        return np.asarray(wave, np.float32)
    # interpret the samples as being at rate samp_freq*factor, then
    # resample to samp_freq
    src_rate = samp_freq * factor
    # LinearResample needs integer-ish rates; scale both by 100
    rs = LinearResample(int(round(src_rate * 100)),
                        int(round(samp_freq * 100)))
    return rs.resample(np.asarray(wave, np.float64))


def volume_perturb(wave: np.ndarray, factor: float) -> np.ndarray:
    return (np.asarray(wave, np.float32) * factor).astype(np.float32)


def reverberate(wave: np.ndarray, rir: np.ndarray,
                shift_output: bool = True,
                normalize_power: bool = True) -> np.ndarray:
    """FFT convolution with a room impulse response
    (wav-reverberate --impulse-response)."""
    wave = np.asarray(wave, np.float64)
    rir = np.asarray(rir, np.float64)
    n = len(wave) + len(rir) - 1
    nfft = 1 << (n - 1).bit_length()
    out = np.fft.irfft(np.fft.rfft(wave, nfft) * np.fft.rfft(rir, nfft),
                       nfft)[:n]
    if shift_output:
        # align to the RIR peak so the output is time-aligned with input
        peak = int(np.argmax(np.abs(rir)))
        out = out[peak:peak + len(wave)]
    else:
        out = out[:len(wave)]
    if normalize_power:
        pin = (wave ** 2).mean() + 1e-20
        pout = (out ** 2).mean() + 1e-20
        out = out * np.sqrt(pin / pout)
    return out.astype(np.float32)


def add_noise(wave: np.ndarray, noise: np.ndarray, snr_db: float,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Additive noise at the requested SNR (wav-reverberate
    --additive-signals). The noise is looped/cropped to the wave length."""
    wave = np.asarray(wave, np.float64)
    noise = np.asarray(noise, np.float64)
    if len(noise) < len(wave):
        reps = int(np.ceil(len(wave) / len(noise)))
        noise = np.tile(noise, reps)
    if len(noise) > len(wave):
        start = 0 if rng is None else int(rng.integers(
            0, len(noise) - len(wave) + 1))
        noise = noise[start:start + len(wave)]
    p_sig = (wave ** 2).mean() + 1e-20
    p_noise = (noise ** 2).mean() + 1e-20
    scale = np.sqrt(p_sig / (p_noise * 10 ** (snr_db / 10.0)))
    return (wave + scale * noise).astype(np.float32)
