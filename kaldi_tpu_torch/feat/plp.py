"""PLP feature pieces (port of `kaldi_tpu/feat/plp.py`; parity with the
reference's feat/feature-plp.cc and mel-computations.cc Durbin:267,
Lpc2Cepstrum:300, GetEqualLoudnessVector:311, feature-functions.cc
InitIdftBases:188).

The tables are host numpy, built once.  The per-frame scalar Durbin and
cepstrum recursions become order-indexed loops of elementwise PyTorch
ops over the whole (batch, frames) tensor on the device: at order 12 a
few hundred small ops a batch, in the reference's order of operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from kaldi_tpu_torch.feat import mel as melmod
from kaldi_tpu_torch.feat import window as win


@dataclass
class PlpOptions:
    frame_opts: win.FrameExtractionOptions = field(
        default_factory=win.FrameExtractionOptions)
    mel_opts: melmod.MelBanksOptions = field(
        default_factory=lambda: melmod.MelBanksOptions(23))
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    feature_type = "plp"

    def dim(self) -> int:
        return self.num_ceps


def equal_loudness_vector(center_freqs: np.ndarray) -> np.ndarray:
    fsq = center_freqs.astype(np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(
        np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    angle = np.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def durbin_batch(autocorr: torch.Tensor, order: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin over the last axis: autocorr (..., order+1) ->
    (lpc (..., order), residual energy (...,))."""
    E = autocorr[..., 0]
    lpc = [torch.zeros_like(E) for _ in range(order)]
    for i in range(order):
        ki = autocorr[..., i + 1]
        for j in range(i):
            ki = ki + lpc[j] * autocorr[..., i - j]
        ki = ki / E
        c = torch.clamp_min(1.0 - ki * ki, 1.0e-5)
        E = E * c
        new = [None] * (i + 1)
        new[i] = -ki
        for j in range(i):
            new[j] = lpc[j] - ki * lpc[i - j - 1]
        for j in range(i + 1):
            lpc[j] = new[j]
    return torch.stack(lpc, dim=-1), E


def lpc_to_cepstrum_batch(lpc: torch.Tensor, order: int) -> torch.Tensor:
    """Lpc2Cepstrum over the last axis."""
    ceps = []
    for i in range(order):
        s = torch.zeros_like(lpc[..., 0])
        for j in range(i):
            s = s + (i - j) * lpc[..., j] * ceps[i - j - 1]
        ceps.append(-lpc[..., i] - s / (i + 1))
    return torch.stack(ceps, dim=-1)
