"""Batched, fused MFCC extraction on the device (port of
`kaldi_tpu/feat/frontend.py`, MFCC branch).

Parity with the reference's OfflineFeatureTpl + feature-mfcc.cc: the
whole utterance batch is framed with one gather, and DC removal ->
raw log energy -> pre-emphasis -> window -> FFT -> mel -> log -> DCT ->
lifter run as tensor ops over a (batch, frames, window) tensor.  The
mel and DCT stages are float32 matmuls with TF32 off.

Waves arrive on the wire as mu-law bytes (uint8), int16 or float32 and
are widened on the device.  Frame counts are bucketed to a power of
two >= 16, exactly as the reference does, because the padded frames
feed the acoustic model's right context.

A VTLN warp factor selects a warped mel matrix, built once a warp and
kept (the reference's per-warp bank cache).  A batch whose utterances
carry different warps groups its lanes by warp at the mel product, one
matrix a group.

fbank, spectrogram, PLP and dither are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.feat import mel as melmod
from kaldi_tpu_torch.feat import window as win

_FLT_EPS = float(np.finfo(np.float32).eps)
_MU = 255.0


def mulaw_encode(wave: np.ndarray) -> np.ndarray:
    """8-bit mu-law companding of int16-range audio (the wire format of
    the main path); decoded on the device by `_widen_mulaw`."""
    x = np.asarray(wave, np.float32) / 32768.0
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.clip(np.rint((y + 1.0) * 127.5), 0, 255).astype(np.uint8)


def _widen_mulaw(u8: torch.Tensor) -> torch.Tensor:
    y = u8.to(torch.float32) / 127.5 - 1.0
    x = torch.sign(y) * torch.expm1(torch.abs(y) * float(np.log1p(_MU))) / _MU
    return x * 32768.0


def _widen_i16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


@dataclass
class MfccOptions:
    frame_opts: win.FrameExtractionOptions = field(
        default_factory=win.FrameExtractionOptions)
    mel_opts: melmod.MelBanksOptions = field(
        default_factory=lambda: melmod.MelBanksOptions(23))
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False

    def dim(self) -> int:
        return self.num_ceps


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class OfflineFeature:
    """Batched offline MFCC extractor.

    stage_batch(waves)              -> host-side padded wire batch
    compute_batch_device(...)       -> (feats (B, F_bucket, dim) on the
                                        device, nframes (B,) numpy)
    """

    def __init__(self, opts: MfccOptions, device: DeviceLike = None):
        fo = opts.frame_opts
        if fo.dither != 0.0:
            raise NotImplementedError("dither is not ported yet")
        if not fo.snip_edges:
            raise NotImplementedError("snip_edges=False is not ported yet")
        nb = opts.mel_opts.num_bins
        if opts.num_ceps > nb:
            raise ValueError("num-ceps cannot be larger than num-mel-bins")
        self.opts = opts
        self.device = resolve_device(device)
        dev = self.device
        # host float tables become float32 on the device, as jnp.asarray
        # of the reference's tables does
        self._window = torch.from_numpy(
            win.feature_window_function(fo)).to(dev)
        self._mel_cache: Dict[float, torch.Tensor] = {}
        self._dct = torch.from_numpy(
            melmod.compute_dct_matrix(opts.num_ceps, nb)).to(dev)
        self._lifter = (torch.from_numpy(melmod.compute_lifter_coeffs(
            opts.cepstral_lifter, opts.num_ceps)).to(dev)
            if opts.cepstral_lifter != 0.0 else None)

    def dim(self) -> int:
        return self.opts.dim()

    def mel_matrix(self, vtln_warp: float = 1.0) -> torch.Tensor:
        """The (num_bins, num_fft_bins) mel matrix of a warp factor on
        the device, built at its first use."""
        vtln_warp = float(vtln_warp)
        if vtln_warp not in self._mel_cache:
            self._mel_cache[vtln_warp] = torch.from_numpy(
                melmod.mel_banks_matrix(self.opts.mel_opts,
                                        self.opts.frame_opts,
                                        vtln_warp)[0]).to(self.device)
        return self._mel_cache[vtln_warp]

    # -- the fused device program ---------------------------------------
    def _compute_frames(self, frames: torch.Tensor,
                        warps: Sequence[float] = (1.0,)) -> torch.Tensor:
        """frames: (B, F, window_size) float32 -> (B, F, num_ceps);
        warps: one VTLN warp for the batch, or one a lane."""
        opts = self.opts
        fo = opts.frame_opts
        padded = fo.padded_window_size()
        x = frames
        if fo.remove_dc_offset:
            x = x - torch.mean(x, dim=-1, keepdim=True)
        raw_log_energy = torch.log(torch.clamp_min(
            torch.sum(x * x, dim=-1), _FLT_EPS))
        if fo.preemph_coeff != 0.0:
            shifted = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
            x = x - fo.preemph_coeff * shifted
        x = x * self._window
        if opts.raw_energy:
            log_energy = raw_log_energy
        else:
            log_energy = torch.log(torch.clamp_min(
                torch.sum(x * x, dim=-1), _FLT_EPS))
        spectrum = torch.fft.rfft(x, n=padded, dim=-1)
        power = spectrum.real ** 2 + spectrum.imag ** 2
        ps = power[..., :padded // 2]             # Nyquist bin dropped
        with full_f32():
            if len(set(warps)) == 1:
                mel_energies = ps @ self.mel_matrix(warps[0]).T
            else:
                mel_energies = ps.new_empty(ps.shape[:-1] + (
                    self.opts.mel_opts.num_bins,))
                for w in sorted(set(warps)):
                    lanes = torch.tensor([i for i, x in enumerate(warps)
                                          if x == w], device=ps.device)
                    mel_energies[lanes] = (ps[lanes]
                                           @ self.mel_matrix(w).T)
            mel_log = torch.log(torch.clamp_min(mel_energies, _FLT_EPS))
            feat = mel_log @ self._dct.T
        if self._lifter is not None:
            feat = feat * self._lifter
        if opts.use_energy:
            if opts.energy_floor > 0.0:
                log_energy = torch.clamp_min(
                    log_energy, float(np.log(opts.energy_floor)))
            feat = torch.cat([log_energy[..., None], feat[..., 1:]], dim=-1)
        if opts.htk_compat:
            c0 = feat[..., :1]
            if not opts.use_energy:
                c0 = c0 * float(np.sqrt(np.float32(2.0)))
            feat = torch.cat([feat[..., 1:], c0], dim=-1)
        return feat

    def _gather_frames(self, wave_batch: torch.Tensor,
                       max_frames: int) -> torch.Tensor:
        """wave_batch: (B, T) zero-padded -> (B, max_frames, window)."""
        fo = self.opts.frame_opts
        idx = torch.from_numpy(win.frame_indices(
            max_frames, wave_batch.shape[1], fo).astype(np.int64))
        idx = idx.clamp(0, wave_batch.shape[1] - 1).to(wave_batch.device)
        return wave_batch[:, idx]

    # -- public API -------------------------------------------------------
    def stage_batch(self, waves: Sequence[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Host-side staging only: pad the wave batch to its bucket and
        pick the wire dtype.  Returns (batch (B, T) numpy, lengths,
        nframes, bucket_f)."""
        fo = self.opts.frame_opts
        lengths = np.array([len(w) for w in waves], dtype=np.int32)
        nframes = np.array([win.num_frames(int(n), fo) for n in lengths],
                           dtype=np.int32)
        max_f = int(nframes.max(initial=0))
        if max_f == 0:
            return (np.zeros((len(waves), 1), np.float32), lengths,
                    nframes, 0)
        bucket_f = _bucket(max_f)
        need = win.first_sample_of_frame(bucket_f - 1, fo) + \
            fo.window_size()
        T = max(need, int(lengths.max(initial=1)))
        dtypes = {np.asarray(w).dtype for w in waves}
        if dtypes == {np.dtype(np.uint8)}:        # mu-law wire
            wire_dtype = np.uint8
        elif dtypes == {np.dtype(np.int16)}:
            wire_dtype = np.int16
        else:
            wire_dtype = np.float32
        batch = np.zeros((len(waves), T), dtype=wire_dtype)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = np.asarray(w, dtype=wire_dtype)
        return batch, lengths, nframes, bucket_f

    def compute_batch_device(self, waves: Sequence[np.ndarray] = (),
                             staged=None,
                             vtln_warp: Union[float, Sequence[float]] = 1.0
                             ) -> Tuple[torch.Tensor, np.ndarray]:
        """Returns (feats (B, F_bucket, dim) on the device, nframes (B,)
        numpy).  Rows past nframes[i] are computed from the zero padding
        and consumers mask them by length.  staged: the output of
        stage_batch().  vtln_warp: one warp factor for the batch or one
        an utterance."""
        if staged is None:
            staged = self.stage_batch(waves)
        batch, _lengths, nframes, bucket_f = staged
        with torch.inference_mode():
            if bucket_f == 0:
                return (torch.zeros((batch.shape[0], 0, self.dim()),
                                    dtype=torch.float32, device=self.device),
                        nframes)
            wb = torch.from_numpy(batch).to(self.device)
            if wb.dtype == torch.uint8:
                wb = _widen_mulaw(wb)
            elif wb.dtype == torch.int16:
                wb = _widen_i16(wb)
            warps = ([float(vtln_warp)] if np.isscalar(vtln_warp)
                     else [float(w) for w in vtln_warp])
            if len(warps) not in (1, wb.shape[0]):
                raise ValueError(f"{len(warps)} warps for a batch of "
                                 f"{wb.shape[0]}")
            frames = self._gather_frames(wb, bucket_f)
            return self._compute_frames(frames, warps), nframes
