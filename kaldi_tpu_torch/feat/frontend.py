"""Batched, fused feature extraction on the device: MFCC, fbank,
spectrogram and PLP (port of `kaldi_tpu/feat/frontend.py`).

Parity with the reference's OfflineFeatureTpl + feature-mfcc.cc,
feature-fbank.cc, feature-spectrogram.cc and feature-plp.cc: the whole
utterance batch is framed with one gather, and dither -> DC removal ->
raw log energy -> pre-emphasis -> window -> FFT -> (mel -> log -> DCT ->
lifter | mel -> log | log power | mel -> equal loudness -> compression
-> IDFT -> Durbin -> cepstra -> lifter) run as tensor ops over a
(batch, frames, window) tensor.  The mel, DCT and IDFT stages are
float32 matmuls with TF32 off.

Waves arrive on the wire as mu-law bytes (uint8), int16 or float32 and
are widened on the device.  Frame counts are bucketed to a power of
two >= 16, exactly as the reference does, because the padded frames
feed the acoustic model's right context.  With `snip_edges=False` the
frames are centred on their shift and their samples past either edge
of an utterance are reflected back into it, lane by lane
(`window.reflect_indices`).

Dither adds Gaussian noise to every frame window (each overlapping
window draws anew, as the reference does) from a `torch.Generator` on
the frames' device, seeded from `seed` or, when that is None, from the
computer's own `np.random.default_rng(0)` stream, as the reference
picks its PRNG key; the noise's bits are not JAX's.

A VTLN warp factor selects a warped mel matrix (and, for PLP, its
equal-loudness vector), built once a warp and kept (the reference's
per-warp bank cache).  A batch whose utterances carry different warps
groups its lanes by warp at the mel product, one matrix a group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.feat import mel as melmod
from kaldi_tpu_torch.feat import plp as plpmod
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

    feature_type = "mfcc"

    def dim(self) -> int:
        return self.num_ceps


@dataclass
class FbankOptions:
    frame_opts: win.FrameExtractionOptions = field(
        default_factory=win.FrameExtractionOptions)
    mel_opts: melmod.MelBanksOptions = field(
        default_factory=lambda: melmod.MelBanksOptions(23))
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    htk_compat: bool = False
    use_log_fbank: bool = True
    use_power: bool = True

    feature_type = "fbank"

    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


@dataclass
class SpectrogramOptions:
    frame_opts: win.FrameExtractionOptions = field(
        default_factory=win.FrameExtractionOptions)
    energy_floor: float = 0.0
    raw_energy: bool = True
    # registered by the reference and never read there; the port refuses
    # True instead of ignoring it
    return_raw_fft: bool = False

    feature_type = "spectrogram"

    def dim(self) -> int:
        return self.frame_opts.padded_window_size() // 2 + 1


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def dither_noise(shape, seed: int, dither: float,
                 device: torch.device) -> torch.Tensor:
    """The dither noise the program adds to (B, F, window) frames:
    Gaussian, standard deviation `dither`, from a generator of `seed` on
    `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * dither


def _floor_energy(log_energy: torch.Tensor, opts) -> torch.Tensor:
    if opts.energy_floor > 0.0:
        return torch.clamp_min(log_energy, float(np.log(opts.energy_floor)))
    return log_energy


class OfflineFeature:
    """Batched offline feature extractor of one type (the options' class
    picks it: MfccOptions, FbankOptions, SpectrogramOptions or
    PlpOptions).

    stage_batch(waves)              -> host-side padded wire batch
    compute_batch_device(...)       -> (feats (B, F_bucket, dim) on the
                                        device, nframes (B,) numpy)
    compute_batch(waves)            -> a host array an utterance
    """

    def __init__(self, opts, device: DeviceLike = None):
        fo = opts.frame_opts
        self.type = opts.feature_type
        if self.type == "spectrogram" and opts.return_raw_fft:
            raise NotImplementedError(
                "--return-raw-fft: the reference registers it and never "
                "reads it; the port does not ignore it")
        self.opts = opts
        self.device = resolve_device(device)
        dev = self.device
        # host float tables become float32 on the device, as jnp.asarray
        # of the reference's tables does
        self._window = torch.from_numpy(
            win.feature_window_function(fo)).to(dev)
        self._mel_cache: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lifter = None
        if self.type == "mfcc":
            nb = opts.mel_opts.num_bins
            if opts.num_ceps > nb:
                raise ValueError("num-ceps cannot be larger than "
                                 "num-mel-bins")
            self._dct = torch.from_numpy(
                melmod.compute_dct_matrix(opts.num_ceps, nb)).to(dev)
        if self.type == "plp":
            if opts.num_ceps > opts.lpc_order + 1:
                raise ValueError("num-ceps cannot be larger than "
                                 "lpc-order + 1")
            self._idft = torch.from_numpy(plpmod.idft_bases(
                opts.lpc_order + 1, opts.mel_opts.num_bins + 2)).to(dev)
        if self.type in ("mfcc", "plp") and opts.cepstral_lifter != 0.0:
            self._lifter = torch.from_numpy(melmod.compute_lifter_coeffs(
                opts.cepstral_lifter, opts.num_ceps)).to(dev)
        self._rng = np.random.default_rng(0)

    def dim(self) -> int:
        return self.opts.dim()

    def _mel_pair(self, vtln_warp: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (num_bins, num_fft_bins) mel matrix of a warp factor and
        its equal-loudness vector on the device, built at first use."""
        vtln_warp = float(vtln_warp)
        if vtln_warp not in self._mel_cache:
            mat, center = melmod.mel_banks_matrix(
                self.opts.mel_opts, self.opts.frame_opts, vtln_warp)
            self._mel_cache[vtln_warp] = (
                torch.from_numpy(mat).to(self.device),
                torch.from_numpy(plpmod.equal_loudness_vector(
                    center)).to(self.device))
        return self._mel_cache[vtln_warp]

    def _mel_energies(self, ps: torch.Tensor,
                      warps: Sequence[float]) -> torch.Tensor:
        """ps (B, F, num_fft_bins) -> (B, F, num_bins), a warp's matrix a
        group of lanes; PLP's equal-loudness weights applied after."""
        plp = self.type == "plp"

        def project(p, w):
            mat, eql = self._mel_pair(w)
            m = p @ mat.T
            return m * eql if plp else m
        if len(set(warps)) == 1:
            return project(ps, warps[0])
        out = ps.new_empty(ps.shape[:-1] + (self.opts.mel_opts.num_bins,))
        for w in sorted(set(warps)):
            lanes = torch.tensor([i for i, x in enumerate(warps) if x == w],
                                 device=ps.device)
            out[lanes] = project(ps[lanes], w)
        return out

    # -- the fused device program ---------------------------------------
    def _compute_frames(self, frames: torch.Tensor,
                        warps: Sequence[float] = (1.0,),
                        seed: Optional[int] = None) -> torch.Tensor:
        """frames: (B, F, window_size) float32 -> (B, F, dim); warps: one
        VTLN warp for the batch, or one a lane; seed: the dither noise's
        (needed when the options dither)."""
        opts = self.opts
        fo = opts.frame_opts
        padded = fo.padded_window_size()
        x = frames
        if fo.dither != 0.0:
            x = x + dither_noise(x.shape, seed, fo.dither, x.device)
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

        if self.type == "spectrogram":
            feat = torch.log(torch.clamp_min(power, _FLT_EPS))
            return torch.cat([_floor_energy(log_energy, opts)[..., None],
                              feat[..., 1:]], dim=-1)

        ps = power[..., :padded // 2]             # Nyquist bin dropped
        if not getattr(opts, "use_power", True):
            ps = torch.sqrt(ps)
        with full_f32():
            mel_energies = self._mel_energies(ps, warps)
            if self.type == "plp":
                return self._plp(mel_energies, log_energy)
            if self.type == "fbank":
                if opts.use_log_fbank:
                    mel_energies = torch.log(torch.clamp_min(
                        mel_energies, _FLT_EPS))
                if not opts.use_energy:
                    return mel_energies
                e = _floor_energy(log_energy, opts)[..., None]
                return torch.cat([mel_energies, e] if opts.htk_compat
                                 else [e, mel_energies], dim=-1)
            mel_log = torch.log(torch.clamp_min(mel_energies, _FLT_EPS))
            feat = mel_log @ self._dct.T
        if self._lifter is not None:
            feat = feat * self._lifter
        if opts.use_energy:
            feat = torch.cat([_floor_energy(log_energy, opts)[..., None],
                              feat[..., 1:]], dim=-1)
        if opts.htk_compat:
            c0 = feat[..., :1]
            if not opts.use_energy:
                c0 = c0 * float(np.sqrt(np.float32(2.0)))
            feat = torch.cat([feat[..., 1:], c0], dim=-1)
        return feat

    def _plp(self, mel_energies: torch.Tensor,
             log_energy: torch.Tensor) -> torch.Tensor:
        """The PLP tail (feature-plp.cc:140-180) from the equal-loudness
        weighted mel energies."""
        opts = self.opts
        order = opts.lpc_order
        m = torch.pow(torch.clamp_min(mel_energies, _FLT_EPS),
                      opts.compress_factor)
        # duplicate first and last bins (feature-plp.cc:152)
        dup = torch.cat([m[..., :1], m, m[..., -1:]], dim=-1)
        autocorr = dup @ self._idft.T
        lpc, resid = plpmod.durbin_batch(autocorr, order)
        # quirk kept from feature-plp.cc:162: the residual LOG energy is
        # floored at FLT_MIN (about 0), not at the log of a floor
        resid_log = torch.clamp_min(
            torch.log(torch.clamp_min(resid, 1e-37)),
            float(np.finfo(np.float32).tiny))
        ceps = plpmod.lpc_to_cepstrum_batch(lpc, order)
        feat = torch.cat([resid_log[..., None],
                          ceps[..., :opts.num_ceps - 1]], dim=-1)
        if self._lifter is not None:
            feat = feat * self._lifter
        if opts.cepstral_scale != 1.0:
            feat = feat * opts.cepstral_scale
        if opts.use_energy:
            feat = torch.cat([_floor_energy(log_energy, opts)[..., None],
                              feat[..., 1:]], dim=-1)
        if opts.htk_compat:
            feat = torch.cat([feat[..., 1:], feat[..., :1]], dim=-1)
        return feat

    def _gather_frames(self, wave_batch: torch.Tensor, lengths: np.ndarray,
                       max_frames: int) -> torch.Tensor:
        """wave_batch: (B, T) zero-padded; lengths: (B,) true lengths ->
        (B, max_frames, window)."""
        fo = self.opts.frame_opts
        B, T = wave_batch.shape
        idx = torch.from_numpy(win.frame_indices(
            max_frames, T, fo).astype(np.int64)).to(wave_batch.device)
        if fo.snip_edges:
            return wave_batch[:, idx.clamp(0, T - 1)]
        n = torch.as_tensor(np.maximum(np.asarray(lengths, np.int64), 1),
                            device=wave_batch.device)[:, None, None]
        ref = win.reflect_indices(idx[None], n)
        return torch.gather(wave_batch, 1, ref.reshape(B, -1)).reshape(
            B, max_frames, -1)

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
        # padded sample budget covering bucket_f frames; reflection maps
        # any out-of-range index back into [0, true_length)
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
                             vtln_warp: Union[float, Sequence[float]] = 1.0,
                             seed: Optional[int] = None
                             ) -> Tuple[torch.Tensor, np.ndarray]:
        """Returns (feats (B, F_bucket, dim) on the device, nframes (B,)
        numpy).  Rows past nframes[i] are computed from the padding (zeros,
        or the reflected utterance with snip_edges=False) and consumers
        mask them by length.  staged: the output of stage_batch().
        vtln_warp: one warp factor for the batch or one an utterance.
        seed: the dither noise's; None draws one from the computer's own
        stream."""
        if staged is None:
            staged = self.stage_batch(waves)
        batch, lengths, nframes, bucket_f = staged
        with torch.inference_mode():
            if bucket_f == 0:
                return (torch.zeros((batch.shape[0], 0, self.dim()),
                                    dtype=torch.float32, device=self.device),
                        nframes)
            if self.opts.frame_opts.dither != 0.0 and seed is None:
                seed = int(self._rng.integers(2 ** 31 - 1))
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
            frames = self._gather_frames(wb, lengths, bucket_f)
            return self._compute_frames(frames, warps, seed), nframes

    def compute_batch(self, waves: Sequence[np.ndarray],
                      vtln_warp: Union[float, Sequence[float]] = 1.0,
                      seed: Optional[int] = None) -> List[np.ndarray]:
        """A host float32 array (num_frames, dim) an utterance."""
        feats, nframes = self.compute_batch_device(waves, vtln_warp=vtln_warp,
                                                   seed=seed)
        feats = feats.cpu().numpy()
        return [feats[i, :nframes[i]] for i in range(len(waves))]

    def compute(self, wave: np.ndarray, vtln_warp: float = 1.0,
                seed: Optional[int] = None) -> np.ndarray:
        return self.compute_batch([wave], vtln_warp, seed)[0]


def make_feature_computer(feature_type: str, opts=None,
                          device: DeviceLike = None) -> OfflineFeature:
    if opts is None:
        opts = {"mfcc": MfccOptions, "fbank": FbankOptions,
                "spectrogram": SpectrogramOptions,
                "plp": plpmod.PlpOptions}[feature_type]()
    return OfflineFeature(opts, device=device)
