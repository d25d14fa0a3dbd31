"""i-vector extractor training and extraction (port of
`IvectorExtractorOptions`, `IvectorExtractor`,
`OnlineIvectorEstimationStats`, `IvectorExtractorStats` and
`train_ivector_extractor` of `kaldi_tpu/ivector/extractor.py`; parity:
ivector/ivector-extractor.h:136 IvectorExtractor, :314
OnlineIvectorEstimationStats, :481 training stats).

Model: per-UBM-Gaussian total-variability projections M_g (D x R); an
utterance's i-vector posterior given zeroth/first-order stats
(gamma_g, x_g) is

  precision L = I + sum_g gamma_g M_g^T Sigma_g^-1 M_g
  linear    b = prior_offset e_0 + sum_g M_g^T Sigma_g^-1 x_g
  E[w] = L^-1 b

Sigma_g is diagonal when the UBM is a `DiagGmm` and full when it is a
`FullGmm` (the fgmm-global UBM of the recipes).  The model and its files
are host numpy in float64, as in the reference.  All the arithmetic runs
in `ExtractorOnDevice`, on a device in float64, batched over utterances:
the UBM posteriors (in the dtype the reference scores them in), the
statistics as products, U_g = M_g^T Sigma_g^-1 M_g once per pass (the
reference recomputes it for every utterance, which gives the same
numbers), every utterance's L, b and solve at once, the training
statistics A and B as matrix products, and the M-step as one batched
solve.  The streaming estimate (`OnlineIvectorEstimationStats`, and
`ExtractorOnDevice.online_rows`, every chunk boundary of an utterance at
once) reads the same U and Sigma^-1 M, and both read their i-vectors
through `map_ivectors`.  `arrays()` hands a diagonal-UBM extractor to
`ivector.batched.BatchedIvectorExtractor`, the main path's float32
extraction.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.device import CHUNK_FRAMES, DeviceLike, resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import FullGmm
from kaldi_tpu_torch.gmm.ubm import UbmScorer

_log = logging.getLogger(__name__)


@dataclass
class IvectorExtractorOptions:
    ivector_dim: int = field(default=100,
                             metadata={"doc": "Dimension of iVector"})
    num_iters: int = 10
    prior_offset: float = 100.0


class IvectorExtractor:
    def __init__(self, ubm: Union[DiagGmm, FullGmm], ivector_dim: int,
                 prior_offset: float = 100.0, seed: int = 0):
        self.ubm = ubm
        G, D = ubm.num_gauss, ubm.dim
        self.R = ivector_dim
        self.prior_offset = prior_offset
        rng = np.random.default_rng(seed)
        # M[g]: (D, R); column 0 starts at the UBM mean, so that
        # ivector[0] ~ prior_offset reproduces the UBM (the reference's
        # convention)
        self.M = rng.normal(scale=0.1, size=(G, D, ivector_dim))
        self.M[:, :, 0] = ubm.get_means() / prior_offset
        if isinstance(ubm, FullGmm):
            self.sigma_inv = ubm.inv_covars.astype(np.float64).copy()
        else:
            self.sigma_inv = ubm.inv_vars.astype(np.float64).copy()

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]
                    ) -> "IvectorExtractor":
        """The extractor of `recipes.bench_corpus.load_ivector_extractor`'s
        arrays (a diagonal UBM), as the reference package's loader builds
        it."""
        G, D = np.asarray(arrays["means"]).shape
        ubm = DiagGmm(G, D)
        ubm.set_from_means_and_vars(arrays["weights"], arrays["means"],
                                    1.0 / np.asarray(arrays["inv_vars"]))
        out = cls.__new__(cls)
        out.ubm = ubm
        out.M = np.asarray(arrays["M"], np.float64)
        out.sigma_inv = np.asarray(arrays["sigma_inv"], np.float64)
        out.R = out.M.shape[2]
        out.prior_offset = float(arrays["prior"])
        return out

    @property
    def full_cov(self) -> bool:
        return self.sigma_inv.ndim == 3

    @property
    def num_gauss(self) -> int:
        return self.M.shape[0]

    @property
    def dim(self) -> int:
        return self.M.shape[1]

    def arrays(self) -> Dict[str, np.ndarray]:
        """The arrays `BatchedIvectorExtractor` takes (the keys
        `recipes.bench_corpus.load_ivector_extractor` returns)."""
        return {"M": self.M, "sigma_inv": self.sigma_inv,
                "prior": float(self.prior_offset),
                "weights": np.asarray(self.ubm.weights, np.float64),
                "means": self.ubm.get_means().astype(np.float64),
                "inv_vars": self.ubm.inv_vars.astype(np.float64)}

    # -- I/O (the reference package's layout) ---------------------------

    def write(self, stream, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<IvectorExtractor>")
        iof.write_float(stream, binary, self.prior_offset)
        iof.write_int32(stream, binary, self.num_gauss)
        iof.write_int32(stream, binary, self.dim)
        iof.write_int32(stream, binary, self.R)
        for g in range(self.num_gauss):
            iof.write_matrix(stream, binary, self.M[g])
        if self.full_cov:
            iof.write_token(stream, binary, "<SigmaInvFull>")
            iof.write_matrix(stream, binary,
                             self.sigma_inv.reshape(-1, self.dim))
        else:
            iof.write_matrix(stream, binary, self.sigma_inv)
        self.ubm.write(stream, binary)
        iof.write_token(stream, binary, "</IvectorExtractor>")

    @classmethod
    def read(cls, stream, binary: bool = True) -> "IvectorExtractor":
        iof.expect_token(stream, binary, "<IvectorExtractor>")
        prior = iof.read_float(stream, binary)
        G = iof.read_int32(stream, binary)
        D = iof.read_int32(stream, binary)
        R = iof.read_int32(stream, binary)
        M = np.stack([iof.read_matrix(stream, binary).astype(np.float64)
                      for _ in range(G)])
        if iof.peek_token(stream, binary) == "<SigmaInvFull>":
            iof.expect_token(stream, binary, "<SigmaInvFull>")
            sigma_inv = iof.read_matrix(stream, binary).astype(np.float64)
            sigma_inv = sigma_inv.reshape(G, D, D)
            ubm = FullGmm.read(stream, binary)
        else:
            sigma_inv = iof.read_matrix(stream, binary).astype(np.float64)
            ubm = DiagGmm.read(stream, binary)
        iof.expect_token(stream, binary, "</IvectorExtractor>")
        out = cls.__new__(cls)
        out.ubm = ubm
        out.M = M
        out.sigma_inv = sigma_inv
        out.R = R
        out.prior_offset = prior
        return out


class ExtractorOnDevice:
    """An extractor's arithmetic on a device in float64, batched over
    utterances.  M, Sigma^-1 M and U go to the device at construction
    and again at `load_projections` (after an M-step)."""

    def __init__(self, ex: IvectorExtractor, device: DeviceLike = None):
        self.ex = ex
        self.scorer = UbmScorer(ex.ubm, device)
        self.device = self.scorer.device
        self.R, self.G, self.D = ex.R, ex.num_gauss, ex.dim
        self.prior = float(ex.prior_offset)
        self.load_projections()

    def load_projections(self) -> None:
        """Sigma^-1 M (G, D, R) and U (G, R, R) of the extractor's
        current M."""
        M = torch.from_numpy(self.ex.M).to(self.device)
        sigma_inv = torch.from_numpy(self.ex.sigma_inv).to(self.device)
        if self.ex.full_cov:
            self.MS = sigma_inv @ M
        else:
            self.MS = M * sigma_inv[:, :, None]
        self.U = self.MS.transpose(1, 2) @ M

    def posteriors(self, feats: torch.Tensor) -> torch.Tensor:
        """(T, D) float64 frames -> (T, G) float64 posteriors, as the
        reference scores them (frames rounded to float32 first)."""
        x = feats.to(torch.float32).to(self.scorer.frames_dtype)
        return self.scorer.posteriors(x).to(torch.float64)

    def utt_stats(self, feats_list: Sequence[np.ndarray]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """gamma (N, G) and x (N, G, D) of every utterance, float64 on the
        device; utterances go through in padded batches."""
        N = len(feats_list)
        gamma = torch.zeros((N, self.G), dtype=torch.float64,
                            device=self.device)
        x = torch.zeros((N, self.G, self.D), dtype=torch.float64,
                        device=self.device)
        for lo, hi in _batches([f.shape[0] for f in feats_list]):
            T = max(feats_list[i].shape[0] for i in range(lo, hi))
            pad = np.zeros((hi - lo, T, self.D), np.float64)
            mask = np.zeros((hi - lo, T), np.float64)
            for b, i in enumerate(range(lo, hi)):
                n = feats_list[i].shape[0]
                pad[b, :n] = feats_list[i]
                mask[b, :n] = 1.0
            f = torch.from_numpy(pad).to(self.device)
            post = self.posteriors(f.reshape(-1, self.D)).reshape(
                hi - lo, T, self.G) * torch.from_numpy(mask).to(
                    self.device)[:, :, None]
            gamma[lo:hi] = post.sum(dim=1)
            x[lo:hi] = post.transpose(1, 2) @ f
        return gamma, x

    def quad_linear(self, gamma: torch.Tensor, x: torch.Tensor):
        """The data terms of L and b: sum_g gamma_g U_g (..., R, R) and
        sum_g M_g^T Sigma_g^-1 x_g (..., R), of stats gamma (..., G) and
        x (..., G, D)."""
        R = self.R
        lead = gamma.shape[:-1]
        quad = (gamma @ self.U.reshape(self.G, R * R)).reshape(
            *lead, R, R)
        lin = x.reshape(*lead, -1) @ self.MS.reshape(-1, R)
        return quad, lin

    def extract(self, feats_list: Sequence[np.ndarray],
                remove_offset: bool = False) -> np.ndarray:
        """(N, R) i-vectors, float64 on the host; with the prior offset
        unless `remove_offset` (the nnet3 input convention)."""
        ivs = map_ivectors(*self.quad_linear(*self.utt_stats(feats_list)),
                           prior=self.prior).cpu().numpy()
        if remove_offset:
            ivs[:, 0] -= self.prior
        return ivs

    def online_rows(self, feats_list: Sequence[np.ndarray], period: int,
                    max_count: float = 0.0, carry: bool = False
                    ) -> List[np.ndarray]:
        """ivector-extract-online's rows: for each utterance, the MAP
        i-vector (with the prior offset) after each `period` frames, as
        `OnlineIvectorEstimationStats` gives it fed those chunks; with
        `carry`, one set of statistics runs through the utterances in
        order (a speaker's, in ivector-extract-online2).  -> one
        (chunks, R) float64 array an utterance (no rows for one of 0
        frames)."""
        G, D, R = self.G, self.D, self.R
        dev = self.device
        cg = torch.zeros(G, dtype=torch.float64, device=dev)
        cx = torch.zeros((G, D), dtype=torch.float64, device=dev)
        out = []
        for feats in feats_list:
            if not carry:
                cg, cx = cg * 0, cx * 0
            T = feats.shape[0]
            C = -(-T // period)
            if C == 0:
                out.append(np.zeros((0, R)))
                continue
            f = torch.zeros((C * period, D), dtype=torch.float64,
                            device=dev)
            f[:T] = torch.from_numpy(np.asarray(feats, np.float64)).to(dev)
            post = self.posteriors(f)
            post[T:] = 0.0
            post = post.reshape(C, period, G)
            g_cum = torch.cumsum(post.sum(dim=1), dim=0) + cg     # (C, G)
            x_cum = torch.cumsum(post.transpose(1, 2)
                                 @ f.reshape(C, period, D), dim=0) + cx
            cg, cx = g_cum[-1], x_cum[-1]
            out.append(map_ivectors(
                *self.quad_linear(g_cum, x_cum), g_cum.sum(dim=1),
                max_count, self.prior).cpu().numpy())
        return out


def map_ivectors(quad: torch.Tensor, lin: torch.Tensor,
                 counts: Optional[torch.Tensor] = None,
                 max_count: float = 0.0, prior: float = 0.0
                 ) -> torch.Tensor:
    """MAP i-vectors (..., R), with the prior offset, of the data terms
    `quad` (..., R, R) and `lin` (..., R) of `ExtractorOnDevice.
    quad_linear`.  With `max_count` > 0, stats whose frame count
    `counts` (...) exceeds it are scaled by max_count / count first (the
    reference's soft limit, which keeps the prior at full weight)."""
    if max_count > 0:
        scale = torch.where(counts > max_count,
                            max_count / counts.clamp(min=1e-300),
                            torch.ones_like(counts))
        quad = quad * scale[..., None, None]
        lin = lin * scale[..., None]
    lin = lin.clone()
    lin[..., 0] += prior
    eye = torch.eye(quad.shape[-1], dtype=quad.dtype, device=quad.device)
    return _solve(eye + quad, lin[..., None])[..., 0]


def _batches(lengths: Sequence[int], frames: int = CHUNK_FRAMES):
    """(lo, hi) ranges of consecutive utterances whose padded batch holds
    at most `frames` rows (one utterance at least)."""
    lo = 0
    while lo < len(lengths):
        hi, T = lo + 1, lengths[lo]
        while hi < len(lengths) and \
                max(T, lengths[hi]) * (hi + 1 - lo) <= frames:
            T = max(T, lengths[hi])
            hi += 1
        yield lo, hi
        lo = hi


def _check(X: torch.Tensor, info: torch.Tensor) -> None:
    """Raise on a singular system of a batched solve or inverse, on the
    CPU and on the card alike (numpy raises LinAlgError there)."""
    bad = torch.nonzero(info.reshape(-1)).flatten()
    if bad.numel() or not bool(torch.isfinite(X).all()):
        raise KaldiTpuError(f"singular system in a batched solve "
                            f"(batch entries {bad.tolist()[:8]})")


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    X, info = torch.linalg.solve_ex(A, B)
    _check(X, info)
    return X


class OnlineIvectorEstimationStats:
    """Streaming stats (ivector-extractor.h:314): accumulate frames
    (possibly weighted), read out the current MAP i-vector at any time.
    Float64 on `device`, over `ExtractorOnDevice`'s posteriors, U and
    Sigma^-1 M (the reference package recomputes the last two for every
    chunk); the stats are kept as the data terms of `map_ivectors`."""

    def __init__(self, extractor: IvectorExtractor,
                 max_count: float = 0.0, device: DeviceLike = None):
        self.ex = extractor
        self.on = ExtractorOnDevice(extractor, device)
        self.R = extractor.R
        self.quad = torch.zeros((self.R, self.R), dtype=torch.float64,
                                device=self.on.device)
        self.lin = torch.zeros(self.R, dtype=torch.float64,
                               device=self.on.device)
        self.num_frames = 0.0
        self.max_count = max_count

    def acc_frames(self, feats: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> None:
        f = torch.from_numpy(np.asarray(feats, np.float64)).to(
            self.on.device)
        post = self.on.posteriors(f)
        if weights is not None:
            post = post * torch.from_numpy(
                np.asarray(weights, np.float64)).to(self.on.device)[:, None]
        gamma = post.sum(dim=0)
        quad, lin = self.on.quad_linear(gamma, post.T @ f)
        self.quad += quad
        self.lin += lin
        self.num_frames += float(gamma.sum())

    def ivector(self) -> np.ndarray:
        n = torch.tensor(self.num_frames, dtype=torch.float64)
        return map_ivectors(self.quad, self.lin, n.to(self.on.device),
                            self.max_count, self.on.prior).cpu().numpy()

    def scale(self, s: float) -> None:
        """Scale stats (for decaying old utterances' influence)."""
        self.quad *= s
        self.lin *= s
        self.num_frames *= s

    def copy(self) -> "OnlineIvectorEstimationStats":
        st = OnlineIvectorEstimationStats.__new__(OnlineIvectorEstimationStats)
        st.__dict__.update(self.__dict__)
        st.quad = self.quad.clone()
        st.lin = self.lin.clone()
        return st


class IvectorExtractorStats:
    """Accumulable E-step statistics (ivector-extractor.h:481
    IvectorExtractorStats): acc a batch of utterances on a device, sum
    across jobs (ivector-extractor-sum-accs), update() applies the M-step
    (ivector-extractor-est)."""

    def __init__(self, ex: IvectorExtractor):
        G, D, R = ex.num_gauss, ex.dim, ex.R
        self.A = np.zeros((G, R, R))   # sum_u gamma_u,g E[w w^T]
        self.B = np.zeros((G, D, R))   # sum_u x_u,g E[w]^T
        self.num_utts = 0

    def acc_device(self, on: ExtractorOnDevice,
                   feats_list: Sequence[np.ndarray]) -> None:
        """The stats of every utterance of `feats_list` on `on`'s
        device."""
        self.acc_utt_stats(on, *on.utt_stats(feats_list))

    def acc_utt_stats(self, on: ExtractorOnDevice, gamma: torch.Tensor,
                      x: torch.Tensor) -> None:
        """The stats of utterances' gamma (N, G) and x (N, G, D) on `on`'s
        device: each utterance's posterior mean and E[w w^T] from one
        batched inverse, A and B as products over the utterances."""
        quad, lin = on.quad_linear(gamma, x)
        N, G, D, R = gamma.shape[0], on.G, on.D, on.R
        lin[:, 0] += on.prior
        cov, info = torch.linalg.inv_ex(
            torch.eye(R, dtype=torch.float64, device=on.device) + quad)
        _check(cov, info)
        mean = (cov @ lin[:, :, None])[:, :, 0]
        Eww = cov + mean[:, :, None] * mean[:, None, :]
        self.A += (gamma.T @ Eww.reshape(N, R * R)).reshape(
            G, R, R).cpu().numpy()
        self.B += (x.reshape(N, G * D).T @ mean).reshape(
            G, D, R).cpu().numpy()
        self.num_utts += N

    def add(self, other: "IvectorExtractorStats") -> None:
        self.A += other.A
        self.B += other.B
        self.num_utts += other.num_utts

    def update(self, ex: IvectorExtractor,
               device: DeviceLike = "cpu") -> None:
        """M-step: M_g = B_g A_g^-1, every Gaussian's solve at once on
        `device`; a Gaussian whose A_g is singular (no occupancy) raises,
        as numpy's solve does in the reference."""
        dev = resolve_device(device)
        A = torch.from_numpy(self.A).to(dev)
        B = torch.from_numpy(self.B).to(dev)
        ex.M = _solve(A.transpose(1, 2), B.transpose(1, 2)).transpose(
            1, 2).cpu().numpy().copy()

    # -- I/O (the reference package's layout) ---------------------------

    def write(self, stream, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<IvectorExtractorStats>")
        iof.write_int32(stream, binary, self.num_utts)
        G = self.A.shape[0]
        iof.write_int32(stream, binary, G)
        for g in range(G):
            iof.write_matrix(stream, binary, self.A[g])
            iof.write_matrix(stream, binary, self.B[g])
        iof.write_token(stream, binary, "</IvectorExtractorStats>")

    @classmethod
    def read(cls, stream, binary: bool = True) -> "IvectorExtractorStats":
        iof.expect_token(stream, binary, "<IvectorExtractorStats>")
        out = cls.__new__(cls)
        out.num_utts = iof.read_int32(stream, binary)
        G = iof.read_int32(stream, binary)
        A, B = [], []
        for _ in range(G):
            A.append(iof.read_matrix(stream, binary))
            B.append(iof.read_matrix(stream, binary))
        out.A = np.stack(A).astype(np.float64)
        out.B = np.stack(B).astype(np.float64)
        iof.expect_token(stream, binary, "</IvectorExtractorStats>")
        return out


def train_ivector_extractor(ubm, feats_list: Sequence[np.ndarray],
                            opts: Optional[IvectorExtractorOptions] = None,
                            device: DeviceLike = None) -> IvectorExtractor:
    """EM training of the T-matrix (ivector-extractor.h:481 stats +
    update) on `device`; ubm may be a DiagGmm or a full-covariance
    FullGmm.  The UBM is fixed, so the utterances' stats are taken once."""
    if opts is None:
        opts = IvectorExtractorOptions()
    ex = IvectorExtractor(ubm, opts.ivector_dim, opts.prior_offset)
    on = ExtractorOnDevice(ex, device)
    gamma, x = on.utt_stats(feats_list)
    for it in range(opts.num_iters):
        stats = IvectorExtractorStats(ex)
        stats.acc_utt_stats(on, gamma, x)
        stats.update(ex, on.device)
        on.load_projections()
        _log.info("ivector EM iteration %d done", it)
    return ex
