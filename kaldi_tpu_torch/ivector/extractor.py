"""i-vector extractor training and extraction (port of
`IvectorExtractorOptions`, `IvectorExtractor`, `IvectorExtractorStats`
and `train_ivector_extractor` of `kaldi_tpu/ivector/extractor.py`;
parity: ivector/ivector-extractor.h:136 IvectorExtractor, :481 training
stats).  Host numpy in float64, as in the reference.

Model: per-UBM-Gaussian total-variability projections M_g (D x R); an
utterance's i-vector posterior given zeroth/first-order stats
(gamma_g, x_g) is

  precision L = I + sum_g gamma_g M_g^T Sigma_g^-1 M_g
  linear    b = prior_offset e_0 + sum_g M_g^T Sigma_g^-1 x_g
  E[w] = L^-1 b

with a diagonal UBM (Sigma_g diagonal).  `arrays()` gives the extractor
to `ivector.batched.BatchedIvectorExtractor`, the card's batched
extraction.

Not carried over yet: full-covariance UBMs, the extractor's and the
stats' I/O, and `OnlineIvectorEstimationStats` (the batched online
state of `ivector.batched` serves the port's online pipelines).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm

_log = logging.getLogger(__name__)


@dataclass
class IvectorExtractorOptions:
    ivector_dim: int = field(default=100,
                             metadata={"doc": "Dimension of iVector"})
    num_iters: int = 10
    prior_offset: float = 100.0


class IvectorExtractor:
    def __init__(self, ubm: DiagGmm, ivector_dim: int,
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
        self.sigma_inv = ubm.inv_vars.astype(np.float64).copy()

    def _ms(self) -> np.ndarray:
        """MS[g] = Sigma_g^-1 M_g: (G, D, R)."""
        return self.M * self.sigma_inv[:, :, None]

    @property
    def num_gauss(self) -> int:
        return self.M.shape[0]

    @property
    def dim(self) -> int:
        return self.M.shape[1]

    def acc_utt_stats(self, feats: np.ndarray,
                      posteriors: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Zeroth/first-order stats (gamma (G,), x (G, D)) against the
        UBM."""
        feats = np.asarray(feats, np.float64)
        if posteriors is None:
            posteriors = self.ubm.component_posteriors(
                feats.astype(np.float32)).astype(np.float64)
        gamma = posteriors.sum(axis=0)
        x = posteriors.T @ feats
        return gamma, x

    def _precision_linear(self, gamma: np.ndarray, x: np.ndarray):
        MS = self._ms()                                     # (G, D, R)
        U = np.einsum("gdr,gds->grs", MS, self.M)           # (G, R, R)
        L = np.eye(self.R) + np.einsum("g,grs->rs", gamma, U)
        b = np.einsum("gdr,gd->r", MS, x)
        b[0] += self.prior_offset
        return L, b

    def extract(self, feats: np.ndarray,
                posteriors: Optional[np.ndarray] = None) -> np.ndarray:
        gamma, x = self.acc_utt_stats(feats, posteriors)
        L, b = self._precision_linear(gamma, x)
        return np.linalg.solve(L, b)

    def extract_offset_removed(self, feats) -> np.ndarray:
        iv = self.extract(feats)
        iv[0] -= self.prior_offset
        return iv

    def arrays(self) -> Dict[str, np.ndarray]:
        """The arrays `BatchedIvectorExtractor` takes (the keys
        `recipes.bench_corpus.load_ivector_extractor` returns)."""
        return {"M": self.M, "sigma_inv": self.sigma_inv,
                "prior": float(self.prior_offset),
                "weights": np.asarray(self.ubm.weights, np.float64),
                "means": self.ubm.get_means().astype(np.float64),
                "inv_vars": self.ubm.inv_vars.astype(np.float64)}


class IvectorExtractorStats:
    """Accumulable E-step statistics (ivector-extractor.h:481
    IvectorExtractorStats); update() applies the M-step."""

    def __init__(self, ex: IvectorExtractor):
        G, D, R = ex.num_gauss, ex.dim, ex.R
        self.A = np.zeros((G, R, R))   # sum_u gamma_u,g E[w w^T]
        self.B = np.zeros((G, D, R))   # sum_u x_u,g E[w]^T
        self.num_utts = 0

    def acc_stats(self, ex: IvectorExtractor, feats: np.ndarray,
                  posteriors: Optional[np.ndarray] = None) -> None:
        gamma, x = ex.acc_utt_stats(feats, posteriors)
        self.acc_from_utt_stats(ex, gamma, x)

    def acc_from_utt_stats(self, ex: IvectorExtractor,
                           gamma: np.ndarray, x: np.ndarray) -> None:
        L, b = ex._precision_linear(gamma, x)
        cov = np.linalg.inv(L)
        mean = cov @ b
        Eww = cov + np.outer(mean, mean)
        self.A += gamma[:, None, None] * Eww[None, :, :]
        self.B += np.einsum("gd,r->gdr", x, mean)
        self.num_utts += 1

    def add(self, other: "IvectorExtractorStats") -> None:
        self.A += other.A
        self.B += other.B
        self.num_utts += other.num_utts

    def update(self, ex: IvectorExtractor) -> None:
        """M-step: M_g = B_g A_g^-1, one solve a Gaussian."""
        for g in range(ex.num_gauss):
            ex.M[g] = np.linalg.solve(self.A[g].T, self.B[g].T).T


def train_ivector_extractor(ubm: DiagGmm, feats_list: Sequence[np.ndarray],
                            opts: Optional[IvectorExtractorOptions] = None
                            ) -> IvectorExtractor:
    """EM training of the T-matrix (ivector-extractor.h:481 stats +
    update)."""
    if opts is None:
        opts = IvectorExtractorOptions()
    ex = IvectorExtractor(ubm, opts.ivector_dim, opts.prior_offset)
    utt_stats = [ex.acc_utt_stats(f) for f in feats_list]
    for it in range(opts.num_iters):
        stats = IvectorExtractorStats(ex)
        for gamma, x in utt_stats:
            stats.acc_from_utt_stats(ex, gamma, x)
        stats.update(ex)
        _log.info("ivector EM iteration %d done", it)
    return ex
