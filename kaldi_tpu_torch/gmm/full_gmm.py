"""Full-covariance GMMs (port of `FullGmm`, `AccumFullGmm`,
`MleFullGmmOptions` and `mle_full_gmm_update` of
`kaldi_tpu/gmm/full_gmm.py`; parity: gmm/full-gmm.h, gmm/mle-full-gmm.h).
Used for the full-covariance UBMs (fgmm-global-*) that feed i-vector
extractors.

The model and its update are host numpy in float64, as in the reference.
The frame-level work runs on a device in float64 (`gmm.ubm.UbmScorer`,
`AccumFullGmm.accumulate_device`): the quadratic term of every component
is one product of the frames' outer products (T, D*D) with the stacked
inverse covariances (D*D, M), the statistics are the products of the
posteriors with the frames and with their outer products.

The file format is the reference package's: each inverse covariance is
stored as a full float32 matrix (stacked into one (M*D, D) matrix), not
the packed triangle of the C++ `SpMatrix`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.device import frame_chunks
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm

_log = logging.getLogger(__name__)

M_LOG_2PI = 1.8378770664093454835606594728112

class FullGmm:
    def __init__(self, num_comp: int = 0, dim: int = 0):
        self.weights = np.ones(num_comp, np.float64) / max(num_comp, 1)
        self.gconsts = np.zeros(num_comp, np.float64)
        self.means_invcovars = np.zeros((num_comp, dim), np.float64)
        self.inv_covars = np.stack([np.eye(dim)] * num_comp) \
            if num_comp else np.zeros((0, dim, dim))
        self.valid_gconsts = False

    @property
    def num_gauss(self) -> int:
        return self.means_invcovars.shape[0]

    @property
    def dim(self) -> int:
        return self.means_invcovars.shape[1]

    # -- parameter access --------------------------------------------------

    def get_means(self) -> np.ndarray:
        return np.stack([np.linalg.solve(self.inv_covars[j],
                                         self.means_invcovars[j])
                         for j in range(self.num_gauss)])

    def get_covars(self) -> np.ndarray:
        return np.stack([np.linalg.inv(self.inv_covars[j])
                         for j in range(self.num_gauss)])

    def set_from_means_and_covars(self, weights, means, covars) -> None:
        means = np.asarray(means, np.float64)
        covars = np.asarray(covars, np.float64)
        self.weights = np.asarray(weights, np.float64)
        self.inv_covars = np.stack([np.linalg.inv(c) for c in covars])
        self.means_invcovars = np.stack(
            [self.inv_covars[j] @ means[j] for j in range(len(means))])
        self.compute_gconsts()

    @classmethod
    def from_diag(cls, diag: DiagGmm) -> "FullGmm":
        """CopyFromDiagGmm."""
        f = cls(diag.num_gauss, diag.dim)
        f.weights = diag.weights.copy()
        f.inv_covars = np.stack([np.diag(diag.inv_vars[j].astype(np.float64))
                                 for j in range(diag.num_gauss)])
        f.means_invcovars = diag.means_invvars.astype(np.float64).copy()
        f.compute_gconsts()
        return f

    def to_diag(self) -> DiagGmm:
        """Diagonal approximation (keeps the diagonal of each covar)."""
        d = DiagGmm(self.num_gauss, self.dim)
        covars = self.get_covars()
        means = self.get_means()
        d.set_from_means_and_vars(
            self.weights, means,
            np.stack([np.diag(c) for c in covars]))
        return d

    def compute_gconsts(self) -> int:
        n_bad = 0
        gc = np.zeros(self.num_gauss, np.float64)
        for j in range(self.num_gauss):
            sign, logdet = np.linalg.slogdet(self.inv_covars[j])
            if sign <= 0:
                n_bad += 1
                gc[j] = -np.inf
                continue
            mu_s_mu = float(self.means_invcovars[j]
                            @ np.linalg.solve(self.inv_covars[j],
                                              self.means_invcovars[j]))
            gc[j] = (np.log(max(self.weights[j], 1e-300))
                     - 0.5 * (self.dim * M_LOG_2PI - logdet + mu_s_mu))
        self.gconsts = gc
        self.valid_gconsts = True
        if n_bad:
            _log.warning("FullGmm: %d non-positive-definite components",
                         n_bad)
        return n_bad

    # -- likelihoods (host) --------------------------------------------------

    def component_log_likes(self, data: np.ndarray) -> np.ndarray:
        """(T, D) -> (T, M) per-component log-likelihoods."""
        if not self.valid_gconsts:
            self.compute_gconsts()
        x = np.atleast_2d(np.asarray(data, np.float64))
        quad = -0.5 * np.einsum("td,mde,te->tm", x, self.inv_covars, x,
                                optimize=True)
        lin = x @ self.means_invcovars.T
        return self.gconsts[None, :] + lin + quad

    def log_likelihood(self, data: np.ndarray) -> np.ndarray:
        cl = self.component_log_likes(data)
        m = cl.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(cl - m).sum(axis=1, keepdims=True)))[:, 0]

    def component_posteriors(self, data: np.ndarray) -> np.ndarray:
        cl = self.component_log_likes(data)
        m = cl.max(axis=1, keepdims=True)
        p = np.exp(cl - m)
        return p / p.sum(axis=1, keepdims=True)

    # -- serialization (<FullGMM>, the reference package's layout) ---------

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        if not self.valid_gconsts:
            self.compute_gconsts()
        iof.write_token(stream, binary, "<FullGMM>")
        iof.write_token(stream, binary, "<GCONSTS>")
        iof.write_vector(stream, binary, self.gconsts.astype(np.float32))
        iof.write_token(stream, binary, "<WEIGHTS>")
        iof.write_vector(stream, binary, self.weights.astype(np.float32))
        iof.write_token(stream, binary, "<MEANS_INVCOVARS>")
        iof.write_matrix(stream, binary,
                         self.means_invcovars.astype(np.float32))
        iof.write_token(stream, binary, "<INV_COVARS>")
        iof.write_matrix(stream, binary,
                         self.inv_covars.reshape(-1, self.dim)
                         .astype(np.float32))
        iof.write_token(stream, binary, "</FullGMM>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "FullGmm":
        iof.expect_token(stream, binary, "<FullGMM>")
        iof.expect_token(stream, binary, "<GCONSTS>")
        gconsts = iof.read_vector(stream, binary)
        iof.expect_token(stream, binary, "<WEIGHTS>")
        weights = iof.read_vector(stream, binary)
        iof.expect_token(stream, binary, "<MEANS_INVCOVARS>")
        mic = iof.read_matrix(stream, binary)
        iof.expect_token(stream, binary, "<INV_COVARS>")
        icv = iof.read_matrix(stream, binary)
        iof.expect_token(stream, binary, "</FullGMM>")
        g = cls()
        g.weights = weights.astype(np.float64)
        g.gconsts = gconsts.astype(np.float64)
        g.means_invcovars = mic.astype(np.float64)
        d = mic.shape[1]
        g.inv_covars = icv.astype(np.float64).reshape(-1, d, d)
        g.valid_gconsts = True
        return g


def outer_rows(x: torch.Tensor) -> torch.Tensor:
    """(T, D) -> (T, D*D) rows x_d x_e."""
    return (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)


class AccumFullGmm:
    """mle-full-gmm.h AccumFullGmm: occupancy + first/second moments."""

    def __init__(self, num_comp: int, dim: int):
        self.occupancy = np.zeros(num_comp, np.float64)
        self.mean_accs = np.zeros((num_comp, dim), np.float64)
        self.covar_accs = np.zeros((num_comp, dim, dim), np.float64)

    @property
    def num_comp(self):
        return self.occupancy.shape[0]

    def accumulate(self, data: np.ndarray, posteriors: np.ndarray) -> None:
        data = np.asarray(data, np.float64)
        post = np.asarray(posteriors, np.float64)
        self.occupancy += post.sum(axis=0)
        self.mean_accs += post.T @ data
        self.covar_accs += np.einsum("tm,td,te->mde", post, data, data,
                                     optimize=True)

    def accumulate_from_full(self, gmm: FullGmm, data: np.ndarray) -> float:
        post = gmm.component_posteriors(data)
        self.accumulate(data, post)
        return float(gmm.log_likelihood(data).sum())

    def accumulate_device(self, scorer, feats_list) -> Tuple[
            float, int]:
        """Accumulate every utterance of `feats_list` (host (T, D)
        arrays, in float64 as the reference reads them) against the full
        UBM of `scorer` (`gmm.ubm.UbmScorer`) on its device in float64
        -> (total log-likelihood, frames)."""
        if not scorer.full:
            raise ValueError("accumulate_device needs a FullGmm scorer")
        sums, like, frames = None, 0.0, 0
        for x in frame_chunks(feats_list, scorer.device):
            ll = scorer.log_likes(x)
            like += torch.logsumexp(ll, dim=1).sum()
            m = _moments(x, torch.softmax(ll, dim=1))
            sums = m if sums is None else [a + b for a, b in zip(sums, m)]
            frames += x.shape[0]
        if sums is not None:
            self._add(sums)
        return float(like), frames

    def accumulate_tensors(self, x: torch.Tensor,
                           post: torch.Tensor) -> None:
        """`accumulate` of float64 frames (T, D) and posteriors (T, M)
        already on a device."""
        self._add(_moments(x, post))

    def _add(self, sums) -> None:
        occ, mean, cov = (t.cpu().numpy() for t in sums)
        self.occupancy += occ
        self.mean_accs += mean
        self.covar_accs += cov.reshape(self.covar_accs.shape)

    # the fgmm-global-* stats files are npz containers, as the reference
    # package writes them
    def write_npz(self, stream: BinaryIO) -> None:
        np.savez(stream, occupancy=self.occupancy, mean_accs=self.mean_accs,
                 covar_accs=self.covar_accs)

    @classmethod
    def read_npz(cls, stream: BinaryIO) -> "AccumFullGmm":
        data = np.load(stream)
        acc = cls.__new__(cls)
        acc.occupancy = data["occupancy"]
        acc.mean_accs = data["mean_accs"]
        acc.covar_accs = data["covar_accs"]
        return acc


def _moments(x: torch.Tensor, post: torch.Tensor):
    """Occupancy (M,), first (M, D) and second (M, D*D) moments."""
    return post.sum(dim=0), post.T @ x, post.T @ outer_rows(x)


@dataclass
class MleFullGmmOptions:
    min_gaussian_occupancy: float = 10.0
    variance_floor: float = 0.001    # eigenvalue floor on covariances
    remove_low_count_gaussians: bool = True


def mle_full_gmm_update(opts: MleFullGmmOptions, acc: AccumFullGmm,
                        gmm: FullGmm) -> Tuple[float, float]:
    """MleFullGmmUpdate: weights, means, covariances (eigenvalue
    floored). Returns (objf improvement proxy, total occupancy)."""
    occ = acc.occupancy
    tot = float(occ.sum())
    if tot <= 0:
        _log.warning("mle_full_gmm_update: no stats")
        return 0.0, 0.0
    keep = occ >= opts.min_gaussian_occupancy
    if not np.any(keep):
        raise KaldiTpuError("all Gaussians below min occupancy")
    weights = []
    means = []
    covars = []
    for j in range(gmm.num_gauss):
        if not keep[j]:
            if not opts.remove_low_count_gaussians:
                keep[j] = True
                weights.append(max(occ[j], 1e-10) / tot)
                means.append(gmm.get_means()[j])
                covars.append(np.linalg.inv(gmm.inv_covars[j]))
            continue
        mu = acc.mean_accs[j] / occ[j]
        sigma = acc.covar_accs[j] / occ[j] - np.outer(mu, mu)
        sigma = 0.5 * (sigma + sigma.T)
        evals, evecs = np.linalg.eigh(sigma)
        evals = np.maximum(evals, opts.variance_floor)
        sigma = (evecs * evals) @ evecs.T
        weights.append(occ[j] / tot)
        means.append(mu)
        covars.append(sigma)
    removed = gmm.num_gauss - len(weights)
    if removed:
        _log.info("mle_full_gmm_update: removed %d low-count gaussians",
                  removed)
    w = np.asarray(weights)
    gmm.set_from_means_and_covars(w / w.sum(), np.stack(means),
                                  np.stack(covars))
    return tot, tot
