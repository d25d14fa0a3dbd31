"""Diagonal-covariance GMM (port of `kaldi_tpu/gmm/diag_gmm.py`; parity: gmm/diag-gmm.h:42).  Host-side
numpy: the statistics of monophone training stay on the host, as in the
reference; the batched scoring of every pdf runs on the card
(`AmDiagGmm.log_likes_batch`).

Stored in the reference's inverse-variance parameterization: weights,
gconsts, means_invvars (= mean * inv_var), inv_vars, so that scoring a
frame is two matmuls (DiagGmm::LogLikelihoods, diag-gmm.h:91).

Serialization matches <DiagGMM>.
"""

from __future__ import annotations

import math
from typing import BinaryIO, Optional

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof

M_LOG_2PI = math.log(2.0 * math.pi)


class DiagGmm:
    def __init__(self, num_comp: int = 0, dim: int = 0):
        self.weights = np.ones(num_comp, np.float64) / max(num_comp, 1)
        self.gconsts = np.zeros(num_comp, np.float32)
        self.means_invvars = np.zeros((num_comp, dim), np.float32)
        self.inv_vars = np.ones((num_comp, dim), np.float32)
        self.valid_gconsts = False

    @property
    def num_gauss(self) -> int:
        return self.means_invvars.shape[0]

    @property
    def dim(self) -> int:
        return self.means_invvars.shape[1]

    # -- parameter access ----------------------------------------------------

    def get_means(self) -> np.ndarray:
        return self.means_invvars / self.inv_vars

    def get_vars(self) -> np.ndarray:
        return 1.0 / self.inv_vars

    def set_from_means_and_vars(self, weights, means, variances) -> None:
        self.weights = np.asarray(weights, np.float64)
        variances = np.asarray(variances, np.float64)
        means = np.asarray(means, np.float64)
        self.inv_vars = (1.0 / variances).astype(np.float32)
        self.means_invvars = (means / variances).astype(np.float32)
        self.compute_gconsts()

    def compute_gconsts(self) -> int:
        """gconst = log w + 0.5 Σ (log invvar − log 2π − μ² invvar)
        (diag-gmm.cc ComputeGconsts). Returns #invalid."""
        w = np.maximum(self.weights, 1e-300)
        mi = self.means_invvars.astype(np.float64)
        iv = self.inv_vars.astype(np.float64)
        gc = (np.log(w)
              + 0.5 * (np.log(iv) - M_LOG_2PI - mi * mi / iv).sum(axis=1))
        bad = ~np.isfinite(gc)
        n_bad = int(bad.sum())
        gc[bad] = -1e10
        self.gconsts = gc.astype(np.float32)
        self.valid_gconsts = True
        return n_bad

    # -- scoring (matmul form; used batched on device by AmDiagGmm) ---------

    def component_log_likes(self, data: np.ndarray) -> np.ndarray:
        """(T, D) -> (T, M) per-component loglikes."""
        data = np.asarray(data, np.float32)
        return (self.gconsts[None, :]
                + data @ self.means_invvars.T
                - 0.5 * (data * data) @ self.inv_vars.T)

    def log_likelihood(self, data: np.ndarray) -> np.ndarray:
        """(T, D) -> (T,) total loglike (logsumexp over components)."""
        ll = self.component_log_likes(np.atleast_2d(data))
        m = ll.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(ll - m).sum(axis=1)))

    def component_posteriors(self, data: np.ndarray) -> np.ndarray:
        ll = self.component_log_likes(np.atleast_2d(data))
        m = ll.max(axis=1, keepdims=True)
        p = np.exp(ll - m)
        return p / p.sum(axis=1, keepdims=True)

    # -- splitting / merging (mixing up) ------------------------------------

    def split(self, target: int, perturb_factor: float = 0.01,
              rng: Optional[np.random.Generator] = None) -> None:
        """Split heaviest components until num_gauss == target
        (diag-gmm.cc Split)."""
        if rng is None:
            rng = np.random.default_rng(0)
        if target < self.num_gauss:
            raise ValueError("split: target below current size")
        weights = list(self.weights)
        mi = [row for row in self.means_invvars]
        iv = [row for row in self.inv_vars]
        while len(weights) < target:
            i = int(np.argmax(weights))
            weights[i] *= 0.5
            std = 1.0 / np.sqrt(iv[i])
            perturb = (perturb_factor * rng.normal(size=self.dim)
                       ).astype(np.float32)
            mean = mi[i] / iv[i]
            m1 = mean + perturb * std
            m2 = mean - perturb * std
            weights.append(weights[i])
            mi.append((m2 * iv[i]).astype(np.float32))
            iv.append(iv[i].copy())
            mi[i] = (m1 * iv[i]).astype(np.float32)
        self.weights = np.asarray(weights, np.float64)
        self.means_invvars = np.stack(mi)
        self.inv_vars = np.stack(iv)
        self.compute_gconsts()

    def merge(self, target: int) -> None:
        """Greedy pair merging down to `target` components
        (diag-gmm.cc Merge): repeatedly merge the pair with the
        smallest log-likelihood loss (weighted log-det increase),
        moment-matching the merged Gaussian."""
        if target >= self.num_gauss:
            return
        if target < 1:
            raise ValueError("merge: target must be >= 1")
        w = np.asarray(self.weights, np.float64).copy()
        means = self.get_means().astype(np.float64)
        var = (1.0 / self.inv_vars).astype(np.float64)
        x2 = var + means ** 2           # second moments, for moment matching

        def logdet(v):
            return float(np.log(np.maximum(v, 1e-20)).sum())

        while len(w) > target:
            M = len(w)
            best = (np.inf, 0, 1)
            ld = np.array([logdet(var[i]) for i in range(M)])
            for i in range(M - 1):
                wj = w[i + 1:]
                tot = w[i] + wj
                mm = (w[i] * means[i] + wj[:, None] * means[i + 1:]) \
                    / tot[:, None]
                xx = (w[i] * x2[i] + wj[:, None] * x2[i + 1:]) \
                    / tot[:, None]
                vv = np.maximum(xx - mm ** 2, 1e-10)
                ld_merged = np.log(vv).sum(axis=1)
                cost = 0.5 * (tot * ld_merged
                              - w[i] * ld[i] - wj * ld[i + 1:])
                j = int(np.argmin(cost))
                if cost[j] < best[0]:
                    best = (float(cost[j]), i, i + 1 + j)
            _, i, j = best
            tot = w[i] + w[j]
            mm = (w[i] * means[i] + w[j] * means[j]) / tot
            xx = (w[i] * x2[i] + w[j] * x2[j]) / tot
            means[i], x2[i], w[i] = mm, xx, tot
            var[i] = np.maximum(xx - mm ** 2, 1e-10)
            keep = np.ones(M, bool)
            keep[j] = False
            w, means, var, x2 = w[keep], means[keep], var[keep], x2[keep]
        self.set_from_means_and_vars(w / w.sum(), means, var)
        self.compute_gconsts()

    # -- I/O -----------------------------------------------------------------

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        if not self.valid_gconsts:
            self.compute_gconsts()
        iof.write_token(stream, binary, "<DiagGMM>")
        iof.write_token(stream, binary, "<GCONSTS>")
        iof.write_vector(stream, binary, self.gconsts)
        iof.write_token(stream, binary, "<WEIGHTS>")
        iof.write_vector(stream, binary, self.weights.astype(np.float32))
        iof.write_token(stream, binary, "<MEANS_INVVARS>")
        iof.write_matrix(stream, binary, self.means_invvars)
        iof.write_token(stream, binary, "<INV_VARS>")
        iof.write_matrix(stream, binary, self.inv_vars)
        iof.write_token(stream, binary, "</DiagGMM>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "DiagGmm":
        gmm = cls()
        iof.expect_token(stream, binary, "<DiagGMM>")
        tok = iof.read_token(stream, binary)
        if tok == "<GCONSTS>":
            gmm.gconsts = iof.read_vector(stream, binary).astype(np.float32)
            tok = iof.read_token(stream, binary)
        if tok != "<WEIGHTS>":
            raise ValueError(f"expected <WEIGHTS>, got {tok}")
        gmm.weights = iof.read_vector(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "<MEANS_INVVARS>")
        gmm.means_invvars = iof.read_matrix(stream,
                                            binary).astype(np.float32)
        iof.expect_token(stream, binary, "<INV_VARS>")
        gmm.inv_vars = iof.read_matrix(stream, binary).astype(np.float32)
        iof.expect_token(stream, binary, "</DiagGMM>")
        gmm.valid_gconsts = True
        return gmm
