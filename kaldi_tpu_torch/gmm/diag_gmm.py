"""Diagonal-covariance GMM (port of the parameters, scoring and `split`
of `kaldi_tpu/gmm/diag_gmm.py`; parity: gmm/diag-gmm.h:42).  Host-side
numpy: the statistics of monophone training stay on the host, as in the
reference; the batched scoring of every pdf runs on the card
(`AmDiagGmm.log_likes_batch`).

Stored in the reference's inverse-variance parameterization: weights,
gconsts, means_invvars (= mean * inv_var), inv_vars, so that scoring a
frame is two matmuls (DiagGmm::LogLikelihoods, diag-gmm.h:91).

Not carried over yet: `merge` and the <DiagGMM> I/O.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

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

    # -- splitting (mixing up) ----------------------------------------------

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
