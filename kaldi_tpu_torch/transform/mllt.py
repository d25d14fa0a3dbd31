"""MLLT / global STC estimation (port of `kaldi_tpu/transform/mllt.py`;
parity: transform/mllt.h MlltAccs).

Accumulates each Gaussian's posterior-weighted scatter of (x - mu) in the
current feature space, scaled per dimension by the inverse variance:
G_i = sum_m invvar[m, i] sum_t post[t, m] (x_t - mu_m)(x_t - mu_m)^T.
The sums run in float64 on the device over all frames and Gaussians of
a batch at once (`accumulate_groups`); `update` is the reference's
row-wise iterative optimization of
Q(M) = beta log|det M| - 1/2 sum_i m_i^T G_i m_i, on the host in numpy
float64.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.transform.gauss_rows import (GaussRows, pack_groups,
                                                  third_moment)

# the reference skips a Gaussian whose posteriors in a call sum below this
MIN_TOTAL = 1e-8


class MlltAccs:
    """beta and G live on the host as float64 numpy arrays; each
    accumulation runs on `device` and adds its sums to them."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.beta = 0.0
        self.G = np.zeros((dim, dim, dim))  # per-dim outer products

    @property
    def dim(self):
        return self.G.shape[0]

    def accumulate_from_posteriors(self, gmm: DiagGmm, data: np.ndarray,
                                   posteriors: np.ndarray) -> None:
        """gmm: DiagGmm in the CURRENT feature space; data (T, D);
        posteriors (T, M)."""
        self.accumulate_groups([(gmm, data, posteriors)])

    def accumulate_groups(self, groups: Iterable[
            Tuple[DiagGmm, np.ndarray, np.ndarray]]) -> None:
        """`accumulate_from_posteriors` of each (gmm, data, posteriors),
        in one pass on the device."""
        self.accumulate_rows(pack_groups(groups, MIN_TOTAL, self.device))

    def accumulate_rows(self, r: GaussRows) -> None:
        """The device part of `accumulate_groups`."""
        D = r.x.shape[1]
        keep = (r.post > 0).reshape(-1)
        diff = (r.x[:, None, :] - r.means).reshape(-1, D)[keep]
        a = (r.post[:, :, None] * r.inv_vars).reshape(-1, D)[keep]
        self.G += third_moment(a, diff, diff).cpu().numpy()
        self.beta += float(r.post.sum())

    def update(self, num_iters: int = 20
               ) -> Tuple[np.ndarray, float]:
        """Returns (M (D,D), objf improvement per frame)."""
        D = self.dim
        M = np.eye(D)
        if self.beta <= 0:
            return M, 0.0
        G = self.G / self.beta

        def objf(Mm):
            sign, logdet = np.linalg.slogdet(Mm)
            q = sum(Mm[i] @ G[i] @ Mm[i] for i in range(D))
            return logdet - 0.5 * q

        start = objf(M)
        for _ in range(num_iters):
            for i in range(D):
                inv = np.linalg.inv(M)
                cofactor = inv[:, i]  # ∝ row of cofactors
                Gi_inv = np.linalg.inv(G[i] + 1e-10 * np.eye(D))
                d = Gi_inv @ cofactor
                denom = cofactor @ d
                if denom <= 0:
                    continue
                M[i] = d * np.sqrt(1.0 / denom)
        impr = objf(M) - start
        return M, float(impr)

    def add(self, other: "MlltAccs") -> None:
        """Sum accumulators (sum-mllt-accs)."""
        self.beta += other.beta
        self.G += other.G

    def write(self, stream, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<MLLTACCS>")
        iof.write_double(stream, binary, self.beta)
        for i in range(self.dim):
            iof.write_matrix(stream, binary, self.G[i])
        iof.write_token(stream, binary, "</MLLTACCS>")

    @classmethod
    def read(cls, stream, binary: bool = True,
             device: DeviceLike = None) -> "MlltAccs":
        iof.expect_token(stream, binary, "<MLLTACCS>")
        beta = iof.read_double(stream, binary)
        first = iof.read_matrix(stream, binary)
        out = cls(first.shape[0], device=device)
        out.beta = beta
        out.G[0] = first
        for i in range(1, out.dim):
            out.G[i] = iof.read_matrix(stream, binary)
        iof.expect_token(stream, binary, "</MLLTACCS>")
        return out
