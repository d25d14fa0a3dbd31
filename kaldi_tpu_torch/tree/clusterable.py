"""Gaussian sufficient statistics for clustering and tree building (port
of `GaussClusterable` and `sum_clusterables` of
`kaldi_tpu/tree/clusterable.py`; parity: tree/clusterable-classes.h
GaussClusterable).  Host numpy, float64.

Not carried over yet: the GCL/BTS stats I/O.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

M_LOG_2PI = math.log(2.0 * math.pi)


class GaussClusterable:
    """count, x-sum, x^2-sum; objf() = the best diagonal-Gaussian
    log-likelihood of the data given these stats (with a variance
    floor)."""

    __slots__ = ("count", "stats_sum", "stats_sumsq", "var_floor")

    def __init__(self, dim: int = 0, var_floor: float = 0.01):
        self.count = 0.0
        self.stats_sum = np.zeros(dim, np.float64)
        self.stats_sumsq = np.zeros(dim, np.float64)
        self.var_floor = var_floor

    def add_stats(self, vec: np.ndarray, weight: float = 1.0) -> None:
        self.count += weight
        self.stats_sum += weight * vec
        self.stats_sumsq += weight * vec * vec

    def accumulate(self, feats: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> None:
        feats = np.asarray(feats, np.float64)
        if weights is None:
            self.count += feats.shape[0]
            self.stats_sum += feats.sum(axis=0)
            self.stats_sumsq += (feats * feats).sum(axis=0)
        else:
            w = np.asarray(weights, np.float64)[:, None]
            self.count += float(w.sum())
            self.stats_sum += (feats * w).sum(axis=0)
            self.stats_sumsq += (feats * feats * w).sum(axis=0)

    def add(self, other: "GaussClusterable") -> "GaussClusterable":
        out = GaussClusterable(len(self.stats_sum), self.var_floor)
        out.count = self.count + other.count
        out.stats_sum = self.stats_sum + other.stats_sum
        out.stats_sumsq = self.stats_sumsq + other.stats_sumsq
        return out

    def objf(self) -> float:
        """Total loglike of the data under the ML diagonal Gaussian
        (clusterable-classes.cc GaussClusterable::Objf)."""
        if self.count <= 0:
            return 0.0
        mean = self.stats_sum / self.count
        var = self.stats_sumsq / self.count - mean * mean
        var = np.maximum(var, self.var_floor)
        dim = len(var)
        return float(-0.5 * self.count
                     * (dim * M_LOG_2PI + np.log(var).sum() + dim))

    def mean(self) -> np.ndarray:
        return self.stats_sum / max(self.count, 1e-10)

    def var(self) -> np.ndarray:
        m = self.mean()
        return np.maximum(self.stats_sumsq / max(self.count, 1e-10) - m * m,
                          self.var_floor)

    def distance(self, other: "GaussClusterable") -> float:
        """Likelihood loss if merged (always >= 0)."""
        return self.objf() + other.objf() - self.add(other).objf()


def sum_clusterables(items) -> GaussClusterable:
    """The stats of items added in their order."""
    it = iter(items)
    acc = next(it)
    total = GaussClusterable(len(acc.stats_sum), acc.var_floor)
    total.count = acc.count
    total.stats_sum = acc.stats_sum.copy()
    total.stats_sumsq = acc.stats_sumsq.copy()
    for c in it:
        total.count += c.count
        total.stats_sum += c.stats_sum
        total.stats_sumsq += c.stats_sumsq
    return total
