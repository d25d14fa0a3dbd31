"""Gaussian sufficient statistics for clustering and tree building (port
of `GaussClusterable` and `sum_clusterables` of
`kaldi_tpu/tree/clusterable.py`; parity: tree/clusterable-classes.h
GaussClusterable).  Host numpy, float64.

The GCL/BTS stats files of acc-tree-stats are written and read as the
reference writes them, byte for byte.
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

# ---------------------------------------------------------------------------
# Wire format (reference-compatible): GaussClusterable::Write
# (tree/clusterable-classes.cc:173 — "GCL" + count + var_floor + 2xdim
# double matrix of [x-sum; x^2-sum]), and Write/ReadBuildTreeStats
# (tree/build-tree-utils.cc:29 — "BTS" + size + per-entry EventType
# ("EV" + pairs, tree/event-map.cc:228) + nonNull bool + clusterable).

def write_gauss_clusterable(stream, binary: bool, c: "GaussClusterable"):
    from kaldi_tpu_torch.base import io_funcs as iof
    iof.write_token(stream, binary, "GCL")
    iof.write_double(stream, binary, c.count)
    iof.write_double(stream, binary, c.var_floor)
    iof.write_matrix(stream, binary,
                     np.stack([c.stats_sum, c.stats_sumsq]).astype(np.float64))


def read_gauss_clusterable(stream, binary: bool) -> "GaussClusterable":
    from kaldi_tpu_torch.base import io_funcs as iof
    iof.expect_token(stream, binary, "GCL")
    count = iof.read_double(stream, binary)
    var_floor = iof.read_double(stream, binary)
    stats = iof.read_matrix(stream, binary)
    c = GaussClusterable(stats.shape[1], var_floor)
    c.count = count
    c.stats_sum = stats[0].astype(np.float64)
    c.stats_sumsq = stats[1].astype(np.float64)
    return c


def write_build_tree_stats(stream, binary: bool, stats) -> None:
    """stats: dict {event tuple -> GaussClusterable} or list of pairs."""
    from kaldi_tpu_torch.base import io_funcs as iof
    items = sorted(stats.items()) if hasattr(stats, "items") else list(stats)
    iof.write_token(stream, binary, "BTS")
    iof.write_uint32(stream, binary, len(items))
    for event, clus in items:
        iof.write_token(stream, binary, "EV")
        iof.write_uint32(stream, binary, len(event))
        for key, value in event:
            iof.write_int32(stream, binary, key)
            iof.write_int32(stream, binary, value)
        if not binary:
            stream.write(b"\n")
        iof.write_bool(stream, binary, clus is not None)
        if clus is not None:
            write_gauss_clusterable(stream, binary, clus)
    if not binary:
        stream.write(b"\n")


def read_build_tree_stats(stream, binary: bool):
    """Returns dict {event tuple -> GaussClusterable}; duplicate events
    (e.g. when summing multiple acc files) are added together."""
    from kaldi_tpu_torch.base import io_funcs as iof
    iof.expect_token(stream, binary, "BTS")
    n = iof.read_uint32(stream, binary)
    stats = {}
    for _ in range(n):
        iof.expect_token(stream, binary, "EV")
        npairs = iof.read_uint32(stream, binary)
        event = tuple((iof.read_int32(stream, binary),
                       iof.read_int32(stream, binary))
                      for _ in range(npairs))
        if iof.read_bool(stream, binary):
            c = read_gauss_clusterable(stream, binary)
            stats[event] = stats[event].add(c) if event in stats else c
    return stats
