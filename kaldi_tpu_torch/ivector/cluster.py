"""Agglomerative clustering for diarization (port of
kaldi_tpu/ivector/cluster.py: ivector/agglomerative-clustering.h and the
agglomerative-cluster binary).

The reference merges by average linkage and recomputes every pair's mean
from the members in each round, O(N^2) pairs times the members of each
pair in host Python.  This port keeps its rules (the highest mean score
merges first; among equal means the first pair in sorted-key order, a
merged cluster taking the next new key; the threshold stops the merging
only when no cluster count is given; labels numbered by each cluster's
smallest member) but carries the sums of the score matrix between
clusters, so a round is one masked argmax over the (K, K) means.  The
merge order is the reference's wherever no two means tie within
rounding.  It runs in host float64: a recording holds tens to hundreds
of segments, too few for a card's launch to pay."""

from __future__ import annotations

from typing import Optional

import numpy as np


def agglomerative_cluster(scores: np.ndarray,
                          threshold: Optional[float] = None,
                          num_clusters: Optional[int] = None) -> np.ndarray:
    """scores: (N, N) pairwise similarity (e.g. PLDA LLR).  Merges the
    highest-scoring pair (average linkage) until the best remaining
    score < threshold or the target count is reached.  Returns (N,)
    cluster ids (0-based, contiguous)."""
    scores = np.asarray(scores, np.float64)
    N = scores.shape[0]
    if threshold is None and num_clusters is None:
        num_clusters = 1
    # cluster key -> slot; keys grow as the reference's do, so slot
    # order is sorted-key order
    slots = 2 * N - 1 if N else 0
    sums = np.zeros((slots, slots))
    sums[:N, :N] = scores
    size = np.zeros(slots)
    size[:N] = 1
    members = {i: [i] for i in range(N)}
    next_id = N
    while len(members) > 1:
        if num_clusters is not None and len(members) <= num_clusters:
            break
        keys = np.fromiter(sorted(members), np.int64)
        means = sums[np.ix_(keys, keys)] / np.outer(size[keys], size[keys])
        means[np.tril_indices(len(keys))] = -np.inf
        flat = int(np.argmax(means))   # first maximum in row-major order
        x, y = divmod(flat, len(keys))
        best, bi, bj = means[x, y], int(keys[x]), int(keys[y])
        if num_clusters is None and threshold is not None \
                and best < threshold:
            break
        new = next_id
        next_id += 1
        sums[new, :] = sums[bi, :] + sums[bj, :]
        sums[:, new] = sums[:, bi] + sums[:, bj]
        size[new] = size[bi] + size[bj]
        members[new] = members.pop(bi) + members.pop(bj)
    out = np.zeros(N, np.int32)
    for cid, m in enumerate(sorted(members.values(), key=min)):
        out[m] = cid
    return out


def cluster_embeddings(embeddings: np.ndarray, plda=None,
                       threshold: float = 0.0,
                       num_clusters: Optional[int] = None) -> np.ndarray:
    """Diarization front door: pairwise PLDA (or cosine) scores and
    agglomerative clustering."""
    N = embeddings.shape[0]
    scores = np.zeros((N, N))
    if plda is not None:
        trans = [plda.transform_ivector(e) for e in embeddings]
        for i in range(N):
            for j in range(N):
                if i != j:
                    scores[i, j] = plda.log_likelihood_ratio(
                        trans[i], 1, trans[j])
    else:
        norm = embeddings / (np.linalg.norm(embeddings, axis=1,
                                            keepdims=True) + 1e-9)
        scores = norm @ norm.T
    return agglomerative_cluster(scores, threshold=threshold,
                                 num_clusters=num_clusters)
