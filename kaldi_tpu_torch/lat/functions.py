"""Lattice algorithms: `lattice_best_path` (the one function of
`kaldi_tpu/lat/functions.py` that the pipeline's lattice mode needs)."""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, INF, Arc, LatticeWeight
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice


def _total(w: Tuple[float, float]) -> float:
    return w[0] + w[1]


def lattice_best_path(lat: Lattice) -> Tuple[List[int], List[int], float]:
    """Returns (alignment tids, words, total cost)."""
    n = lat.num_states
    dist = [INF] * n
    back: List[Optional[Tuple[int, Arc]]] = [None] * n
    dist[lat.start] = 0.0
    inq = [False] * n
    q = deque([lat.start])
    inq[lat.start] = True
    while q:
        s = q.popleft()
        inq[s] = False
        for a in lat.arcs[s]:
            nd = dist[s] + _total(a.weight)
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
                if not inq[a.nextstate]:
                    q.append(a.nextstate)
                    inq[a.nextstate] = True
    best_s, best_c = -1, INF
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            c = dist[s] + _total(lat.finals[s])
            if c < best_c:
                best_c, best_s = c, s
    if best_s < 0:
        return [], [], INF
    ali, words = [], []
    s = best_s
    while s != lat.start and back[s] is not None:
        p, a = back[s]
        if a.ilabel != EPS:
            ali.append(a.ilabel)
        if a.olabel != EPS:
            words.append(a.olabel)
        s = p
    ali.reverse()
    words.reverse()
    return ali, words, best_c
