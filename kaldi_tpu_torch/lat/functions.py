"""Lattice algorithms (the part of `kaldi_tpu/lat/functions.py` that the
lattice decoders and their tests need; parity: lat/lattice-functions.h,
latbin tools).

lattice_best_path      — lattice-best-path
lattice_prune          — lattice-prune (forward-backward cost pruning)
lattice_state_times    — the frame index of each state
lattice_nbest          — lattice-to-nbest (exact k-best, acyclic)

Not carried over yet: lattice_scale, add_word_ins_penalty, posteriors
and the determinization (it needs `fstext/ops.py` `determinize_star`).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        VectorFst)
from kaldi_tpu_torch.fstext.ops import connect
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


def _forward_backward_costs(lat: Lattice) -> Tuple[List[float], List[float]]:
    """Viterbi forward and backward total costs per state."""
    n = lat.num_states
    fwd = [INF] * n
    fwd[lat.start] = 0.0
    inq = [False] * n
    q = deque([lat.start])
    while q:
        s = q.popleft()
        inq[s] = False
        for a in lat.arcs[s]:
            nd = fwd[s] + _total(a.weight)
            if nd < fwd[a.nextstate] - 1e-12:
                fwd[a.nextstate] = nd
                if not inq[a.nextstate]:
                    q.append(a.nextstate)
                    inq[a.nextstate] = True
    bwd = [INF] * n
    preds: List[List[Tuple[int, Arc]]] = [[] for _ in range(n)]
    for s in range(n):
        for a in lat.arcs[s]:
            preds[a.nextstate].append((s, a))
    q = deque()
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            bwd[s] = _total(lat.finals[s])
            q.append(s)
    inq = [False] * n
    while q:
        s = q.popleft()
        inq[s] = False
        for p, a in preds[s]:
            nd = bwd[s] + _total(a.weight)
            if nd < bwd[p] - 1e-12:
                bwd[p] = nd
                if not inq[p]:
                    q.append(p)
                    inq[p] = True
    return fwd, bwd


def lattice_prune(lat: Lattice, beam: float) -> Lattice:
    fwd, bwd = _forward_backward_costs(lat)
    best = min((f + b for f, b in zip(fwd, bwd)), default=INF)
    out = VectorFst(LatticeWeight)
    out.add_states(lat.num_states)
    out.start = lat.start
    for s in range(lat.num_states):
        out.finals[s] = lat.finals[s]
        if fwd[s] + bwd[s] > best + beam:
            out.finals[s] = LatticeWeight.zero
            continue
        for a in lat.arcs[s]:
            arc_cost = fwd[s] + _total(a.weight) + bwd[a.nextstate]
            if arc_cost <= best + beam:
                out.add_arc(s, Arc(a.ilabel, a.olabel, a.weight, a.nextstate))
    return connect(out)


def lattice_state_times(lat: Lattice) -> List[int]:
    """Frame index of each state (requires a topologically-sane lattice
    where emitting arcs advance time; lattice-functions.cc
    LatticeStateTimes)."""
    n = lat.num_states
    times = [-1] * n
    times[lat.start] = 0
    order = _topsort(lat)
    for s in order:
        if times[s] < 0:
            # unreachable state: must not propagate its bogus (-1)
            # time into reachable successors
            continue
        for a in lat.arcs[s]:
            t = times[s] + (1 if a.ilabel != EPS else 0)
            if times[a.nextstate] < 0:
                times[a.nextstate] = t
    return times


def _topsort(lat: VectorFst) -> List[int]:
    n = lat.num_states
    indeg = [0] * n
    for s in range(n):
        for a in lat.arcs[s]:
            indeg[a.nextstate] += 1
    q = deque([s for s in range(n) if indeg[s] == 0])
    order = []
    while q:
        s = q.popleft()
        order.append(s)
        for a in lat.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                q.append(a.nextstate)
    if len(order) != n:
        raise ValueError("lattice has cycles")
    return order


def lattice_nbest(lat: Lattice, n: int) -> List[Tuple[List[int], List[int], float]]:
    """Exact n-best paths for an acyclic lattice: DP keeping n best
    (cost, path) per state."""
    order = _topsort(lat)
    # best lists propagate forward
    paths: List[List[Tuple[float, List[Arc]]]] = \
        [[] for _ in range(lat.num_states)]
    paths[lat.start] = [(0.0, [])]
    results = []
    for s in order:
        if not paths[s]:
            continue
        if lat.finals[s] != LatticeWeight.zero:
            for c, arcs in paths[s]:
                results.append((c + _total(lat.finals[s]), arcs))
        for a in lat.arcs[s]:
            cand = [(c + _total(a.weight), arcs + [a]) for c, arcs in paths[s]]
            merged = sorted(paths[a.nextstate] + cand, key=lambda x: x[0])[:n]
            paths[a.nextstate] = merged
    results.sort(key=lambda x: x[0])
    out = []
    for c, arcs in results[:n]:
        ali = [a.ilabel for a in arcs if a.ilabel != EPS]
        words = [a.olabel for a in arcs if a.olabel != EPS]
        out.append((ali, words, c))
    return out
