"""Minimum Bayes Risk decoding / confusion networks (port of
`kaldi_tpu/lat/sausages.py`, the same order of operations; host-side;
parity: lat/sausages.h:77 MinimumBayesRisk).

Implements the ARC-LEVEL recursion of "Minimum Bayes Risk decoding and
system combination based on a recursion for edit distance" (Xu, Povey,
Mangu, Zhu, CSL 2011), exactly as lat/sausages.cc: the expected edit
distance between the full lattice posterior and the current hypothesis
R is computed by the alpha-dash forward recursion over lattice arcs
(Figure 4), and the per-bin word posteriors gamma (the sausage) by the
corresponding backward pass (Figure 5) — no n-best expansion, so deep
lattices are handled exactly.  MbrDecode then iteratively replaces
each R[q] with the bin argmax until the expected risk stops improving.

Input lattices carry transition-ids on ilabels and words on olabels;
arcs with olabel 0 are epsilon words, which the recursion supports
natively.  Weights (graph, acoustic) are assumed already scaled
(lattice-scale semantics)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.base.logging import warn
from kaldi_tpu_torch.fstext.fst import LatticeWeight
from kaldi_tpu_torch.lat.functions import (_topsort, lattice_best_path,
                                     lattice_state_times)
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice

_DELTA = 1.0e-05         # sausages.h:188 delta()
_LOG_ZERO = -1e30


@dataclass
class MinimumBayesRiskOptions:
    decode_mbr: bool = field(default=True, metadata={"doc": "If true, do MBR decoding (else use MAP hypothesis as output)"})
    print_silence: bool = False


def _logadd(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= _LOG_ZERO / 2:
        return a
    return a + math.log1p(math.exp(b - a))


class _Arc:
    __slots__ = ("start_node", "end_node", "word", "loglike")

    def __init__(self, s, e, w, ll):
        self.start_node = s
        self.end_node = e
        self.word = w
        self.loglike = ll


class MinimumBayesRisk:
    def __init__(self, lat: Lattice,
                 opts: Optional[MinimumBayesRiskOptions] = None,
                 words: Optional[Sequence[int]] = None):
        self.opts = opts or MinimumBayesRiskOptions()
        self.hyp: List[int] = []
        self.confidences: List[float] = []
        self.bins: List[Dict[int, float]] = []
        self.times: List[Tuple[float, float]] = []
        self.sausage_times: List[Tuple[float, float]] = []
        self.one_best_times: List[Tuple[float, float]] = []
        self.L = 0.0
        if lat.num_states == 0 or lat.start is None:
            return
        self._prepare(lat)
        if words is not None:
            self.R = [int(w) for w in words]
        else:
            _ali, map_words, _c = lattice_best_path(lat)
            self.R = list(map_words)
        self._mbr_decode()

    # -- lattice preparation (PrepareLatticeAndInitStats) -------------
    def _prepare(self, lat: Lattice) -> None:
        order = _topsort(lat)
        if order is None:
            raise ValueError("MBR: lattice has cycles")
        state_times = lattice_state_times(lat)
        # node ids 1..N in topological order; one super-final node
        node_of = {s: i + 1 for i, s in enumerate(order)}
        n_super = len(order) + 1
        arcs: List[_Arc] = []
        for s in order:
            for a in lat.arcs[s]:
                g, ac = a.weight
                arcs.append(_Arc(node_of[s], node_of[a.nextstate],
                                 a.olabel, -(g + ac)))
            if lat.finals[s] != LatticeWeight.zero:
                g, ac = lat.finals[s]
                arcs.append(_Arc(node_of[s], n_super, 0, -(g + ac)))
        self.N = n_super
        self.arcs = arcs
        self.pre: List[List[int]] = [[] for _ in range(self.N + 1)]
        for i, a in enumerate(arcs):
            self.pre[a.end_node].append(i)
        st = [0] + [state_times[s] for s in order]
        st.append(max(st) if st else 0)
        self.state_times = st          # index by node id (1..N)

    # -- edit-distance cost -------------------------------------------
    @staticmethod
    def _l(a: int, b: int, penalize: bool = False) -> float:
        if a == b:
            return 0.0
        return 1.0 + _DELTA if penalize else 1.0

    # -- Figure 4: expected edit distance -----------------------------
    def _edit_distance(self, alpha, alpha_dash, alpha_dash_arc) -> float:
        R, l = self.R, self._l
        N, Q = self.N, len(R)
        alpha[1] = 0.0
        alpha_dash[1, 0] = 0.0
        for q in range(1, Q + 1):
            alpha_dash[1, q] = alpha_dash[1, q - 1] + l(0, R[q - 1])
        for n in range(2, N + 1):
            alpha_n = _LOG_ZERO
            for i in self.pre[n]:
                a = self.arcs[i]
                alpha_n = _logadd(alpha_n, alpha[a.start_node]
                                  + a.loglike)
            alpha[n] = alpha_n
            for i in self.pre[n]:
                a = self.arcs[i]
                s_a, w_a = a.start_node, a.word
                row = alpha_dash[s_a]
                alpha_dash_arc[0] = row[0] + l(w_a, 0, True)
                for q in range(1, Q + 1):
                    r_q = R[q - 1]
                    a1 = row[q - 1] + l(w_a, r_q)
                    a2 = row[q] + l(w_a, 0, True)
                    a3 = alpha_dash_arc[q - 1] + l(0, r_q)
                    alpha_dash_arc[q] = min(a1, a2, a3)
                scale = math.exp(alpha[s_a] + a.loglike - alpha[n])
                alpha_dash[n] += scale * alpha_dash_arc
        return float(alpha_dash[N, Q])

    # -- Figure 5: stats accumulation ---------------------------------
    def _acc_stats(self) -> None:
        R, l = self.R, self._l
        N, Q = self.N, len(R)
        alpha = np.zeros(N + 1)
        alpha_dash = np.zeros((N + 1, Q + 1))
        alpha_dash_arc = np.zeros(Q + 1)
        beta_dash = np.zeros((N + 1, Q + 1))
        beta_dash_arc = np.zeros(Q + 1)
        b_arc = np.zeros(Q + 1, np.int8)
        gamma: List[Dict[int, float]] = [dict() for _ in range(Q + 1)]
        tau_b: List[Dict[int, float]] = [dict() for _ in range(Q + 1)]
        tau_e: List[Dict[int, float]] = [dict() for _ in range(Q + 1)]

        def add(m, k, v):
            m[k] = m.get(k, 0.0) + v

        L = self._edit_distance(alpha, alpha_dash, alpha_dash_arc)
        if self.L != 0.0 and L > self.L + 1e-6:
            warn(f"MBR: edit distance increased {L} > {self.L}")
        self.L = L
        beta_dash[N, Q] = 1.0
        st = self.state_times
        for n in range(N, 1, -1):
            for i in self.pre[n]:
                a = self.arcs[i]
                s_a, w_a = a.start_node, a.word
                row = alpha_dash[s_a]
                alpha_dash_arc[0] = row[0] + l(w_a, 0, True)
                for q in range(1, Q + 1):
                    r_q = R[q - 1]
                    a1 = row[q - 1] + l(w_a, r_q)
                    a2 = row[q] + l(w_a, 0, True)
                    a3 = alpha_dash_arc[q - 1] + l(0, r_q)
                    if a1 <= a2:
                        if a1 <= a3:
                            b_arc[q] = 1
                            alpha_dash_arc[q] = a1
                        else:
                            b_arc[q] = 3
                            alpha_dash_arc[q] = a3
                    else:
                        if a2 <= a3:
                            b_arc[q] = 2
                            alpha_dash_arc[q] = a2
                        else:
                            b_arc[q] = 3
                            alpha_dash_arc[q] = a3
                beta_dash_arc[:] = 0.0
                occ = math.exp(alpha[s_a] + a.loglike - alpha[n])
                for q in range(Q, 0, -1):
                    beta_dash_arc[q] += occ * beta_dash[n, q]
                    v = beta_dash_arc[q]
                    k = b_arc[q]
                    if k == 1:
                        beta_dash[s_a, q - 1] += v
                        add(gamma[q], w_a, v)
                        add(tau_b[q], w_a, st[s_a] * v)
                        add(tau_e[q], w_a, st[n] * v)
                    elif k == 2:
                        beta_dash[s_a, q] += v
                    else:
                        beta_dash_arc[q - 1] += v
                        add(gamma[q], 0, v)
                        # sausages.cc:244 — NOT st[s_a]; erratum to
                        # Appendix C of the paper
                        add(tau_b[q], 0, st[n] * v)
                        add(tau_e[q], 0, st[n] * v)
                beta_dash_arc[0] += occ * beta_dash[n, 0]
                beta_dash[s_a, 0] += beta_dash_arc[0]
        beta_dash_arc[:] = 0.0
        for q in range(Q, 0, -1):
            beta_dash_arc[q] += beta_dash[1, q]
            beta_dash_arc[q - 1] += beta_dash_arc[q]
            add(gamma[q], 0, beta_dash_arc[q])
            add(tau_b[q], 0, st[1] * beta_dash_arc[q])
            add(tau_e[q], 0, st[1] * beta_dash_arc[q])
        for q in range(1, Q + 1):
            tot = sum(gamma[q].values())
            if abs(tot - 1.0) > 0.1:
                warn(f"MBR: sum of gamma[{q}] is {tot}")
        # convert to sorted per-bin lists (0-indexed)
        self.gamma: List[List[Tuple[int, float]]] = []
        self.times = []
        self.sausage_times = []
        for q in range(1, Q + 1):
            items = sorted(gamma[q].items(), key=lambda kv: -kv[1])
            self.gamma.append(items)
            row = []
            t_b = t_e = 0.0
            for w, g in items:
                wb, we = tau_b[q].get(w, 0.0), tau_e[q].get(w, 0.0)
                row.append((wb / g if g else 0.0, we / g if g else 0.0))
                t_b += wb
                t_e += we
            self.times.append(row)
            self.sausage_times.append((t_b, t_e))
            if q > 1 and self.sausage_times[-2][1] > t_b:
                mid = 0.5 * (self.sausage_times[-2][1] + t_b)
                self.sausage_times[-2] = (self.sausage_times[-2][0], mid)
                self.sausage_times[-1] = (mid, t_e)

    # -- normalization helpers ----------------------------------------
    @staticmethod
    def _remove_eps(vec: List[int]) -> List[int]:
        return [w for w in vec if w != 0]

    @classmethod
    def _normalize_eps(cls, vec: List[int]) -> List[int]:
        out = [0]
        for w in cls._remove_eps(vec):
            out.append(w)
            out.append(0)
        return out

    # -- the MbrDecode loop -------------------------------------------
    def _mbr_decode(self) -> None:
        counter = 0
        while True:
            self.R = self._normalize_eps(self.R)
            self._acc_stats()
            delta_q = 0.0
            self.one_best_times = []
            self.confidences = []
            for q in range(len(self.R)):
                if self.opts.decode_mbr:
                    this_gamma = self.gamma[q]
                    rq = self.R[q]
                    rhat, new_gamma = this_gamma[0]
                    old_gamma = 0.0
                    for w, g in this_gamma:
                        if w == rq:
                            old_gamma = g
                            break
                    delta_q += old_gamma - new_gamma
                    self.R[q] = rhat
                if self.R[q] != 0 or self.opts.print_silence:
                    s = 0
                    for j, (w, _g) in enumerate(self.gamma[q]):
                        if w == self.R[q]:
                            s = j
                            break
                    self.one_best_times.append(self.times[q][s])
                    i = len(self.one_best_times)
                    if (i > 1 and self.one_best_times[i - 2][1]
                            > self.one_best_times[i - 1][0]):
                        prev_right = (self.one_best_times[i - 3][1]
                                      if i > 2 else 0.0)
                        left = max(prev_right,
                                   min(self.one_best_times[i - 2][0],
                                       self.one_best_times[i - 1][0]))
                        right = max(self.one_best_times[i - 2][1],
                                    self.one_best_times[i - 1][1])
                        d1 = (self.one_best_times[i - 2][1]
                              - self.one_best_times[i - 2][0])
                        d2 = (self.one_best_times[i - 1][1]
                              - self.one_best_times[i - 1][0])
                        mid = (left + (right - left) * d1 / (d1 + d2)
                               if d1 > 0 else left)
                        self.one_best_times[i - 2] = (left, mid)
                        self.one_best_times[i - 1] = (
                            mid, right)
                    conf = 0.0
                    for w, g in self.gamma[q]:
                        if w == self.R[q]:
                            conf = g
                            break
                    self.confidences.append(conf)
            counter += 1
            if delta_q == 0.0 or not self.opts.decode_mbr:
                break
            if counter > 100:
                warn("MBR: iterating too many times; stopping")
                break
        r_full = list(self.R)       # aligned with self.gamma
        if not self.opts.print_silence:
            self.R = self._remove_eps(self.R)
        self.hyp = list(self.R)
        # bins aligned with the OUTPUT hypothesis (dict view kept for
        # backward compatibility with round-1 consumers)
        self.bins = [dict(g) for g, r in zip(self.gamma, r_full)
                     if r != 0 or self.opts.print_silence]

    # -- public accessors (sausages.h surface) ------------------------
    def get_one_best(self) -> List[int]:
        return list(self.hyp)

    def get_bayes_risk(self) -> float:
        return float(self.L)

    def get_one_best_times(self) -> List[Tuple[float, float]]:
        return list(self.one_best_times)

    def get_one_best_confidences(self) -> List[float]:
        return list(self.confidences)

    def get_sausage_stats(self) -> List[List[Tuple[int, float]]]:
        return [list(g) for g in self.gamma]

    def get_sausage_times(self) -> List[Tuple[float, float]]:
        return list(self.sausage_times)
