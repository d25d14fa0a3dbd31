"""Packed HMM graphs for the chain forward pass (port of `PackedGraph`,
`pack_emission_fst`, `DenominatorGraph`, `den_graph_from_fst_file` and
`batch_pack` of `kaldi_tpu/chain/graphs.py`, and of `_den_graph_to_fsts`
of `kaldi_tpu/cli/chain_tools.py`; parity: chain/chain-den-graph.h:53).

A packed graph is a set of numpy arrays:

  src[a], dst[a]   arc endpoints (states)
  pdf[a]           emission pdf-id of the arc
  log_prob[a]      transition log-prob
  initial[s]       initial log-probs (den: stationary; num: state 0)
  final[s]         final log-probs
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst


@dataclass
class PackedGraph:
    src: np.ndarray        # (A,) int32
    dst: np.ndarray        # (A,) int32
    pdf: np.ndarray        # (A,) int32  (emission on the arc)
    log_prob: np.ndarray   # (A,) float32
    initial: np.ndarray    # (S,) float32 log initial probs (-inf if not)
    final: np.ndarray      # (S,) float32 log final probs (-inf if not)

    @property
    def num_states(self) -> int:
        return self.initial.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.src.shape[0]

    def padded(self, num_states: int, num_arcs: int) -> "PackedGraph":
        """Pad to fixed sizes (extra arcs are self-loops on a dead state
        with -inf weight; extra states unreachable)."""
        S, A = self.num_states, self.num_arcs
        assert num_states >= S and num_arcs >= A
        pad_s = num_states - S
        pad_a = num_arcs - A
        ninf = np.float32(-1e30)
        return PackedGraph(
            src=np.concatenate([self.src, np.full(pad_a, S if pad_s else 0,
                                                  np.int32)]),
            dst=np.concatenate([self.dst, np.full(pad_a, S if pad_s else 0,
                                                  np.int32)]),
            pdf=np.concatenate([self.pdf, np.zeros(pad_a, np.int32)]),
            log_prob=np.concatenate([self.log_prob,
                                     np.full(pad_a, ninf, np.float32)]),
            initial=np.concatenate([self.initial,
                                    np.full(pad_s, ninf, np.float32)]),
            final=np.concatenate([self.final,
                                  np.full(pad_s, ninf, np.float32)]),
        )


def pack_emission_fst(fst: VectorFst, pdf_offset: int = 0) -> PackedGraph:
    """Pack an FST whose non-eps input labels are pdf-id+1 (0 = eps).
    Epsilon arcs are not supported in FB — remove them first."""
    src: List[int] = []
    dst: List[int] = []
    pdf: List[int] = []
    lp: List[float] = []
    n = fst.num_states
    for s in range(n):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                raise ValueError("pack_emission_fst: epsilon arc present; "
                                 "run rm_epsilon first")
            src.append(s)
            dst.append(a.nextstate)
            pdf.append(a.ilabel - 1 - pdf_offset)
            lp.append(-a.weight)  # tropical cost -> log prob
    ninf = -1e30
    initial = np.full(n, ninf, np.float32)
    initial[fst.start] = 0.0
    final = np.array([(-w if w != TropicalWeight.zero else ninf)
                      for w in fst.finals], np.float32)
    return PackedGraph(np.array(src, np.int32), np.array(dst, np.int32),
                       np.array(pdf, np.int32), np.array(lp, np.float32),
                       initial, final)


@dataclass
class DenominatorGraph:
    """Denominator graph + derived quantities (chain-den-graph.h:53)."""
    graph: PackedGraph
    # 'initial' for the denominator is the stationary distribution the
    # reference computes; we store explicit initial probs in the graph.

    @property
    def num_states(self) -> int:
        return self.graph.num_states


def den_graph_from_fst_file(path: str) -> DenominatorGraph:
    """den.fst (a pdf+1 acceptor as written by chain-make-den-fst) ->
    DenominatorGraph with the stationary initial distribution
    (chain-den-graph.cc:249 SetInitialProbs equivalent)."""
    from kaldi_tpu_torch.chain.supervision import _stationary_initial
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    pg = pack_emission_fst(read_fst_file(path))
    pg.initial = _stationary_initial(pg)
    return DenominatorGraph(pg)


def den_graph_to_fsts(den: DenominatorGraph) -> Tuple[VectorFst, VectorFst]:
    """DenominatorGraph -> (den fst, normalization fst) as pdf+1
    acceptors.  The den fst carries the transition structure from the
    most likely initial state; the normalization fst has the initial
    distribution on epsilon arcs from a new start state
    (chain-den-graph.cc GetNormalizationFst)."""
    g = den.graph
    init = np.asarray(g.initial)
    fin = np.asarray(g.final)

    def acceptor(offset: int) -> VectorFst:
        fst = VectorFst(TropicalWeight)
        for _ in range(g.num_states + offset):
            fst.add_state()
        for s in range(g.num_states):
            if np.isfinite(fin[s]):
                fst.finals[s + offset] = -float(fin[s])
        for a in range(g.num_arcs):
            lbl = int(g.pdf[a]) + 1
            fst.add_arc(int(g.src[a]) + offset,
                        Arc(lbl, lbl, -float(g.log_prob[a]),
                            int(g.dst[a]) + offset))
        return fst

    den_fst = acceptor(0)
    den_fst.set_start(int(np.argmax(init)))
    norm_fst = acceptor(1)
    norm_fst.set_start(0)
    for s in range(g.num_states):
        if np.isfinite(init[s]):
            norm_fst.add_arc(0, Arc(EPS, EPS, -float(init[s]), s + 1))
    return den_fst, norm_fst


def batch_pack(graphs: Sequence[PackedGraph]
               ) -> Tuple[np.ndarray, ...]:
    """Pad a list of per-sequence graphs to common shapes; returns
    stacked (B, ...) arrays (src, dst, pdf, log_prob, initial, final)."""
    S = max(g.num_states for g in graphs) + 1  # +1 dead state for padding
    A = max(g.num_arcs for g in graphs)
    padded = [g.padded(S, A) for g in graphs]
    return (np.stack([g.src for g in padded]),
            np.stack([g.dst for g in padded]),
            np.stack([g.pdf for g in padded]),
            np.stack([g.log_prob for g in padded]),
            np.stack([g.initial for g in padded]),
            np.stack([g.final for g in padded]))
