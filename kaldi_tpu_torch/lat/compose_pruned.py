"""Pruned on-the-fly lattice x LM composition (port of
`kaldi_tpu/lat/compose_pruned.py`; host-side).

Parity: lat/compose-lattice-pruned.h:87 (PrunedCompactLatticeComposer
behind ComposeCompactLatticePruned, used by
latbin/lattice-lmrescore-pruned.cc).  The reference expands composed
states best-first, ranked by (forward cost in the composed graph +
backward cost in the input lattice), and stops at a beam around the
best final cost or at an arc budget — so a huge LM (ConstArpaLm or an
RNNLM) only ever instantiates the composed states a good path can
reach.

This implementation keeps that exact search contract as an A* loop
over (lattice-state, lm-state) pairs.  The LM side is anything with
the DeterministicLm surface (start/step/final returning -ln costs):
lm.rescore.DeterministicLm, lm.const_arpa.ConstArpaLm, or
rnnlm.rescore adapters.
"""

from __future__ import annotations

import heapq
from typing import Dict, Hashable, List, Tuple

from kaldi_tpu_torch.base.logging import warn
from kaldi_tpu_torch.fstext.fst import EPS, Arc, LatticeWeight, VectorFst
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.lat.functions import _forward_backward_costs
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice

INF = float("inf")


def compose_lattice_pruned(lat: Lattice, det_lm, lm_scale: float = 1.0,
                           beam: float = 6.0, max_arcs: int = 100000
                           ) -> Lattice:
    """Compose `lat`'s word labels with a deterministic LM, adding
    lm_scale * LM cost to the graph cost, expanding only composed
    states within `beam` of the best complete path (A* with the
    lattice's backward costs as the heuristic), up to `max_arcs`.

    Defaults mirror ComposeLatticePrunedOptions
    (lat/compose-lattice-pruned.h:46: lattice_compose_beam=6.0,
    max_arcs=100000)."""
    if lat.num_states == 0 or lat.start is None:
        return lat
    _, bwd = _forward_backward_costs(lat)

    out = VectorFst(LatticeWeight)
    state_of: Dict[Tuple[int, Hashable], int] = {}
    alpha: List[float] = []
    lm_state_of: List[Hashable] = []
    lat_state_of: List[int] = []

    expanded: List[bool] = []

    def get(ls: int, hist) -> int:
        key = (ls, hist)
        s = state_of.get(key)
        if s is None:
            s = out.add_state()
            state_of[key] = s
            alpha.append(INF)
            lm_state_of.append(hist)
            lat_state_of.append(ls)
            expanded.append(False)
        return s

    start = get(lat.start, det_lm.start())
    alpha[start] = 0.0
    out.set_start(start)

    # heap of (priority, composed-state); lazy-deletion Dijkstra/A*.
    # A state's out-arcs are created exactly once; if its alpha later
    # improves (possible with negative weights, e.g. lm_scale < 0),
    # the re-pop re-relaxes through the already-created arcs.
    heap: List[Tuple[float, int]] = [(bwd[lat.start], start)]
    best_final = INF
    n_arcs = 0
    while heap:
        prio, cur = heapq.heappop(heap)
        a_cur = alpha[cur]
        ls, hist = lat_state_of[cur], lm_state_of[cur]
        if prio > a_cur + bwd[ls] + 1e-9:
            continue                       # stale entry
        if best_final < INF and prio > best_final + beam:
            break                          # everything left is pruned
        if n_arcs > max_arcs:
            warn(f"compose_lattice_pruned: hit max_arcs={max_arcs}; "
                 "output may be over-pruned")
            break
        if lat.finals[ls] != LatticeWeight.zero:
            if out.finals[cur] == LatticeWeight.zero:
                g, ac = lat.finals[ls]
                fcost = lm_scale * det_lm.final(hist)
                out.finals[cur] = (g + fcost, ac)
            fg, fa = out.finals[cur]
            best_final = min(best_final, a_cur + fg + fa)
        if expanded[cur]:
            relax = [(a.weight, a.nextstate)
                     for a in out.arcs[cur]]
        else:
            expanded[cur] = True
            relax = []
            for arc in lat.arcs[ls]:
                if arc.olabel == EPS:
                    nhist, lmc = hist, 0.0
                else:
                    nhist, lmc = det_lm.step(hist, arc.olabel)
                g, ac = arc.weight
                w = (g + lm_scale * lmc, ac)
                ns = get(arc.nextstate, nhist)
                out.add_arc(cur, Arc(arc.ilabel, arc.olabel, w, ns))
                n_arcs += 1
                relax.append((w, ns))
        for w, ns in relax:
            nd = a_cur + w[0] + w[1]
            if nd < alpha[ns] - 1e-12:
                alpha[ns] = nd
                heapq.heappush(
                    heap, (nd + bwd[lat_state_of[ns]], ns))
    connect(out)
    return out
