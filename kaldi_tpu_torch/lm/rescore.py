"""Lattice LM rescoring (port of `kaldi_tpu/lm/rescore.py`; host-side;
parity: lm/const-arpa-lm.h:211 ConstArpaLm +
latbin/lattice-lmrescore{,-const-arpa}).

A DeterministicLm answers exact backoff-smoothed conditional scores
with NO epsilon/backoff arcs (the DeterministicOnDemandFst idea,
fstext/deterministic-fst.h:75): composition with the word level of a
lattice is then a simple product construction over
(lattice state × LM history)."""

from __future__ import annotations

from collections import deque
from typing import Dict, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, Arc, LatticeWeight, VectorFst
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice
from kaldi_tpu_torch.lm.arpa import M_LN10, ArpaLm


class DeterministicLm:
    """Exact n-gram LM as a deterministic on-demand automaton over word
    IDS. States are histories; step(state, word) -> (new_state, cost in
    -ln)."""

    def __init__(self, lm: ArpaLm, word_names: Dict[int, str],
                 bos: str = "<s>", eos: str = "</s>"):
        self.lm = lm
        self.names = word_names
        self.bos, self.eos = bos, eos

    def start(self):
        return (self.bos,)

    def step(self, hist: Tuple[str, ...], word_id: int):
        word = self.names[word_id]
        cost = -self.lm._cond_log10(hist, word) * M_LN10
        new_hist = (hist + (word,))[-(self.lm.order - 1):] \
            if self.lm.order > 1 else ()
        # truncate to an existing history (backoff states)
        while new_hist and (len(new_hist) > self.lm.order - 1
                            or new_hist not in
                            self.lm.ngrams[len(new_hist) - 1]):
            new_hist = new_hist[1:]
        return new_hist, cost

    def final(self, hist: Tuple[str, ...]) -> float:
        return -self.lm._cond_log10(hist, self.eos) * M_LN10


def lattice_lmrescore(lat: Lattice, det_lm: DeterministicLm,
                      lm_scale: float = 1.0) -> Lattice:
    """Compose the lattice's word level with the deterministic LM,
    adding lm_scale * LM cost to graph costs (lattice-lmrescore
    semantics: pass a negative scale to subtract an old LM)."""
    out = VectorFst(LatticeWeight)
    state_map: Dict[Tuple[int, Tuple], int] = {}
    work = deque()

    def get(key):
        if key not in state_map:
            state_map[key] = out.add_state()
            work.append(key)
        return state_map[key]

    start_key = (lat.start, det_lm.start())
    out.set_start(get(start_key))
    while work:
        key = work.popleft()
        s, hist = key
        cur = state_map[key]
        if lat.finals[s] != LatticeWeight.zero:
            fcost = det_lm.final(hist) * lm_scale
            g, a = lat.finals[s]
            out.finals[cur] = (g + fcost, a)
        for arc in lat.arcs[s]:
            if arc.olabel == EPS:
                ns = get((arc.nextstate, hist))
                out.add_arc(cur, Arc(arc.ilabel, arc.olabel, arc.weight, ns))
            else:
                new_hist, cost = det_lm.step(hist, arc.olabel)
                g, ac = arc.weight
                ns = get((arc.nextstate, new_hist))
                out.add_arc(cur, Arc(arc.ilabel, arc.olabel,
                                     (g + lm_scale * cost, ac), ns))
    return out
