"""On-the-fly LM composition for decoding (port of
`kaldi_tpu/decoder/biglm.py`; parity: src/gmmbin/gmm-decode-biglm-faster.cc,
gmm-latgen-biglm-faster.cc, src/nnet3bin/nnet3-latgen-faster-lookahead.cc;
fstext/deterministic-fst.h BackoffDeterministicOnDemandFst and
ComposeDeterministicOnDemandFst).

`LazyBiglmFst`: HCLG carries a small G's scores; the difference
automaton (-G_old) o G_new is composed lazily, per state the search
reaches, so word emissions pay (new LM cost - old LM cost).
`LazyComposeFst`: an HCL graph composed on demand with a grammar G in
place of a prebuilt HCLG.  Both expose the duck type of a VectorFst
(start / arcs[s] / finals[s]) and intern a product state when an arc
that reaches it is made; `num_interned` counts them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst


class BackoffWordFst:
    """Deterministic-on-demand view of a backoff word acceptor G
    (fstext/deterministic-fst.h BackoffDeterministicOnDemandFst):
    epsilon arcs are backoff transitions; looking up a word follows
    backoff until an explicit arc exists."""

    def __init__(self, g: VectorFst):
        self.start = g.start
        self._arcs: List[Dict[int, Tuple[float, int]]] = []
        self._backoff: List[Optional[Tuple[float, int]]] = []
        self._final: List[float] = []
        for s in range(g.num_states):
            d: Dict[int, Tuple[float, int]] = {}
            backoff = None
            for a in g.arcs[s]:
                if a.ilabel == EPS:
                    backoff = (float(a.weight), a.nextstate)
                else:
                    d[a.ilabel] = (float(a.weight), a.nextstate)
            self._arcs.append(d)
            self._backoff.append(backoff)
            self._final.append(float(g.finals[s])
                               if g.finals[s] != TropicalWeight.zero
                               else float("inf"))

    def get_arc(self, s: int, label: int
                ) -> Optional[Tuple[float, int]]:
        cost = 0.0
        while True:
            hit = self._arcs[s].get(label)
            if hit is not None:
                return cost + hit[0], hit[1]
            bo = self._backoff[s]
            if bo is None:
                return None
            cost += bo[0]
            s = bo[1]

    def final(self, s: int) -> float:
        cost = 0.0
        while True:
            if self._final[s] != float("inf"):
                return cost + self._final[s]
            bo = self._backoff[s]
            if bo is None:
                return float("inf")
            cost += bo[0]
            s = bo[1]


class _LazyArcs:
    def __init__(self, owner: "LazyBiglmFst"):
        self.owner = owner

    def __getitem__(self, state: int):
        return self.owner._arcs_of(state)


class _LazyFinals:
    def __init__(self, owner: "LazyBiglmFst"):
        self.owner = owner

    def __getitem__(self, state: int):
        return self.owner._final_of(state)


class LazyBiglmFst:
    """Lazy composition HCLG o ((-G_old) o G_new) over word labels."""

    def __init__(self, hclg: VectorFst, old_g: BackoffWordFst,
                 new_g: BackoffWordFst):
        self.hclg = hclg
        self.old_g = old_g
        self.new_g = new_g
        self._ids: Dict[Tuple[int, int, int], int] = {}
        self._keys: List[Tuple[int, int, int]] = []
        self._arc_cache: Dict[int, list] = {}
        self.start = self._intern((hclg.start, old_g.start,
                                   new_g.start))
        self.arcs = _LazyArcs(self)
        self.finals = _LazyFinals(self)

    @property
    def num_interned(self) -> int:
        return len(self._keys)

    def _intern(self, key: Tuple[int, int, int]) -> int:
        i = self._ids.get(key)
        if i is None:
            i = len(self._keys)
            self._ids[key] = i
            self._keys.append(key)
        return i

    def _arcs_of(self, state: int):
        cached = self._arc_cache.get(state)
        if cached is not None:
            return cached
        h, so, sn = self._keys[state]
        out = []
        for a in self.hclg.arcs[h]:
            w = float(a.weight)
            so2, sn2 = so, sn
            if a.olabel != EPS:
                old_hit = self.old_g.get_arc(so, a.olabel)
                new_hit = self.new_g.get_arc(sn, a.olabel)
                if old_hit is None or new_hit is None:
                    continue   # word absent from an LM: path dies
                w += new_hit[0] - old_hit[0]
                so2, sn2 = old_hit[1], new_hit[1]
            out.append(Arc(a.ilabel, a.olabel, w,
                           self._intern((a.nextstate, so2, sn2))))
        self._arc_cache[state] = out
        return out

    def _final_of(self, state: int):
        h, so, sn = self._keys[state]
        fw = self.hclg.finals[h]
        if fw == TropicalWeight.zero:
            return TropicalWeight.zero
        fo = self.old_g.final(so)
        fn = self.new_g.final(sn)
        if fo == float("inf") or fn == float("inf"):
            return TropicalWeight.zero
        return float(fw) + fn - fo


class LazyComposeFst:
    """Lazy on-the-fly composition HCLr o Gr over word labels (parity:
    src/nnet3bin/nnet3-latgen-faster-lookahead.cc:1, which decodes an
    HCLr graph composed on demand with a grammar Gr instead of a
    prebuilt HCLG; OpenFst's label-lookahead matcher is a pruning
    optimization of the same product — here dead product states die at
    the BackoffWordFst lookup).  Exposes the VectorFst duck type
    (start / arcs[s] / finals[s]) the decoders consume, materializing
    states on demand."""

    def __init__(self, hcl: VectorFst, g: BackoffWordFst):
        self.hcl = hcl
        self.g = g
        self._ids: Dict[Tuple[int, int], int] = {}
        self._keys: List[Tuple[int, int]] = []
        self._arc_cache: Dict[int, list] = {}
        self.start = self._intern((hcl.start, g.start))
        self.arcs = _LazyArcs(self)
        self.finals = _LazyFinals(self)

    @property
    def num_interned(self) -> int:
        return len(self._keys)

    def _intern(self, key: Tuple[int, int]) -> int:
        i = self._ids.get(key)
        if i is None:
            i = len(self._keys)
            self._ids[key] = i
            self._keys.append(key)
        return i

    def _arcs_of(self, state: int):
        cached = self._arc_cache.get(state)
        if cached is not None:
            return cached
        h, sg = self._keys[state]
        out = []
        for a in self.hcl.arcs[h]:
            w = float(a.weight)
            sg2 = sg
            if a.olabel != EPS:
                hit = self.g.get_arc(sg, a.olabel)
                if hit is None:
                    continue       # word absent from G: path dies
                w += hit[0]
                sg2 = hit[1]
            out.append(Arc(a.ilabel, a.olabel, w,
                           self._intern((a.nextstate, sg2))))
        self._arc_cache[state] = out
        return out

    def _final_of(self, state: int):
        h, sg = self._keys[state]
        fw = self.hcl.finals[h]
        if fw == TropicalWeight.zero:
            return TropicalWeight.zero
        fg = self.g.final(sg)
        if fg == float("inf"):
            return TropicalWeight.zero
        return float(fw) + fg
