"""Port parity: GrammarFst (`kaldi_tpu_torch/fstext/grammar_fst.py`)
against the JAX package's, on the reference test's top-level graph and
sub-graph (tests/test_grammar_fst.py) built in both packages.

Exact: the prepared FSTs, the lazily spliced arcs and finals state for
state, the instances made; the port's LatticeFasterDecoder over the
GrammarFst equals JAX's over JAX's (raw lattices arc for arc, periodic
link pruning off), and equals the decode of the statically spliced
graph (best path; cost within 1e-9); a sub-FST the search never reaches
is never instantiated.
"""

import math

import numpy as np
import pytest

from kaldi_tpu.decoder.lattice_decoder import LatticeFasterDecoder as JLat
from kaldi_tpu.fstext import grammar_fst as JG
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.decoder.lattice_decoder import (
    LatticeFasterDecoder, LatticeFasterDecoderOptions)
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext import grammar_fst as TG
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.lat.functions import lattice_best_path

OFFSET = 10                 # nonterm_phones_offset in phones.txt
NT_X = OFFSET + 4           # #nonterm:x
NT_Y = OFFSET + 5           # #nonterm:y
PORT, JAX = (VectorFst, Arc), (JFst, JArc)


def enc(kind_or_nt, phone):
    assert TG.encode_symbol(OFFSET, kind_or_nt, phone) == \
        JG.encode_symbol(OFFSET, kind_or_nt, phone)
    return TG.encode_symbol(OFFSET, kind_or_nt, phone)


def fst(side, n, arcs, finals, start=0):
    Fst, A = side
    f = Fst(TropicalWeight)
    f.add_states(n)
    f.set_start(start)
    for s, il, ol, w, d in arcs:
        f.add_arc(s, A(il, ol, w, d))
    for s, w in finals.items():
        f.finals[s] = w
    return f


TOP = [(0, 1, 100, 0.5, 1), (1, enc(NT_X, 1), EPS, 0.3, 2),
       (2, enc(OFFSET + JG.NONTERM_REENTER, 2), EPS, 0.1, 3),
       (2, enc(OFFSET + JG.NONTERM_REENTER, 3), EPS, 0.2, 4),
       (3, 1, 101, 0.4, 5), (4, 2, 102, 0.4, 5)]
SUB = [(0, enc(OFFSET + JG.NONTERM_BEGIN, 1), EPS, 0.05, 1),
       (1, 2, 200, 0.6, 2), (1, 3, 201, 0.7, 3),
       (2, enc(OFFSET + JG.NONTERM_END, 2), EPS, 0.15, 4),
       (3, enc(OFFSET + JG.NONTERM_END, 3), EPS, 0.25, 4)]
LG2 = -math.log(2.0)
STATIC = [(0, 1, 100, 0.5, 1), (1, EPS, EPS, 0.3 + 0.05, 2),
          (2, 2, 200, 0.6, 3), (2, 3, 201, 0.7, 4),
          (3, EPS, EPS, 0.15 + 0.1 + LG2, 5),
          (4, EPS, EPS, 0.25 + 0.2 + LG2, 6),
          (5, 1, 101, 0.4, 7), (6, 2, 102, 0.4, 7)]
# a second branch from the start that invokes #nonterm:y
TOP_Y = TOP + [(0, 3, 300, 0.5, 6), (6, enc(NT_Y, 3), EPS, 0.1, 7),
               (7, enc(OFFSET + JG.NONTERM_REENTER, 2), EPS, 0.1, 5)]
SUB_Y = [(0, enc(OFFSET + JG.NONTERM_BEGIN, 3), EPS, 0.0, 1),
         (1, 2, 400, 0.2, 2),
         (2, enc(OFFSET + JG.NONTERM_END, 2), EPS, 0.0, 3)]


def grammars(top=TOP, extra=(), subs=((NT_X, SUB),)):
    out = []
    for side, M in ((PORT, TG), (JAX, JG)):
        t = fst(side, 1 + max(max(a[0], a[4]) for a in top),
                top + list(extra), {5: 0.0})
        ifsts = [(nt, M.prepare_for_grammar_fst(
            fst(side, 1 + max(a[4] for a in arcs), arcs, {}), OFFSET))
            for nt, arcs in subs]
        out.append(M.GrammarFst(OFFSET, M.prepare_for_grammar_fst(
            t, OFFSET), ifsts))
    return out


def walk(g):
    out, seen, queue = [], {g.start}, [g.start]
    while queue:
        s = queue.pop(0)
        arcs = [(a.ilabel, a.olabel, round(float(a.weight), 12),
                 a.nextstate) for a in g.arcs[s]]
        out.append((s, float(g.finals[s]), arcs))
        for a in arcs:
            if a[3] not in seen:
                seen.add(a[3])
                queue.append(a[3])
    return out


def rows(f):
    return [list(map(tuple, a)) for a in f.arcs], list(f.finals)


def test_encoding_and_prepare_equal_jax():
    for label in (enc(NT_X, 1), enc(OFFSET + JG.NONTERM_END, 3)):
        assert TG.decode_symbol(OFFSET, label) == \
            JG.decode_symbol(OFFSET, label)
    assert TG.get_encoding_multiple(1234) == 2000
    extra = [(1, 3, 103, 2.0, 5)]       # a mixed state
    for top in (TOP, TOP_Y):
        t = TG.prepare_for_grammar_fst(fst(PORT, 8, top + extra, {5: 0.0}),
                                       OFFSET)
        j = JG.prepare_for_grammar_fst(fst(JAX, 8, top + extra, {5: 0.0}),
                                       OFFSET)
        assert rows(t) == rows(j)
        assert TG.KALDI_GRAMMAR_FST_SPECIAL_WEIGHT in t.finals


@pytest.mark.parametrize("extra", [(), ((1, 3, 103, 2.0, 5),)])
def test_lazy_arcs_state_for_state(extra):
    tg, jg = grammars(extra=extra)
    assert walk(tg) == walk(jg)
    assert len(tg.instances) == len(jg.instances) == 2
    # the splice, by hand (the reference test's static graph)
    static = fst(PORT, 8, STATIC + [(1, 3, 103, 2.0, 7)] * len(extra),
                 {7: 0.0})
    assert sorted(p for p in paths(tg)) == sorted(paths(static))


def paths(g, depth=12):
    out, stack = [], [(g.start, (), (), 0.0)]
    while stack:
        s, il, ol, w = stack.pop()
        fw = float(g.finals[s])
        if fw != TropicalWeight.zero:
            out.append((ol, il, round(w + fw, 9)))
        if len(il) < depth:
            for a in g.arcs[s]:
                stack.append((a.nextstate,
                              il + ((a.ilabel,) if a.ilabel else ()),
                              ol + ((a.olabel,) if a.olabel else ()),
                              w + float(a.weight)))
    return out


def test_errors_as_jax():
    with pytest.raises(KaldiTpuError, match="two FSTs"):
        TG.GrammarFst(OFFSET, fst(PORT, 1, [], {0: 0.0}),
                      [(NT_X, VectorFst()), (NT_X, VectorFst())])
    with pytest.raises(KaldiTpuError, match="expected to be >="):
        TG.GrammarFst(OFFSET, fst(PORT, 1, [], {0: 0.0}),
                      [(OFFSET + 1, VectorFst())])
    # a nonterminal with no FST for it fails when the search gets there
    tg, _ = grammars(subs=())
    with pytest.raises(KaldiTpuError, match="no FST provided"):
        walk(tg)


TID2PDF = np.array([0, 0, 1, 2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_equals_jax_and_static(seed):
    rng = np.random.default_rng(seed)
    ll = rng.normal(scale=3.0, size=(3, 3)).astype(np.float32)
    ll[0, 0] = ll[1, 1] = ll[2, 0] = 2.0
    opts = LatticeFasterDecoderOptions(beam=30.0, lattice_beam=20.0,
                                       prune_interval=0)
    tg, jg = grammars()
    lat = LatticeFasterDecoder(tg, opts).decode(ll, TID2PDF, 1.0)
    jlat = JLat(jg, opts).decode(ll, TID2PDF, 1.0)
    assert rows(lat) == rows(jlat)
    slat = LatticeFasterDecoder(fst(PORT, 8, STATIC, {7: 0.0}), opts) \
        .decode(ll, TID2PDF, 1.0)
    a1, w1, c1 = lattice_best_path(lat)
    a2, w2, c2 = lattice_best_path(slat)
    assert (a1, w1) == (a2, w2) and c1 == pytest.approx(c2, abs=1e-9)
    f = FasterDecoder(grammars()[0], FasterDecoderOptions(beam=30.0)) \
        .decode(ll, TID2PDF, 1.0)
    assert f[:2] == (a1, w1) and f[2] == pytest.approx(c1, abs=1e-9)


def test_unreached_sub_fst_is_never_instantiated():
    """Two branches from the start, the acoustics favour the #nonterm:x
    one by far and the beam is narrow: the decoder never asks for the
    invocation state of #nonterm:y, so its instance is never made (and a
    wide beam makes it)."""
    ll = np.full((3, 3), -20.0, np.float32)
    ll[0, 0] = ll[1, 1] = ll[2, 0] = 0.0
    subs = ((NT_X, SUB), (NT_Y, SUB_Y))
    # (beam, instances, special states expanded: the invocations and the
    # sub-FSTs' end states)
    for beam, n_inst, n_special in ((5.0, 2, 2), (100.0, 3, 5)):
        tg, _ = grammars(top=TOP_Y, subs=subs)
        dec = LatticeFasterDecoder(tg, LatticeFasterDecoderOptions(
            beam=beam, lattice_beam=beam))
        lat = dec.decode(ll, TID2PDF, 1.0)
        assert lattice_best_path(lat)[1] == [100, 200, 101]
        assert len(tg.instances) == n_inst
        n_expanded = sum(len(i.expanded_states) for i in tg.instances)
        assert n_expanded == n_special
        total = len(walk(grammars(top=TOP_Y, subs=subs)[0]))
        assert (dec.stats["states_expanded"] < total) == (n_inst == 2)
