"""Lang construction, decoding graphs and per-utterance training graphs
(port of `kaldi_tpu/decoder/graph.py`).  Host-side.

Parity targets: utils/prepare_lang.sh (L.fst with disambiguation
symbols, the add_lex_disambig.pl / make_lexicon_fst.pl logic),
utils/mkgraph.sh (the HCLG pipeline) and
decoder/training-graph-compiler.h:59 (one graph a transcript).  For a
monophone tree C is the identity, so a graph is the HMM expansion of
det(L o G) with phones as input labels; a context-dependent tree adds
the context expansion (fstext/context.py) before the HMM expansion.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.base.logging import KaldiTpuError, log
from kaldi_tpu_torch.fstext.context import context_expand
from kaldi_tpu_torch.fstext.ops import (arcsort, compose, determinize_star,
                                        minimize_encoded, relabel,
                                        rm_epsilon)
from kaldi_tpu_torch.hmm.hmm_utils import expand_hmm
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import ContextDependency


class Lang:
    """The lang-directory equivalent: symbol tables, lexicon, topology.

    Mirrors the data contract of utils/prepare_lang.sh (SURVEY.md §1):
    phones.txt / words.txt numbering, disambiguation symbols, optional
    silence, topo."""

    def __init__(self, lexicon: Dict[str, List[List[str]]],
                 sil_phone: str = "SIL", sil_prob: float = 0.5,
                 oov_word: Optional[str] = None,
                 position_dependent: bool = False):
        """lexicon: word -> list of pronunciations (phone lists)."""
        self.lexicon = {w: [list(p) for p in prons]
                        for w, prons in lexicon.items()}
        self.sil_phone = sil_phone
        self.sil_prob = sil_prob
        phone_set = sorted({p for prons in lexicon.values()
                            for pron in prons for p in pron} | {sil_phone})
        # phone ids: 1-based; 0 = eps
        self.phones = {p: i + 1 for i, p in enumerate(phone_set)}
        self.phone_names = {i: p for p, i in self.phones.items()}
        # words: 0 = eps, then sorted; <s>/</s> not included
        word_set = sorted(lexicon.keys())
        self.words = {w: i + 1 for i, w in enumerate(word_set)}
        self.word_names = {i: w for w, i in self.words.items()}
        self.oov_word = oov_word
        # disambig symbols come after phones
        self.num_disambig = 0
        self.first_disambig = len(phone_set) + 1
        self.topo: Optional[HmmTopology] = None

    def make_topology(self, num_nonsil_states: int = 3,
                      num_sil_states: int = 5) -> HmmTopology:
        sil_id = self.phones[self.sil_phone]
        nonsil = [i for p, i in self.phones.items() if p != self.sil_phone]
        self.topo = HmmTopology.three_state(
            sorted(self.phones.values()), nonsil_phones=sorted(nonsil),
            sil_phones=[sil_id], num_sil_states=num_sil_states,
            num_nonsil_states=num_nonsil_states)
        return self.topo

    def disambig_ids(self) -> List[int]:
        return list(range(self.first_disambig,
                          self.first_disambig + self.num_disambig + 1))

    @property
    def phone_zero_word(self) -> int:
        """#0 symbol id on the phone side (backoff pass-through)."""
        return self.first_disambig + self.num_disambig

    def word_ids(self, words: Sequence[str]) -> List[int]:
        out = []
        for w in words:
            if w in self.words:
                out.append(self.words[w])
            elif self.oov_word is not None:
                out.append(self.words[self.oov_word])
            else:
                raise ValueError(f"OOV word {w!r} and no oov_word set")
        return out


def add_lex_disambig(lexicon: Dict[str, List[List[str]]]
                     ) -> Tuple[Dict[str, List[Tuple[List[str], int]]], int]:
    """Determine disambiguation symbols (utils/add_lex_disambig.pl):
    pronunciations that are prefixes of others or homophones get #k.
    Returns (word -> [(pron, disambig_index or 0)], max_disambig)."""
    prons = [(w, tuple(p)) for w, plist in lexicon.items() for p in plist]
    count: Dict[Tuple[str, ...], int] = {}
    prefixes = set()
    for _, p in prons:
        count[p] = count.get(p, 0) + 1
        for i in range(1, len(p)):
            prefixes.add(p[:i])
    last_used: Dict[Tuple[str, ...], int] = {}
    out: Dict[str, List[Tuple[List[str], int]]] = {w: [] for w in lexicon}
    max_disambig = 0
    for w, p in prons:
        if count[p] == 1 and p not in prefixes:
            out[w].append((list(p), 0))
        else:
            cur = last_used.get(p, 0) + 1
            last_used[p] = cur
            max_disambig = max(max_disambig, cur)
            out[w].append((list(p), cur))
    return out, max_disambig


def make_lexicon_fst(lang: Lang, with_disambig: bool = True) -> VectorFst:
    """L (or L_disambig): phones -> words with optional silence
    (make_lexicon_fst.pl construction)."""
    sil_prob = lang.sil_prob
    sil_cost = -math.log(sil_prob) if sil_prob > 0 else 0.0
    no_sil_cost = -math.log(1.0 - sil_prob) if sil_prob > 0 else 0.0

    if with_disambig:
        dlex, max_d = add_lex_disambig(lang.lexicon)
        lang.num_disambig = max_d
        # silence also needs a disambig symbol if optional silence is used
        sil_disambig = lang.first_disambig + max_d + 1 if sil_prob > 0 else 0
        if sil_prob > 0:
            lang.num_disambig = max_d + 1
    else:
        dlex = {w: [(p, 0) for p in prons]
                for w, prons in lang.lexicon.items()}
        lang.num_disambig = 0
        sil_disambig = 0

    fst = VectorFst(TropicalWeight)
    start = fst.add_state()
    loop = fst.add_state()
    fst.set_start(start)
    fst.set_final(loop)
    sil_id = lang.phones[lang.sil_phone]

    if sil_prob > 0:
        sil_state = fst.add_state()
        fst.add_arc(start, Arc(EPS, EPS, no_sil_cost, loop))
        fst.add_arc(start, Arc(EPS, EPS, sil_cost, sil_state))
        if sil_disambig:
            dstate = fst.add_state()
            fst.add_arc(sil_state, Arc(sil_id, EPS, 0.0, dstate))
            fst.add_arc(dstate, Arc(sil_disambig, EPS, 0.0, loop))
        else:
            fst.add_arc(sil_state, Arc(sil_id, EPS, 0.0, loop))
    else:
        fst.add_arc(start, Arc(EPS, EPS, 0.0, loop))

    for word, prons in dlex.items():
        wid = lang.words[word]
        for phones, disambig in prons:
            syms = [lang.phones[p] for p in phones]
            if disambig:
                syms.append(lang.first_disambig + disambig - 1)
            cur = loop
            for i, sym in enumerate(syms):
                olabel = wid if i == 0 else EPS
                last = i == len(syms) - 1
                if not last:
                    ns = fst.add_state()
                    fst.add_arc(cur, Arc(sym, olabel, 0.0, ns))
                    cur = ns
                else:
                    if sil_prob > 0:
                        fst.add_arc(cur, Arc(sym, olabel, no_sil_cost, loop))
                        fst.add_arc(cur, Arc(sym, olabel, sil_cost, sil_state))
                    else:
                        fst.add_arc(cur, Arc(sym, olabel, 0.0, loop))
    return arcsort(fst, "olabel")


def make_linear_word_acceptor(word_ids: Sequence[int]) -> VectorFst:
    fst = VectorFst(TropicalWeight)
    cur = fst.add_state()
    fst.set_start(cur)
    for w in word_ids:
        ns = fst.add_state()
        fst.add_arc(cur, Arc(w, w, 0.0, ns))
        cur = ns
    fst.set_final(cur)
    return fst


def _remove_disambig(fst: VectorFst, lang: Lang) -> VectorFst:
    """Relabel disambiguation symbols (incl. the phone-side #0) to eps."""
    dmap = {d: EPS for d in range(lang.first_disambig,
                                  lang.first_disambig + lang.num_disambig + 2)}
    return relabel(fst, ilabel_map=dmap)


def make_decoding_graph(lang: Lang, g_fst: VectorFst,
                        tree: ContextDependency, tm: TransitionModel,
                        transition_scale: float = 1.0,
                        self_loop_scale: float = 0.1) -> VectorFst:
    """HCLG (the mkgraph.sh pipeline): det(min(L o G)), the disambiguation
    symbols removed, context-expanded for a triphone tree, then
    HMM-expanded."""
    L = make_lexicon_fst(lang, with_disambig=True)
    lg = compose(L, arcsort(g_fst, "ilabel"))
    lg = determinize_star(lg)
    lg = minimize_encoded(lg)
    lg = _remove_disambig(lg, lang)
    lg = rm_epsilon(lg)
    ilabel_info = None
    if tree.context_width() != 1:
        lg, ilabel_info = context_expand(lg, tree.context_width(),
                                         tree.central_position())
    hclg = expand_hmm(lg, tm, tree, transition_scale, self_loop_scale,
                      ilabel_info=ilabel_info)
    log(f"HCLG: {hclg.num_states} states, {hclg.num_arcs()} arcs")
    return hclg


def compile_graph_from_lexicon_fst(lex_fst: VectorFst,
                                   word_ids: Sequence[int],
                                   tm: TransitionModel,
                                   tree: ContextDependency,
                                   transition_scale: float = 1.0,
                                   self_loop_scale: float = 0.1
                                   ) -> VectorFst:
    """compile-train-graphs body: prebuilt L(_disambig) + integer
    transcript -> HCLG-style training graph.  Input labels of L that are
    not known phones are treated as disambiguation symbols.  word_ids
    may instead be a word-level FST (the compile-train-graphs-fsts
    variant for uncertain transcripts).  A monophone tree's graph, as
    in the reference (no context expansion here)."""
    phones = set(tm.get_phones())
    g = (word_ids if isinstance(word_ids, VectorFst)
         else make_linear_word_acceptor(word_ids))
    lg = compose(lex_fst, arcsort(g, "ilabel"))
    lg = determinize_star(lg)
    dmap = {}
    for arcs in lg.arcs:
        for a in arcs:
            if a.ilabel != EPS and a.ilabel not in phones:
                dmap[a.ilabel] = EPS
    relabel(lg, ilabel_map=dmap)
    lg = rm_epsilon(lg)
    graph = expand_hmm(lg, tm, tree, transition_scale, self_loop_scale)
    if graph.num_states == 0:
        raise KaldiTpuError("empty training graph")
    return graph


class TrainingGraphCompiler:
    """Per-utterance graphs from transcripts
    (decoder/training-graph-compiler.h:59)."""

    def __init__(self, tm: TransitionModel, tree: ContextDependency,
                 lang: Lang, transition_scale: float = 1.0,
                 self_loop_scale: float = 0.1):
        self.tm = tm
        self.tree = tree
        self.lang = lang
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self._lex = make_lexicon_fst(lang, with_disambig=True)

    def compile(self, transcript: Sequence[str]) -> VectorFst:
        word_ids = self.lang.word_ids(transcript)
        return self.compile_from_ids(word_ids)

    def compile_from_ids(self, word_ids: Sequence[int]) -> VectorFst:
        return self.expand(self.word_graph(word_ids))

    def word_graph(self, word_ids: Sequence[int]) -> VectorFst:
        """The transcript's phone-level graph (L o G, determinized, the
        disambiguation symbols and epsilons removed): the costly part of
        a compile, which does not depend on the transition model."""
        g = make_linear_word_acceptor(word_ids)
        lg = compose(self._lex, arcsort(g, "ilabel"))
        lg = determinize_star(lg)
        lg = _remove_disambig(lg, self.lang)
        return rm_epsilon(lg)

    def expand(self, lg: VectorFst) -> VectorFst:
        """A `word_graph` expanded to HMM transitions with this compiler's
        transition model and scales, after the context expansion of a
        triphone tree (lg is not changed)."""
        ilabel_info = None
        if self.tree.context_width() != 1:
            lg, ilabel_info = context_expand(lg, self.tree.context_width(),
                                             self.tree.central_position())
        graph = expand_hmm(lg, self.tm, self.tree,
                           self.transition_scale, self.self_loop_scale,
                           ilabel_info=ilabel_info)
        if graph.num_states == 0:
            raise ValueError("empty training graph (bad transcript?)")
        return graph
