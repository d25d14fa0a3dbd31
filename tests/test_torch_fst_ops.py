"""Port parity: the FST operations of the training-graph compiler
(`arcsort`, `relabel`, `compose`, `rm_epsilon`, `determinize_star`),
`expand_hmm`, the lexicon FST and `TrainingGraphCompiler.compile` of
kaldi_tpu_torch against the JAX package's, on the CPU, on the lexicon and
transcripts of a tiny bench corpus (V=30).  States, labels and arcs must
be equal; weights within 1e-5."""

import numpy as np
import pytest

from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.fstext import fst as jfst
from kaldi_tpu.fstext import ops as jops
from kaldi_tpu.hmm.hmm_utils import expand_hmm as jexpand
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.fstext import fst as tfst
from kaldi_tpu_torch.fstext import ops as tops
from kaldi_tpu_torch.hmm.hmm_utils import expand_hmm as texpand
from kaldi_tpu_torch.hmm.topology import HmmTopology as TTopo
from kaldi_tpu_torch.hmm.transition_model import TransitionModel as TTm
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

TINY = dict(vocab=30, num_phone_groups=5, phones_per_group=2,
            words_per_utt=8, num_train=12, num_test=4, num_lm_sents=60,
            noise=850.0, f2_gap=120.0, seed=11)


def fst_struct(f):
    """(start, arcs as (ilabel, olabel, nextstate) lists, weights, finals)
    of a VectorFst of either package."""
    arcs = [[(a.ilabel, a.olabel, a.nextstate) for a in s] for s in f.arcs]
    weights = [a.weight for s in f.arcs for a in s]
    return f.start, arcs, np.asarray(weights, np.float64), list(f.finals)


def assert_fst_equal(t, j, tol=1e-5):
    ts, ta, tw, tf = fst_struct(t)
    js, ja, jw, jf = fst_struct(j)
    assert ts == js
    assert ta == ja
    np.testing.assert_allclose(tw, jw, rtol=0, atol=tol)
    assert [np.isinf(x) for x in tf] == [np.isinf(x) for x in jf]
    np.testing.assert_allclose([x for x in tf if not np.isinf(x)],
                               [x for x in jf if not np.isinf(x)],
                               rtol=0, atol=tol)


@pytest.fixture(scope="module")
def corpus():
    spec = tbc.BenchCorpusSpec(**TINY)
    lexicon = tbc.make_lexicon(spec)
    sents = tbc.make_text(spec, spec.num_train, spec.seed + 1)
    assert sents == jbc.make_text(jbc.BenchCorpusSpec(**TINY),
                                  spec.num_train, spec.seed + 1)
    return lexicon, sents


def langs(lexicon):
    return (tgraph.Lang(lexicon, sil_phone="SIL", sil_prob=0.5),
            jgraph.Lang(lexicon, sil_phone="SIL", sil_prob=0.5))


def mono_systems(tlang, jlang):
    """(port (tm, tree), JAX (tm, tree)) of the three-state topology."""
    out = []
    for lang, mono, Tm in ((tlang, monophone_context_dependency, TTm),
                           (jlang, jmono, JTm)):
        topo = lang.make_topology()
        phones = sorted(lang.phones.values())
        tree = mono(phones, {p: topo.num_pdf_classes(p) for p in phones})
        out.append((Tm(topo, tree), tree))
    return out


def test_lang_and_topology_match(corpus):
    lexicon, _ = corpus
    tlang, jlang = langs(lexicon)
    assert tlang.phones == jlang.phones and tlang.words == jlang.words
    assert tlang.first_disambig == jlang.first_disambig
    t_topo, j_topo = tlang.make_topology(), jlang.make_topology()
    assert t_topo.phones == j_topo.phones
    assert t_topo.phone2idx == j_topo.phone2idx
    for te, je in zip(t_topo.entries, j_topo.entries):
        assert [(s.forward_pdf_class, s.self_loop_pdf_class, s.transitions)
                for s in te] == [(s.forward_pdf_class, s.self_loop_pdf_class,
                                  s.transitions) for s in je]
    (ttm, _), (jtm, _) = mono_systems(tlang, jlang)
    assert ttm.tuples == jtm.tuples
    np.testing.assert_array_equal(ttm.log_probs, jtm.log_probs)


@pytest.mark.parametrize("with_disambig", [True, False])
def test_lexicon_fst_matches(corpus, with_disambig):
    lexicon, _ = corpus
    tlang, jlang = langs(lexicon)
    assert tgraph.add_lex_disambig(lexicon) == \
        jgraph.add_lex_disambig(lexicon)
    t = tgraph.make_lexicon_fst(tlang, with_disambig)
    j = jgraph.make_lexicon_fst(jlang, with_disambig)
    assert_fst_equal(t, j)
    assert tlang.num_disambig == jlang.num_disambig


@pytest.mark.parametrize("utt", [0, 3, 7])
def test_graph_ops_match_step_by_step(corpus, utt):
    """L o G, determinize_star, relabel, rm_epsilon and arcsort of one
    transcript, each step against the JAX package's."""
    lexicon, sents = corpus
    tlang, jlang = langs(lexicon)
    tl = tgraph.make_lexicon_fst(tlang)
    jl = jgraph.make_lexicon_fst(jlang)
    ids = tlang.word_ids(sents[utt])
    assert ids == jlang.word_ids(sents[utt])
    tg = tops.arcsort(tgraph.make_linear_word_acceptor(ids), "ilabel")
    jg = jops.arcsort(jgraph.make_linear_word_acceptor(ids), "ilabel")
    assert_fst_equal(tg, jg)
    t, j = tops.compose(tl, tg), jops.compose(jl, jg)
    assert_fst_equal(t, j)
    assert t.num_states > len(ids)
    t, j = tops.determinize_star(t), jops.determinize_star(j)
    assert_fst_equal(t, j)
    dmap = {d: 0 for d in range(tlang.first_disambig,
                                tlang.first_disambig + tlang.num_disambig
                                + 2)}
    t, j = tops.relabel(t, ilabel_map=dmap), jops.relabel(j, ilabel_map=dmap)
    assert_fst_equal(t, j)
    t, j = tops.rm_epsilon(t), jops.rm_epsilon(j)
    assert_fst_equal(t, j)
    assert not any(a.ilabel == 0 and a.olabel == 0
                   for s in t.arcs for a in s)
    t, j = tops.arcsort(t, "olabel"), jops.arcsort(j, "olabel")
    assert_fst_equal(t, j)


def test_determinize_star_non_functional_matches():
    """Lattice semantics (functional=False) on a small FST with two
    output strings for one input: the better weight's string wins."""
    out = []
    for m in (tfst, jfst):
        f = m.VectorFst()
        for _ in range(4):
            f.add_state()
        f.set_start(0)
        f.add_arc(0, m.Arc(1, 5, 0.5, 1))
        f.add_arc(0, m.Arc(1, 6, 0.25, 2))
        f.add_arc(1, m.Arc(2, 0, 0.0, 3))
        f.add_arc(2, m.Arc(2, 7, 1.0, 3))
        f.add_arc(1, m.Arc(0, 8, 0.125, 2))
        f.set_final(3, 0.75)
        out.append(f)
    t = tops.determinize_star(out[0], functional=False)
    j = jops.determinize_star(out[1], functional=False)
    assert_fst_equal(t, j)


@pytest.mark.parametrize("topology", ["three_state", "chain"])
def test_expand_hmm_matches(corpus, topology):
    lexicon, sents = corpus
    tlang, jlang = langs(lexicon)
    if topology == "three_state":
        (ttm, ttree), (jtm, jtree) = mono_systems(tlang, jlang)
        scales = (1.0, 0.1)
    else:
        phones = sorted(tlang.phones.values())
        ttree = monophone_context_dependency(phones, {p: 2 for p in phones})
        jtree = jmono(phones, {p: 2 for p in phones})
        ttm = TTm(TTopo.chain_topology(phones), ttree)
        jtm = JTm(JTopo.chain_topology(phones), jtree)
        scales = (1.0, 1.0)
    tl = tgraph.make_lexicon_fst(tlang, with_disambig=False)
    jl = jgraph.make_lexicon_fst(jlang, with_disambig=False)
    ids = tlang.word_ids(sents[1])
    t = tops.rm_epsilon(tops.compose(
        tl, tops.arcsort(tgraph.make_linear_word_acceptor(ids), "ilabel")))
    j = jops.rm_epsilon(jops.compose(
        jl, jops.arcsort(jgraph.make_linear_word_acceptor(ids), "ilabel")))
    assert_fst_equal(texpand(t, ttm, ttree, *scales),
                     jexpand(j, jtm, jtree, *scales))


def test_training_graph_compiler_matches(corpus):
    lexicon, sents = corpus
    tlang, jlang = langs(lexicon)
    (ttm, ttree), (jtm, jtree) = mono_systems(tlang, jlang)
    tc = tgraph.TrainingGraphCompiler(ttm, ttree, tlang)
    jc = jgraph.TrainingGraphCompiler(jtm, jtree, jlang)
    for sent in sents:
        t, j = tc.compile(sent), jc.compile(sent)
        assert_fst_equal(t, j)
        assert t.num_states > 3 * len(sent)
    with pytest.raises(ValueError, match="OOV"):
        tc.compile(["NOT_A_WORD"])
