"""Port parity: the flat-start alignment (`align_equal`) and the native
aligner of monophone training (`decoder/native_viterbi.py`), on the CPU,
against the JAX package's, over the training graphs of a tiny bench
corpus (V=30).  The same seed must give the same equal alignment; the
port's native aligner must equal its own exact FasterDecoder and, beam
for beam, the JAX package's native aligner."""

import numpy as np
import pytest

from kaldi_tpu import native as jnative
from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.decoder import viterbi as jvit
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.decoder import native_viterbi as tnative
from kaldi_tpu_torch.decoder import viterbi as tvit
from kaldi_tpu_torch.hmm.transition_model import TransitionModel as TTm
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

from jax_native_private import private_jax_native_build  # noqa: F401

TINY = dict(vocab=30, num_phone_groups=5, phones_per_group=2,
            words_per_utt=8, num_train=10, num_test=4, num_lm_sents=60,
            noise=850.0, f2_gap=120.0, seed=11)


@pytest.fixture(scope="module")
def graphs():
    """(port graphs, JAX graphs, port tm, JAX tm) of 10 transcripts."""
    spec = tbc.BenchCorpusSpec(**TINY)
    lexicon = tbc.make_lexicon(spec)
    sents = tbc.make_text(spec, spec.num_train, spec.seed + 1)
    out = []
    for Lang, mono, Tm, Compiler in (
            (tgraph.Lang, monophone_context_dependency, TTm,
             tgraph.TrainingGraphCompiler),
            (jgraph.Lang, jmono, JTm, jgraph.TrainingGraphCompiler)):
        lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
        topo = lang.make_topology()
        phones = sorted(lang.phones.values())
        tree = mono(phones, {p: topo.num_pdf_classes(p) for p in phones})
        tm = Tm(topo, tree)
        comp = Compiler(tm, tree, lang)
        out.append(([comp.compile(s) for s in sents], tm))
    (tg, ttm), (jg, jtm) = out
    return tg, jg, ttm, jtm


@pytest.mark.parametrize("extra", [0, 7, 40, 123])
def test_align_equal_matches(graphs, extra):
    tg, jg, ttm, jtm = graphs
    for seed, (t, j) in enumerate(zip(tg, jg)):
        # the arcs of one feasible path (at least its emitting arcs), plus
        # `extra` frames
        n = len(jvit._random_feasible_path(j, 10 ** 6, 0)) + extra
        a = tvit.align_equal(t, n, ttm, seed=seed)
        b = jvit.align_equal(j, n, jtm, seed=seed)
        assert a is not None and a == b
        assert len(a) == n


def test_align_equal_too_few_frames(graphs):
    tg, _, ttm, _ = graphs
    assert tvit.align_equal(tg[0], 3, ttm) is None


def _loglikes(T: int, num_pdfs: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, num_pdfs)) * 8.0 - 60.0).astype(np.float32)


def test_native_aligner_matches_faster_decoder_and_jax(graphs):
    tg, jg, ttm, jtm = graphs
    assert tnative.get_lib() is not None, "g++ build of beam_viterbi failed"
    assert jnative.get_lib() is not None
    for i, (t, j) in enumerate(zip(tg, jg)):
        T = 3 * t.num_states // 4
        ll = _loglikes(T, ttm.num_pdfs, 100 + i)
        nat = tnative.NativeViterbi(t).decode(ll, ttm.id2pdf_id, 0.1)
        exact = tvit.FasterDecoder(t, tvit.FasterDecoderOptions(
            beam=1e9, max_active=10 ** 9)).decode(ll, ttm.id2pdf_id, 0.1)
        assert nat is not None and exact is not None
        assert nat[0] == exact[0] and nat[1] == exact[1]
        assert abs(nat[2] - exact[2]) <= 1e-4 * abs(exact[2])
        assert len(nat[0]) == T
        for beam in (10.0, 1e9):
            ours = tnative.NativeViterbi(t).decode(ll, ttm.id2pdf_id, 0.1,
                                                   beam=beam)
            ref = jnative.NativeViterbi(j).decode(ll, jtm.id2pdf_id, 0.1,
                                                  beam=beam)
            assert ours == ref


def test_native_aligner_fails_without_a_path(graphs):
    tg, _, ttm, _ = graphs
    ll = _loglikes(2, ttm.num_pdfs, 1)
    assert tnative.NativeViterbi(tg[0]).decode(ll, ttm.id2pdf_id) is None


def _fst_rows(fst):
    return (fst.start, list(fst.finals),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for arcs in fst.arcs])


def test_word_graph_reused_with_another_transition_model():
    """A word graph made with one transition model and expanded with
    another (train_mono's graphs re-expanded with the trained model, as
    train_system does) equals the JAX package's compile with the other
    model from scratch, and the word graph is left as it was."""
    spec = tbc.BenchCorpusSpec(**TINY)
    lexicon = tbc.make_lexicon(spec)
    sents = tbc.make_text(spec, 4, spec.seed + 1)
    rng = np.random.default_rng(0)
    tms, comps = [], []
    for Lang, mono, Tm, Compiler in (
            (tgraph.Lang, monophone_context_dependency, TTm,
             tgraph.TrainingGraphCompiler),
            (jgraph.Lang, jmono, JTm, jgraph.TrainingGraphCompiler)):
        lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
        topo = lang.make_topology()
        phones = sorted(lang.phones.values())
        tree = mono(phones, {p: topo.num_pdf_classes(p) for p in phones})
        tms.append(Tm(topo, tree))
        comps.append((Compiler, lang, tree))
    first = tgraph.TrainingGraphCompiler(tms[0], comps[0][2], comps[0][1])
    trained = [Tm(c[1].topo, c[2]) for c in comps]
    log_probs = np.log(rng.uniform(0.05, 0.95, size=len(
        trained[0].log_probs))).astype(np.float32)
    for tm in trained:
        tm.log_probs = log_probs.copy()
    second = tgraph.TrainingGraphCompiler(trained[0], comps[0][2],
                                          comps[0][1])
    jax_second = jgraph.TrainingGraphCompiler(trained[1], comps[1][2],
                                              comps[1][1])
    for s in sents:
        wg = first.word_graph(comps[0][1].word_ids(s))
        before = _fst_rows(wg)
        first.expand(wg)
        got = second.expand(wg)
        assert _fst_rows(wg) == before
        assert _fst_rows(got) == _fst_rows(second.compile(s))
        want = jax_second.compile(s)
        assert got.num_states == want.num_states
        for a, b in zip(got.arcs, want.arcs):
            assert [(x.ilabel, x.olabel, x.nextstate) for x in a] == \
                [(y.ilabel, y.olabel, y.nextstate) for y in b]
            np.testing.assert_allclose([x.weight for x in a],
                                       [y.weight for y in b], rtol=1e-6)
