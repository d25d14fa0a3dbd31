"""Port parity: the n-gram lexchain graph and decoder of kaldi_tpu_torch
against the JAX reference (`kaldi_tpu/decoder/lexchain_ng.py`), on the
CPU.  The same seeded numpy inputs go through both: the graph's tables
and the decoder's host tables must be equal; decode_batch must give
equal words and tids and costs within 1e-4 relative, in exact mode and
in pruned mode, on both slot-fold paths (the inverse-permutation gather
of single-variant lexicons, the scatter of multi-variant ones), with
and without optional silence, with synthetic and with trained (committed
transition model and tree) tables.  The port's decoder is also held
against the port's host FasterDecoder on `to_flat_graph()` (equal words
and tids, cost within 1e-3 * max(1, |cost|), the bar of the reference's
own tests/test_lexchain_ng.py)."""

import os

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.lexchain_ng import NgramLexDecoder as JaxDecoder
from kaldi_tpu.decoder.lexchain_ng import NgramLexGraph as JaxGraph
from kaldi_tpu.hmm.transition_model import TransitionModel as JaxTm
from kaldi_tpu.lm.trigram import TrigramBackoffLm as JaxLm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.tree.context_dep import ContextDependency as JaxTree
from kaldi_tpu.util import kaldi_io as jaxio
from kaldi_tpu_torch.decoder.lexchain_ng import (INF, NgramLexDecoder,
                                                 NgramLexGraph)
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lm.trigram import TrigramBackoffLm
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")
GRAPH_ARRAYS = (
    "pron_word", "pron_cost", "unit_var", "unit_hist", "unit_word",
    "row_unit", "row_pos", "row_is_first", "end_row", "pdf_fwd_row",
    "pdf_self_row", "tid_fwd_row", "tid_self_row", "tr_fwd_row",
    "tr_self_row", "pdf_end", "tid_end", "tr_end", "pdf_root_self",
    "tid_root_self", "tr_root_self", "tid2pdf")
GRAPH_SCALARS = ("U", "Nr", "n_rows_true", "num_pdfs", "num_states", "S",
                 "sil_pdf_fwd", "sil_pdf_self", "sil_tid_fwd",
                 "sil_tid_self", "sil_tr_fwd", "sil_tr_self", "sil_cost",
                 "nosil_cost")


def corpus(rng, V, n=150, length=5):
    """Seeded sentences over V words (the reference tests' corpus)."""
    words = [f"W{i}" for i in range(V)]
    probs = rng.dirichlet(np.ones(V) * 0.4)
    return words, [[words[int(rng.choice(V, p=probs))]
                    for _ in range(int(rng.integers(1, length)))]
                   for _ in range(n)]


def lexicon(V, rng, num_phones=5, extra_variants=1):
    """One pronunciation a word, plus `extra_variants` second variants
    of random words (cost 0.3), which put several slots on one LM state
    and so take the decoder's scatter path."""
    prons, pron_word = [], []
    for w in range(V):
        prons.append(rng.integers(1, num_phones + 1,
                                  int(rng.integers(1, 4))).astype(np.int32))
        pron_word.append(w)
    for _ in range(extra_variants):
        pron_word.append(int(rng.integers(0, V)))
        prons.append(rng.integers(1, num_phones + 1, 2).astype(np.int32))
    cost = np.zeros(len(prons), np.float32)
    cost[V:] = 0.3
    return prons, pron_word, cost


def graphs(seed, V=6, use_sil=False, ctx=1, extra_variants=1, n=150,
           length=5):
    """The same graph on both sides -> (JAX graph, port graph, rng)."""
    out = []
    for Lm, Graph in ((JaxLm, JaxGraph), (TrigramBackoffLm, NgramLexGraph)):
        rng = np.random.default_rng(seed)
        words, sents = corpus(rng, V, n=n, length=length)
        lm = Lm.from_counts(sents, vocab=words, prune_bi=1, prune_tri=1)
        prons, pron_word, pron_cost = lexicon(
            V, rng, extra_variants=extra_variants)
        out.append(Graph.build(prons, lm, pron_word=pron_word,
                               pron_cost=pron_cost, num_pdfs=40,
                               use_sil=use_sil, sil_phone=5, sil_prob=0.4,
                               synth_context=ctx))
    return out[0], out[1], rng


def assert_graphs_equal(jg, tg):
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)
    for name in GRAPH_SCALARS:
        assert getattr(tg, name) == getattr(jg, name), name
    assert len(tg.prons) == len(jg.prons)
    for a, b in zip(tg.prons, jg.prons):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.eos_of_slot(), jg.eos_of_slot())


def assert_decoder_tables_equal(jd, td):
    """The host tables of the two decoders: virtual-context rows, fold
    tree, inverse permutation."""
    assert td.VC == jd.VC
    for name in ("_vc_src", "_vc_dst", "_vc_cost", "_fold_fin"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)
    assert len(td._fold_levels) == len(jd._fold_levels)
    for a, b in zip(td._fold_levels, jd._fold_levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (td._hist_inv is None) == (jd._hist_inv is None)
    if td._hist_inv is not None:
        np.testing.assert_array_equal(td._hist_inv.numpy(),
                                      np.asarray(jd._hist_inv))
    assert (td._fold_perm is None) == jd._fold_identity


def assert_hyps_match(got, want, rel=1e-4):
    for b, (o, r) in enumerate(zip(got, want)):
        assert (o is None) == (r is None), b
        if r is None:
            continue
        assert o[0] == r[0], f"lane {b} words {o[0]} vs {r[0]}"
        assert o[1] == r[1], f"lane {b} tids"
        assert abs(o[2] - r[2]) <= rel * max(1.0, abs(r[2])), \
            f"lane {b}: {o[2]} vs {r[2]}"


def assert_matches_host(g, hyps, ll, lengths):
    host = FasterDecoder(g.to_flat_graph().to_vector_fst(),
                         FasterDecoderOptions(beam=1e9, max_active=10 ** 9))
    for b, h in enumerate(hyps):
        ref = host.decode(ll[b, :lengths[b]], g.tid2pdf)
        assert ref is not None and h is not None
        assert h[0] == ref[1], f"lane {b} words"
        assert h[1] == ref[0], f"lane {b} tids"
        assert abs(h[2] - ref[2]) < 1e-3 * max(1.0, abs(ref[2]))


@pytest.mark.parametrize("seed,use_sil,ctx,extra", [
    (0, False, 1, 1), (0, True, 1, 1), (1, False, 3, 1), (1, True, 3, 0),
    (2, True, 1, 0), (3, False, 3, 0)])
def test_exact_matches_jax_and_host(seed, use_sil, ctx, extra):
    jg, tg, rng = graphs(seed, use_sil=use_sil, ctx=ctx,
                         extra_variants=extra)
    assert_graphs_equal(jg, tg)
    jd, td = JaxDecoder(jg), NgramLexDecoder(tg, device="cpu")
    assert_decoder_tables_equal(jd, td)
    assert (td._hist_inv is not None) == (extra == 0)
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = [T, T - 2, T - 4]
    got = td.decode_batch(ll, lengths=lengths)
    assert_hyps_match(got, jd.decode_batch(ll, lengths=lengths))
    assert_matches_host(tg, got, ll, lengths)


@pytest.mark.parametrize("seed,extra,beam", [(0, 1, 3.0), (1, 0, 2.0),
                                              (4, 2, 6.0)])
def test_pruned_matches_jax(seed, extra, beam):
    """prune_k=4 with a finite beam: the pool loses real candidates, and
    the port selects the same rows as the reference (lower row first
    among equal values)."""
    jg, tg, rng = graphs(seed, V=8, use_sil=True, ctx=3,
                         extra_variants=extra)
    jd, td = JaxDecoder(jg), NgramLexDecoder(tg, device="cpu")
    B, T = 4, 12
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32) * 2
    kw = dict(prune_k=4, prune_beam=beam, exact_topk=False)
    got = td.decode_batch(ll, **kw)
    assert_hyps_match(got, jd.decode_batch(ll, **kw))
    exact = td.decode_batch(ll)
    assert all(o[2] >= e[2] - 1e-4 for o, e in zip(got, exact))


def test_fold_tree_of_several_levels():
    """An LM in which a word has more than 16 pair states, so the backoff
    fold tree has two levels or more."""
    jg, tg, rng = graphs(5, V=30, use_sil=True, ctx=1, extra_variants=2,
                         n=500, length=7)
    jd, td = JaxDecoder(jg), NgramLexDecoder(tg, device="cpu")
    assert np.bincount(tg.lm.pair_v).max() > 16
    assert len(td._fold_levels) >= 2
    assert_decoder_tables_equal(jd, td)
    B, T = 3, 10
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    assert_hyps_match(td.decode_batch(ll), jd.decode_batch(ll))
    kw = dict(prune_k=16, prune_beam=5.0)
    assert_hyps_match(td.decode_batch(ll, **kw), jd.decode_batch(ll, **kw))


def test_to_flat_graph_matches_jax():
    jg, tg, _ = graphs(2, use_sil=True, ctx=3)
    jf, tf = jg.to_flat_graph(), tg.to_flat_graph()
    for name in ("src", "dst", "ilabel", "olabel", "weight", "finals",
                 "tid2pdf"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name),
                                      err_msg=name)
    assert (tf.start, tf.num_pdfs, tf.words) == (jf.start, jf.num_pdfs,
                                                 jf.words)


def test_select_breaks_ties_by_lower_row():
    """The pool selection against jax.lax.top_k on values with ties,
    INF rows and negative values."""
    rng = np.random.default_rng(3)
    vm = rng.integers(-3, 4, size=(50, 5)).astype(np.float32) * 0.5
    vm[rng.random(vm.shape) < 0.3] = INF
    for K in (1, 7, 50):
        ids, vals = NgramLexDecoder._select(torch.as_tensor(vm), K)
        neg, want = jax.lax.top_k(-vm.T, K)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_stats_decode_and_empty_lanes():
    jg, tg, rng = graphs(0, use_sil=True)
    td = NgramLexDecoder(tg, device="cpu")
    ll = rng.normal(size=(2, 6, tg.num_pdfs)).astype(np.float32)
    stats = {}
    got = td.decode_batch(torch.as_tensor(ll), lengths=[6, 0], stats=stats)
    assert set(stats) == {"fwd_s", "fol_s", "traceback_s"}
    assert got[1] is not None and got[1][:2] == ([], [])
    one = td.decode(ll[0])
    assert one == got[0]
    assert_hyps_match([one], [JaxDecoder(jg).decode(ll[0])])
    with pytest.raises(ValueError, match="pdf dim"):
        td.decode_batch(ll[:, :, :5])


def real_model_graphs():
    """build_decode_graph_ng on a V=300 bench corpus with the committed
    transition model and tree, each package reading them itself."""
    kw = dict(vocab=300, num_lm_sents=3000, num_test=4)
    out = []
    for bc, Tm, Tree, read in (
            (jbc, JaxTm, JaxTree, jaxio.read_kaldi_object),
            (tbc, TransitionModel, ContextDependency, read_kaldi_object)):
        spec = bc.bench_scale_spec(**kw)
        lexicon = bc.make_lexicon(spec)
        text = bc.make_text(spec, spec.num_lm_sents, spec.seed + 3)
        tm = read(Tm.read, os.path.join(ART, "flagship_ng.tm"))
        tree = read(Tree.read, os.path.join(ART, "flagship_ng.tree"))
        lang = bc.build_lang(lexicon)
        assert len(lang.phones) == 31          # every phone of the tree
        out.append(bc.build_decode_graph_ng(lexicon, text, tm, tree,
                                            lang=lang, prune_bi=2,
                                            prune_tri=3))
    return out


def test_real_model_tables_and_decode():
    jg, tg = real_model_graphs()
    assert_graphs_equal(jg, tg)
    assert tg.num_pdfs == 2000 and tg.use_sil
    jd, td = JaxDecoder(jg), NgramLexDecoder(tg, device="cpu")
    assert_decoder_tables_equal(jd, td)
    rng = np.random.default_rng(9)
    B, T = 3, 14
    ll = (rng.normal(size=(B, T, tg.num_pdfs)) * 3).astype(np.float32)
    lengths = [T, T - 3, T - 6]
    assert_hyps_match(td.decode_batch(ll, lengths=lengths),
                      jd.decode_batch(ll, lengths=lengths))
    kw = dict(prune_k=32, prune_beam=16.0, exact_topk=False)
    assert_hyps_match(td.decode_batch(ll, lengths=lengths, **kw),
                      jd.decode_batch(ll, lengths=lengths, **kw))


def test_decoder_on_cuda_without_a_card_raises():
    _, tg, _ = graphs(0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        NgramLexDecoder(tg)
