"""Port parity: the chain system of kaldi_tpu_torch made without
training artifacts, against the JAX package's, on the CPU: the chain
topology (`HmmTopology.chain_topology`), the monophone tree
(`monophone_context_dependency`, `pdfs_for`) and the transition model
built from them (`TransitionModel(topo, tree)`).  Tuples, tid -> pdf and
tid -> phone maps, self-loops and log-probs must be equal (exactly:
both take ln of the same float64 probabilities and round to float32);
then `chain_tm_tree_for` on the quick legacy spec's lexicon."""

import io

import numpy as np
import pytest

from kaldi_tpu.hmm.topology import HmmTopology as JaxTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JaxTm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.tree import monophone_context_dependency as jax_mono
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import (ContextDependency,
                                              monophone_context_dependency)

QUICK = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
             words_per_utt=5, num_train=2, num_test=6, num_lm_sents=80)


def assert_tms_equal(t, j):
    assert t.tuples == j.tuples
    assert t.num_pdfs == j.num_pdfs
    assert t.num_transition_ids == j.num_transition_ids
    assert t.log_probs.dtype == j.log_probs.dtype == np.float32
    np.testing.assert_array_equal(t.log_probs, j.log_probs)
    np.testing.assert_array_equal(t.state2id, j.state2id)
    for tid in range(1, t.num_transition_ids + 1):
        assert t.transition_id_to_pdf(tid) == j.transition_id_to_pdf(tid)
        assert t.tuples[t.id2state[tid] - 1][0] == \
            j.transition_id_to_phone(tid)
        assert t.is_self_loop(tid) == j.is_self_loop(tid)
        assert t.get_transition_log_prob(tid) == \
            j.get_transition_log_prob(tid)
    for ts in range(1, len(t.tuples) + 1):
        assert t.self_loop_of(ts) == j.self_loop_of(ts)
        assert t.num_transition_indices(ts) == j.num_transition_indices(ts)


@pytest.mark.parametrize("phones", [[1, 2, 3, 4], [1, 3, 4, 7, 9],
                                    list(range(1, 26))])
def test_chain_system_matches_jax(phones):
    topo, jtopo = (HmmTopology.chain_topology(phones),
                   JaxTopo.chain_topology(phones))
    assert topo.phones == jtopo.phones == sorted(phones)
    for p in phones:
        assert topo.num_pdf_classes(p) == jtopo.num_pdf_classes(p) == 2
        (a, af), (b, bf) = topo.topology_for_phone(p), \
            jtopo.topology_for_phone(p)
        assert (a.forward_pdf_class, a.self_loop_pdf_class,
                a.transitions) == (b.forward_pdf_class,
                                   b.self_loop_pdf_class, b.transitions)
        assert af.forward_pdf_class == bf.forward_pdf_class == -1
    npc = {p: 2 for p in phones}
    tree, jtree = (monophone_context_dependency(phones, npc),
                   jax_mono(phones, npc))
    assert tree.num_pdfs == jtree.num_pdfs == 2 * len(phones)
    assert (tree.N, tree.P) == (jtree.N, jtree.P) == (1, 0)
    for p in phones:
        for c in (0, 1):
            assert tree.compute([p], c) == jtree.compute([p], c)
            assert tree.pdfs_for(p, c) == jtree.pdfs_for(p, c)
    tm = TransitionModel(topo, tree)
    assert_tms_equal(tm, JaxTm(jtopo, jtree))
    assert tm.num_pdfs == 2 * len(phones)
    assert len(tm.tuples) == len(phones)


def test_pdfs_for_a_context_tree():
    """pdfs_for over a tree read from a file whose split depends on the
    left context: every pdf the central phone can reach, as JAX's."""
    text = (b"ContextDependency 3 1 ToPdf "
            b"SE 0 [ 1 2 ] { TE -1 2 ( CE 0 CE 1 ) "
            b"SE 1 [ 3 ] { TE -1 2 ( CE 2 CE 3 ) "
            b"TE -1 2 ( CE 4 CE 5 ) } } "
            b"EndContextDependency ")
    from kaldi_tpu.tree.context_dep import ContextDependency as JaxTree
    tree = ContextDependency.read(io.BytesIO(text), binary=False)
    jtree = JaxTree.read(io.BytesIO(text), binary=False)
    for phone in (1, 2, 3, 4):
        for c in (0, 1):
            assert tree.pdfs_for(phone, c) == jtree.pdfs_for(phone, c)
    assert tree.pdfs_for(3, 0) == [0, 2]
    assert tree.pdfs_for(4, 1) == [1, 5]


def test_chain_tm_tree_for_quick_spec():
    out = []
    for bc in (tbc, jbc):
        spec = bc.BenchCorpusSpec(**QUICK)
        out.append((bc.make_lexicon(spec),) + bc.chain_tm_tree_for(
            bc.make_lexicon(spec)))
    (lex, lang, tm, tree), (jlex, jlang, jtm, jtree) = out
    assert lex == jlex
    assert lang.phones == jlang.phones and lang.words == jlang.words
    assert (lang.sil_phone, lang.sil_prob) == (jlang.sil_phone,
                                               jlang.sil_prob) == ("SIL", 0.5)
    assert len(lang.phones) == 9                    # 8 phones and SIL
    assert tree.num_pdfs == jtree.num_pdfs == 18
    assert_tms_equal(tm, jtm)


def test_legacy_spec_chain_system():
    """The default BenchCorpusSpec (the legacy bench): 24 phones and SIL,
    so 50 pdfs, the num_pdfs of the committed flagship_params.npz."""
    spec = tbc.BenchCorpusSpec()
    lang, tm, tree = tbc.chain_tm_tree_for(tbc.make_lexicon(spec))
    jspec = jbc.BenchCorpusSpec()
    _, jtm, _ = jbc.chain_tm_tree_for(jbc.make_lexicon(jspec))
    assert tm.num_pdfs == tree.num_pdfs == 50
    assert_tms_equal(tm, jtm)
