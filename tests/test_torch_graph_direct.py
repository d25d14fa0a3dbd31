"""Port parity: the flat decoding graphs and the host token-passing
decoder of kaldi_tpu_torch against the JAX package's: every array of
`build_direct_hclg` and of `BlockChainGraph.to_flat_graph` equal
(`np.array_equal`, same dtypes), and `FasterDecoder` giving the same
alignment and words with costs equal (the same Python float arithmetic on
both sides) on the same inputs."""

import numpy as np
import pytest

from kaldi_tpu.decoder import graph_direct as jgd
from kaldi_tpu.decoder.block_chain import BlockChainGraph as JaxGraph
from kaldi_tpu.decoder.viterbi import FasterDecoder as JaxFasterDecoder
from kaldi_tpu.decoder.viterbi import \
    FasterDecoderOptions as JaxFasterDecoderOptions
from kaldi_tpu_torch.decoder import graph_direct as tgd
from kaldi_tpu_torch.decoder.block_chain import BlockChainGraph
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)

FLAT_ARRAYS = ("src", "dst", "ilabel", "olabel", "weight", "finals",
               "tid2pdf")
SMALL = dict(vocab=9, num_phones=6, min_pron=1, max_pron=4, num_pdfs=48)
# the graph the GPU smoke test decodes over
SMOKE = dict(vocab=64, num_pdfs=2000)


def assert_flat_equal(tf, jf):
    for name in FLAT_ARRAYS:
        a, b = getattr(tf, name), getattr(jf, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert (tf.start, tf.num_pdfs, tf.words) == (jf.start, jf.num_pdfs,
                                                 jf.words)
    assert (tf.num_states, tf.num_arcs) == (jf.num_states, jf.num_arcs)


def fst_key(fst):
    return (fst.start, list(fst.finals),
            [[tuple(a) for a in arcs] for arcs in fst.arcs])


@pytest.mark.parametrize("kw", [dict(SMALL, seed=0), dict(SMALL, seed=3),
                                SMOKE], ids=["small0", "small3", "smoke"])
def test_build_direct_hclg_equals_jax(kw):
    tf = tgd.build_direct_hclg(tgd.DirectGraphSpec(**kw))
    jf = jgd.build_direct_hclg(jgd.DirectGraphSpec(**kw))
    assert_flat_equal(tf, jf)
    assert tf.num_arcs > tf.num_states > kw["vocab"]


def test_build_direct_hclg_takes_prons_and_bigram_and_checks_shape():
    spec = tgd.DirectGraphSpec(**SMALL)
    prons, bigram = tgd.synth_lexicon(spec), tgd.synth_bigram(spec)
    tf = tgd.build_direct_hclg(spec, prons=prons[:5], bigram=bigram[:6, :5])
    jf = jgd.build_direct_hclg(jgd.DirectGraphSpec(**SMALL), prons=prons[:5],
                               bigram=bigram[:6, :5])
    assert_flat_equal(tf, jf)
    with pytest.raises(ValueError, match="bigram shape"):
        tgd.build_direct_hclg(spec, prons=prons[:5], bigram=bigram)


def test_trie_and_pdf_hash_equal_jax():
    spec = tgd.DirectGraphSpec(**SMALL)
    prons = tgd.synth_lexicon(spec)
    tt, jt = tgd._Trie(prons), jgd._Trie(prons)
    for name in ("in_phone", "edge_src", "edge_dst", "edge_phone"):
        assert np.array_equal(getattr(tt, name), getattr(jt, name)), name
    assert (tt.word_pre, tt.word_last, tt.num_nodes) == \
        (jt.word_pre, jt.word_last, jt.num_nodes)
    a = np.arange(40, dtype=np.int32)
    b = (a * 7 + 3).astype(np.int64)
    for salt in (1, 2):
        assert np.array_equal(tgd._pdf_hash(a, b, 2000, salt),
                              jgd._pdf_hash(a, b, 2000, salt))


def block_graphs(kw, eos_cost=1.5):
    js, ts = jgd.DirectGraphSpec(**kw), tgd.DirectGraphSpec(**kw)
    jg = JaxGraph.build(jgd.synth_lexicon(js), jgd.synth_bigram(js),
                        eos_cost=eos_cost, num_pdfs=kw["num_pdfs"])
    tg = BlockChainGraph.build(tgd.synth_lexicon(ts), tgd.synth_bigram(ts),
                               eos_cost=eos_cost, num_pdfs=kw["num_pdfs"])
    return jg, tg


@pytest.mark.parametrize("kw", [dict(SMALL, seed=0), dict(SMALL, seed=2),
                                SMOKE], ids=["small0", "small2", "smoke"])
def test_to_flat_graph_equals_jax(kw):
    jg, tg = block_graphs(kw)
    tf, jf = tg.to_flat_graph(), jg.to_flat_graph()
    assert_flat_equal(tf, jf)
    # state numbering of the device layout
    assert tf.num_states == tg.num_states
    assert tf.start == tg.U * tg.N + tg.V
    assert (tf.finals < 1e29).sum() == tg.V
    assert not ((tf.src == tf.start) & (tf.dst == tf.start)).any()


def test_to_vector_fst_equals_jax():
    jg, tg = block_graphs(dict(SMALL, seed=1))
    tfst = tg.to_flat_graph().to_vector_fst()
    jfst = jg.to_flat_graph().to_vector_fst()
    assert fst_key(tfst) == fst_key(jfst)
    assert tfst.num_arcs() == tg.to_flat_graph().num_arcs


@pytest.mark.parametrize("seed,beam", [(0, 1e9), (1, 1e9), (2, 6.0)])
def test_faster_decoder_equals_jax(seed, beam):
    """Exact search and a real beam (with max_active) on the flat graph."""
    jg, tg = block_graphs(dict(SMALL, seed=seed))
    tfst = tg.to_flat_graph().to_vector_fst()
    jfst = jg.to_flat_graph().to_vector_fst()
    kw = dict(beam=beam, max_active=10 ** 9 if beam > 100 else 30)
    host = FasterDecoder(tfst, FasterDecoderOptions(**kw))
    ref = JaxFasterDecoder(jfst, JaxFasterDecoderOptions(**kw))
    rng = np.random.default_rng(seed + 20)
    ll = rng.normal(size=(3, 9, tg.num_pdfs)).astype(np.float32)
    for b, T in enumerate((9, 7, 4)):
        for scale, penalty in ((1.0, 0.0), (0.7, 0.5)):
            got = host.decode(ll[b, :T], tg.tid2pdf, scale, penalty)
            want = ref.decode(ll[b, :T], jg.tid2pdf, scale, penalty)
            assert got is not None and got == want
            assert len(got[0]) == T


def test_faster_decoder_epsilon_arcs_and_failure():
    """ProcessNonemitting: an epsilon arc with a word label is followed;
    a graph whose final state cannot be reached gives None."""
    from kaldi_tpu.fstext.fst import Arc as JaxArc
    from kaldi_tpu.fstext.fst import VectorFst as JaxFst
    from kaldi_tpu_torch.fstext.fst import Arc, VectorFst
    hyps = []
    for fst_cls, arc_cls, dec_cls in ((JaxFst, JaxArc, JaxFasterDecoder),
                                      (VectorFst, Arc, FasterDecoder)):
        fst = fst_cls()
        for _ in range(4):
            fst.add_state()
        fst.start = 0
        fst.add_arc(0, arc_cls(0, 3, 0.25, 1))         # eps, word 3
        fst.add_arc(1, arc_cls(1, 0, 0.5, 1))
        fst.add_arc(1, arc_cls(2, 0, 0.5, 2))
        fst.add_arc(2, arc_cls(0, 4, 0.125, 3))        # eps, word 4
        fst.set_final(3, 1.0)
        ll = np.array([[0.5, -1.0], [0.25, 2.0], [-0.5, 0.75]], np.float32)
        hyps.append(dec_cls(fst).decode(ll, np.array([0, 0, 1]), 1.0))
        assert dec_cls(fst).decode(ll[:0], np.array([0, 0, 1])) is None
    assert hyps[0] == hyps[1]
    assert hyps[1][0] == [1, 1, 2] and hyps[1][1] == [3, 4]
