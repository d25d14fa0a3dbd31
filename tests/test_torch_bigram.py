"""Port parity: BigramBackoffLm of kaldi_tpu_torch (`lm/bigram.py`)
against the JAX package's, on the CPU.  The same seeded sentences go
through both `from_counts`; every field must be equal (np.array_equal:
both estimate in float64 and round to float32 the same way), and so
must `dense_cost` and `cost`."""

import numpy as np
import pytest

from kaldi_tpu.lm.bigram import BigramBackoffLm as JaxLm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
from kaldi_tpu_torch.recipes import bench_corpus as tbc

FIELDS = ("uni", "bo", "expl_src", "expl_dst", "expl_cost", "eos")


def sentences(seed, V=6, n=40, max_len=8):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(V)]
    return vocab, [[vocab[rng.integers(V)]
                    for _ in range(rng.integers(1, max_len))]
                   for _ in range(n)]


def assert_lms_equal(t, j):
    assert t.words == j.words
    for name in FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.eos_uni == j.eos_uni
    assert (t.V, t.num_explicit) == (j.V, j.num_explicit)
    np.testing.assert_array_equal(t.dense_cost(), j.dense_cost())


@pytest.mark.parametrize("seed,V,discount,prune", [
    (0, 6, 0.5, 1), (1, 9, 0.5, 1), (2, 6, 0.3, 2), (3, 12, 0.7, 1),
    (4, 5, 0.5, 3)])
def test_from_counts_matches_jax(seed, V, discount, prune):
    vocab, sents = sentences(seed, V=V)
    got = BigramBackoffLm.from_counts(sents, vocab, discount=discount,
                                      prune_count=prune)
    want = JaxLm.from_counts(sents, vocab, discount=discount,
                             prune_count=prune)
    assert_lms_equal(got, want)
    # explicit arcs sorted by (dst, src)
    key = got.expl_dst.astype(np.int64) * (got.V + 1) + got.expl_src
    assert (np.diff(key) > 0).all()


def test_vocab_from_text_and_unseen_words():
    """Without a vocabulary the sorted words of the text; with one, its
    unseen words get unigram mass and an unseen context backs off
    purely."""
    _, sents = sentences(5, V=4)
    assert_lms_equal(BigramBackoffLm.from_counts(sents),
                     JaxLm.from_counts(sents))
    vocab = [f"w{i}" for i in range(7)]           # w4..w6 never occur
    got = BigramBackoffLm.from_counts(sents, vocab)
    assert_lms_equal(got, JaxLm.from_counts(sents, vocab))
    assert (got.bo[4:7] == 0.0).all()


def test_is_a_distribution_and_scalar_cost():
    vocab, sents = sentences(0)
    lm = BigramBackoffLm.from_counts(sents, vocab)
    dense = lm.dense_cost()
    for u in range(lm.V + 1):
        mass = np.exp(-dense[u].astype(np.float64)).sum() + \
            np.exp(-float(lm.eos[u]))
        assert 0.5 < mass < 1.02, (u, mass)
        for w in range(lm.V):
            assert abs(dense[u, w] - lm.cost(u, w)) < 1e-5
    want = JaxLm.from_counts(sents, vocab)
    assert [lm.cost(u, 2) for u in range(lm.V + 1)] == \
        [want.cost(u, 2) for u in range(lm.V + 1)]


def test_legacy_corpus_lm_matches_jax():
    """The quick legacy corpus's LM text, as build_decode_graph
    estimates it."""
    kw = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
              words_per_utt=5, num_train=2, num_test=6, num_lm_sents=80)
    out = []
    for bc, Lm in ((tbc, BigramBackoffLm), (jbc, JaxLm)):
        spec = bc.BenchCorpusSpec(**kw)
        lexicon = bc.make_lexicon(spec)
        text = bc.make_text(spec, spec.num_lm_sents, spec.seed + 3)
        out.append(Lm.from_counts(text, sorted(lexicon)))
    assert_lms_equal(*out)
    assert out[0].num_explicit > 100
