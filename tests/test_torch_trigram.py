"""Port parity: the port's `TrigramBackoffLm.from_counts` and
`eos_state_cost` (kaldi_tpu_torch/lm/trigram.py) against the JAX
package's on seeded text: every array equal, for each pruning of the
bigram and trigram levels at counts 1 and 2."""

import numpy as np
import pytest

from kaldi_tpu.lm.trigram import TrigramBackoffLm as JaxLm
from kaldi_tpu_torch.lm.trigram import TrigramBackoffLm

ARRAYS = ("uni", "bo1", "fold_src", "fold_dst", "fold_cost", "pair_u",
          "pair_v", "bo2", "ent_bi_cost", "tri_src", "tri_dst", "tri_cost",
          "eos_bi", "eos_tri")


def text(seed, V=12, n=300):
    rng = np.random.default_rng(seed)
    words = [f"w{i:02d}" for i in range(V)]
    p = rng.dirichlet(np.ones(V) * 0.5)
    return words, [[words[i] for i in rng.choice(V, int(rng.integers(1, 9)),
                                                 p=p)] for _ in range(n)]


def assert_lms_equal(got, want):
    assert got.words == want.words
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.eos_uni == want.eos_uni
    assert (got.V, got.SP, got.num_explicit_bi, got.num_explicit_tri) == \
        (want.V, want.SP, want.num_explicit_bi, want.num_explicit_tri)
    for a, b in zip(got.eos_state_cost(), want.eos_state_cost()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prune_bi", [1, 2])
@pytest.mark.parametrize("prune_tri", [1, 2])
def test_from_counts_matches_jax(prune_bi, prune_tri):
    words, sents = text(prune_bi * 10 + prune_tri)
    kw = dict(vocab=words, prune_bi=prune_bi, prune_tri=prune_tri)
    got = TrigramBackoffLm.from_counts(sents, **kw)
    assert_lms_equal(got, JaxLm.from_counts(sents, **kw))
    assert got.SP > 0 and got.num_explicit_tri > 0
    # pruned trigram counts leave bigram states without continuations
    assert (len(got.fold_src) > 0) == (prune_tri > 1)


def test_vocab_from_text_and_discount():
    _, sents = text(7, V=9, n=80)
    kw = dict(discount=0.3, prune_tri=1)
    assert_lms_equal(TrigramBackoffLm.from_counts(sents, **kw),
                     JaxLm.from_counts(sents, **kw))


def test_no_trigram_state():
    """Text too short for a kept trigram: no pair state, every bigram
    folded."""
    sents = [["a"], ["b", "a"], ["a", "b"]]
    got = TrigramBackoffLm.from_counts(sents, prune_tri=2)
    assert got.SP == 0 and got.eos_state_cost()[1].shape == (0,)
    assert_lms_equal(got, JaxLm.from_counts(sents, prune_tri=2))
