"""Port parity: ARPA parsing and G compilation (`lm/arpa.py`) against the
JAX package's, on the CPU: the same n-grams, sentence scores and G
(states, arcs, labels and weights), over the generic recipe's bigram and
a trigram with backoff, unseen histories and an OOV word."""

import numpy as np
import pytest

from kaldi_tpu.lm import arpa as jarpa
from kaldi_tpu_torch.lm import arpa as tarpa
from kaldi_tpu_torch.recipes.template_corpus import ARPA as BIGRAM

TRIGRAM = """
\\data\\
ngram 1=7
ngram 2=7
ngram 3=4

\\1-grams:
-1.0 <s> -0.5
-0.7 </s>
-0.9 a -0.3
-1.1 b -0.25
-1.3 c -0.2
-1.6 d
-2.0 zz -0.1

\\2-grams:
-0.4 <s> a -0.2
-0.5 a b -0.15
-0.6 b c -0.1
-0.3 c </s>
-0.8 a zz
-0.45 b a -0.05
-0.7 d </s>

\\3-grams:
-0.2 <s> a b
-0.25 a b c
-0.3 b c </s>
-0.35 b a b

\\end\\
"""
WORDS = {"a": 1, "b": 2, "c": 3, "d": 4}
TEMPLATE_WORDS = {"HEY": 1, "NO": 2, "YES": 3}


def _arcs(fst):
    return [(s, a.ilabel, a.olabel, a.nextstate, a.weight)
            for s in range(fst.num_states) for a in fst.arcs[s]]


@pytest.mark.parametrize("text", [BIGRAM, TRIGRAM])
def test_parse_arpa_matches(text):
    t, j = tarpa.parse_arpa(text), jarpa.parse_arpa(text)
    assert t.order == j.order
    assert t.ngrams == j.ngrams


@pytest.mark.parametrize("sentence", [["a", "b", "c"], ["b", "a", "b"],
                                      ["d"], ["c", "c", "a", "zz"], []])
def test_sentence_scores_match(sentence):
    t, j = tarpa.parse_arpa(TRIGRAM), jarpa.parse_arpa(TRIGRAM)
    assert t.score_sentence_log10(sentence) == \
        j.score_sentence_log10(sentence)


@pytest.mark.parametrize("text,words", [(BIGRAM, TEMPLATE_WORDS),
                                        (TRIGRAM, WORDS)])
@pytest.mark.parametrize("backoff_label", [0, 9])
def test_arpa_to_fst_matches(text, words, backoff_label):
    t = tarpa.arpa_to_fst(tarpa.parse_arpa(text), words,
                          backoff_label=backoff_label)
    j = jarpa.arpa_to_fst(jarpa.parse_arpa(text), words,
                          backoff_label=backoff_label)
    assert (t.num_states, t.start) == (j.num_states, j.start)
    assert _arcs(t) == _arcs(j)
    assert list(t.finals) == list(j.finals)


def test_oov_handling():
    # zz is not in the word table: skipped by default, refused on request
    t = tarpa.arpa_to_fst(tarpa.parse_arpa(TRIGRAM), WORDS)
    assert all(a[1] in WORDS.values() or a[1] == 0 for a in _arcs(t))
    with pytest.raises(Exception, match="OOV"):
        tarpa.arpa_to_fst(tarpa.parse_arpa(TRIGRAM), WORDS,
                          oov_handling="error")
    with pytest.raises(Exception, match="data"):
        tarpa.parse_arpa("ngram 1=2\n")


def test_g_fst_bytes_match(tmp_path):
    from kaldi_tpu.fstext.openfst_io import write_fst as jwrite
    from kaldi_tpu_torch.fstext.openfst_io import write_fst as twrite
    for name, mod, write in (("t", tarpa, twrite), ("j", jarpa, jwrite)):
        g = mod.arpa_to_fst(mod.parse_arpa(BIGRAM), TEMPLATE_WORDS)
        with open(tmp_path / f"{name}.fst", "wb") as f:
            write(f, g)
    assert (tmp_path / "t.fst").read_bytes() == \
        (tmp_path / "j.fst").read_bytes()
    assert np.isfinite([w for *_, w in _arcs(
        tarpa.arpa_to_fst(tarpa.parse_arpa(BIGRAM), TEMPLATE_WORDS))]).all()
