"""Port parity: ConstArpa and lattice LM rescoring (`lm/const_arpa.py`,
`lm/rescore.py`, `lat/compose_pruned.py`, `lm/bigram.py` from_arpa /
to_arpa, and the tools arpa-to-const-arpa, lattice-lmrescore,
lattice-lmrescore-const-arpa, lattice-lmrescore-pruned and
lattice-compose) against the JAX package's, on the CPU: ConstArpa files
byte for byte and their lookups equal, every lattice archive byte for
byte, on seeded lattices of a small chain system (chain_lattices.py) and
a seeded trigram ARPA over its words; and steps/lmrescore.sh's identity
(the LM taken out at -1, put back from ConstArpa at 1) keeping every
best path and its cost within 1e-4 relative."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.lm import bigram as jbigram
from kaldi_tpu.lm import const_arpa as jca
from kaldi_tpu.lm.arpa import parse_arpa as jparse
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lm import bigram as tbigram
from kaldi_tpu_torch.lm import const_arpa as tca
from kaldi_tpu_torch.lm.arpa import parse_arpa as tparse
from kaldi_tpu_torch.util.table import SequentialTableReader

sys.path.insert(0, os.path.dirname(__file__))
import chain_lattices as C  # noqa: E402


def run(get, *argv):
    with contextlib.redirect_stderr(io.StringIO()):
        return get(argv[0])([str(a) for a in argv])


def trigram_arpa(seed: int = 3, name=str) -> str:
    """A trigram ARPA over the chain system's words: every unigram, the
    bigrams and trigrams of SENTENCES (with <s> and </s>), seeded log10
    probabilities and backoffs; each word written as name(word)."""
    rng = np.random.default_rng(seed)
    sents = [["<s>", *s, "</s>"] for s in C.SENTENCES]
    grams = [sorted({(w,) for w in C.PRONS} | {("<s>",), ("</s>",)}),
             sorted({tuple(s[i:i + 2]) for s in sents
                     for i in range(len(s) - 1)}),
             sorted({tuple(s[i:i + 3]) for s in sents
                     for i in range(len(s) - 2)})]
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(g)}"
                            for n, g in enumerate(grams)]
    for n, g in enumerate(grams):
        lines += ["", f"\\{n + 1}-grams:"]
        for ng in g:
            lp = -99.0 if ng == ("<s>",) else -rng.uniform(0.1, 1.5)
            row = f"{lp:.6f}\t{' '.join(map(name, ng))}"
            if n < 2 and ng[-1] != "</s>":
                row += f"\t{-rng.uniform(0.05, 0.8):.6f}"
            lines.append(row)
    return "\n".join(lines + ["", "\\end\\", ""])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmrescore")
    system = C.build_chain_system(str(d))
    lats = C.write_lattices(system, str(d / "lat.ark"), n=6, seed=11)
    (d / "tri.arpa").write_text(trigram_arpa())
    words = f"{system['lang']}/words.txt"
    C.mkgraph_steps.const_arpa_symbols(words, str(d / "words_lm.txt"))
    return dict(d=d, system=system, lats=lats, words=words,
                lm_words=str(d / "words_lm.txt"), arpa=system["arpa"],
                tri=str(d / "tri.arpa"))


def both_files(work, name, *args):
    """`name` in each package with {out} the output; equal status and
    bytes -> the bytes."""
    got = []
    for side, get in (("j", jtool), ("t", ttool)):
        out = work["d"] / f"{name}.{abs(hash(args))}.{side}"
        assert run(get, name, *[str(a).format(out=out) for a in args]) == 0
        got.append(out.read_bytes())
    assert got[0] == got[1]
    return got[1]


# -- ConstArpa ---------------------------------------------------------------

@pytest.mark.parametrize("lm", ["arpa", "tri"])
def test_arpa_to_const_arpa_bytes(work, lm):
    data = both_files(work, "arpa-to-const-arpa",
                      f"--read-symbol-table={work['lm_words']}", work[lm],
                      "{out}")
    assert len(data) % 8 == 0


def test_const_arpa_integer_words_and_ids(work, tmp_path):
    """An ARPA of integer words with --bos-symbol/--eos-symbol, as
    utils/map_arpa_lm.pl gives it."""
    names = read_symbol_table(work["lm_words"])
    V = max(names.values()) - 2
    ints = tmp_path / "int.arpa"
    ints.write_text(trigram_arpa(name=lambda w: str(names[w])))
    both_files(work, "arpa-to-const-arpa", f"--bos-symbol={V + 1}",
               f"--eos-symbol={V + 2}", "--unk-symbol=0", ints, "{out}")


@pytest.mark.parametrize("lm", ["arpa", "tri"])
def test_const_arpa_read_write_and_lookups(work, lm, tmp_path):
    names = read_symbol_table(work["lm_words"])
    j = jca.ConstArpaLm.build_from_arpa(work[lm], symbols=dict(names))
    t = tca.ConstArpaLm.build_from_arpa(work[lm], symbols=dict(names))
    j.write(str(tmp_path / "j.carpa"))
    t.write(str(tmp_path / "t.carpa"))
    assert (tmp_path / "j.carpa").read_bytes() == \
        (tmp_path / "t.carpa").read_bytes()
    back = tca.ConstArpaLm.read(str(tmp_path / "j.carpa"))
    back.write(str(tmp_path / "back.carpa"))
    assert (tmp_path / "back.carpa").read_bytes() == \
        (tmp_path / "j.carpa").read_bytes()
    assert (t.order, t.num_ngrams, t.bos_id, t.eos_id) == \
        (j.order, j.num_ngrams, j.bos_id, j.eos_id)
    rng = np.random.default_rng(5)
    ids = sorted(i for w, i in names.items() if w not in ("<eps>", "<s>"))
    for _ in range(60):
        seq = [int(x) for x in rng.choice(ids, int(rng.integers(1, 7)))]
        assert back.score_sequence_ln(seq) == j.score_sequence_ln(seq)
        sj, st = j.start(), back.start()
        for w in seq:
            (sj, pj), (st, pt) = j.step(sj, w), back.step(st, w)
            assert (st, pt) == (sj, pj)
        assert back.final(st) == j.final(sj)


def test_bigram_from_and_to_arpa(work):
    names = [w for w in C.PRONS]
    jl = jbigram.BigramBackoffLm.from_counts(C.SENTENCES, sorted(names))
    tl = tbigram.BigramBackoffLm.from_counts(C.SENTENCES, sorted(names))
    assert tl.to_arpa() == jl.to_arpa()
    text = open(work["tri"]).read()
    for vocab in (None, sorted(names)):
        jb = jbigram.BigramBackoffLm.from_arpa(jparse(text), vocab)
        tb = tbigram.BigramBackoffLm.from_arpa(tparse(text), vocab)
        for f in ("uni", "bo", "expl_src", "expl_dst", "expl_cost", "eos"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
        assert (tb.words, tb.eos_uni) == (jb.words, jb.eos_uni)
        assert tb.to_arpa() == jb.to_arpa()


# -- the rescoring tools -----------------------------------------------------

@pytest.mark.parametrize("scale", [-1.0, 1.0, 0.5])
def test_lattice_lmrescore_bytes(work, scale):
    both_files(work, "lattice-lmrescore", f"--lm-scale={scale}",
               f"ark:{work['d']}/lat.ark", work["tri"], work["words"],
               "ark:{out}")


@pytest.mark.parametrize("lm", ["arpa", "tri"])
def test_lattice_lmrescore_const_arpa_bytes(work, lm):
    carpa = work["d"] / f"{lm}.carpa"
    assert run(ttool, "arpa-to-const-arpa",
               f"--read-symbol-table={work['lm_words']}", work[lm],
               carpa) == 0
    for scale in (1.0, -0.5):
        both_files(work, "lattice-lmrescore-const-arpa",
                   f"--lm-scale={scale}", f"ark:{work['d']}/lat.ark", carpa,
                   "ark:{out}")


@pytest.mark.parametrize("beam", [6.0, 2.0])
def test_lattice_lmrescore_pruned_bytes(work, beam):
    carpa = work["d"] / "tri_pruned.carpa"
    assert run(ttool, "arpa-to-const-arpa",
               f"--read-symbol-table={work['lm_words']}", work["tri"],
               carpa) == 0
    both_files(work, "lattice-lmrescore-pruned", f"--compose-beam={beam}",
               "--lm-scale=1.0", f"ark:{work['d']}/lat.ark", work["arpa"],
               work["words"], carpa, "ark:{out}")


def test_lattice_compose_bytes(work):
    both_files(work, "lattice-compose", f"ark:{work['d']}/lat.ark",
               work["system"]["G"], "ark:{out}")


def _lats(path):
    return dict(SequentialTableReader("lattice", f"ark:{path}"))


def test_rescoring_identity_keeps_best_paths(work):
    """steps/lmrescore_const_arpa.sh over the decoding LM itself: the LM
    out at -1 (lattice-lmrescore, the ARPA), in again at 1
    (lattice-lmrescore-const-arpa, arpa-to-const-arpa of the same ARPA);
    and lattice-lmrescore-pruned with the same pair."""
    d = work["d"]
    carpa = d / "g.carpa"
    assert run(ttool, "arpa-to-const-arpa",
               f"--read-symbol-table={work['lm_words']}", work["arpa"],
               carpa) == 0
    assert run(ttool, "lattice-lmrescore", "--lm-scale=-1",
               f"ark:{d}/lat.ark", work["arpa"], work["words"],
               f"ark:{d}/nolm.ark") == 0
    assert run(ttool, "lattice-lmrescore-const-arpa", "--lm-scale=1",
               f"ark:{d}/nolm.ark", carpa, f"ark:{d}/relm.ark") == 0
    assert run(ttool, "lattice-lmrescore-pruned", f"ark:{d}/lat.ark",
               work["arpa"], work["words"], carpa,
               f"ark:{d}/pruned.ark") == 0
    before = _lats(d / "lat.ark")
    for name in ("relm.ark", "pruned.ark"):
        after = _lats(d / name)
        assert sorted(after) == sorted(before)
        for k, lat in before.items():
            a, b = lattice_best_path(lat), lattice_best_path(after[k])
            assert b[:2] == a[:2]
            assert abs(b[2] - a[2]) <= 1e-4 * abs(a[2])
