"""Port parity: MBR decoding, word alignment, CTM and phone-pruned
determinization (`lat/sausages.py`, `lat/word_align.py`, `lat/functions.py`
determinize_lattice_phone_pruned, and the tools lattice-mbr-decode,
lattice-to-ctm-conf, lattice-to-nbest, nbest-to-linear,
lattice-align-words, lattice-align-words-lexicon, nbest-to-ctm and
lattice-determinize-phone-pruned) against the JAX package's, on the CPU,
over seeded lattices of a small chain system with no exact ties
(chain_lattices.py): every archive and CTM byte for byte, Bayes risks
within 1e-9 relative, and the properties steps/get_ctm.sh and
steps/score_kaldi.sh rely on (each CTM's words the 1-best's, start times
non-decreasing inside the utterance, best paths kept)."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.lat import functions as jfun
from kaldi_tpu.lat import sausages as jsau
from kaldi_tpu.lat import word_align as jwa
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu.util.table import SequentialTableReader as JReader
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.lat import functions as tfun
from kaldi_tpu_torch.lat import sausages as tsau
from kaldi_tpu_torch.lat import word_align as twa
from kaldi_tpu_torch.util.table import SequentialTableReader

sys.path.insert(0, os.path.dirname(__file__))
import chain_lattices as C  # noqa: E402


def run(get, *argv):
    with contextlib.redirect_stderr(io.StringIO()):
        return get(argv[0])([str(a) for a in argv])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("mbr")
    system = C.build_chain_system(str(d))
    C.write_lattices(system, str(d / "lat.ark"), n=8, seed=21)
    C.mkgraph_steps.align_lexicon(C.PRONS, system["lang"],
                                  str(d / "align_lexicon.int"))
    phones = read_symbol_table(f"{system['lang']}/phones.txt")
    with open(d / "word_boundary.int", "w") as f:
        for name, i in phones.items():
            if name != "<eps>" and not name.startswith("#"):
                f.write(f"{i} {'nonword' if name == 'SIL' else 'singleton'}"
                        "\n")
    assert run(ttool, "lattice-1best", f"ark:{d}/lat.ark",
               f"ark:{d}/1best.ark") == 0
    jtm = jio.read_kaldi_object(JTm.read, system["tm"])
    return dict(d=d, system=system, tm=system["tm"], jtm=jtm,
                ttm=system["tm_obj"])


def both_files(work, name, *args):
    got = []
    for side, get in (("j", jtool), ("t", ttool)):
        outs = [work["d"] / f"{name}.{k}.{side}" for k in range(2)]
        assert run(get, name, *[str(a).format(out=outs[0], out2=outs[1])
                                for a in args]) == 0
        got.append([o.read_bytes() if o.exists() else None for o in outs])
    assert got[0] == got[1]
    return got[1]


def _lats(path, reader=SequentialTableReader):
    return dict(reader("lattice", f"ark:{path}"))


# -- MBR ---------------------------------------------------------------------

def test_minimum_bayes_risk_matches(work):
    jl, tl = _lats(work["d"] / "lat.ark", JReader), \
        _lats(work["d"] / "lat.ark")
    risks = []
    for k in sorted(tl):
        for decode_mbr in (True, False):
            jm = jsau.MinimumBayesRisk(jl[k], jsau.MinimumBayesRiskOptions(
                decode_mbr=decode_mbr))
            tm = tsau.MinimumBayesRisk(tl[k], tsau.MinimumBayesRiskOptions(
                decode_mbr=decode_mbr))
            assert tm.get_one_best() == jm.get_one_best()
            a, b = tm.get_bayes_risk(), jm.get_bayes_risk()
            assert abs(a - b) <= 1e-9 * max(abs(b), 1e-30)
            risks.append(b)
            assert tm.get_one_best_times() == jm.get_one_best_times()
            assert tm.get_sausage_times() == jm.get_sausage_times()
            for x, y in zip(tm.get_one_best_confidences(),
                            jm.get_one_best_confidences()):
                assert abs(x - y) <= 1e-9
            for tb, jb in zip(tm.get_sausage_stats(), jm.get_sausage_stats()):
                assert [w for w, _ in tb] == [w for w, _ in jb]
                np.testing.assert_allclose([p for _, p in tb],
                                           [p for _, p in jb], rtol=1e-9)
    assert max(risks) > 0.0          # some lattices are not one path


@pytest.mark.parametrize("scales", [("1.0", "1.0"), ("0.5", "0.1")])
def test_lattice_mbr_decode_bytes(work, scales):
    lm, ac = scales
    tra, risk = both_files(work, "lattice-mbr-decode", f"--lm-scale={lm}",
                           f"--acoustic-scale={ac}",
                           f"ark:{work['d']}/lat.ark", "ark,t:{out}",
                           "ark,t:{out2}")
    assert tra and risk


@pytest.mark.parametrize("mbr", ["true", "false"])
def test_lattice_to_ctm_conf_bytes(work, mbr):
    ctm, _ = both_files(work, "lattice-to-ctm-conf", f"--decode-mbr={mbr}",
                        "--acoustic-scale=0.5", "--frame-shift=0.03",
                        f"ark:{work['d']}/lat.ark", "{out}")
    assert len(ctm.decode().splitlines()) >= 8


# -- n-best, word alignment, CTM -----------------------------------------------

def test_lattice_to_nbest_and_nbest_to_linear_bytes(work):
    d = work["d"]
    both_files(work, "lattice-to-nbest", "--n=3", "--acoustic-scale=0.5",
               f"ark:{d}/lat.ark", "ark:{out}")
    assert run(ttool, "lattice-to-nbest", "--n=3", f"ark:{d}/lat.ark",
               f"ark:{d}/nbest.ark") == 0
    both_files(work, "nbest-to-linear", f"ark:{d}/nbest.ark", "ark,t:{out}",
               "ark,t:{out2}")


def test_word_alignment_and_ctm_bytes(work):
    """steps/get_ctm.sh's chain: lattice-1best, then
    lattice-align-words-lexicon over phones/align_lexicon.int as
    prepare_lang.sh writes it, then nbest-to-ctm; and the word-boundary
    form of lattice-align-words."""
    d = work["d"]
    both_files(work, "lattice-align-words-lexicon", d / "align_lexicon.int",
               work["tm"], f"ark:{d}/1best.ark", "ark:{out}")
    assert run(ttool, "lattice-align-words-lexicon",
               d / "align_lexicon.int", work["tm"], f"ark:{d}/1best.ark",
               f"ark:{d}/aligned.ark") == 0
    ctm, _ = both_files(work, "nbest-to-ctm", "--frame-shift=0.03",
                        f"ark:{d}/aligned.ark", "{out}")
    both_files(work, "lattice-align-words", d / "word_boundary.int",
               work["tm"], f"ark:{d}/1best.ark", "ark:{out}")
    # the legacy 3-argument form (a CTM of each best path): JAX's reads a
    # GMM model for its transition model, so it is held to JAX's
    # functions over the chain model's
    assert run(ttool, "lattice-align-words", work["tm"], f"ark:{d}/1best.ark",
               d / "legacy.ctm") == 0
    want = "".join(jwa.format_ctm(jwa.lattice_to_ctm(lat, work["jtm"], k))
                   for k, lat in _lats(d / "1best.ark", JReader).items())
    assert (d / "legacy.ctm").read_text() == want
    # each utterance's CTM words are its 1-best's, in order, with start
    # times non-decreasing and inside the utterance
    best = {k: tfun.lattice_best_path(lat)
            for k, lat in _lats(d / "lat.ark").items()}
    rows = {}
    for line in ctm.decode().splitlines():
        utt, _ch, start, dur, word = line.split()
        rows.setdefault(utt, []).append((float(start), float(dur),
                                         int(word)))
    assert sorted(rows) == sorted(k for k, b in best.items() if b[1])
    for utt, r in rows.items():
        assert [w for *_, w in r] == best[utt][1]
        starts = [s for s, _, _ in r]
        assert starts == sorted(starts) and starts[0] >= 0.0
        n_frames = sum(1 for t in best[utt][0] if t)
        assert r[-1][0] + r[-1][1] <= 0.03 * n_frames + 1e-9


def test_word_align_functions_match(work):
    jl, tl = _lats(work["d"] / "1best.ark", JReader), \
        _lats(work["d"] / "1best.ark")
    lexicon = []
    for line in open(work["d"] / "align_lexicon.int"):
        p = [int(x) for x in line.split()]
        lexicon.append((p[0], p[1], tuple(p[2:])))
    info_j = jwa.WordBoundaryInfo.from_file(str(work["d"] /
                                                "word_boundary.int"))
    info_t = twa.WordBoundaryInfo.from_file(str(work["d"] /
                                                "word_boundary.int"))
    for k in sorted(tl):
        assert twa.best_path_word_times(tl[k], work["ttm"]) == \
            jwa.best_path_word_times(jl[k], work["jtm"])
        for fn, args_t, args_j in (
                (lambda m, *a: m.word_align_lattice_lexicon(*a),
                 (work["ttm"], lexicon), (work["jtm"], lexicon)),
                (lambda m, *a: m.phone_align_lattice(*a),
                 (work["ttm"], True), (work["jtm"], True)),
                (lambda m, *a: m.word_align_lattice(*a),
                 (work["ttm"], info_t), (work["jtm"], info_j))):
            a = fn(twa, tl[k], *args_t)
            b = fn(jwa, jl[k], *args_j)
            a = a[0] if isinstance(a, tuple) else a
            b = b[0] if isinstance(b, tuple) else b
            assert (a is None) == (b is None)
            if a is not None:
                assert a.to_text() == b.to_text()
        ct = twa.lattice_to_ctm(tl[k], work["ttm"], k, 0.03)
        cj = jwa.lattice_to_ctm(jl[k], work["jtm"], k, 0.03)
        assert twa.format_ctm(ct) == jwa.format_ctm(cj)


# -- phone-pruned determinization ------------------------------------------------

@pytest.mark.parametrize("beam", [4.0, 10.0])
def test_lattice_determinize_phone_pruned(work, tmp_path, beam):
    """lattice-determinize-phone-pruned on the raw (undeterminized)
    lattices: JAX's bytes, each best path kept."""
    raw = tmp_path / "raw.ark"
    lats = C.write_lattices(work["system"], str(raw), n=6, seed=31,
                            determinize=False)
    out, _ = both_files(work, "lattice-determinize-phone-pruned",
                        f"--beam={beam}", "--acoustic-scale=0.5",
                        work["tm"], f"ark:{raw}", "ark:{out}")
    got = _lats(work["d"] / "lattice-determinize-phone-pruned.0.t")
    for k, lat in lats.items():
        a, b = tfun.lattice_best_path(lat), tfun.lattice_best_path(got[k])
        assert b[:2] == a[:2]
        assert abs(b[2] - a[2]) <= 1e-4 * abs(a[2])
    jl = _lats(raw, JReader)
    for k, lat in _lats(raw).items():
        for pd, wd in ((True, False), (False, True)):
            t = tfun.determinize_lattice_phone_pruned(
                lat, work["ttm"], beam, phone_determinize=pd,
                word_determinize=wd)
            j = jfun.determinize_lattice_phone_pruned(
                jl[k], work["jtm"], beam, phone_determinize=pd,
                word_determinize=wd)
            assert t.to_text() == j.to_text()
