"""Port parity: the lang directory and the data/lang validators
(`decoder/lang_dir.py`, `util/validation.py`) and their stage-0 tools
(prepare-lang, validate-data-dir, validate-lang) against the JAX
package's, on the CPU: every file of a lang directory byte for byte, the
same problems found in the same broken directories, the same exit
codes."""

import os
import sys

import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.decoder import lang_dir as jlang
from kaldi_tpu.util import validation as jval
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.decoder import lang_dir as tlang
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.util import validation as tval

sys.path.insert(0, os.path.dirname(__file__))
from lang_dir_expect import expected_bytes  # noqa: E402

LEXICONS = {
    "template": "YES Y\nNO N\nHEY H EY\n",
    # alternative pronunciations, a homophone pair and a shared prefix:
    # disambiguation symbols #1.. are needed
    "prons": ("A AH\nA EY\nB B IY\nBEE B IY\nBE B IY\nC S IY\n"
              "SEA S IY\nSEAT S IY T\nCAT K AE T\n"),
}
LANG_FILES = ("words.txt", "phones.txt", "topo", "L.fst", "L_disambig.fst",
              "phones/silence.csl", "phones/nonsilence.csl",
              "phones/disambig.int")


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def lang_dirs(tmp_path_factory):
    out = {}
    for name, text in LEXICONS.items():
        root = tmp_path_factory.mktemp(f"lang_{name}")
        lex = root / "lexicon.txt"
        lex.write_text(text)
        jlang.prepare_lang(str(lex), str(root / "jax"))
        tlang.prepare_lang(str(lex), str(root / "torch"))
        out[name] = (str(root / "jax"), str(root / "torch"))
    return out


@pytest.mark.parametrize("lexicon", sorted(LEXICONS))
def test_prepare_lang_writes_the_same_files(lang_dirs, lexicon):
    j, t = lang_dirs[lexicon]
    assert _files(t) == _files(j)
    assert set(LANG_FILES) <= set(_files(t))


@pytest.mark.parametrize("lexicon", sorted(LEXICONS))
@pytest.mark.parametrize("name", LANG_FILES)
def test_lang_file_bytes(lang_dirs, lexicon, name):
    """JAX's bytes, phones.txt and disambig.int with the #k lines that
    the port adds (lang_dir_expect.py)."""
    j, t = lang_dirs[lexicon]
    with open(os.path.join(t, name), "rb") as b:
        assert b.read() == expected_bytes(j, name)


@pytest.mark.parametrize("lexicon", sorted(LEXICONS))
def test_read_lang_dir_matches(lang_dirs, lexicon):
    j, _ = lang_dirs[lexicon]
    jp, jw, jtopo, jl, jd = jlang.read_lang_dir(j)
    tp, tw, ttopo, tl, td = tlang.read_lang_dir(j)
    assert (tp, tw, td) == (jp, jw, jd)
    assert ttopo.phones == jtopo.phones
    assert tl.num_states == jl.num_states and tl.start == jl.start
    for s in range(jl.num_states):
        assert [(a.ilabel, a.olabel, a.weight, a.nextstate)
                for a in tl.arcs[s]] == \
            [(a.ilabel, a.olabel, a.weight, a.nextstate) for a in jl.arcs[s]]
        assert tl.finals[s] == jl.finals[s]
    assert tlang.read_symbol_table(os.path.join(j, "words.txt")) == \
        jlang.read_symbol_table(os.path.join(j, "words.txt"))


def _break(d, how):
    """Damage a fabricated data dir in one of the ways the validator
    reports."""
    def rewrite(name, fn):
        p = os.path.join(d, name)
        with open(p) as f:
            lines = f.read().splitlines()
        with open(p, "w") as f:
            f.write("".join(line + "\n" for line in fn(lines)))

    if how == "no_text":
        os.remove(os.path.join(d, "text"))
    elif how == "unsorted":
        rewrite("utt2spk", lambda ls: ls[::-1])
    elif how == "wav_mismatch":
        rewrite("wav.scp", lambda ls: ls[1:])
    elif how == "duplicate":
        rewrite("text", lambda ls: ls + ls[:1])
    elif how == "spk2utt":
        with open(os.path.join(d, "spk2utt"), "w") as f:
            f.write("spk0 tr00\n")
    elif how == "segments":
        with open(os.path.join(d, "segments"), "w") as f:
            f.write("tr00 rec0 1.0 0.5\n")
    elif how == "no_utt2spk":
        os.remove(os.path.join(d, "utt2spk"))


BREAKS = ("none", "no_text", "unsorted", "wav_mismatch", "duplicate",
          "spk2utt", "segments", "no_utt2spk")


@pytest.mark.parametrize("how", BREAKS)
def test_validate_data_dir_finds_the_same_problems(tmp_path, how):
    make_standard_corpus(str(tmp_path), 6, 2)
    d = str(tmp_path / "train")
    _break(d, how)
    for kw in ({"require_text": False}, {"require_feats": True}, {}):
        want = jval.validate_data_dir(d, **kw)
        assert tval.validate_data_dir(d, **kw) == want
    assert (want == []) == (how == "none")
    args = ["validate-data-dir", d]
    assert ttool("validate-data-dir")(args) == jtool("validate-data-dir")(args)


LANG_BREAKS = ("none", "no_topo", "eps", "l_range", "no_l")


@pytest.mark.parametrize("how", LANG_BREAKS)
def test_validate_lang_finds_the_same_problems(tmp_path, how):
    lex = tmp_path / "lexicon.txt"
    lex.write_text(LEXICONS["prons"])
    d = str(tmp_path / "lang")
    tlang.prepare_lang(str(lex), d)
    if how == "no_topo":
        os.remove(os.path.join(d, "topo"))
    elif how == "eps":
        with open(os.path.join(d, "words.txt"), "a") as f:
            f.write("<eps> 99\n")
    elif how == "l_range":
        # a phones.txt that no longer covers L's input labels
        with open(os.path.join(d, "phones.txt"), "w") as f:
            f.write("<eps> 0\nSIL 1\n")
    elif how == "no_l":
        os.remove(os.path.join(d, "L.fst"))
    want = jval.validate_lang_dir(d)
    assert tval.validate_lang_dir(d) == want
    assert (want == []) == (how == "none")
    assert ttool("validate-lang")(["validate-lang", d]) == \
        jtool("validate-lang")(["validate-lang", d])


def test_prepare_lang_tool_options(tmp_path):
    lex = tmp_path / "lexicon.txt"
    lex.write_text(LEXICONS["template"])
    args = ["--sil-phone=SIL", "--sil-prob=0.3", str(lex)]
    assert jtool("prepare-lang")(["prepare-lang", *args,
                                  str(tmp_path / "j")]) == 0
    assert ttool("prepare-lang")(["prepare-lang", *args,
                                  str(tmp_path / "t")]) == 0
    for name in LANG_FILES:
        assert (tmp_path / "t" / name).read_bytes() == \
            expected_bytes(str(tmp_path / "j"), name), name
    with pytest.raises(Exception, match="unknown option"):
        ttool("prepare-lang")(["prepare-lang", "--no-such-option=1",
                               str(lex), str(tmp_path / "x")])


def test_fix_data_dir_matches(tmp_path):
    for side in ("j", "t"):
        make_standard_corpus(str(tmp_path / side), 6, 2)
        d = str(tmp_path / side / "train")
        _break(d, "wav_mismatch")
        removed = (jval if side == "j" else tval).fix_data_dir(d)
        assert removed == 1
    for name in ("wav.scp", "text", "utt2spk", "spk2utt"):
        a = (tmp_path / "j" / "train" / name).read_text()
        b = (tmp_path / "t" / "train" / name).read_text()
        assert a.replace(str(tmp_path / "j"), "") == \
            b.replace(str(tmp_path / "t"), "")
