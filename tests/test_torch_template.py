"""The port's generic corpus recipe (`recipes/template_run.py`, stages 0-5
of egs/template/run.py) on the CPU: its corpus generator byte for byte
against the reference test's `make_standard_corpus`; the recipe over the
reference's own corpus at the reference test's widths (40 leaves, 80
Gaussians) to the reference test's bar (WER <= 10%) with the artifacts
of stages 0-5 in the reference's places; the files that do not depend
on the features' float rounding byte for byte against the JAX recipe's,
and its HCLG's size equal; stages 6-8 and a card without CUDA refused."""

import contextlib
import os
import re
import sys

import pytest

from kaldi_tpu_torch.recipes import template_run
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

sys.path.insert(0, os.path.dirname(__file__))
from jax_native_private import private_jax_native_build  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("lang/L.fst", "lang/G.fst", "mono/final.mdl", "tri1/final.mdl",
             "tri1/HCLG.fst", "tri1/lat.ark", "tri1/hyp.txt")
SAME_BYTES = ("lang/words.txt", "lang/phones.txt", "lang/topo", "lang/L.fst",
              "lang/L_disambig.fst", "lang/G.fst", "mono/tree",
              "mono/graphs.ark")


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_generator_matches_the_reference_corpus(tmp_path):
    from test_template_recipe import make_standard_corpus as reference
    t = make_standard_corpus(str(tmp_path / "t"))
    j = reference(str(tmp_path / "j"))
    assert t == j
    names = _files(tmp_path / "j")
    assert names == _files(tmp_path / "t") and len(names) == 2 + 2 * 3 + 18
    for name in names:
        a = (tmp_path / "t" / name).read_bytes()
        b = (tmp_path / "j" / name).read_bytes()
        if name.endswith("wav.scp"):
            a = a.replace(str(tmp_path / "t").encode(), b"")
            b = b.replace(str(tmp_path / "j").encode(), b"")
        assert a == b, name


def _args(root, *extra):
    return ["--train", f"{root}/train", "--test", f"{root}/test",
            "--lexicon", f"{root}/lexicon.txt", "--arpa", f"{root}/lm.arpa",
            "--dir", f"{root}/exp", "--num-leaves", "40", "--tot-gauss", "80",
            *extra]


class _Stage6(Exception):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's recipe and the JAX recipe (stopped as its stage 6
    begins) over the reference's corpus, each in its own directory."""
    root = tmp_path_factory.mktemp("template")
    make_standard_corpus(str(root / "t"))
    make_standard_corpus(str(root / "j"))
    report = {}
    wer = template_run.main(_args(root / "t", "--use-gpu=no"),
                            report=report)
    sys.path.insert(0, os.path.join(REPO, "egs", "template"))
    import run as jax_run

    def print_until_stage6(*a, **kw):
        if re.match(r"=== stage [6-9]", " ".join(map(str, a))):
            raise _Stage6()
        print(*a, **kw, file=sys.stderr)

    jax_run.print = print_until_stage6
    try:
        with contextlib.redirect_stdout(sys.stderr):
            jax_run.main(_args(root / "j"))
    except _Stage6:
        pass
    finally:
        del jax_run.print
    return root, wer, report


def test_recipe_reaches_the_reference_bar(runs):
    root, wer, report = runs
    assert wer is not None and wer <= 10.0
    assert report["wer"] == wer and report["ref_words"] == 16
    assert report["align_failures"] == 0 and report["lattices"] == 4
    assert report["tool_stats"]["gmm-latgen-faster"]["det_fallbacks"] == 0
    assert set(report["stage_s"]) == {str(s) for s in range(6)}
    for name in ARTIFACTS:
        assert os.path.exists(root / "t" / "exp" / name), name


@pytest.mark.parametrize("name", SAME_BYTES)
def test_artifacts_equal_the_jax_recipe(runs, name):
    root = runs[0]
    assert (root / "t" / "exp" / name).read_bytes() == \
        (root / "j" / "exp" / name).read_bytes()


def test_hclg_and_models_match_the_jax_recipe(runs):
    from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    root, _, report = runs
    hclg = read_fst_file(str(root / "j" / "exp" / "tri1" / "HCLG.fst"))
    assert (report["hclg_states"], report["hclg_arcs"]) == \
        (hclg.num_states, hclg.num_arcs())
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm as tread
    for name in ("mono", "tri1"):
        _, tam = tread(str(root / "t" / "exp" / name / "final.mdl"),
                       device="cpu")
        _, jam = jread(str(root / "j" / "exp" / name / "final.mdl"))
        assert tam.num_pdfs == jam.num_pdfs
        assert abs(tam.num_gauss() - jam.num_gauss()) <= 2


@pytest.mark.parametrize("extra", [["--stage", "6"], ["--stage", "8"],
                                   ["--chain-epochs", "3"]])
def test_later_stages_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        template_run.main(_args(tmp_path, *extra))


def test_the_card_is_required_unless_declined(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    make_standard_corpus(str(tmp_path), 3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        template_run.main(_args(tmp_path))


def test_later_stage_resumes_from_the_files(runs, tmp_path):
    """--stage 4 rebuilds G and the HCLG from the files stages 0-3 left,
    then decodes to the same WER."""
    root, wer, report = runs
    again = {}
    assert template_run.main(_args(root / "t", "--use-gpu=no", "--stage",
                                   "4"), report=again) == wer
    assert (again["hclg_states"], again["hclg_arcs"]) == \
        (report["hclg_states"], report["hclg_arcs"])
    assert set(again["stage_s"]) == {"4", "5"}
