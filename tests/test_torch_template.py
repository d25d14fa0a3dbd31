"""The port's generic corpus recipe (`recipes/template_run.py`, stages
0-8 of egs/template/run.py) on the CPU: its corpus generator byte for
byte against the reference test's `make_standard_corpus`; the recipe at
its defaults (stages 0-7) over the reference's own corpus at the
reference test's widths (40 leaves, 80 Gaussians) to the reference
test's bar (WER <= 10%) with the artifacts of every stage in the
reference's places; the files that do not depend on the features' float
rounding byte for byte against the JAX recipe's, and its HCLG's size
equal; stages 6-7 from the JAX recipe's tri1 files to JAX's SAT tree;
stage 8 (the flat-start chain model) through the same entry point, and
from the JAX package's initial weights to the reference test's bar of
15% at 30 epochs (slow); the card refused where it is missing."""

import contextlib
import io
import os
import re
import shutil
import sys

import pytest

from kaldi_tpu_torch.recipes import template_run
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

sys.path.insert(0, os.path.dirname(__file__))
from jax_native_private import private_jax_native_build  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("lang/L.fst", "lang/G.fst", "mono/final.mdl", "tri1/final.mdl",
             "tri1/HCLG.fst", "tri1/lat.ark", "tri1/hyp.txt", "tri2/final.mdl",
             "tri2/tree", "tri2/final.mat", "tri2/hyp.txt", "tri3/final.mdl",
             "tri3/tree", "tri3/hyp.txt")
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
    """At its defaults the recipe runs stages 0-7 and returns tri3's
    WER, as the reference does."""
    root, wer, report = runs
    assert wer is not None and wer <= 10.0
    assert report["wer"] == wer == report["tri3"]["wer"]
    for name in ("tri1", "tri2", "tri3"):
        assert report[name]["wer"] <= 10.0 and \
            report[name]["ref_words"] == 16, name
    assert report["align_failures"] == 0 and report["decode_failures"] == 0
    assert report["tri1"]["lattices"] == 4
    assert report["tool_stats"]["gmm-latgen-faster"]["det_fallbacks"] == 0
    assert set(report["stage_s"]) == {str(s) for s in range(8)}
    assert report["tri2"]["final_mat"] == [20, 66]
    assert report["tri3"]["train_speakers"] == 3
    assert report["tri3"]["test_speakers"] == 3
    assert report["tri3"]["first_pass"] == 4
    for name in ARTIFACTS:
        assert os.path.exists(root / "t" / "exp" / name), name
    assert not os.path.exists(root / "t" / "exp" / "chain")


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


@pytest.mark.parametrize("stage", [[], ["--stage", "6"],
                                   ["--stage", "8", "--chain-epochs", "1"]])
def test_the_card_is_required_unless_declined(runs, tmp_path, stage):
    """Stage 1's MFCC, stage 6's GMMs, stage 8's training: each refuses
    a machine without CUDA unless --use-gpu=no."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    if stage:
        shutil.copytree(runs[0] / "t", tmp_path, dirs_exist_ok=True)
    else:
        make_standard_corpus(str(tmp_path), 3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        template_run.main(_args(tmp_path, *stage))


def test_later_stage_resumes_from_the_files(runs, tmp_path):
    """--stage 4 rebuilds G and the HCLG from the files stages 0-3 left,
    then runs stages 5-7 to the same WERs."""
    root, wer, report = runs
    shutil.copytree(root / "t", tmp_path, dirs_exist_ok=True)
    again = {}
    assert template_run.main(_args(tmp_path, "--use-gpu=no", "--stage",
                                   "4"), report=again) == wer
    assert (again["hclg_states"], again["hclg_arcs"]) == \
        (report["hclg_states"], report["hclg_arcs"])
    assert set(again["stage_s"]) == {"4", "5", "6", "7"}
    for name in ("tri1", "tri2", "tri3"):
        assert again[name] == report[name], name


def test_stages_6_7_from_the_jax_tri1(runs, tmp_path):
    """The port's stages 6-7 over the JAX recipe's files (its features,
    tri1 and G): tri3 is the JAX package's train_sat over the same
    files, to the tree, the pdf and Gaussian counts and the means within
    1e-4; tri2's transform has the reference's shape."""
    import numpy as np
    from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread
    from kaldi_tpu.decoder.graph import Lang as JLang
    from kaldi_tpu.decoder.graph import TrainingGraphCompiler
    from kaldi_tpu.recipes.lda_mllt import TrainSatOptions, train_sat
    from kaldi_tpu.recipes.mono import MonoSystem, _align_all
    from kaldi_tpu.tree import ContextDependency as JCtx
    from kaldi_tpu.util import kaldi_io as jkio
    from kaldi_tpu.util.table import SequentialTableReader
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    root = runs[0]
    shutil.copytree(root / "j", tmp_path, dirs_exist_ok=True)
    d = str(tmp_path / "exp")
    report = {}
    wer = template_run.main(_args(tmp_path, "--use-gpu=no", "--stage", "6"),
                            report=report)
    assert wer <= 10.0 and report["align_failures"] == 0
    assert set(report["stage_s"]) == {"6", "7"}
    assert report["tri2"]["final_mat"] == [20, 66]
    lang = JLang(template_run.read_lexicon(f"{tmp_path}/lexicon.txt"),
                 sil_phone="SIL", sil_prob=0.5)
    tm, am = jread(f"{d}/tri1/final.mdl")
    lang.topo = tm.topo
    tri1 = MonoSystem(lang, jkio.read_kaldi_object(JCtx.read,
                                                   f"{d}/tri1/tree"), tm, am)
    feats = dict(SequentialTableReader("matrix",
                                       f"ark:{tmp_path}/train/feats.ark"))
    texts = template_run.read_texts(f"{tmp_path}/train")
    compiler = TrainingGraphCompiler(tm, tri1.tree, lang)
    ali = _align_all(tri1, {u: compiler.compile(texts[u]) for u in feats},
                     feats, 10.0, 0.1, 1.0)
    sys3, _ = train_sat(lang, feats, texts,
                        template_run.read_utt2spk(f"{tmp_path}/train"), tri1,
                        ali, TrainSatOptions(
                            num_iters=5, totgauss=80, num_leaves=40,
                            realign_iters=(2, 4), tree_min_gain=20.0,
                            fmllr_iters=(1, 3), fmllr_min_count=50.0))
    jtree = io.BytesIO()
    sys3.tree.write(jtree, True)
    with open(f"{d}/tri3/tree", "rb") as f:
        assert f.read()[2:] == jtree.getvalue()
    _, tam = read_am_gmm(f"{d}/tri3/final.mdl", device="cpu")
    assert tam.num_pdfs == sys3.am.num_pdfs == report["tri3"]["pdfs"]
    assert tam.num_gauss() == sys3.am.num_gauss()
    for p in range(tam.num_pdfs):
        a, b = tam.get_pdf(p).get_means(), sys3.am.get_pdf(p).get_means()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), p


def test_stage8_through_the_entry_point(runs, tmp_path):
    """--stage 8 --chain-epochs 1 over the recipe's directory: the flow,
    the files and the returns of the reference's stage 8 (one epoch: the
    bar is the slow test's)."""
    shutil.copytree(runs[0] / "t", tmp_path, dirs_exist_ok=True)
    report = {}
    wer = template_run.main(_args(tmp_path, "--use-gpu=no", "--stage", "8",
                                  "--chain-epochs", "1"), report=report)
    chain = report["chain"]
    assert wer == report["wer"] == chain["wer"] and 0 <= wer <= 200
    assert set(report["stage_s"]) == {"8"}
    assert chain["ref_words"] == 16 and chain["acoustic_scale"] in (0.5, 1.0)
    train = chain["train"]
    assert (train["utterances"], train["buckets"]) == (14, 1)
    assert len(train["step_objf"]) == 3 and len(train["epoch_objf"]) == 1
    assert train["step_ms"] == []             # timed on CUDA only
    assert os.path.isdir(tmp_path / "exp" / "chain")


@pytest.mark.slow
def test_stage8_reaches_the_reference_bar(runs, tmp_path, monkeypatch):
    """The reference test's stage 8 (30 epochs, WER <= 15%) through the
    entry point, from the initial weights that the JAX package's stage 8
    draws (its seed 0).  The bar is that draw's: over seeds the WER at
    30 epochs spreads in both packages (tools/template_chain_seeds.py,
    PERF.md §6), and from the same weights the port trains as JAX does
    (test_torch_chain_e2e)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu_torch.recipes import chain as tchain

    def jax_draw(cfg, _gen):
        v = ChainTdnnf(ChainTdnnfConfig(**vars(cfg)), train=True).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 228, cfg.feat_dim)))
        return jax.tree.map(np.asarray, {
            "params": dict(v["params"]),
            "batch_stats": dict(v["batch_stats"])})

    monkeypatch.setattr(tchain, "chain_tdnnf_init", jax_draw)
    shutil.copytree(runs[0] / "t", tmp_path, dirs_exist_ok=True)
    report = {}
    wer = template_run.main(_args(tmp_path, "--use-gpu=no", "--stage", "8",
                                  "--chain-epochs", "30"), report=report)
    assert wer <= 15.0
    objf = report["chain"]["train"]["epoch_objf"]
    assert len(objf) == 30 and objf[-1] > objf[0]
