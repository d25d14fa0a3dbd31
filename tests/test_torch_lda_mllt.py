"""Port parity: LDA+MLLT and SAT training (`recipes/lda_mllt.py`) and the
transform tools (`cli/transform_tools.py`) of kaldi_tpu_torch against the
JAX package's on the CPU.  The start is a JAX tri1 system: the reference
recipe (egs/template/run.py stages 0-3) over the reference test's
fabricated corpus at its widths (14 train, 4 test utterances; 40
leaves, 80 Gaussians).  The same system, features and alignments carried
across: `train_lda_mllt` and `train_sat` at the recipe's stage 6 and 7
options give the same tree, the same pdf and Gaussian counts, and
transforms and means within 1e-4 (the bar of `train_deltas`); the LDA
and MLLT statistics of a pass within 1e-9; each of the 8 tools over the
same files gives the JAX tool's archive byte for byte, or its float
matrices within 1e-6."""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest

from kaldi_tpu.base import io_funcs as jiof
from kaldi_tpu.cli import get_tool as jget
from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread_am
from kaldi_tpu.decoder.graph import Lang as JLang
from kaldi_tpu.decoder.graph import TrainingGraphCompiler as JCompiler
from kaldi_tpu.recipes import lda_mllt as jlm
from kaldi_tpu.recipes.mono import MonoSystem as JMono
from kaldi_tpu.recipes.mono import _align_all as j_align_all
from kaldi_tpu.transform.lda import LdaEstimate as JLda
from kaldi_tpu.transform.mllt import MlltAccs as JMllt
from kaldi_tpu.tree import ContextDependency as JCtx
from kaldi_tpu.util import kaldi_io as jkio
from kaldi_tpu.util.table import SequentialTableReader as JReader
from kaldi_tpu.util.table import TableWriter as JWriter
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
from kaldi_tpu_torch.decoder.graph import Lang
from kaldi_tpu_torch.feat.functions import splice_frames
from kaldi_tpu_torch.recipes import lda_mllt
from kaldi_tpu_torch.recipes.mono import MonoSystem
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.recipes.template_run import (read_lexicon, read_texts,
                                                  read_utt2spk)
from kaldi_tpu_torch.transform.mllt import MlltAccs
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.util import kaldi_io

sys.path.insert(0, os.path.dirname(__file__))
from jax_native_private import private_jax_native_build  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# egs/template/run.py's stage 6 and 7 options at the reference test's
# widths
LDA_OPTS = dict(num_iters=6, totgauss=80, num_leaves=40,
                realign_iters=(2, 4), tree_min_gain=20.0, lda_dim=20,
                splice_left=2, splice_right=2, mllt_iters=(1, 2))
SAT_OPTS = dict(num_iters=5, totgauss=80, num_leaves=40,
                realign_iters=(2, 4), tree_min_gain=20.0,
                fmllr_iters=(1, 3), fmllr_min_count=50.0)


class _Stage4(Exception):
    pass


@pytest.fixture(scope="module")
def tri1(tmp_path_factory):
    """The JAX recipe's tri1 over the fabricated corpus; tri1's
    alignments of the train set by the JAX package; both packages'
    systems over the same files."""
    root = tmp_path_factory.mktemp("tri1")
    make_standard_corpus(str(root))
    sys.path.insert(0, os.path.join(REPO, "egs", "template"))
    import run as jax_run

    def print_until_stage4(*a, **kw):
        if re.match(r"=== stage [4-9]", " ".join(map(str, a))):
            raise _Stage4()
        print(*a, **kw, file=sys.stderr)

    jax_run.print = print_until_stage4
    try:
        with contextlib.redirect_stdout(sys.stderr):
            jax_run.main(["--train", f"{root}/train", "--test",
                          f"{root}/test", "--lexicon", f"{root}/lexicon.txt",
                          "--arpa", f"{root}/lm.arpa", "--dir",
                          f"{root}/exp", "--num-leaves", "40",
                          "--tot-gauss", "80"])
    except _Stage4:
        pass
    finally:
        del jax_run.print
    lexicon = read_lexicon(f"{root}/lexicon.txt")
    mdl, tree = f"{root}/exp/tri1/final.mdl", f"{root}/exp/tri1/tree"
    jlang = JLang(lexicon, sil_phone="SIL", sil_prob=0.5)
    jtm, jam = jread_am(mdl)
    jlang.topo = jtm.topo
    jsys = JMono(jlang, jkio.read_kaldi_object(JCtx.read, tree), jtm, jam)
    tlang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    ttm, tam = read_am_gmm(mdl, device="cpu")
    tlang.topo = ttm.topo
    tsys = MonoSystem(tlang, kaldi_io.read_kaldi_object(
        ContextDependency.read, tree), ttm, tam)
    feats = dict(JReader("matrix", f"ark:{root}/train/feats.ark"))
    texts = read_texts(f"{root}/train")
    compiler = JCompiler(jtm, jsys.tree, jlang)
    graphs = {u: compiler.compile(texts[u]) for u in feats}
    ali = j_align_all(jsys, graphs, feats, 10.0, 0.1, 1.0)
    assert len(ali) == len(feats) == 14
    return dict(root=root, jsys=jsys, tsys=tsys, feats=feats, texts=texts,
                ali=ali, utt2spk=read_utt2spk(f"{root}/train"))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def tree_bytes(tree):
    f = io.BytesIO()
    tree.write(f, True)
    return f.getvalue()


def assert_systems_match(tsys, jsys):
    assert tree_bytes(tsys.tree) == tree_bytes(jsys.tree)
    assert tsys.am.num_pdfs == jsys.am.num_pdfs
    for p in range(jsys.am.num_pdfs):
        tg, jg = tsys.am.get_pdf(p), jsys.am.get_pdf(p)
        assert tg.num_gauss == jg.num_gauss, p
        assert rel(tg.get_means(), jg.get_means()) <= 1e-4, p
        assert rel(tg.get_vars(), jg.get_vars()) <= 1e-4, p


def test_lda_and_mllt_statistics_match(tri1):
    """One pass of each of train_lda_mllt's statistics over tri1's
    alignments: the LDA classes of the spliced features, and MLLT's
    per-pdf Gaussian posteriors, within 1e-9."""
    jsys, tsys, ali = tri1["jsys"], tri1["tsys"], tri1["ali"]
    spliced = {u: splice_frames(f, 2, 2) for u, f in tri1["feats"].items()}
    t_est = lda_mllt.lda_estimate(tsys, spliced, ali)
    j_est = JLda(jsys.tm.num_pdfs, 65)
    for utt, a in ali.items():
        pdfs = jsys.tm.transition_ids_to_pdfs(a)
        for pdf in np.unique(pdfs):
            j_est.accumulate(spliced[utt][pdfs == pdf], int(pdf))
    for name in ("zero_acc", "first_acc", "total_second_acc"):
        assert rel(getattr(t_est, name), getattr(j_est, name)) <= 1e-9
    # the rows past the between-class rank span a degenerate eigenspace
    # (LdaEstimate.estimate): the rows within it
    rank = int((j_est.zero_acc > 0).sum()) - 1
    assert 10 <= rank < 20
    assert rel(lda_mllt.estimate_lda(tsys, spliced, ali, 20)[:rank],
               jlm.estimate_lda(jsys, spliced, ali, 20)[:rank]) <= 1e-8
    feats = tri1["feats"]
    t_acc = MlltAccs(13, device="cpu")
    t_acc.accumulate_groups(lda_mllt.mllt_groups(tsys, feats, ali))
    j_acc = JMllt(13)
    for utt, a in ali.items():
        pdfs = jsys.tm.transition_ids_to_pdfs(a)
        for pdf in np.unique(pdfs):
            g = jsys.am.get_pdf(int(pdf))
            sub = feats[utt][pdfs == pdf]
            j_acc.accumulate_from_posteriors(g, sub,
                                             g.component_posteriors(sub))
    assert abs(t_acc.beta - j_acc.beta) <= 1e-9 * j_acc.beta
    assert rel(t_acc.G, j_acc.G) <= 1e-9


def test_train_lda_mllt_matches_jax(tri1, monkeypatch):
    """From JAX's LDA too, carried across: with fewer pdfs than the LDA
    dimension its last rows are a basis that the statistics' last bits
    pick (test_lda_and_mllt_statistics_match holds the rest)."""
    spliced = {u: splice_frames(f, 2, 2) for u, f in tri1["feats"].items()}
    j_lda = jlm.estimate_lda(tri1["jsys"], spliced, tri1["ali"], 20)
    monkeypatch.setattr(lda_mllt, "estimate_lda", lambda *a: j_lda)
    jsys2, jW, jfeats = jlm.train_lda_mllt(
        tri1["jsys"].lang, tri1["feats"], tri1["texts"], tri1["jsys"],
        tri1["ali"], jlm.TrainLdaMlltOptions(**LDA_OPTS))
    tsys2, tW, tfeats = lda_mllt.train_lda_mllt(
        tri1["tsys"].lang, tri1["feats"], tri1["texts"], tri1["tsys"],
        tri1["ali"], lda_mllt.TrainLdaMlltOptions(**LDA_OPTS))
    assert tW.shape == jW.shape == (20, 66)
    assert rel(tW, jW) <= 1e-4
    assert_systems_match(tsys2, jsys2)
    assert tsys2.am.num_gauss() == jsys2.am.num_gauss()
    for u in jfeats:
        assert rel(tfeats[u], jfeats[u]) <= 1e-4


def test_train_sat_matches_jax(tri1):
    jsys3, jW = jlm.train_sat(
        tri1["jsys"].lang, tri1["feats"], tri1["texts"], tri1["utt2spk"],
        tri1["jsys"], tri1["ali"], jlm.TrainSatOptions(**SAT_OPTS))
    tsys3, tW = lda_mllt.train_sat(
        tri1["tsys"].lang, tri1["feats"], tri1["texts"], tri1["utt2spk"],
        tri1["tsys"], tri1["ali"], lda_mllt.TrainSatOptions(**SAT_OPTS))
    assert sorted(tW) == sorted(jW) == ["spk0", "spk1", "spk2"]
    for spk in jW:
        assert rel(tW[spk], jW[spk]) <= 1e-4
        assert not np.allclose(jW[spk], lda_mllt._identity(13))
    assert_systems_match(tsys3, jsys3)
    np.testing.assert_array_equal(
        lda_mllt.adapt_all(tri1["feats"], tri1["utt2spk"], tW, "cpu")["tr00"],
        lda_mllt.transform_all({"tr00": tri1["feats"]["tr00"]},
                               tW[tri1["utt2spk"]["tr00"]], "cpu")["tr00"])


# --------------------------------------------------------------------------
# the tools

@pytest.fixture(scope="module")
def files(tri1):
    """The tools' inputs in tri1's directory: spliced features, the
    alignments and their posteriors, spk2utt, and the JAX tools' own
    LDA, MLLT and fMLLR files that later tools read."""
    root = tri1["root"]
    d = str(root / "tools")
    os.makedirs(d, exist_ok=True)
    with JWriter("matrix", f"ark:{d}/spliced.ark") as w:
        for u, f in tri1["feats"].items():
            w.write(u, splice_frames(f, 2, 2))
    with JWriter("int-vector", f"ark:{d}/ali.ark") as w:
        for u, a in tri1["ali"].items():
            w.write(u, a)
    spk2utt = {}
    for u, s in tri1["utt2spk"].items():
        spk2utt.setdefault(s, []).append(u)
    with open(f"{d}/spk2utt", "w") as f:
        for s, us in spk2utt.items():
            f.write(f"{s} {' '.join(us)}\n")
    f = dict(d=d, mdl=f"{root}/exp/tri1/final.mdl",
             feats=f"ark:{root}/train/feats.ark",
             spliced=f"ark:{d}/spliced.ark", ali=f"ark:{d}/ali.ark",
             post=f"ark:{d}/post.ark", spk2utt=f"ark:{d}/spk2utt",
             utt2spk=f"ark:{root}/train/utt2spk")
    run_jax("ali-to-post", f["ali"], f["post"])
    run_jax("acc-lda", f["mdl"], f["spliced"], f["ali"], f"{d}/j.lda.acc")
    run_jax("est-lda", "--dim=20", f"{d}/j.lda.mat", f"{d}/j.lda.acc")
    run_jax("gmm-acc-mllt", f["mdl"], f["feats"], f["post"],
            f"{d}/j.mllt.acc")
    run_jax("est-mllt", f"{d}/j.mllt.mat", f"{d}/j.mllt.acc")
    run_jax("gmm-est-fmllr", f"--spk2utt={f['spk2utt']}", f["mdl"],
            f["feats"], f["post"], f"ark:{d}/j.fmllr.ark")
    W = archive(f"ark:{d}/j.fmllr.ark")["spk1"]
    jkio.write_kaldi_object(lambda s, b: jiof.write_matrix(s, b, W),
                            f"{d}/w.mat")
    return f


def run_jax(tool, *args):
    with contextlib.redirect_stdout(sys.stderr):
        assert jget(tool)([tool, *map(str, args)]) == 0, tool


def run_port(tool, *args):
    return get_tool(tool)([tool, *map(str, args)])


def matrix(path):
    return jkio.read_kaldi_object(jiof.read_matrix, path)


def mllt_acc(path):
    """(beta, G) of gmm-acc-mllt's <MlltAccs> file."""
    with jkio.input_stream(path) as f:
        b = jiof.init_input_stream(f)
        jiof.expect_token(f, b, "<MlltAccs>")
        beta = jiof.read_double(f, b)
        dim = jiof.read_int32(f, b)
        G = np.stack([jiof.read_matrix(f, b) for _ in range(dim)])
        jiof.expect_token(f, b, "</MlltAccs>")
    return beta, G


def archive(spec):
    return dict(JReader("matrix", spec))


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


TOOL_CASES = ["acc-lda", "est-lda", "transform-feats", "gmm-acc-mllt",
              "est-mllt", "compose-transforms", "gmm-est-fmllr",
              "gmm-transform-means"]


@pytest.mark.parametrize("tool", TOOL_CASES)
def test_tool_matches_jax(tool, files):
    f, d = files, files["d"]
    if tool == "acc-lda":
        assert run_port(tool, "--use-gpu=no", f["mdl"], f["spliced"],
                        f["ali"], f"{d}/t.lda.acc") == 0
        t = jkio.read_kaldi_object(JLda.read, f"{d}/t.lda.acc")
        j = jkio.read_kaldi_object(JLda.read, f"{d}/j.lda.acc")
        for name in ("zero_acc", "first_acc", "total_second_acc"):
            assert rel(getattr(t, name), getattr(j, name)) <= 1e-9
        with pytest.raises(NotImplementedError, match="rand-prune"):
            run_port(tool, "--rand-prune=0.1", "--use-gpu=no", f["mdl"],
                     f["spliced"], f["ali"], f"{d}/x.acc")
    elif tool == "est-lda":
        assert run_port(tool, "--dim=20", f"{d}/t.lda.mat",
                        f"{d}/j.lda.acc") == 0
        assert read_bytes(f"{d}/t.lda.mat") == read_bytes(f"{d}/j.lda.mat")
        with pytest.raises(NotImplementedError, match="allow-large-dim"):
            run_port(tool, "--allow-large-dim=true", f"{d}/x.mat",
                     f"{d}/j.lda.acc")
    elif tool == "transform-feats":
        for mat, feats in ((f"{d}/j.lda.mat", f["spliced"]),
                           (f"{d}/j.mllt.mat", f["feats"])):
            assert run_port(tool, "--use-gpu=no", mat, feats,
                            f"ark:{d}/t.tf.ark") == 0
            run_jax(tool, mat, feats, f"ark:{d}/j.tf.ark")
            t, j = archive(f"ark:{d}/t.tf.ark"), archive(f"ark:{d}/j.tf.ark")
            assert sorted(t) == sorted(j)
            for u in j:
                assert t[u].dtype == j[u].dtype and rel(t[u], j[u]) <= 1e-6
        # per-speaker transforms through --utt2spk
        args = (f"--utt2spk={f['utt2spk']}", f"ark:{d}/j.fmllr.ark",
                f["feats"])
        assert run_port(tool, "--use-gpu=no", *args,
                        f"ark:{d}/t.tf.ark") == 0
        run_jax(tool, *args, f"ark:{d}/j.tf.ark")
        t, j = archive(f"ark:{d}/t.tf.ark"), archive(f"ark:{d}/j.tf.ark")
        assert sorted(t) == sorted(j) and len(j) == 14
        for u in j:
            assert rel(t[u], j[u]) <= 1e-6
    elif tool == "gmm-acc-mllt":
        assert run_port(tool, "--use-gpu=no", f["mdl"], f["feats"],
                        f["post"], f"{d}/t.mllt.acc") == 0
        (tb, tG), (jb, jG) = (mllt_acc(f"{d}/{w}.mllt.acc")
                              for w in ("t", "j"))
        assert abs(tb - jb) <= 1e-9 * jb and rel(tG, jG) <= 1e-9
        run_port("est-mllt", f"{d}/t.from_t.mat", f"{d}/t.mllt.acc")
        assert rel(matrix(f"{d}/t.from_t.mat"),
                   matrix(f"{d}/j.mllt.mat")) <= 1e-6
    elif tool == "est-mllt":
        assert run_port(tool, f"{d}/t.mllt.mat", f"{d}/j.mllt.acc",
                        f"{d}/j.mllt.acc") == 0
        run_jax(tool, f"{d}/j2.mllt.mat", f"{d}/j.mllt.acc",
                f"{d}/j.mllt.acc")
        assert read_bytes(f"{d}/t.mllt.mat") == read_bytes(f"{d}/j2.mllt.mat")
    elif tool == "compose-transforms":
        for a, b, extra in ((f"{d}/j.mllt.mat", f"{d}/w.mat", ()),
                            (f"{d}/w.mat", f"{d}/w.mat", ()),
                            (f"{d}/w.mat", f"{d}/w.mat",
                             ("--b-is-affine=true",))):
            assert run_port(tool, *extra, a, b, f"{d}/t.c.mat") == 0
            run_jax(tool, *extra, a, b, f"{d}/j.c.mat")
            assert read_bytes(f"{d}/t.c.mat") == read_bytes(f"{d}/j.c.mat")
        assert run_port(tool, f"{d}/j.lda.mat", f"{d}/w.mat",
                        f"{d}/t.c.mat") == 1
    elif tool == "gmm-est-fmllr":
        for extra in ((f"--spk2utt={f['spk2utt']}",), ()):
            assert run_port(tool, "--use-gpu=no", *extra, f["mdl"],
                            f["feats"], f["post"], f"ark:{d}/t.f.ark") == 0
            run_jax(tool, *extra, f["mdl"], f["feats"], f["post"],
                    f"ark:{d}/j.f.ark")
            t, j = archive(f"ark:{d}/t.f.ark"), archive(f"ark:{d}/j.f.ark")
            assert list(t) == list(j) and len(j) == (3 if extra else 14)
            for k in j:
                assert rel(t[k], j[k]) <= 1e-6
    elif tool == "gmm-transform-means":
        for mat in (f"{d}/j.mllt.mat", f"{d}/w.mat"):
            assert run_port(tool, mat, f["mdl"], f"{d}/t.mdl") == 0
            run_jax(tool, mat, f["mdl"], f"{d}/j.mdl")
            assert read_bytes(f"{d}/t.mdl") == read_bytes(f"{d}/j.mdl")
