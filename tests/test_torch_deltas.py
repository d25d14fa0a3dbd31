"""Port parity: triphone training (`recipes/deltas.py`), the tree
statistics it builds on (`tree/build_tree.py` `accumulate_tree_stats`,
the BTS files of `tree/clusterable.py`) and the tree tools
(acc-tree-stats, sum-tree-stats, cluster-phones, build-tree) and
convert-ali (`cli/tree_tools.py`), against the JAX package's, on the
CPU, from the mono system that the JAX tools trained on 8 utterances of
the generic recipe's corpus: statistics, trees and converted alignments
byte for byte; `train_deltas` to the same tree and, where no Viterbi tie
flips, to the same model within 1e-4."""

import numpy as np
import pytest

from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread
from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.recipes import deltas as jdeltas
from kaldi_tpu.recipes import mono as jmono
from kaldi_tpu.tree import build_tree as jbt
from kaldi_tpu.tree.context_dep import ContextDependency as JCd
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm as tread
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.recipes import deltas as tdeltas
from kaldi_tpu_torch.recipes import mono as tmono
from kaldi_tpu_torch.tree import build_tree as tbt
from kaldi_tpu_torch.tree.context_dep import ContextDependency as TCd
from kaldi_tpu_torch.util import kaldi_io as tio
from kaldi_tpu_torch.util.table import SequentialTableReader

from jax_native_private import private_jax_native_build  # noqa: F401
from template_stages import jax_stage2, run

LEXICON = {"YES": [["Y"]], "NO": [["N"]], "HEY": [["H", "EY"]]}


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    root = jax_stage2(tmp_path_factory.mktemp("deltas"))
    feats = dict(SequentialTableReader("matrix",
                                       f"ark:{root}/train/feats.ark"))
    ali = {k: list(v) for k, v in SequentialTableReader(
        "int-vector", f"ark:{root}/ali1.ark")}
    texts = {}
    with open(root / "train" / "text") as f:
        for line in f:
            utt, *words = line.split()
            texts[utt] = words
    return root, feats, ali, texts


def _systems(root):
    """Each package's MonoSystem over the JAX tools' 2.mdl and tree."""
    out = []
    for lang_mod, read, cd, io_, mono in (
            (tgraph, lambda p: tread(p, device="cpu"), TCd, tio, tmono),
            (jgraph, jread, JCd, jio, jmono)):
        lang = lang_mod.Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
        tm, am = read(str(root / "2.mdl"))
        lang.topo = tm.topo
        tree = io_.read_kaldi_object(cd.read, str(root / "tree"))
        out.append(mono.MonoSystem(lang, tree, tm, am))
    return out


@pytest.mark.parametrize("N,P,ci", [(3, 1, True), (3, 1, False),
                                    (2, 1, True), (1, 0, False)])
def test_accumulate_tree_stats_matches(stage2, N, P, ci):
    root, feats, ali, _ = stage2
    t, j = _systems(root)
    sil = [t.lang.phones["SIL"]] if ci else []
    ts, js = {}, {}
    for u in sorted(ali):
        tbt.accumulate_tree_stats(t.tm, t.tm.topo, feats[u], ali[u], N, P,
                                  ts, ci_phones=sil)
        jbt.accumulate_tree_stats(j.tm, j.tm.topo, feats[u], ali[u], N, P,
                                  js, ci_phones=sil)
    assert list(ts) == list(js)
    for e in js:
        assert ts[e].count == js[e].count
        np.testing.assert_array_equal(ts[e].stats_sum, js[e].stats_sum)
        np.testing.assert_array_equal(ts[e].stats_sumsq, js[e].stats_sumsq)


def _tool_bytes(tmp_path, tool, args, out):
    got = []
    for side in ("jax", "torch"):
        o = tmp_path / f"{side}_{out}"
        a = [str(x).format(out=o, tmp=tmp_path) for x in args]
        assert run(side, tool, *a) == 0
        got.append(o.read_bytes())
    return got


@pytest.fixture(scope="module")
def tree_files(stage2, tmp_path_factory):
    """The JAX tools' tree statistics (two halves and their sum), phone
    sets, questions, roots and tree."""
    root, feats, ali, _ = stage2
    d = tmp_path_factory.mktemp("tree_files")
    keys = sorted(ali)
    for i, part in enumerate((keys[:4], keys[4:])):
        with open(d / f"utts{i}", "w") as f:
            f.write("\n".join(part) + "\n")
        from kaldi_tpu_torch.util.table import TableWriter
        with TableWriter("int-vector", f"ark:{d}/ali{i}.ark") as w:
            for k in part:
                w.write(k, ali[k])
        assert run("jax", "acc-tree-stats", "--ci-phones=4", root / "2.mdl",
                   f"ark:{root}/train/feats.ark", f"ark:{d}/ali{i}.ark",
                   d / f"{i}.treeacc") == 0
    assert run("jax", "sum-tree-stats", d / "treeacc", d / "0.treeacc",
               d / "1.treeacc") == 0
    (d / "sets").write_text("1\n2\n3\n5\n")
    assert run("jax", "cluster-phones", d / "treeacc", d / "sets",
               d / "questions") == 0
    (d / "roots").write_text("shared split 1\nshared split 2\n"
                             "shared split 3\nshared split 5\n"
                             "shared not-split 4\n")
    assert run("jax", "build-tree", "--max-leaves=20", "--thresh=5",
               d / "treeacc", d / "roots", d / "questions",
               root / "lang" / "topo", d / "tree") == 0
    # the triphone model convert-ali maps onto (as gmm-init-model makes it)
    from kaldi_tpu.base import io_funcs as iof
    from kaldi_tpu.cli.gmm_tools import write_am_gmm
    from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
    from kaldi_tpu.tree.clusterable import read_build_tree_stats
    jtree = jio.read_kaldi_object(JCd.read, str(d / "tree"))
    jtm = JTm(jread(str(root / "2.mdl"))[0].topo, jtree)
    with open(d / "treeacc", "rb") as f:
        stats = read_build_tree_stats(f, iof.init_input_stream(f))
    write_am_gmm(str(d / "tri.mdl"), jtm,
                 jdeltas.init_model_from_tree_stats(jtree, jtm, stats, 13))
    return d


TREE_TOOLS = {
    "acc-tree-stats": (["--ci-phones=4", "{root}/2.mdl",
                        "ark:{root}/train/feats.ark", "ark:{root}/ali1.ark",
                        "{out}"], "treeacc"),
    "sum-tree-stats": (["{out}", "{d}/0.treeacc", "{d}/1.treeacc"],
                       "sum.treeacc"),
    "cluster-phones": (["{d}/treeacc", "{d}/sets", "{out}"], "questions"),
    "build-tree": (["--max-leaves=20", "--thresh=5", "{d}/treeacc",
                    "{d}/roots", "{d}/questions", "{root}/lang/topo",
                    "{out}"], "tree"),
    "convert-ali": (["{root}/2.mdl", "{d}/tri.mdl", "{d}/tree",
                     "ark:{root}/ali1.ark", "ark:{out}"], "ali.ark"),
}


@pytest.mark.parametrize("tool", sorted(TREE_TOOLS))
def test_tree_tool_bytes(stage2, tree_files, tmp_path, tool):
    root = stage2[0]
    args, out = TREE_TOOLS[tool]
    args = [str(a).replace("{root}", str(root)).replace(
        "{d}", str(tree_files)) for a in args]
    j, t = _tool_bytes(tmp_path, tool, args, out)
    assert t == j and len(t) > 0


def test_tree_stats_file_round_trip(tree_files, tmp_path):
    from kaldi_tpu_torch.cli.tree_tools import (_read_tree_stats,
                                                _write_tree_stats)
    stats = _read_tree_stats(str(tree_files / "treeacc"))
    assert len(stats) > 10
    _write_tree_stats(str(tmp_path / "again"), stats)
    assert (tmp_path / "again").read_bytes() == \
        (tree_files / "treeacc").read_bytes()


def test_convert_alignment_and_init_model_match(stage2, tree_files):
    root, feats, ali, _ = stage2
    t, j = _systems(root)
    ttree = tio.read_kaldi_object(TCd.read, str(tree_files / "tree"))
    jtree = jio.read_kaldi_object(JCd.read, str(tree_files / "tree"))
    from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel as TTm
    ttm, jtm = TTm(t.tm.topo, ttree), JTm(j.tm.topo, jtree)
    for u in sorted(ali):
        a = tdeltas.convert_alignment(ali[u], t.tm, ttm, ttree, t.tm.topo)
        b = jdeltas.convert_alignment(ali[u], j.tm, jtm, jtree, j.tm.topo)
        assert a == b and a is not None
    from kaldi_tpu_torch.cli.tree_tools import _read_tree_stats
    stats = _read_tree_stats(str(tree_files / "treeacc"))
    from kaldi_tpu.tree.clusterable import read_build_tree_stats
    from kaldi_tpu.base import io_funcs as iof
    with open(tree_files / "treeacc", "rb") as f:
        jstats = read_build_tree_stats(f, iof.init_input_stream(f))
    am_t = tdeltas.init_model_from_tree_stats(ttree, ttm, stats, 13,
                                              device="cpu")
    am_j = jdeltas.init_model_from_tree_stats(jtree, jtm, jstats, 13)
    for g, h in zip(am_t.densities, am_j.densities):
        np.testing.assert_array_equal(g.means_invvars, h.means_invvars)
        np.testing.assert_array_equal(g.gconsts, h.gconsts)


def test_cluster_thresh_raises():
    with pytest.raises(NotImplementedError, match="post-clustering"):
        tbt.build_tree({}, {}, [([1], True, True)], 3, 1,
                       tbt.BuildTreeOptions(cluster_thresh=10.0))


def test_train_deltas_matches(stage2):
    root, feats, ali, texts = stage2
    t, j = _systems(root)
    opts = dict(num_iters=5, max_iter_inc=3, totgauss=60, num_leaves=20,
                realign_iters=(3,), tree_min_gain=5.0)
    ts = tdeltas.train_deltas(t.lang, feats, texts, t, ali,
                              tdeltas.TrainDeltasOptions(**opts))
    js = jdeltas.train_deltas(j.lang, feats, texts, j, ali,
                              jdeltas.TrainDeltasOptions(**opts))
    import io
    from kaldi_tpu_torch.base import io_funcs as tiof
    a, b = io.BytesIO(), io.BytesIO()
    tiof.init_output_stream(a, True)
    tiof.init_output_stream(b, True)
    ts.tree.write(a, True)
    js.tree.write(b, True)
    assert a.getvalue() == b.getvalue()
    assert ts.am.num_pdfs == js.am.num_pdfs
    assert ts.am.num_gauss() == js.am.num_gauss()
    for g, h in zip(ts.am.densities, js.am.densities):
        np.testing.assert_allclose(g.means_invvars, h.means_invvars,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.weights, h.weights, rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(ts.tm.log_probs, js.tm.log_probs, rtol=1e-4)
