"""Port parity: the example types, holders and egs pipeline of
kaldi_tpu_torch (nnet3/egs.py, hmm/posterior.py) against the JAX
package's, on the CPU: every example type and holder written by one
package is read by the other and written back to the same bytes;
shuffle_egs draws the same order; merged_minibatches yields the same
batches in the same order (the leftover groups of drop_last=False in
dict-insertion order); and the plain egs and posterior tools' archives
(nnet3-get-egs, -copy-egs, -shuffle-egs, -merge-egs, -subset-egs,
ali-to-pdf, ali-to-post, post-to-pdf-post) are byte for byte the JAX
tools'."""

import numpy as np
import pytest

from kaldi_tpu.chain.graphs import PackedGraph as JGraph
from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.hmm import posterior as jpost
from kaldi_tpu.nnet3 import egs as jegs
from kaldi_tpu.util.table import TableWriter as JWriter
from kaldi_tpu_torch.chain.graphs import PackedGraph as PGraph
from kaldi_tpu_torch.cli import get_tool as port_tool
from kaldi_tpu_torch.hmm import posterior as ppost
from kaldi_tpu_torch.nnet3 import egs as pegs


def graph(rng, pkg_graph, S=6, A=11):
    ninf = -1e30
    initial = np.full(S, ninf, np.float32)
    initial[0] = 0.0
    final = np.full(S, ninf, np.float32)
    final[-1] = 0.0
    return pkg_graph(rng.integers(0, S, A).astype(np.int32),
                     rng.integers(0, S, A).astype(np.int32),
                     rng.integers(0, 9, A).astype(np.int32),
                     rng.normal(size=A).astype(np.float32), initial, final)


def values(kind, pkg):
    """One value of each holder's type, from a fixed seed."""
    rng = np.random.default_rng(7)
    g = graph(rng, JGraph if pkg == "jax" else PGraph)
    feats = rng.normal(size=(9, 4)).astype(np.float32)
    mod = jegs if pkg == "jax" else pegs
    if kind == "chain-eg":
        return mod.NnetChainExample(feats, g, 3, 2)
    if kind == "eg":
        return mod.NnetExample(feats, [[(1, 0.25), (4, 0.75)], [(2, 1.0)]],
                               2, 1, batch=3)
    if kind == "supervision":
        return g
    if kind == "posterior":
        return [[(3, 0.5), (7, 0.5)], [], [(1, 1.0)]]
    return [[(2, rng.normal(size=3).astype(np.float32))], []]


def holder(kind, pkg):
    mod = jegs if pkg == "jax" else pegs
    post = jpost if pkg == "jax" else ppost
    return {"chain-eg": mod.ChainExampleHolder,
            "eg": mod.ExampleHolder,
            "supervision": mod.SupervisionHolder,
            "posterior": post.PosteriorHolder,
            "gauss-post": post.GaussPostHolder}[kind]()


# every holder in binary mode; in text mode those whose text form reads
# back
CASES = [(k, True) for k in ("chain-eg", "eg", "supervision", "posterior",
                             "gauss-post")] + [("eg", False),
                                               ("posterior", False)]


@pytest.mark.parametrize("kind,binary", CASES)
def test_holders_round_trip_across_packages(tmp_path, kind, binary):
    """Each package writes the value; the archives are equal; each
    package reads the other's and writes it back to the same bytes."""
    from kaldi_tpu.util.table import SequentialTableReader as JR
    from kaldi_tpu_torch.util.table import SequentialTableReader as PR
    from kaldi_tpu_torch.util.table import TableWriter as PW
    spec = "ark" if binary else "ark,t"
    paths = {}
    for pkg, W in (("jax", JWriter), ("port", PW)):
        paths[pkg] = tmp_path / f"{pkg}.ark"
        with W(holder(kind, pkg), f"{spec}:{paths[pkg]}") as w:
            w.write("k1", values(kind, pkg))
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    for reader_pkg, R, W, src in (("port", PR, PW, "jax"),
                                  ("jax", JR, JWriter, "port")):
        (key, val), = list(R(holder(kind, reader_pkg), f"ark:{paths[src]}"))
        back = tmp_path / f"{reader_pkg}_back.ark"
        with W(holder(kind, reader_pkg), f"{spec}:{back}") as w:
            w.write(key, val)
        assert back.read_bytes() == paths[src].read_bytes()


def test_posterior_table_holder_names():
    """The "posterior" and "gauss-post" holder names of the table system
    are the port's holders now."""
    from kaldi_tpu_torch.util.table import _make_holder
    assert isinstance(_make_holder("posterior"), ppost.PosteriorHolder)
    assert isinstance(_make_holder("gauss-post"), ppost.GaussPostHolder)


def chain_egs_ark(path, n=23, seed=0):
    """n chain egs of three shapes (first, middle, last chunks) with
    numerators of two lengths, written by the port."""
    from kaldi_tpu_torch.util.table import TableWriter
    rng = np.random.default_rng(seed)
    with TableWriter(pegs.ChainExampleHolder(), f"ark:{path}") as w:
        for i in range(n):
            T = (10, 12, 11)[i % 3]
            S = 5 if i % 4 else 6
            w.write(f"u{i:03d}", pegs.NnetChainExample(
                rng.normal(size=(T, 3)).astype(np.float32),
                graph(rng, PGraph, S=S, A=S + 2), i % 3, 1))


@pytest.mark.parametrize("seed,buffer_size", [(0, 5000), (4, 5), (9, 1)])
def test_shuffle_egs_bytes_equal_jax(tmp_path, seed, buffer_size):
    chain_egs_ark(tmp_path / "egs.ark")
    out = {}
    for name, mod in (("jax", jegs), ("port", pegs)):
        n = mod.shuffle_egs(f"ark:{tmp_path}/egs.ark",
                            f"ark:{tmp_path}/{name}.ark", seed=seed,
                            buffer_size=buffer_size)
        assert n == 23
        out[name] = (tmp_path / f"{name}.ark").read_bytes()
    assert out["jax"] == out["port"]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("mb", [2, 4, 32])
def test_merged_minibatches_same_order(tmp_path, drop_last, mb):
    chain_egs_ark(tmp_path / "egs.ark")
    spec = f"ark:{tmp_path}/egs.ark"
    got = list(pegs.merged_minibatches(spec, mb, drop_last=drop_last))
    want = list(jegs.merged_minibatches(spec, mb, drop_last=drop_last))
    assert len(got) == len(want) and (got or drop_last)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["feats"], w["feats"])
        for a, b in zip(g["num_graphs"], w["num_graphs"]):
            np.testing.assert_array_equal(a, b)
        assert (g["left_context"], g["right_context"]) == \
            (w["left_context"], w["right_context"])


def test_merge_plain_egs_equals_jax():
    egs = {pkg: [values("eg", pkg) for _ in range(3)]
           for pkg in ("jax", "port")}
    j = jegs.merge_plain_egs(egs["jax"])
    p = pegs.merge_plain_egs(egs["port"])
    np.testing.assert_array_equal(p.feats, j.feats)
    assert (p.targets, p.left_context, p.right_context, p.batch) == \
        (j.targets, j.left_context, j.right_context, j.batch)


@pytest.fixture
def plain_inputs(tmp_path):
    """A GMM model (a transition model and one Gaussian a pdf),
    alignments over its transition-ids and features, written by the JAX
    package."""
    from kaldi_tpu.cli.gmm_tools import write_am_gmm
    from kaldi_tpu.gmm.am_diag_gmm import AmDiagGmm
    from kaldi_tpu.gmm.diag_gmm import DiagGmm
    from kaldi_tpu.hmm.topology import HmmTopology
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.tree import monophone_context_dependency
    phones = [1, 2, 3]
    topo = HmmTopology.three_state(phones, sil_phones=[1])
    tm = TransitionModel(topo, monophone_context_dependency(
        phones, {p: topo.num_pdf_classes(p) for p in phones}))
    am = AmDiagGmm()
    for _ in range(tm.num_pdfs):
        g = DiagGmm(1, 5)
        g.set_from_means_and_vars([1.0], np.zeros((1, 5)), np.ones((1, 5)))
        am.add_pdf(g)
    write_am_gmm(f"{tmp_path}/final.mdl", tm, am)
    rng = np.random.default_rng(3)
    with JWriter("int-vector", f"ark:{tmp_path}/ali.ark") as wa, \
            JWriter("matrix", f"ark:{tmp_path}/feats.ark") as wf:
        for i, T in enumerate((37, 20, 41)):
            wa.write(f"u{i}", rng.integers(1, tm.num_transition_ids + 1,
                                           size=T).astype(np.int32))
            wf.write(f"u{i}", rng.normal(size=(T, 5)).astype(np.float32))
    return tmp_path


def run_both(d, tool, *args):
    for name, get_tool in (("jax", jax_tool), ("port", port_tool)):
        (d / name).mkdir(exist_ok=True)
        argv = [tool] + [a.format(out=d / name, d=d) for a in args]
        assert get_tool(tool)(argv) == 0, (name, argv)


def test_alignment_and_posterior_tools_bytes_equal_jax(plain_inputs):
    """ali-to-pdf, ali-to-post (of the pdfs and of the transition-ids)
    and post-to-pdf-post: the same archives as the JAX tools', and the
    two routes to pdf posteriors agree."""
    d = plain_inputs
    run_both(d, "ali-to-pdf", "{d}/final.mdl", "ark:{d}/ali.ark",
             "ark:{out}/pdf.ark")
    run_both(d, "ali-to-post", "ark:{d}/jax/pdf.ark", "ark:{out}/post.ark")
    run_both(d, "ali-to-post", "ark:{d}/ali.ark", "ark:{out}/tid_post.ark")
    run_both(d, "post-to-pdf-post", "{d}/final.mdl",
             "ark:{d}/jax/tid_post.ark", "ark:{out}/pdf_post.ark")
    for name in ("pdf.ark", "post.ark", "tid_post.ark", "pdf_post.ark"):
        assert (d / "jax" / name).read_bytes() == \
            (d / "port" / name).read_bytes(), name
    assert (d / "port" / "post.ark").read_bytes() == \
        (d / "port" / "pdf_post.ark").read_bytes()


@pytest.mark.parametrize("tool,args,outs", [
    ("nnet3-copy-egs", [], ["c1.ark", "c2.ark", "c3.ark"]),
    ("nnet3-shuffle-egs", ["--srand=2"], ["shuf.ark"]),
    ("nnet3-shuffle-egs", ["--srand=5", "--buffer-size=3"], ["shuf3.ark"]),
    ("nnet3-merge-egs", ["--minibatch-size=3"], ["merged.ark"]),
    ("nnet3-subset-egs", ["--n=4", "--srand=1"], ["sub.ark"]),
])
def test_plain_egs_tools_bytes_equal_jax(plain_inputs, tool, args, outs):
    d = plain_inputs
    run_both(d, "ali-to-pdf", "{d}/final.mdl", "ark:{d}/ali.ark",
             "ark:{out}/pdf.ark")
    run_both(d, "ali-to-post", "ark:{d}/jax/pdf.ark", "ark:{out}/post.ark")
    run_both(d, "nnet3-get-egs", "--num-frames=6", "--left-context=2",
             "--right-context=3", "ark:{d}/feats.ark",
             "ark:{d}/jax/post.ark", "ark:{out}/egs.ark")
    assert (d / "jax" / "egs.ark").read_bytes() == \
        (d / "port" / "egs.ark").read_bytes()
    run_both(d, tool, *args, "ark:{d}/jax/egs.ark",
             *[f"ark:{{out}}/{o}" for o in outs])
    for o in outs:
        assert (d / "jax" / o).stat().st_size > 0
        assert (d / "jax" / o).read_bytes() == (d / "port" / o).read_bytes()
