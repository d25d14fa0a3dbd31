"""Port parity: the decoding-graph build (`fstext/ops.py`
`minimize_encoded`, `decoder/graph.py` `make_decoding_graph`, the
mkgraph.sh pipeline) and gmm-latgen-faster (`cli/gmm_tools.py`) against
the JAX package's, on the CPU: minimized FSTs and HCLGs with the same
states, arcs and labels and weights within 1e-5, for a monophone and a
triphone system of the generic recipe's corpus; lattices of the same
structure with weights within 1e-5 relative, the same best paths and no
determinization fallback."""

import json
import re

import numpy as np
import pytest

from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread
from kaldi_tpu.cli.gmm_tools import write_am_gmm as jwrite_am
from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.fstext import ops as jops
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import LatticeWeight as JLw
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu.fstext.openfst_io import write_fst as jwrite_fst
from kaldi_tpu.lm import arpa as jarpa
from kaldi_tpu.recipes import deltas as jdeltas
from kaldi_tpu.recipes import mono as jmono
from kaldi_tpu.tree.context_dep import ContextDependency as JCd
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm as tread
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.fstext import ops as tops
from kaldi_tpu_torch.fstext.fst import Arc as TArc
from kaldi_tpu_torch.fstext.fst import LatticeWeight as TLw
from kaldi_tpu_torch.fstext.fst import VectorFst as TFst
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
from kaldi_tpu_torch.lm import arpa as tarpa
from kaldi_tpu_torch.recipes.template_corpus import ARPA
from kaldi_tpu_torch.tree.context_dep import ContextDependency as TCd
from kaldi_tpu_torch.util import kaldi_io as tio
from kaldi_tpu_torch.util.table import SequentialTableReader

from jax_native_private import private_jax_native_build  # noqa: F401
from template_stages import jax_stage2, run

LEXICON = {"YES": [["Y"]], "NO": [["N"]], "HEY": [["H", "EY"]]}
WORDS = {"HEY": 1, "NO": 2, "YES": 3}


def _arcs(fst):
    return [(s, a.ilabel, a.olabel, a.nextstate, a.weight)
            for s in range(fst.num_states) for a in fst.arcs[s]]


def _flat(w):
    return list(w) if isinstance(w, tuple) else [w]


def assert_same_fst(t, j, rtol=1e-5, atol=1e-5):
    assert (t.num_states, t.start) == (j.num_states, j.start)
    ta, ja = _arcs(t), _arcs(j)
    assert [a[:4] for a in ta] == [a[:4] for a in ja]
    np.testing.assert_allclose([_flat(a[4]) for a in ta],
                               [_flat(a[4]) for a in ja], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose([_flat(w) for w in t.finals],
                               [_flat(w) for w in j.finals], rtol=rtol,
                               atol=atol)


def _random_det(seed, lattice=False, n=12):
    """The same random deterministic FST (an acceptor-like ilabel set a
    state, with mergeable tails) in both packages."""
    rng = np.random.default_rng(seed)
    out = (TFst(TLw if lattice else None) if lattice else TFst(),
           JFst(JLw) if lattice else JFst())
    for f in out:
        f.add_states(n)
        f.set_start(0)
    for s in range(n - 1):
        for il in rng.choice(np.arange(1, 6), int(rng.integers(1, 4)),
                             replace=False):
            ns = int(rng.integers(s + 1, n))
            w = float(rng.integers(0, 3))
            w = (w, float(rng.integers(0, 2))) if lattice else w
            out[0].add_arc(s, TArc(int(il), int(il) % 3, w, ns))
            out[1].add_arc(s, JArc(int(il), int(il) % 3, w, ns))
    for f in out:
        f.finals[n - 1] = (0.0, 0.0) if lattice else 0.0
        f.finals[n - 2] = (1.0, 0.0) if lattice else 1.0
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("lattice", [False, True])
def test_minimize_encoded_matches(seed, lattice):
    t, j = _random_det(seed, lattice)
    assert_same_fst(tops.minimize_encoded(t), jops.minimize_encoded(j),
                    rtol=0, atol=0)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """The JAX tools' mono system (2.mdl, tree), a small tri1 trained from
    it by the JAX package's train_deltas, and G from the recipe's ARPA."""
    root = jax_stage2(tmp_path_factory.mktemp("mkgraph"))
    feats = dict(SequentialTableReader("matrix",
                                       f"ark:{root}/train/feats.ark"))
    ali = {k: list(v) for k, v in SequentialTableReader(
        "int-vector", f"ark:{root}/ali1.ark")}
    texts = {}
    with open(root / "train" / "text") as f:
        for line in f:
            utt, *words = line.split()
            texts[utt] = words
    lang = jgraph.Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
    tm, am = jread(str(root / "2.mdl"))
    lang.topo = tm.topo
    tree = jio.read_kaldi_object(JCd.read, str(root / "tree"))
    tri = jdeltas.train_deltas(
        lang, feats, texts, jmono.MonoSystem(lang, tree, tm, am), ali,
        jdeltas.TrainDeltasOptions(num_iters=4, max_iter_inc=2,
                                   totgauss=50, num_leaves=20,
                                   realign_iters=(2,), tree_min_gain=5.0))
    jwrite_am(str(root / "tri.mdl"), tri.tm, tri.am)
    jio.write_kaldi_object(tri.tree.write, str(root / "tri.tree"))
    with open(root / "G.fst", "wb") as f:
        jwrite_fst(f, jarpa.arpa_to_fst(jarpa.parse_arpa(ARPA), WORDS))
    return root


def _graphs(root, which):
    mdl, tree = {"mono": ("2.mdl", "tree"),
                 "tri": ("tri.mdl", "tri.tree")}[which]
    out = []
    for lang_mod, read, cd, io_ in (
            (tgraph, lambda p: tread(p, device="cpu"), TCd, tio),
            (jgraph, jread, JCd, jio)):
        lang = lang_mod.Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
        tm, _ = read(str(root / mdl))
        lang.topo = tm.topo
        tr = io_.read_kaldi_object(cd.read, str(root / tree))
        out.append((lang, tr, tm))
    return out


@pytest.mark.parametrize("which", ["mono", "tri"])
@pytest.mark.parametrize("scales", [(1.0, 0.1), (1.0, 1.0)])
def test_make_decoding_graph_matches(systems, which, scales):
    (tl, ttr, ttm), (jl, jtr, jtm) = _graphs(systems, which)
    g = read_fst_file(str(systems / "G.fst"))
    from kaldi_tpu.fstext.openfst_io import read_fst_file as jread_fst
    jg = jread_fst(str(systems / "G.fst"))
    t = tgraph.make_decoding_graph(tl, g, ttr, ttm, *scales)
    j = jgraph.make_decoding_graph(jl, jg, jtr, jtm, *scales)
    assert t.num_states > 50
    assert_same_fst(t, j)


def _lattices(path):
    return dict(SequentialTableReader(LatticeHolder(), f"ark:{path}"))


def _latgen(root, tmp_path, opts, jax_opts=()):
    """HCLG.fst of the tri system (the port's build), then both packages'
    gmm-latgen-faster on the test features (JAX's with jax_opts too)."""
    (tl, ttr, ttm), _ = _graphs(root, "tri")
    hclg = tgraph.make_decoding_graph(
        tl, read_fst_file(str(root / "G.fst")), ttr, ttm)
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    with open(tmp_path / "HCLG.fst", "wb") as f:
        write_fst(f, hclg)
    for side in ("jax", "torch"):
        extra = list(jax_opts) if side == "jax" else []
        assert run(side, "gmm-latgen-faster", "--acoustic-scale=0.1", *opts,
                   *extra,
                   root / "tri.mdl", tmp_path / "HCLG.fst",
                   f"ark:{root}/test/feats.ark",
                   f"ark:{tmp_path}/{side}.lat",
                   f"ark,t:{tmp_path}/{side}.words",
                   f"ark,t:{tmp_path}/{side}.ali") == 0


def _jax_scores(jam):
    """A stand-in for the port's AmDiagGmm.log_likes_device that returns
    the JAX package's loglikes of the same features."""
    import torch

    def scores(self, feats):
        return torch.from_numpy(np.asarray(jam.log_likes_batch(
            feats.cpu().numpy()))).to(feats.device)
    return scores


# the recipe's decode (beam 16, lattice beam 6) and a narrower one, with
# the periodic link pruning off: the port's pruning is upstream's, not the
# reference's (tests/test_torch_lattice_decoder.py
# test_reference_pruning_fault), so the lattices are held equal where
# neither prunes, and within the lattice beam where both do
LATGEN_OPTS = [["--beam=16", "--lattice-beam=6", "--prune-interval=0"],
               ["--beam=16", "--lattice-beam=6", "--prune-interval=0",
                "--determinize-lattice=false"],
               ["--beam=10", "--lattice-beam=4", "--max-active=50",
                "--prune-interval=0"]]


@pytest.mark.parametrize("opts", LATGEN_OPTS)
def test_gmm_latgen_faster_matches_on_the_same_loglikes(
        systems, tmp_path, capfd, monkeypatch, opts):
    """With the port's GMM scoring given the JAX package's loglikes, the
    search and the determinization see the same input: equal lattices."""
    from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
    _, jam = jread(str(systems / "tri.mdl"))
    monkeypatch.setattr(AmDiagGmm, "log_likes_device", _jax_scores(jam))
    _latgen(systems, tmp_path, opts)
    stats = json.loads(re.search(r"gmm-latgen-faster stats (\{.*\})",
                                 capfd.readouterr().err).group(1))
    assert stats["utterances"] == 2 and stats["det_fallbacks"] == 0
    assert stats["kernel_launches"] == {
        "block_chain_step": 0, "block_chain_lattice_step": 0,
        "viterbi_relax": 0}
    a, b = _lattices(tmp_path / "torch.lat"), _lattices(tmp_path / "jax.lat")
    assert sorted(a) == sorted(b)
    for k in b:
        assert_same_fst(a[k], b[k], rtol=1e-5, atol=1e-5)
    for name in ("words", "ali"):
        assert (tmp_path / f"torch.{name}").read_text() == \
            (tmp_path / f"jax.{name}").read_text()


def test_gmm_latgen_faster_pruned_lattices_match(systems, tmp_path,
                                                 monkeypatch):
    """The recipe's options with the port's link pruning on, against
    JAX's without its faulty one, on the same loglikes: the same arcs on
    the paths within the lattice beam."""
    from kaldi_tpu.lat.functions import lattice_prune as jprune
    from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
    from kaldi_tpu_torch.lat.functions import lattice_prune as tprune
    from test_torch_lattice_decoder import relabeled
    _, jam = jread(str(systems / "tri.mdl"))
    monkeypatch.setattr(AmDiagGmm, "log_likes_device", _jax_scores(jam))
    _latgen(systems, tmp_path, ["--beam=16", "--lattice-beam=6",
                                "--determinize-lattice=false"],
            jax_opts=["--prune-interval=0"])
    a, b = _lattices(tmp_path / "torch.lat"), _lattices(tmp_path / "jax.lat")
    for k in b:
        assert relabeled(tprune(a[k], 6.0)) == relabeled(jprune(b[k], 6.0))


def test_gmm_latgen_faster_best_paths_match(systems, tmp_path):
    """On its own loglikes (within 1e-4 of JAX's, tests/test_torch_gmm.py)
    the port's lattices near the beams may keep other tokens; the best
    paths and their costs agree."""
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    _latgen(systems, tmp_path, ["--beam=16", "--lattice-beam=6"])
    a, b = _lattices(tmp_path / "torch.lat"), _lattices(tmp_path / "jax.lat")
    for k in b:
        ta, tw, tc = lattice_best_path(a[k])
        ja, jw, jc = lattice_best_path(b[k])
        assert (ta, tw) == (ja, jw)
        assert abs(tc - jc) <= 1e-4 * abs(jc)
    for name in ("words", "ali"):
        assert (tmp_path / f"torch.{name}").read_text() == \
            (tmp_path / f"jax.{name}").read_text()
