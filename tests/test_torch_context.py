"""Port parity: the context expansion LG -> CLG (`fstext/context.py`) and
the triphone training graphs it opens (`decoder/graph.py`
`TrainingGraphCompiler` with a context-dependent tree), against the JAX
package's, on the CPU: the same states, arcs, labels and weights, and
the same ilabel_info."""

import numpy as np
import pytest

from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.fstext import context as jctx
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.tree import build_tree as jbt
from kaldi_tpu.tree.clusterable import GaussClusterable as JGc
from kaldi_tpu.tree.context_dep import ContextDependency as JCd
from kaldi_tpu.tree.event_map import PDF_CLASS_KEY
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.fstext import context as tctx
from kaldi_tpu_torch.fstext.fst import Arc as TArc
from kaldi_tpu_torch.fstext.fst import VectorFst as TFst
from kaldi_tpu_torch.hmm.transition_model import TransitionModel as TTm
from kaldi_tpu_torch.tree.context_dep import ContextDependency as TCd
from kaldi_tpu_torch.util import kaldi_io as tio

LEXICON = {"YES": [["Y"]], "NO": [["N"]], "HEY": [["H", "EY"]],
           "HAY": [["H", "EY"]], "SAY": [["S", "EY"], ["S", "EH"]]}


def _arcs(fst):
    return [(s, a.ilabel, a.olabel, a.nextstate, a.weight)
            for s in range(fst.num_states) for a in fst.arcs[s]]


def assert_same_fst(t, j, tol=0.0):
    assert (t.num_states, t.start) == (j.num_states, j.start)
    ta, ja = _arcs(t), _arcs(j)
    assert [a[:4] for a in ta] == [a[:4] for a in ja]
    np.testing.assert_allclose([a[4] for a in ta], [a[4] for a in ja],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(t.finals, j.finals, rtol=tol, atol=tol)


def _random_lg(seed, n_states=9, n_phones=6, disambig=(8, 9)):
    """The same random phone-input FST in both packages (epsilon and
    disambiguation inputs included, several finals)."""
    rng = np.random.default_rng(seed)
    fsts = (TFst(), JFst())
    for f in fsts:
        f.add_states(n_states)
        f.set_start(0)
    labels = list(range(n_phones + 1)) + list(disambig)
    for s in range(n_states):
        for _ in range(int(rng.integers(1, 4))):
            il = int(rng.choice(labels))
            ol = int(rng.integers(0, 5))
            w = float(np.round(rng.uniform(0, 3), 3))
            ns = int(rng.integers(0, n_states))
            fsts[0].add_arc(s, TArc(il, ol, w, ns))
            fsts[1].add_arc(s, JArc(il, ol, w, ns))
    for s in rng.choice(n_states, 3, replace=False):
        w = float(np.round(rng.uniform(0, 1), 3))
        fsts[0].finals[int(s)] = w
        fsts[1].finals[int(s)] = w
    return fsts


def _jax_with_disambig_entries(j, N, P, disambig):
    """JAX's (CLG, ilabel_info) as upstream's context FST labels the
    disambiguation symbols: entry (-d,) for each d, in place at N == 1,
    appended after the windows at N > 1 with the CLG's disambiguation
    arcs relabelled to them (the port's repair, ROADMAP.md section 3).
    JAX's CLG keeps each symbol d on its arc, where d may also name a
    window, so JAX is run with the symbols moved out of the window range
    first and the arcs are told apart by that label."""
    cj, ij = jctx.context_expand(j, N, P, disambig_syms=disambig)
    if not disambig:
        return cj, ij
    if N == 1:
        return cj, [(-w[0],) if w and w[0] in disambig else w for w in ij]
    far = {d: 10 ** 6 + d for d in disambig}
    jf = j.copy()
    for arcs in jf.arcs:
        for a in arcs:
            a.ilabel = far.get(a.ilabel, a.ilabel)
    cj, ij = jctx.context_expand(jf, N, P, disambig_syms=list(far.values()))
    index = {far[d]: len(ij) + k for k, d in enumerate(disambig)}
    for arcs in cj.arcs:
        for a in arcs:
            a.ilabel = index.get(a.ilabel, a.ilabel)
    return cj, list(ij) + [(-d,) for d in disambig]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("N,P", [(3, 1), (2, 1), (2, 0), (3, 2), (1, 0)])
def test_context_expand_matches(seed, N, P):
    t, j = _random_lg(seed)
    for disambig in ((), (8, 9)):
        ct, it = tctx.context_expand(t, N, P, disambig_syms=disambig)
        cj, ij = _jax_with_disambig_entries(j, N, P, disambig)
        assert it == ij
        assert_same_fst(ct, cj)


def test_context_expand_rejects_a_bad_window():
    t, _ = _random_lg(0)
    with pytest.raises(Exception, match="central position"):
        tctx.context_expand(t, 2, 2)


@pytest.fixture(scope="module")
def triphone(tmp_path_factory):
    """A triphone tree built by the JAX package from synthetic tree
    statistics over every window of the lexicon's phones, written and
    read by each package, and each package's Lang and TransitionModel."""
    jlang = jgraph.Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
    topo = jlang.make_topology()
    phones = sorted(jlang.phones.values())
    rng = np.random.default_rng(5)
    stats = {}
    for left in [0] + phones:
        for c in phones:
            for right in [0] + phones:
                for pc in range(topo.num_pdf_classes(c)):
                    g = JGc(3)
                    g.add_stats(rng.normal(size=3) + c + 0.3 * left, 4.0)
                    g.add_stats(rng.normal(size=3) - right, 3.0)
                    stats[tuple(sorted([(PDF_CLASS_KEY, pc), (0, left),
                                        (1, c), (2, right)]))] = g
    qs = jbt.cluster_phones(stats, phones, 1)
    questions = {k: qs for k in range(3)}
    questions[PDF_CLASS_KEY] = [[0], [0, 1], [0, 1, 2], [0, 1, 2, 3]]
    sil = jlang.phones["SIL"]
    roots = [([p], True, True) for p in phones if p != sil]
    roots.append(([sil], True, False))
    jtree = jbt.build_tree(stats, questions, roots, 3, 1,
                           jbt.BuildTreeOptions(max_leaves=40, min_gain=1.0),
                           topo=topo)
    path = str(tmp_path_factory.mktemp("tri") / "tree")
    jio.write_kaldi_object(jtree.write, path)
    ttree = tio.read_kaldi_object(TCd.read, path)
    jtree = jio.read_kaldi_object(JCd.read, path)
    tlang = tgraph.Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
    tlang.make_topology()
    assert ttree.context_width() == 3 and ttree.num_pdfs > 10
    return (tlang, ttree, TTm(tlang.topo, ttree),
            jlang, jtree, JTm(topo, jtree))


@pytest.mark.parametrize("words", [["YES"], ["HEY", "NO", "SAY"],
                                   ["SAY", "SAY", "HAY", "YES", "NO"]])
@pytest.mark.parametrize("scales", [(1.0, 0.1), (0.5, 1.0)])
def test_triphone_training_graph_matches(triphone, words, scales):
    tlang, ttree, ttm, jlang, jtree, jtm = triphone
    t = tgraph.TrainingGraphCompiler(ttm, ttree, tlang, *scales)
    j = jgraph.TrainingGraphCompiler(jtm, jtree, jlang, *scales)
    assert_same_fst(t.compile(words), j.compile(words), tol=1e-6)
    # the port's split form: a reused word graph expands the same way
    lg = t.word_graph(tlang.word_ids(words))
    assert_same_fst(t.expand(lg), j.compile(words), tol=1e-6)
