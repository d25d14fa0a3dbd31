"""Port parity: decision-tree building and the Kaldi writers of
kaldi_tpu_torch against the JAX package's, on the CPU.

  - GaussClusterable: stats, objective and merge distance equal (float64,
    the same numpy operations);
  - cluster_phones: the same questions in the same order;
  - build_tree: from the same statistics the same tree, split for split
    (its binary and text bytes equal the JAX package's), and the
    transition model over it;
  - the writers (EventMap with NULL entries, ContextDependency,
    HmmTopology, TransitionModel, write_kaldi_object): bytes equal the
    JAX writers' in binary and text mode, and the committed
    flagship_ng.tm/.tree read and written back give the committed bytes.
"""

import io
import os

import numpy as np
import pytest

from kaldi_tpu.base import io_funcs as jiof
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.tree import build_tree as jbt
from kaldi_tpu.tree import event_map as jem
from kaldi_tpu.tree.clusterable import GaussClusterable as JGauss
from kaldi_tpu.tree.clusterable import sum_clusterables as j_sum
from kaldi_tpu.tree.context_dep import ContextDependency as JCtx
from kaldi_tpu.util import kaldi_io as jkio
from kaldi_tpu_torch.base import io_funcs as tiof
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree import build_tree as tbt
from kaldi_tpu_torch.tree import event_map as tem
from kaldi_tpu_torch.tree.clusterable import GaussClusterable, sum_clusterables
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.util import kaldi_io as tkio

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")
PHONES = list(range(1, 12))


def written(obj, binary: bool, init=None) -> bytes:
    """obj.write's bytes, after the binary marker."""
    f = io.BytesIO()
    (init or tiof.init_output_stream)(f, binary)
    obj.write(f, binary)
    return f.getvalue()


def window_stats(seed: int, n_windows: int, dim: int = 6):
    """The same windowed Gaussian stats in both packages' types: events
    ((-1, pdf_class), (0, left), (1, phone), (2, right)) over PHONES, a
    phone's frames drawn around its centre, moved a little by its
    context."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(max(PHONES) + 1, dim)) * 3
    j, t = {}, {}
    for _ in range(n_windows):
        c = int(rng.choice(PHONES))
        left, right = (int(x) for x in rng.integers(0, max(PHONES) + 1, 2))
        for pc in (0, 1):
            ev = tuple(sorted([(-1, pc), (0, left), (1, c), (2, right)]))
            if ev in j:
                continue
            n = int(rng.integers(1, 20)) if pc else 1
            f = (centres[c] + 0.1 * centres[left] + 0.05 * centres[right]
                 + rng.normal(size=(n, dim))).astype(np.float32)
            j[ev], t[ev] = JGauss(dim), GaussClusterable(dim)
            j[ev].accumulate(f)
            t[ev].accumulate(f)
    return j, t


def test_gauss_clusterable_matches():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(9, 5)), rng.normal(size=(4, 5)) + 1
    w = rng.uniform(0.1, 2, 4)
    ja, jb, ta, tb = JGauss(5), JGauss(5), GaussClusterable(5), \
        GaussClusterable(5)
    ja.accumulate(a)
    ta.accumulate(a)
    jb.accumulate(b, w)
    tb.accumulate(b, w)
    jb.add_stats(a[0], 0.5)
    tb.add_stats(a[0], 0.5)
    for j, t in ((ja, ta), (jb, tb), (ja.add(jb), ta.add(tb)),
                 (j_sum([ja, jb, ja]), sum_clusterables([ta, tb, ta]))):
        assert t.count == j.count
        np.testing.assert_array_equal(t.stats_sum, j.stats_sum)
        np.testing.assert_array_equal(t.stats_sumsq, j.stats_sumsq)
        assert t.objf() == j.objf()
        np.testing.assert_array_equal(t.mean(), j.mean())
        np.testing.assert_array_equal(t.var(), j.var())
    assert ta.distance(tb) == ja.distance(jb) >= 0


def test_cluster_phones_matches():
    j, t = window_stats(1, 200)
    assert tbt.cluster_phones(t, PHONES, 1) == jbt.cluster_phones(
        j, PHONES, 1)


@pytest.mark.parametrize("seed,n_windows,max_leaves,min_gain", [
    (2, 150, 40, 5.0), (3, 400, 120, 5.0), (4, 400, 1000, 60.0)])
def test_build_tree_matches(seed, n_windows, max_leaves, min_gain):
    """The same splits in the same order: the trees' bytes are equal, the
    transition models over them too, and every event maps to the same
    pdf."""
    j, t = window_stats(seed, n_windows)
    trees = []
    for mod, stats, topo_cls in ((jbt, j, JTopo), (tbt, t, HmmTopology)):
        q = mod.cluster_phones(stats, PHONES, 1)
        questions = {k: [[0]] + q for k in range(3)}
        questions[-1] = [[0], [1]]
        trees.append(mod.build_tree(
            stats, questions, [([p], True, True) for p in PHONES], 3, 1,
            mod.BuildTreeOptions(max_leaves=max_leaves, min_gain=min_gain),
            topo=topo_cls.chain_topology(PHONES)))
    jt, tt = trees
    assert tt.num_pdfs == jt.num_pdfs > len(PHONES)
    if max_leaves < 1000:
        assert tt.num_pdfs == max_leaves
    for binary in (True, False):
        assert written(tt, binary) == written(jt, binary, jiof.
                                              init_output_stream)
        assert written(TransitionModel(HmmTopology.chain_topology(PHONES),
                                       tt), binary) == \
            written(JTm(JTopo.chain_topology(PHONES), jt), binary,
                    jiof.init_output_stream)
    for ev in t:
        d = dict(ev)
        win = [d[0], d[1], d[2]]
        assert tt.compute(win, d[-1]) == jt.compute(win, d[-1])


def test_build_tree_root_without_stats():
    """A phone with no stats gets one pdf a pdf-class from the topology,
    as in the reference."""
    j, t = window_stats(5, 100)
    j = {e: s for e, s in j.items() if dict(e)[1] != 3}
    t = {e: s for e, s in t.items() if dict(e)[1] != 3}
    trees = [mod.build_tree(stats, {k: [[0], [1, 2, 3]] for k in range(3)},
                            [([p], True, True) for p in PHONES], 3, 1,
                            mod.BuildTreeOptions(max_leaves=30,
                                                 min_gain=1.0),
                            topo=topo.chain_topology(PHONES))
             for mod, stats, topo in ((jbt, j, JTopo), (tbt, t, HmmTopology))]
    assert written(trees[1], True) == written(trees[0], True,
                                              jiof.init_output_stream)


def test_event_map_writers_match():
    """CE, TE with NULL entries and SE records, binary and text."""
    def make(m):
        return m.TableEventMap(1, [
            None, m.ConstantEventMap(3),
            m.SplitEventMap(0, [5, 2, 2], m.ConstantEventMap(1),
                            m.TableEventMap(-1, [m.ConstantEventMap(0),
                                                 None])),
            m.SplitEventMap(2, [], None, m.ConstantEventMap(7))])
    for binary in (True, False):
        want = written(make(jem), binary, jiof.init_output_stream)
        assert written(make(tem), binary) == want
        f = io.BytesIO(want)
        assert tiof.init_input_stream(f) == binary
        assert written(tem.EventMap.read(f, binary), binary) == want


@pytest.mark.parametrize("binary", [True, False])
def test_topology_and_context_writers_match(binary):
    for j, t in (
            (JTopo.chain_topology(PHONES), HmmTopology.chain_topology(PHONES)),
            (JTopo.three_state(PHONES, sil_phones=[1]),
             HmmTopology.three_state(PHONES, sil_phones=[1]))):
        assert t.is_hmm() == j.is_hmm()
        assert written(t, binary) == written(j, binary,
                                             jiof.init_output_stream)
    jc = JCtx(3, 1, jem.TableEventMap(1, [None, jem.ConstantEventMap(0)]))
    tc = ContextDependency(3, 1, tem.TableEventMap(
        1, [None, tem.ConstantEventMap(0)]))
    assert written(tc, binary) == written(jc, binary,
                                          jiof.init_output_stream)


@pytest.mark.parametrize("name", ["flagship_ng.tm", "flagship_ng.tree"])
def test_committed_model_files_round_trip(tmp_path, name):
    """The committed transition model and tree, read by the port and
    written by `write_kaldi_object` (binary), give the committed bytes;
    in text mode the bytes equal the JAX writer's."""
    path = os.path.join(ART, name)
    cls = TransitionModel if name.endswith(".tm") else ContextDependency
    jcls = JTm if name.endswith(".tm") else JCtx
    obj = tkio.read_kaldi_object(cls.read, path)
    out = os.path.join(tmp_path, name)
    tkio.write_kaldi_object(obj.write, out)
    with open(path, "rb") as f, open(out, "rb") as g:
        assert g.read() == f.read()
    jobj = jkio.read_kaldi_object(jcls.read, path)
    tkio.write_kaldi_object(obj.write, out, binary=False)
    jout = os.path.join(tmp_path, "jax_" + name)
    jkio.write_kaldi_object(jobj.write, jout, binary=False)
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
