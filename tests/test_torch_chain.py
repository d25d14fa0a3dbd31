"""Port parity: the chain (LF-MMI) graphs, supervision and objective of
kaldi_tpu_torch against the JAX package's, on the CPU.  The denominator
graph (phone LM -> HMM acceptor over pdfs, stationary initial probs) and
the time-tolerant numerators are equal, floats within 1e-6; `chain_loss`
with leaky-HMM on and off agrees with the JAX package's, objective and
d objf / d nnet_out (against `jax.value_and_grad`) within 1e-4 relative;
and the properties of tests/test_chain.py hold for the port's forward
pass: agreement with brute-force enumeration, gradient = occupancy,
leaky-HMM only adds probability, gradient ascent improves the
objective.  The bucketed in-arc layout keeps every arc once; at the
--scale recipe's size (the 31,745-state window-LM denominator over the
committed flagship_ng tree) and at the legacy recipe's (50 pdfs, 50
frames) the objective and its gradient agree with JAX's within 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.chain import graphs as jgraphs
from kaldi_tpu.chain import objective as jobj
from kaldi_tpu.chain import supervision as jsup
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.recipes import chain as jchain
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.chain import graphs as tgraphs
from kaldi_tpu_torch.chain import objective as tobj
from kaldi_tpu_torch.chain import supervision as tsup
from kaldi_tpu_torch.hmm.topology import HmmTopology as TTopo
from kaldi_tpu_torch.hmm.transition_model import TransitionModel as TTm
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.tree.context_dep import (ContextDependency,
                                              monophone_context_dependency)
from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object

PHONES = list(range(1, 8))     # 1 = silence


def systems():
    """((port mono tm, tree), (JAX mono tm, tree), port chain tm, tree,
    JAX chain tm, tree) over PHONES."""
    out = []
    for Topo, Tm, mono in ((TTopo, TTm, monophone_context_dependency),
                           (JTopo, JTm, jmono)):
        topo = Topo.three_state(PHONES, sil_phones=[1])
        tree = mono(PHONES, {p: topo.num_pdf_classes(p) for p in PHONES})
        ctree = mono(PHONES, {p: 2 for p in PHONES})
        out.append(((Tm(topo, tree), tree),
                    (Tm(Topo.chain_topology(PHONES), ctree), ctree)))
    return out


def mono_alignment(tm, seed: int, n_phones: int = 12):
    """A frame-level alignment through random phones of the three-state
    topology: each emitting state's forward transition then 0-4 self
    loops."""
    rng = np.random.default_rng(seed)
    ali = []
    for phone in rng.integers(1, len(PHONES) + 1, n_phones):
        entry = tm.topo.topology_for_phone(int(phone))
        fwd = tm.topo.num_pdf_classes(int(phone))
        for j in range(fwd):
            ts = next(s for s in range(1, tm.num_transition_states + 1)
                      if tm.tuples[s - 1][:2] == (int(phone), j))
            idx = next(i for i, (k, _) in enumerate(entry[j].transitions)
                       if k != j)
            ali += [tm.self_loop_of(ts)] * int(rng.integers(0, 5))
            ali.append(tm.pair_to_transition_id(ts, idx))
    return ali


def assert_packed_equal(t, j, tol=1e-6):
    for name in ("src", "dst", "pdf"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("log_prob", "initial", "final"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_denominator_graph_matches():
    ((t_tm, _), (t_ctm, t_ctree)), ((j_tm, _), (j_ctm, j_ctree)) = systems()
    rng = np.random.default_rng(0)
    seqs = [list(rng.integers(1, 8, size=int(rng.integers(3, 12))))
            for _ in range(40)]
    t_lm = tsup.estimate_phone_lm(seqs, t_ctm.get_phones())
    j_lm = jsup.estimate_phone_lm(seqs, j_ctm.get_phones())
    assert t_lm.num_states == j_lm.num_states
    t_den = tsup.make_denominator_graph(seqs, t_ctm, t_ctree)
    j_den = jsup.make_denominator_graph(seqs, j_ctm, j_ctree)
    assert_packed_equal(t_den.graph, j_den.graph)
    np.testing.assert_allclose(
        tsup._stationary_initial(t_den.graph),
        jsup._stationary_initial(j_den.graph), rtol=0, atol=1e-6)
    assert np.exp(t_den.graph.initial).sum() == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_numerators_match(seed):
    ((t_tm, _), (t_ctm, _)), ((j_tm, _), (j_ctm, _)) = systems()
    ali = mono_alignment(j_tm, seed)
    assert tsup.alignment_to_phone_segments(ali, t_tm) == \
        jsup.alignment_to_phone_segments(ali, j_tm)
    for tol in ((5, 5), (1, 2), (0, 0)):
        assert_packed_equal(
            tsup.alignment_to_tolerance_numerator(ali, t_tm, t_ctm, 3, *tol),
            jsup.alignment_to_tolerance_numerator(ali, j_tm, j_ctm, 3, *tol))
    c_ali = tchain.mono_ali_to_chain_ali(ali, t_tm, t_ctm, 3)
    assert c_ali == jchain.mono_ali_to_chain_ali(ali, j_tm, j_ctm, 3)
    assert_packed_equal(tsup.alignment_to_numerator_graph(c_ali, t_ctm, 1),
                        jsup.alignment_to_numerator_graph(c_ali, j_ctm, 1))
    for p in PHONES:
        assert tsup._chain_pdfs_for_phone(t_ctm, p) == \
            jsup._chain_pdfs_for_phone(j_ctm, p)


def loss_inputs(B: int = 3, T: int = 14, seed: int = 0):
    """A den graph, B tolerance numerators of T output frames (numpy) and
    random nnet outputs (B, T, P)."""
    ((_, _), (t_ctm, t_ctree)), ((j_tm, _), (j_ctm, _)) = systems()
    rng = np.random.default_rng(seed)
    seqs = [list(rng.integers(1, 8, size=10)) for _ in range(20)]
    den = jsup.make_denominator_graph(seqs, j_ctm, jmono(
        PHONES, {p: 2 for p in PHONES}))
    nums = []
    for b in range(B):
        ali = mono_alignment(j_tm, 10 * seed + b, n_phones=30)[:3 * T]
        assert len(ali) == 3 * T
        nums.append(jsup.alignment_to_tolerance_numerator(ali, j_tm, j_ctm))
    out = rng.normal(size=(B, T, j_ctm.num_pdfs)).astype(np.float32) * 2.0
    return den, jgraphs.batch_pack(nums), out


@pytest.mark.parametrize("leaky,l2", [(0.1, 5e-5), (1e-5, 0.0), (0.0, 0.0),
                                      (0.0, 1e-3)])
def test_chain_loss_and_gradient_match(leaky, l2):
    den, nums, out = loss_inputs()
    jo = jobj.ChainTrainingOptions(l2_regularize=l2,
                                   leaky_hmm_coefficient=leaky)
    (j_objf, j_aux), j_grad = jax.value_and_grad(
        lambda o: jobj.chain_loss(jo, den, nums, o), has_aux=True)(
            jnp.asarray(out))
    x = torch.tensor(out, requires_grad=True)
    t_objf, t_aux = tobj.chain_loss(tobj.ChainTrainingOptions(
        l2_regularize=l2, leaky_hmm_coefficient=leaky), den, nums, x)
    t_objf.backward()
    assert float(t_objf.detach()) == pytest.approx(float(j_objf), rel=1e-4)
    for k in ("num", "den"):
        assert float(t_aux[k].detach()) == pytest.approx(float(j_aux[k]),
                                                         rel=1e-4)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(x.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(j_grad).max())


def test_chain_loss_xent_term_matches():
    den, nums, out = loss_inputs(seed=1)
    xent = np.log(np.random.default_rng(2).dirichlet(
        np.ones(out.shape[-1]), size=out.shape[:2])).astype(np.float32)
    post = np.random.default_rng(3).dirichlet(
        np.ones(out.shape[-1]), size=out.shape[:2]).astype(np.float32)
    jo = jobj.ChainTrainingOptions(xent_regularize=0.1)
    j_objf, j_aux = jobj.chain_loss(jo, den, nums, jnp.asarray(out),
                                    jnp.asarray(xent), jnp.asarray(post))
    t_objf, t_aux = tobj.chain_loss(
        tobj.ChainTrainingOptions(xent_regularize=0.1), den, nums,
        torch.tensor(out), torch.tensor(xent), torch.tensor(post))
    assert float(t_aux["xent"]) == pytest.approx(float(j_aux["xent"]),
                                                 rel=1e-5)
    assert float(t_objf.detach()) == pytest.approx(float(j_objf), rel=1e-4)
    # without targets the xent head is skipped
    _, aux = tobj.chain_loss(tobj.ChainTrainingOptions(xent_regularize=0.1),
                             den, nums, torch.tensor(out),
                             torch.tensor(xent))
    assert "xent" not in aux


# ---- the properties of tests/test_chain.py, on the port's forward pass

def brute_force_loglike(pg, out: np.ndarray) -> float:
    """Enumerate all paths of length T; logsumexp of path scores."""
    T = out.shape[0]
    scores = []

    def rec(state, t, acc):
        if t == T:
            if pg.final[state] > -1e29:
                scores.append(acc + pg.final[state])
            return
        for a in range(pg.num_arcs):
            if pg.src[a] == state and pg.log_prob[a] > -1e29:
                rec(pg.dst[a], t + 1,
                    acc + pg.log_prob[a] + out[t, pg.pdf[a]])

    for s in range(pg.num_states):
        if pg.initial[s] > -1e29:
            rec(s, 0, float(pg.initial[s]))
    if not scores:
        return -np.inf
    m = max(scores)
    return m + np.log(sum(np.exp(s - m) for s in scores))


def random_graph(seed, S=3, A=7, P=4):
    rng = np.random.default_rng(seed)
    lp = rng.uniform(-2, -0.1, A).astype(np.float32)
    initial = np.full(S, -1e30, np.float32)
    initial[0] = 0.0
    final = rng.uniform(-1, 0, S).astype(np.float32)
    return tgraphs.PackedGraph(rng.integers(0, S, A).astype(np.int32),
                               rng.integers(0, S, A).astype(np.int32),
                               rng.integers(0, P, A).astype(np.int32),
                               lp, initial, final)


def forward(pg, out: torch.Tensor, leaky: float = 0.0) -> torch.Tensor:
    """The port's batched forward pass on one graph."""
    graphs = tobj.InArcs(pg.src, pg.dst, pg.pdf, pg.log_prob, pg.initial,
                         pg.final, out.shape[-1], torch.device("cpu"))
    return tobj._forward_loglike(out[None], graphs, leaky)[0]


@pytest.mark.parametrize("seed", range(4))
def test_forward_matches_brute_force(seed):
    P, T = 4, 5
    pg = random_graph(seed, P=P)
    out = np.random.default_rng(seed + 10).normal(size=(T, P)).astype(
        np.float32)
    got = float(forward(pg, torch.tensor(out)))
    want = brute_force_loglike(pg, out)
    if want == -np.inf:
        assert got < -1e28  # both "no path"
    else:
        assert got == pytest.approx(want, abs=1e-3)


def test_gradient_is_occupancy():
    """d(loglike)/d(out[t,p]) is the expected pdf occupancy, which sums
    to 1 a frame."""
    pg = random_graph(1, P=5)
    out = torch.tensor(np.random.default_rng(2).normal(size=(6, 5)),
                       dtype=torch.float32, requires_grad=True)
    forward(pg, out).backward()
    np.testing.assert_allclose(out.grad.numpy().sum(axis=1), 1.0, atol=1e-4)
    assert (out.grad.numpy() >= -1e-6).all()


def test_leaky_hmm_increases_loglike():
    pg = random_graph(3)
    out = torch.tensor(np.random.default_rng(3).normal(size=(5, 4)),
                       dtype=torch.float32)
    assert float(forward(pg, out, 1e-3)) >= float(forward(pg, out)) - 1e-5


def test_gradient_ascent_improves_objective():
    den, nums, out = loss_inputs(B=2, T=8, seed=4)
    opts = tobj.ChainTrainingOptions(leaky_hmm_coefficient=1e-4)
    x = torch.tensor(out * 0.05, requires_grad=True)
    objf, _ = tobj.chain_loss(opts, den, nums, x)
    objf.backward()
    assert np.isfinite(float(objf.detach()))
    objf2, _ = tobj.chain_loss(opts, den, nums, x.detach() + x.grad)
    assert float(objf2) > float(objf.detach())


# ---- the bucketed in-arc layout

@pytest.mark.parametrize("seed", range(3))
def test_in_arc_gathers_backward_match_gather(seed):
    """Both gathers of the forward pass (the source states' values, the
    slots' pdf scores) take their gradient through the transposed tables;
    it equals torch.gather's own (atomic on CUDA) on every live slot."""
    rng = np.random.default_rng(seed)
    pg = random_graph(seed, S=5, A=12, P=4)
    graphs = tobj.InArcs(pg.src, pg.dst, pg.pdf, pg.log_prob, pg.initial,
                         pg.final, 4, torch.device("cpu"))
    live = torch.isfinite(graphs.log_prob).to(torch.float64)
    w = torch.tensor(rng.normal(size=live.shape)) * live
    for index, uses, n in ((graphs.src, graphs.from_src, graphs.num_states),
                           (graphs.pdf, graphs.from_pdf, 4)):
        y = torch.tensor(rng.normal(size=(1, n)), requires_grad=True)
        (y.gather(-1, index) * w).sum().backward()
        np.testing.assert_allclose(uses.sum(w).numpy(), y.grad.numpy(),
                                   rtol=1e-12, atol=1e-12)


def layout_arcs(graphs, b: int) -> list:
    """(src, dst, pdf, log_prob) of every finite slot of graph b, in the
    graph's own state numbers."""
    back = np.full(graphs.num_states, -1)
    back[graphs.state_row[b]] = np.arange(graphs.state_row.shape[1])
    src, pdf = graphs.src[b].numpy(), graphs.pdf[b].numpy()
    lp = graphs.log_prob[b].numpy()
    out, row, off = [], 0, 0
    for n, k in graphs.buckets:
        for i in range(n):
            for j in range(k):
                q = off + i * k + j
                if np.isfinite(lp[q]):
                    out.append((int(back[src[q]]), int(back[row + i]),
                                int(pdf[q]), float(lp[q])))
        row += n
        off += n * k
    return sorted(out)


def test_in_arc_layout_of_a_padded_batch():
    """Every live arc sits in one slot of its destination; batch_pack's
    padding self-loops keep one copy; a padded batch of unequal graphs
    gives each graph's own loglike."""
    pgs = [random_graph(s, S=3 + s, A=6 + 3 * s, P=4) for s in range(3)]
    packed = tgraphs.batch_pack(pgs)
    graphs = tobj.InArcs(*packed, 4, torch.device("cpu"))
    for b, pg in enumerate(pgs):
        got = layout_arcs(graphs, b)
        want = sorted((int(a), int(d), int(p), float(w)) for a, d, p, w in
                      zip(pg.src, pg.dst, pg.pdf, pg.log_prob))
        dead = {(pg.num_states, pg.num_states, 0, -1e30)} \
            if pg.num_arcs < packed[0].shape[1] else set()
        assert [a for a in got if a[3] > -1e29] == want
        assert {a for a in got if a[3] <= -1e29} == {
            (s, d, p, float(np.float32(w))) for s, d, p, w in dead}
    out = torch.tensor(np.random.default_rng(5).normal(size=(3, 6, 4)),
                       dtype=torch.float32)
    batch = tobj._forward_loglike(out, graphs, 0.0)
    for b, pg in enumerate(pgs):
        assert float(batch[b]) == pytest.approx(float(forward(pg, out[b])),
                                                rel=1e-6, abs=1e-4)


# ---- the denominators of the training recipes, at their sizes

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")


@pytest.fixture(scope="module")
def scale_den():
    """The --scale recipe's denominator over the committed flagship_ng
    tree: the window LM over every word-internal window of its 31 phones
    (seeded word sequences that use every phone), expanded through the
    tree by the port."""
    tm = read_kaldi_object(TTm.read, os.path.join(ART, "flagship_ng.tm"))
    tree = read_kaldi_object(ContextDependency.read,
                             os.path.join(ART, "flagship_ng.tree"))
    phones = list(tm.get_phones())
    rng = np.random.default_rng(0)
    seqs = []
    for _ in range(200):
        seq = [(0, phones[0], 0)]
        for _ in range(8):
            pron = [int(p) for p in rng.choice(phones[1:],
                                               int(rng.integers(1, 5)))]
            pad = [0] + pron + [0]
            seq += [tuple(pad[i:i + 3]) for i in range(len(pron))]
            seq.append((0, phones[0], 0))
        seqs.append(seq)
    lm, info = tsup.estimate_window_lm(seqs)
    return tsup.denominator_graph_from_phone_lm(lm, tm, tree,
                                                ilabel_info=info), tm


def chain_numerators(B, T, P, seed):
    """B numerators of T frames, each a chain through random pdfs."""
    rng = np.random.default_rng(seed)
    nums = []
    for _ in range(B):
        init = np.full(T + 1, -1e30, np.float32)
        init[0] = 0.0
        final = np.full(T + 1, -1e30, np.float32)
        final[-1] = 0.0
        nums.append(jgraphs.PackedGraph(
            np.arange(T, dtype=np.int32), np.arange(1, T + 1, dtype=np.int32),
            rng.integers(0, P, T).astype(np.int32),
            rng.uniform(-1, 0, T).astype(np.float32), init, final))
    return jgraphs.batch_pack(nums)


def assert_loss_matches(den_graph, nums, out, leaky=0.1, l2=5e-5):
    jo = jobj.ChainTrainingOptions(l2_regularize=l2,
                                   leaky_hmm_coefficient=leaky)
    (j_objf, j_aux), j_grad = jax.value_and_grad(
        lambda o: jobj.chain_loss(jo, den_graph, nums, o), has_aux=True)(
            jnp.asarray(out))
    x = torch.tensor(out, requires_grad=True)
    t_objf, t_aux = tobj.chain_loss(tobj.ChainTrainingOptions(
        l2_regularize=l2, leaky_hmm_coefficient=leaky), den_graph, nums, x)
    t_objf.backward()
    assert float(t_objf.detach()) == pytest.approx(float(j_objf), rel=1e-4)
    for k in ("num", "den"):
        assert float(t_aux[k].detach()) == pytest.approx(float(j_aux[k]),
                                                         rel=1e-4, abs=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(x.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(j_grad).max())


def test_scale_denominator_layout(scale_den):
    """31,745 states and 2,000,864 arcs: bucketed by in-degree (the
    start state's 1 padded to 33) the in-arcs take 2,000,897 slots, where
    one width for all would take 31.55M and power-of-two widths
    2,983,937; the layout is built once."""
    den, tm = scale_den
    assert den.num_states == 31745 and den.graph.num_arcs == 2000864
    arcs = tobj.den_arcs(den, tm.num_pdfs, torch.device("cpu"))
    assert arcs.slot_sizes() == {"states": 31745, "arcs": 2000864,
                                 "slots": 2000897,
                                 "buckets": {33: 30753, 994: 992}}
    assert tobj.den_arcs(den, tm.num_pdfs, torch.device("cpu")) is arcs
    assert sum(n * k for n, k in arcs.from_src.buckets) < 1.1 * 2000864
    assert sum(n * k for n, k in arcs.from_pdf.buckets) < 4 * 2000864
    assert len(arcs.from_pdf.buckets) <= 4


def test_scale_chain_loss_matches(scale_den):
    """The bucketed objective and its gradient against JAX's chain_loss
    on the full --scale denominator, B = 2, T = 6."""
    den, tm = scale_den
    P = tm.num_pdfs
    out = np.random.default_rng(1).normal(size=(2, 6, P)).astype(
        np.float32) * 2
    assert_loss_matches(jgraphs.DenominatorGraph(jgraphs.PackedGraph(
        *(getattr(den.graph, k) for k in ("src", "dst", "pdf", "log_prob",
                                          "initial", "final")))),
        chain_numerators(2, 6, P, 2), out)


def test_legacy_size_chain_loss_matches():
    """The legacy recipe's size: 25 phones (50 pdfs), a minibatch of 4
    chunks of 50 output frames."""
    phones = list(range(1, 26))
    topo = JTopo.chain_topology(phones)
    tree = jmono(phones, {p: 2 for p in phones})
    ctm = JTm(topo, tree)
    rng = np.random.default_rng(3)
    seqs = [list(rng.integers(1, 26, size=int(rng.integers(8, 40))))
            for _ in range(100)]
    den = jsup.make_denominator_graph(seqs, ctm, tree)
    assert ctm.num_pdfs == 50
    out = rng.normal(size=(4, 50, 50)).astype(np.float32) * 2
    assert_loss_matches(den, chain_numerators(4, 50, 50, 4), out)
