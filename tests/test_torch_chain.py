"""Port parity: the chain (LF-MMI) graphs, supervision and objective of
kaldi_tpu_torch against the JAX package's, on the CPU.  The denominator
graph (phone LM -> HMM acceptor over pdfs, stationary initial probs) and
the time-tolerant numerators are equal, floats within 1e-6; `chain_loss`
with leaky-HMM on and off agrees with the JAX package's, objective and
d objf / d nnet_out (against `jax.value_and_grad`) within 1e-4 relative;
and the properties of tests/test_chain.py hold for the port's forward
pass: agreement with brute-force enumeration, gradient = occupancy,
leaky-HMM only adds probability, gradient ascent improves the
objective."""

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
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

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


# ---- the padded in-arc layout

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
    for index, uses, n in ((graphs.src, graphs.src_uses, 5),
                           (graphs.pdf, graphs.pdf_uses, 4)):
        x = torch.tensor(rng.normal(size=(1, n)), requires_grad=True)
        (tobj._Gather.apply(x, index, uses) * w).sum().backward()
        y = x.detach().clone().requires_grad_(True)
        (y.gather(-1, index) * w).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_in_arc_layout_of_a_padded_batch():
    """Every live arc sits in one slot of its destination; batch_pack's
    padding self-loops keep one copy; a padded batch of unequal graphs
    gives each graph's own loglike."""
    pgs = [random_graph(s, S=3 + s, A=6 + 3 * s, P=4) for s in range(3)]
    packed = tgraphs.batch_pack(pgs)
    graphs = tobj.InArcs(*packed, 4, torch.device("cpu"))
    S, K = graphs.num_states, graphs.slots
    for b, pg in enumerate(pgs):
        lp = graphs.log_prob[b].view(S, K).numpy()
        src = graphs.src[b].view(S, K).numpy()
        pdf = graphs.pdf[b].view(S, K).numpy()
        got = sorted((int(src[s, k]), s, int(pdf[s, k]), float(lp[s, k]))
                     for s in range(S) for k in range(K)
                     if np.isfinite(lp[s, k]))
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
