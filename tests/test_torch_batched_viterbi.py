"""Port parity: `kaldi_tpu_torch/decoder/batched_viterbi.py` against
`kaldi_tpu/decoder/batched_viterbi.py` on the same graphs and the same
seeded loglikes (continuous random values, so no exact ties).

Tolerances: packed arrays and padded tables equal; per-frame cost tables
rtol 1e-5 below INF / 2 (float32 sums of up to T terms, XLA may fuse a
multiply into a subtraction); `run`: equal alignments and words, cost
within 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import batched_viterbi as jbv
from kaldi_tpu.decoder.graph_direct import DirectGraphSpec as JaxSpec
from kaldi_tpu.decoder.graph_direct import build_direct_hclg as jax_hclg
from kaldi_tpu.fstext.fst import Arc as JaxArc
from kaldi_tpu.fstext.fst import VectorFst as JaxFst
from kaldi_tpu_torch.decoder import batched_viterbi as tbv
from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                  build_direct_hclg)
from kaldi_tpu_torch.fstext.fst import Arc, VectorFst
from kaldi_tpu_torch.ops.viterbi_relax import (INF, closure_is_identity,
                                               each_call, live_counts,
                                               relax_padded)

GRAPH_FIELDS = ("e_src", "e_dst", "e_ilabel", "e_olabel", "e_weight",
                "ne_src", "ne_dst", "ne_olabel", "ne_weight", "final")


def both_fsts(arcs, finals, n, start=0):
    """The same FST as the JAX package's VectorFst and as the port's."""
    out = []
    for fst_cls, arc_cls in ((JaxFst, JaxArc), (VectorFst, Arc)):
        fst = fst_cls()
        for _ in range(n):
            fst.add_state()
        fst.start = start
        for s, il, ol, w, d in arcs:
            fst.add_arc(s, arc_cls(il, ol, w, d))
        for s, w in finals:
            fst.set_final(s, w)
        out.append(fst)
    return out


def random_eps_fst(seed, n=14, num_tids=20, num_words=5):
    """Seeded random graph: an emitting self-loop and two emitting arcs a
    state, and an epsilon DAG (arcs only to higher states, chains of up to
    four) whose arcs carry word labels."""
    rng = np.random.default_rng(seed)
    arcs = []
    for s in range(n):
        arcs.append((s, int(rng.integers(1, num_tids + 1)), 0,
                     float(rng.uniform(0.1, 2.0)), s))
        for d in rng.integers(0, n, 2):
            arcs.append((s, int(rng.integers(1, num_tids + 1)),
                         int(rng.integers(0, num_words + 1)),
                         float(rng.uniform(0.1, 2.0)), int(d)))
    for s in (0, 1, 2, 5, 6, 9):
        if s + 1 < n:
            arcs.append((s, 0, int(rng.integers(0, num_words + 1)),
                         float(rng.uniform(0.2, 1.5)), s + 1))
    if n > 7:
        arcs.append((3, 0, 2, 0.4, 7))
    finals = [(n - 1, 0.5), (n // 2, 1.5), (3, 2.5)]
    tid_to_pdf = np.concatenate([[0], rng.integers(0, 8, num_tids)])
    return arcs, finals, n, tid_to_pdf.astype(np.int32)


def flat_fsts(seed, V=6, num_pdfs=24):
    """A small eps-free direct HCLG on both sides."""
    kw = dict(vocab=V, num_phones=5, min_pron=1, max_pron=3,
              num_pdfs=num_pdfs, seed=seed)
    jf, tf = jax_hclg(JaxSpec(**kw)), build_direct_hclg(DirectGraphSpec(**kw))
    return jf.to_vector_fst(), tf.to_vector_fst(), tf.tid2pdf


def assert_graphs_equal(tg, jg):
    for name in GRAPH_FIELDS:
        a, b = getattr(tg, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tg.start, tg.num_states, tg.eps_depth) == \
        (jg.start, jg.num_states, jg.eps_depth)


def assert_prepared_equal(t_prep, j_prep, shared):
    """The port's tables against the reference's stacked (B, S, K) ones;
    for a shared graph the port keeps one (S, K) copy."""
    t_pad, t_arr, t_S, t_eps = t_prep
    j_pad, j_arr, j_S, j_eps = j_prep
    assert (t_S, t_eps, len(t_pad)) == (j_S, j_eps, len(j_pad))
    for tg, jg in zip(t_pad, j_pad):
        assert_graphs_equal(tg, jg)
    for name, ref in j_arr.items():
        got = t_arr[name]
        assert got.dtype == ref.dtype, name
        if shared and name != "init_cost":
            assert (ref == ref[:1]).all()
            ref = ref[0]
        np.testing.assert_array_equal(got, ref, err_msg=name)


def assert_hyps_match(got, want, n_lanes):
    assert len(got) == len(want) == n_lanes
    for b, (g, w) in enumerate(zip(got, want)):
        assert g is not None and w is not None, f"lane {b}"
        assert g[0] == w[0], f"lane {b} alignment"
        assert g[1] == w[1], f"lane {b} words"
        assert abs(g[2] - w[2]) <= 1e-4 * max(1.0, abs(w[2])), f"lane {b}"


def test_pack_graph_and_eps_depth_equal_jax():
    arcs, finals, n, _ = random_eps_fst(0)
    jfst, tfst = both_fsts(arcs, finals, n)
    jg, tg = jbv.pack_graph(jfst), tbv.pack_graph(tfst)
    assert_graphs_equal(tg, jg)
    assert tg.eps_depth == 5 and len(tg.ne_src) == 7
    jfst, tfst, _ = flat_fsts(0)
    tg = tbv.pack_graph(tfst)
    assert_graphs_equal(tg, jbv.pack_graph(jfst))
    assert tg.eps_depth == 1 and len(tg.ne_src) == 0


def test_shared_epsfree_graph_ragged_lengths():
    jfst, tfst, tid2pdf = flat_fsts(1)
    B, T, P = 5, 11, 24
    ll = np.random.default_rng(11).normal(size=(B, T, P)).astype(np.float32)
    lengths = [11, 9, 11, 4, 7]
    jv = jbv.BatchedViterbi(jfst, tid2pdf, acoustic_scale=0.8)
    tv = tbv.BatchedViterbi(tfst, tid2pdf, acoustic_scale=0.8, device="cpu")
    t_prep, j_prep = tv._prepare(B), jv._prepare(B)
    assert_prepared_equal(t_prep, j_prep, shared=True)
    assert t_prep[1]["ne_in_src"].shape[1] == 1          # K = 1, all dead
    assert t_prep[1]["e_in_src"].ndim == 2
    want = jv.run(ll, lengths)
    got = tv.run(ll, lengths)
    assert_hyps_match(got, want, B)
    assert [len(g[0]) for g in got] == lengths
    assert any(len(g[1]) > 1 for g in got)
    # a tensor input gives the same as a numpy input
    assert tv.run(torch.from_numpy(ll), lengths) == got


@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_device_cost_tables_match_jax(seed):
    arcs, finals, n, tid2pdf = random_eps_fst(seed)
    jfst, tfst = both_fsts(arcs, finals, n)
    B, T, P = 3, 8, 8
    ll = np.random.default_rng(seed + 5).normal(size=(B, T, P)) \
        .astype(np.float32)
    jv = jbv.BatchedViterbi(jfst, tid2pdf, acoustic_scale=0.6)
    tv = tbv.BatchedViterbi(tfst, tid2pdf, acoustic_scale=0.6, device="cpu")
    _, j_arr, S, eps_iters = jv._prepare(B)
    _, t_arr, t_S, t_eps = tv._prepare(B)
    assert (S, eps_iters) == (t_S, t_eps) and eps_iters > 1
    want = np.asarray(jbv._viterbi_device(
        jnp.asarray(ll), 0.6, **{k: jnp.asarray(v) for k, v in j_arr.items()},
        num_states=S, eps_iters=eps_iters))
    calls = []

    def counting_relax(*args, **kw):
        calls.append(len(args))
        return relax_padded(*args, **kw)

    got = tbv._viterbi_device(
        torch.from_numpy(ll), 0.6,
        **{k: torch.from_numpy(v) for k, v in t_arr.items()},
        num_states=S, eps_iters=eps_iters,
        relax=each_call(counting_relax)).numpy()
    assert got.shape == want.shape == (B, T + 1, S + 1)
    live = want < INF / 2
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5)
    assert (got[~live] >= INF / 2).all() and np.isfinite(got).all()
    assert (got[:, :, S] == INF).all()
    assert live.mean() > 0.5
    # T emitting relaxations and (T + 1) * eps_iters closure relaxations
    assert len(calls) == T + (T + 1) * eps_iters
    assert sum(n_args > 3 for n_args in calls) == T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_on_random_graph_with_epsilon_dag(seed):
    arcs, finals, n, tid2pdf = random_eps_fst(seed)
    jfst, tfst = both_fsts(arcs, finals, n)
    B, T, P = 4, 9, 8
    ll = np.random.default_rng(seed + 30).normal(size=(B, T, P)) \
        .astype(np.float32) * 2.0
    lengths = [9, 6, 9, 3]
    jv = jbv.BatchedViterbi(jfst, tid2pdf)
    tv = tbv.BatchedViterbi(tfst, tid2pdf, device="cpu")
    assert_prepared_equal(tv._prepare(B), jv._prepare(B), shared=True)
    want = jv.run(ll, lengths)
    got = tv.run(ll, lengths)
    assert_hyps_match(got, want, B)
    # word labels of epsilon arcs reach the output
    assert any(g[1] for g in got)


def test_one_graph_a_lane_with_different_sizes():
    sizes = [14, 9, 17, 6]
    jfsts, tfsts = [], []
    for b, n in enumerate(sizes):
        arcs, finals, n, tid2pdf = random_eps_fst(40, n=n)
        if b == 1:      # an epsilon-free lane among lanes with epsilons
            arcs = [a for a in arcs if a[1] != 0]
        j, t = both_fsts(arcs, finals, n)
        jfsts.append(j)
        tfsts.append(t)
    B, T, P = len(sizes), 10, 8
    ll = np.random.default_rng(41).normal(size=(B, T, P)).astype(np.float32)
    lengths = [10, 10, 7, 5]
    jv = jbv.BatchedViterbi(jfsts, tid2pdf, acoustic_scale=0.9)
    tv = tbv.BatchedViterbi(tfsts, tid2pdf, acoustic_scale=0.9, device="cpu")
    t_prep = tv._prepare(B)
    assert_prepared_equal(t_prep, jv._prepare(B), shared=False)
    assert t_prep[1]["e_in_src"].shape[:2] == (B, max(sizes) + 1)
    assert_hyps_match(tv.run(ll, lengths), jv.run(ll, lengths), B)
    with pytest.raises(ValueError, match="lanes"):
        tv._prepare(B + 1)


def test_unreachable_final_gives_none():
    arcs = [(0, 1, 0, 0.5, 0), (1, 1, 0, 0.5, 1)]
    _, tfst = both_fsts(arcs, [(1, 0.0)], 2)
    tv = tbv.BatchedViterbi(tfst, np.array([0, 0], np.int32), device="cpu")
    assert tv.run(np.zeros((1, 3, 1), np.float32)) == [None]


def test_pdf_index_outside_loglikes_raises():
    _, tfst, tid2pdf = flat_fsts(2)
    tv = tbv.BatchedViterbi(tfst, tid2pdf, device="cpu")
    with pytest.raises(ValueError, match="in_pdf"):
        tv.run(np.zeros((1, 3, 5), np.float32))


def counting(calls):
    def relax(*args, **kw):
        calls.append(len(args))
        return relax_padded(*args, **kw)
    return relax


def device_tables(tv, ll, arrays, S, eps_iters, scale, **kw):
    calls = []
    got = tbv._viterbi_device(
        torch.from_numpy(ll), scale,
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        num_states=S, eps_iters=eps_iters, relax=each_call(counting(calls)),
        **kw)
    return got.numpy(), calls


def identity_of(arrays):
    e_deg = live_counts(arrays["e_in_src"], arrays["e_in_w"],
                        arrays["e_in_pdf"])
    ne_deg = live_counts(arrays["ne_in_src"], arrays["ne_in_w"])
    return closure_is_identity(arrays["ne_in_src"], arrays["ne_in_w"], ne_deg,
                               arrays["e_in_src"], arrays["e_in_w"],
                               e_deg), e_deg, ne_deg


@pytest.mark.parametrize("seed,with_deg", [(1, False), (2, True), (3, True)])
def test_epsilon_free_graph_takes_no_closure_launch(seed, with_deg):
    """An epsilon-free graph's epsilon table holds dead slots and the pad
    self-arc of weight INF: T relax calls instead of T + (T + 1), and the
    cost tables are exactly those with the closure forced on; against the
    JAX package as test_viterbi_device_cost_tables_match_jax does."""
    jfst, tfst, tid2pdf = flat_fsts(seed)
    B, T, P = 4, 9, 24
    # negative loglikes: costs grow, so no sum cancels to near zero
    ll = -np.abs(np.random.default_rng(seed + 60).normal(size=(B, T, P))
                 .astype(np.float32)) * 3.0
    jv = jbv.BatchedViterbi(jfst, tid2pdf, acoustic_scale=0.7)
    tv = tbv.BatchedViterbi(tfst, tid2pdf, acoustic_scale=0.7, device="cpu")
    _, j_arr, S, eps_iters = jv._prepare(B)
    _, t_arr, _, _ = tv._prepare(B)
    identity, e_deg, ne_deg = identity_of(t_arr)
    assert identity and eps_iters == 1
    assert ne_deg.sum() == 1 and ne_deg[S - 1] == 1      # the pad self-arc
    if with_deg:
        t_arr = dict(t_arr, e_in_deg=e_deg, ne_in_deg=ne_deg)
    got, calls = device_tables(tv, ll, t_arr, S, eps_iters, 0.7,
                               closure_identity=True)
    forced, forced_calls = device_tables(tv, ll, t_arr, S, eps_iters, 0.7)
    assert len(calls) == T and all(n > 3 for n in calls)
    assert len(forced_calls) == T + (T + 1) * eps_iters
    np.testing.assert_array_equal(got, forced)
    want = np.asarray(jbv._viterbi_device(
        jnp.asarray(ll), 0.7, **{k: jnp.asarray(v) for k, v in j_arr.items()},
        num_states=S, eps_iters=eps_iters))
    live = want < INF / 2
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5)
    assert (got[~live] >= INF / 2).all() and np.isfinite(got).all()
    assert (got[:, :, S] == INF).all() and live.mean() > 0.3


def test_closure_stays_when_the_loglikes_could_lift_a_dead_candidate():
    """With scale * ll[:, :, 0] below -DEAD_SLACK a state without in-arc
    ends above 2e30, and a closure step lowers it: the launches stay, and
    the tables are those of the forced closure."""
    _, tfst, tid2pdf = flat_fsts(1)
    B, T, P = 3, 5, 24
    ll = np.random.default_rng(70).normal(size=(B, T, P)).astype(np.float32)
    ll[1, 2, 0] = -1e25
    tv = tbv.BatchedViterbi(tfst, tid2pdf, device="cpu")
    _, t_arr, S, eps_iters = tv._prepare(B)
    got, calls = device_tables(tv, ll, t_arr, S, eps_iters, 1.0,
                               closure_identity=True)
    forced, _ = device_tables(tv, ll, t_arr, S, eps_iters, 1.0)
    assert len(calls) == T + (T + 1) * eps_iters
    np.testing.assert_array_equal(got, forced)
    # the emitting step alone leaves such a state above 2e30 ...
    raw = relax_padded(torch.from_numpy(forced[:, 2]),
                       *[torch.from_numpy(t_arr[k]) for k in
                         ("e_in_src", "e_in_w", "e_in_pdf")],
                       torch.from_numpy(ll[:, 2]), 1.0).numpy()
    assert (raw[1, :S - 1] > INF + INF).any()
    # ... and the closure step brings it back (but for the pad state S-1,
    # whose one epsilon slot is its self-arc)
    assert (forced[1, 3, :S - 1] <= INF + INF).all()


@pytest.mark.parametrize("case", ["ragged_epsfree", "epsilon_dag",
                                  "graph_a_lane", "unreachable_final"])
def test_run_counts_and_results_with_and_without_closure(case, monkeypatch):
    """`run` through `_forward`: the relax calls of a run (T for tables
    whose closure is the identity, T + (T + 1) * eps_iters otherwise) and
    hypotheses equal to those with the closure forced on."""
    lengths = None
    if case == "ragged_epsfree":
        _, tfst, tid2pdf = flat_fsts(1)
        graphs, (B, T, P), lengths = tfst, (5, 11, 24), [11, 9, 11, 4, 7]
    elif case == "epsilon_dag":
        arcs, finals, n, tid2pdf = random_eps_fst(1)
        graphs, (B, T, P), lengths = both_fsts(arcs, finals, n)[1], \
            (4, 9, 8), [9, 6, 9, 3]
    elif case == "graph_a_lane":
        graphs = []
        for b, n in enumerate([14, 9, 17, 6]):
            arcs, finals, n, tid2pdf = random_eps_fst(40, n=n)
            graphs.append(both_fsts([a for a in arcs if a[1] != 0],
                                    finals, n)[1])
        (B, T, P), lengths = (4, 10, 8), [10, 10, 7, 5]
    else:
        graphs = both_fsts([(0, 1, 0, 0.5, 0), (1, 1, 0, 0.5, 1)],
                           [(1, 0.0)], 2)[1]
        tid2pdf, (B, T, P) = np.array([0, 0], np.int32), (1, 3, 1)
    ll = np.random.default_rng(80).normal(size=(B, T, P)).astype(np.float32)
    calls = []
    tv = tbv.BatchedViterbi(graphs, tid2pdf, acoustic_scale=0.9,
                            device="cpu", relax=each_call(counting(calls)))
    _, arrays, _, eps_iters = tv._prepare(B)
    identity = identity_of(arrays)[0]
    # unreachable_final: K = 1 and state 1 is fed by itself alone, so no
    # slot bounds it by 2e30 and the closure launches stay
    assert identity == (case in ("ragged_epsfree", "graph_a_lane"))
    got = tv.run(ll, lengths)
    assert len(calls) == (T if identity else T + (T + 1) * eps_iters)
    monkeypatch.setattr(tbv, "closure_is_identity", lambda *a: False)
    del calls[:]
    forced = tv.run(ll, lengths)
    assert len(calls) == T + (T + 1) * eps_iters
    assert got == forced
    if case == "unreachable_final":
        assert got == [None]
    else:
        assert all(h is not None for h in got)
