"""Port parity: the dense-relaxation device decoder
(`kaldi_tpu_torch/decoder/dense_relax.py`) against the JAX package's
(`kaldi_tpu/decoder/dense_relax.py`) on the CPU, on the same random
graphs and the same continuous random acoustics made from a seed.

Tolerances: the tables (tiers, permutation, flat arcs, initial and
final costs) equal; per lane the total cost within 1e-5 relative of
JAX's; words, ilabels and the chosen arc of every frame equal (the
min-plus sums are the same float32 additions in the same order, and
both argmins take the first minimum).
"""

import numpy as np
import pytest

from kaldi_tpu.decoder import dense_relax as J
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.decoder import dense_relax as D
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst


def random_arcs(rng, S=200, P=10, eps_frac=0.2, n_finals=10,
                olabel_range=5):
    """The reference test's random graph as (arcs, finals, tid2pdf):
    forward-only epsilon arcs keep the eps subgraph a DAG."""
    tid2pdf = np.zeros(P * 3 + 1, np.int64)
    tid2pdf[1:] = (np.arange(1, P * 3 + 1) - 1) % P
    arcs = []
    for s in range(S):
        for _ in range(int(rng.integers(1, 8))):
            if rng.uniform() < eps_frac and s < S - 1:
                arcs.append((s, EPS, int(rng.integers(0, olabel_range)),
                             float(rng.uniform(0, 1.5)),
                             int(rng.integers(s + 1, S))))
            else:
                arcs.append((s, int(rng.integers(1, P * 3 + 1)),
                             int(rng.integers(0, olabel_range)),
                             float(rng.uniform(0, 3.0)),
                             int(rng.integers(0, S))))
    finals = {int(s): float(rng.uniform(0, 1))
              for s in rng.choice(S, n_finals, replace=False)}
    return S, arcs, finals, tid2pdf


def both_fsts(S, arcs, finals):
    """The same graph as the port's VectorFst and the JAX package's."""
    out = []
    for Fst, A in ((VectorFst, Arc), (JFst, JArc)):
        f = Fst(TropicalWeight)
        f.add_states(S)
        f.set_start(0)
        for s, il, ol, w, d in arcs:
            f.add_arc(s, A(il, ol, w, d))
        for s, w in finals.items():
            f.finals[s] = w
        out.append(f)
    return out


def jax_decode(g, ll, scale, chunk, lengths=None):
    """JAX's decode_batch, and the (T_pad, B) chosen arc ids its
    backward pass returns (the part the reference keeps inside)."""
    import jax.numpy as jnp
    dec = J.DenseViterbiDecoder(g, chunk=chunk)
    res = dec.decode_batch(ll, scale, lengths=lengths)
    B, T, _ = ll.shape
    lengths = np.asarray(lengths if lengths is not None else [T] * B)
    C = min(chunk, T)
    n = -(-T // C)
    am = jnp.transpose(jnp.asarray(ll) * (-scale), (1, 2, 0))
    am = jnp.pad(am, ((0, n * C - T), (0, 0), (0, 0)))
    active = jnp.asarray(np.arange(n * C)[:, None] < lengths[None, :])
    fwd, bwd = dec._full_fns(n, C)
    cost, ckpts = fwd(jnp.tile(dec._init_cost[:, None], (1, B)), am,
                      active)
    best = jnp.argmin(cost + dec._final_cost[:, None], axis=0)
    _, arcs = bwd(ckpts, am, active, best)
    return res, np.asarray(arcs)


def assert_same_graph(tg, jg):
    assert len(tg.tiers) == len(jg.tiers)
    for a, b in zip(tg.tiers, jg.tiers):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for name in ("row_offset", "src_flat", "ilabel_flat", "init_cost",
                 "final_cost", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    for name in ("olabels_flat", "init_olabels", "final_olabels"):
        assert list(getattr(tg, name)) == list(getattr(jg, name))
    assert tg.num_pdfs == jg.num_pdfs


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g[0] == w[0] and g[1] == w[1]
        assert g[2] == pytest.approx(w[2], rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graphs_equal_jax(seed):
    """Graphs with epsilon arcs and olabels everywhere, a chunk that
    does not divide T; also the exact host search agrees on the cost."""
    rng = np.random.default_rng(seed)
    S, arcs, finals, tid2pdf = random_arcs(rng)
    tf, jf = both_fsts(S, arcs, finals)
    ll = rng.normal(size=(3, 25, 10)).astype(np.float32)
    tg, jg = D.DenseDeviceGraph.build(tf, tid2pdf), \
        J.DenseDeviceGraph.build(jf, tid2pdf)
    assert_same_graph(tg, jg)
    dec = D.DenseViterbiDecoder(tg, chunk=7, device="cpu")
    got = dec.decode_batch(ll, 1.0)
    want, arcs_j = jax_decode(jg, ll, 1.0, 7)
    assert_same_results(got, want)
    np.testing.assert_array_equal(dec.last_arcs, arcs_j)
    assert dec.stats["eps_truncated"] == 0
    assert dec.stats["chosen_arcs"] == sum(len(r[1]) for r in got if r)
    host = FasterDecoder(tf, FasterDecoderOptions(beam=1e9))
    for b in range(3):
        h = host.decode(ll[b], tid2pdf, 1.0)
        assert (h is None) == (got[b] is None)
        if h is not None:
            assert got[b][2] == pytest.approx(h[2], rel=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_lane_lengths_equal_jax(chunk):
    rng = np.random.default_rng(5)
    S, arcs, finals, tid2pdf = random_arcs(rng, eps_frac=0.1)
    tf, jf = both_fsts(S, arcs, finals)
    lens = [9, 17, 25, 1]
    ll = rng.normal(size=(len(lens), 25, 10)).astype(np.float32)
    dec = D.DenseViterbiDecoder(D.DenseDeviceGraph.build(tf, tid2pdf),
                                chunk=chunk, device="cpu")
    got = dec.decode_batch(ll, 0.5, lengths=lens)
    want, arcs_j = jax_decode(J.DenseDeviceGraph.build(jf, tid2pdf), ll,
                              0.5, chunk, lengths=lens)
    assert_same_results(got, want)
    np.testing.assert_array_equal(dec.last_arcs, arcs_j)
    for b, L in enumerate(lens):
        if got[b] is not None:
            assert len(got[b][1]) == L      # one ilabel a frame


def test_from_arrays_equals_build_and_jax():
    rng = np.random.default_rng(11)
    S, arcs, finals, tid2pdf = random_arcs(rng, S=150, eps_frac=0.0)
    tf, _ = both_fsts(S, arcs, finals)
    src, il, ol, w, dst = (np.array(x) for x in zip(*arcs))
    fin = np.full(S, D.INF, np.float32)
    for s, v in finals.items():
        fin[s] = v
    args = (src, dst, tid2pdf[il], ol, w, fin, 0)
    g2 = D.DenseDeviceGraph.from_arrays(*args, ilabel=il, num_pdfs=10)
    assert_same_graph(g2, J.DenseDeviceGraph.from_arrays(
        *args, ilabel=il, num_pdfs=10))
    g1 = D.DenseDeviceGraph.build(tf, tid2pdf)
    ll = rng.normal(size=(2, 20, 10)).astype(np.float32)
    r1 = D.DenseViterbiDecoder(g1, chunk=9, device="cpu").decode_batch(
        ll, 1.0)
    r2 = D.DenseViterbiDecoder(g2, chunk=9, device="cpu").decode_batch(
        ll, 1.0)
    for a, b in zip(r1, r2):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0] and a[1] == b[1]
            assert a[2] == pytest.approx(b[2], rel=1e-5)


def test_eps_closure_truncation_is_counted():
    """A state whose epsilon closure reaches 70 targets keeps the 64
    cheapest, as JAX's does; the graph counts the state."""
    S = 72
    arcs = [(0, EPS, 0, 0.01 * (k + 1), 1 + k) for k in range(70)]
    arcs += [(1 + k, 1 + k % 3, 0, 0.1, 71) for k in range(70)]
    tid2pdf = np.array([0, 0, 1, 2])
    tf, jf = both_fsts(S, arcs, {71: 0.0})
    tg = D.DenseDeviceGraph.build(tf, tid2pdf)
    assert tg.eps_truncated == 1
    assert_same_graph(tg, J.DenseDeviceGraph.build(jf, tid2pdf))
    ll = np.random.default_rng(2).normal(size=(1, 1, 3)).astype(np.float32)
    dec = D.DenseViterbiDecoder(tg, device="cpu")
    got = dec.decode_batch(ll, 1.0)
    assert dec.stats["eps_truncated"] == 1
    assert_same_results(got, jax_decode(J.DenseDeviceGraph.build(
        jf, tid2pdf), ll, 1.0, 32)[0])


def test_no_reachable_final_is_none():
    tf, jf = both_fsts(2, [(0, 1, 1, 0.5, 1)], {})
    g = D.DenseDeviceGraph.build(tf, np.array([0, 0]))
    assert D.DenseViterbiDecoder(g, device="cpu").decode(
        np.zeros((3, 1), np.float32), 1.0) is None
    assert J.DenseViterbiDecoder(J.DenseDeviceGraph.build(
        jf, np.array([0, 0]))).decode(np.zeros((3, 1), np.float32),
                                      1.0) is None


def test_eps_cycle_refused():
    tf, _ = both_fsts(2, [(0, EPS, 0, 0.1, 1), (1, EPS, 0, 0.1, 0)],
                      {1: 0.0})
    with pytest.raises(KaldiTpuError, match="epsilon cycle"):
        D.DenseDeviceGraph.build(tf, np.array([0]))


def test_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    tf, _ = both_fsts(2, [(0, 1, 1, 0.5, 1)], {1: 0.0})
    g = D.DenseDeviceGraph.build(tf, np.array([0, 0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        D.DenseViterbiDecoder(g)


def test_flat_graph_equals_jax():
    """graph_direct's to_dense_device_graph on a small direct HCLG: the
    same tables and decodes as JAX's."""
    from kaldi_tpu.decoder import graph_direct as JG
    from kaldi_tpu_torch.decoder import graph_direct as TG
    spec = dict(vocab=12, num_phones=6, num_pdfs=40, seed=3)
    tg = TG.to_dense_device_graph(TG.build_direct_hclg(
        TG.DirectGraphSpec(**spec)))
    jg = JG.to_dense_device_graph(JG.build_direct_hclg(
        JG.DirectGraphSpec(**spec)))
    assert_same_graph(tg, jg)
    rng = np.random.default_rng(4)
    ll = rng.normal(size=(2, 30, tg.num_pdfs)).astype(np.float32)
    dec = D.DenseViterbiDecoder(tg, chunk=8, device="cpu")
    got = dec.decode_batch(ll, 1.0, lengths=[30, 21])
    want, arcs_j = jax_decode(jg, ll, 1.0, 8, lengths=[30, 21])
    assert_same_results(got, want)
    np.testing.assert_array_equal(dec.last_arcs, arcs_j)
