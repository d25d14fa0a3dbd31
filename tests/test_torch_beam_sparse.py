"""Port parity: the beam-sparse device decoder
(`kaldi_tpu_torch/decoder/beam_sparse.py`) against the JAX package's
(`kaldi_tpu/decoder/beam_sparse.py`) on the CPU, on the same random
graphs and continuous random acoustics made from a seed.

Tolerances: the degree-capped graph and its tables equal; `_dedup_min`
on constructed ties gives JAX's states and costs exactly (the port's
stable sorts stand for XLA's top_k, lexsort and stable argsort); per
lane the words and states of the traceback equal and the total cost
within 1e-5 relative of JAX's (the same float32 sums in the same
order).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_dense_relax import both_fsts, random_arcs  # noqa: E402

from kaldi_tpu.decoder import beam_sparse as J
from kaldi_tpu_torch.decoder import beam_sparse as D
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext.fst import EPS
from kaldi_tpu_torch.fstext.ops import equal_paths

INF = float(D.INF)


def fst_rows(f):
    return f.start, [list(map(tuple, a)) for a in f.arcs], list(f.finals)


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g[0] == w[0] and g[1] == w[1]
            assert g[2] == pytest.approx(w[2], rel=1e-5, abs=1e-6)


def test_cap_out_degree_language_and_tables_equal_jax():
    rng = np.random.default_rng(0)
    S, arcs, finals, tid2pdf = random_arcs(rng, S=60, eps_frac=0.2)
    # one state of out-degree 23
    arcs += [(3, 1 + k % 30, k % 4, 0.1 * k, (7 * k) % S)
             for k in range(23)]
    tf, jf = both_fsts(S, arcs, finals)
    for d in (4, 8):
        tc, jc = D.cap_out_degree(tf, d), J.cap_out_degree(jf, d)
        assert all(len(tc.arcs[s]) <= d for s in range(tc.num_states))
        assert fst_rows(tc) == fst_rows(jc)
        assert tc.num_states > S
        tg = D.SparseDeviceGraph.build(tf, tid2pdf, max_degree=d)
        jg = J.SparseDeviceGraph.build(jf, tid2pdf, max_degree=d)
        for name in ("e_dst", "e_pdf", "e_olabel", "e_w", "n_dst",
                     "n_olabel", "n_w", "finals"):
            np.testing.assert_array_equal(getattr(tg, name),
                                          getattr(jg, name))
        assert (tg.start, tg.eps_depth) == (jg.start, jg.eps_depth)
    # the language, on the reference test's graph: a state of out-degree
    # 9 split for degree 4
    small = [(0, i % 3 + 1, i % 3 + 1, float(rng.uniform(0, 2)), 1 + i % 3)
             for i in range(9)]
    tf, jf = both_fsts(4, small, {1: 0.5, 2: 0.5, 3: 0.5})
    tc = D.cap_out_degree(tf, 4)
    assert tc.num_states > 4 and equal_paths(tf, tc)
    assert fst_rows(tc) == fst_rows(J.cap_out_degree(jf, 4))


def dedup_cases():
    rng = np.random.default_rng(3)
    cases = []
    # many duplicates, equal costs within a state and across states
    s = rng.integers(0, 6, 40)
    c = rng.integers(0, 4, 40).astype(np.float32)
    cases.append((s, c, 8))
    # the 2 * capacity pre-filter cuts inside a run of tied costs
    s = rng.integers(0, 50, 64)
    c = np.repeat(np.float32([0.5, 1.0, 1.5, 2.0]), 16)
    rng.shuffle(c)
    cases.append((s, c, 8))
    # padding: INF costs, INF + w, fewer unique states than capacity
    s = np.array([9, 9, 9, 2, 2, 5, 9, 9, 1, 1, 1, 1])
    c = np.float32([INF, 2 * INF, INF, 0.0, 0.0, 3.0, INF, 0.0, 1.0, 1.0,
                    INF, 0.5])
    cases.append((s, c, 5))
    # continuous costs
    cases.append((rng.integers(0, 100, 300),
                  rng.normal(size=300).astype(np.float32), 32))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_dedup_min_ties_equal_jax(case):
    import jax.numpy as jnp
    s, c, K = dedup_cases()[case]
    js, jc, _ = J._dedup_min(jnp.asarray(s, jnp.int32),
                             jnp.asarray(c, jnp.float32),
                             jnp.zeros(len(s), jnp.int32), K)
    # as one lane, and as the second of two lanes
    other = torch.randint(0, 100, (1, len(s)))
    ts, tc = D._dedup_min(
        torch.cat([other, torch.as_tensor(s[None], dtype=torch.int64)]),
        torch.cat([torch.rand(1, len(s)), torch.as_tensor(c[None])]), K)
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc))
    ts1, tc1 = D._dedup_min(torch.as_tensor(s[None], dtype=torch.int64),
                            torch.as_tensor(c[None]), K)
    assert torch.equal(ts1[0], ts[1]) and torch.equal(tc1[0], tc[1])


def graph_pair(seed, S=120, eps_frac=0.15, max_degree=6):
    rng = np.random.default_rng(seed)
    S, arcs, finals, tid2pdf = random_arcs(rng, S=S, eps_frac=eps_frac)
    tf, jf = both_fsts(S, arcs, finals)
    return (D.SparseDeviceGraph.build(tf, tid2pdf, max_degree=max_degree),
            J.SparseDeviceGraph.build(jf, tid2pdf, max_degree=max_degree),
            tf, tid2pdf, rng)


@pytest.mark.parametrize("beam,capacity", [(1e9, 512), (6.0, 64),
                                           (4.0, 16)])
def test_lanes_equal_jax_and_single_decodes(beam, capacity):
    tg, jg, tf, tid2pdf, rng = graph_pair(1)
    ll = rng.normal(size=(3, 18, 10)).astype(np.float32)
    dec = D.BeamSparseDecoder(tg, beam=beam, capacity=capacity,
                              device="cpu")
    got = dec.decode_batch(ll, 1.0)
    want = J.BeamSparseDecoder(jg, beam=beam,
                               capacity=capacity).decode_batch(ll, 1.0)
    assert_same_results(got, want)
    assert dec.stats["traceback_failures"] == 0
    for b in range(3):
        assert_same_results([dec.decode(ll[b], 1.0)], [got[b]])
    if beam > 1e8:
        # unbounded beam, capacity above the states: the exact search
        host = FasterDecoder(tf, FasterDecoderOptions(beam=1e9))
        for b in range(3):
            h = host.decode(ll[b], tid2pdf, 1.0)
            assert got[b][2] == pytest.approx(h[2], rel=1e-4)
            assert got[b][0] == h[1]


def test_capacity_overflow_equals_jax():
    """A frontier far below the live states: the decode still returns
    (or gives up) exactly as JAX's does."""
    tg, jg, _, _, rng = graph_pair(2, S=200, eps_frac=0.1)
    ll = rng.normal(size=(2, 25, 10)).astype(np.float32)
    dec = D.BeamSparseDecoder(tg, beam=30.0, capacity=4, device="cpu")
    got = dec.decode_batch(ll, 1.0)
    assert_same_results(got, J.BeamSparseDecoder(
        jg, beam=30.0, capacity=4).decode_batch(ll, 1.0))
    assert any(r is not None for r in got)


def test_eps_cycle_refused():
    from kaldi_tpu_torch.base.logging import KaldiTpuError
    tf, _ = both_fsts(2, [(0, EPS, 0, 0.1, 1), (1, EPS, 0, 0.1, 0)],
                      {1: 0.0})
    with pytest.raises(KaldiTpuError, match="epsilon cycle"):
        D.SparseDeviceGraph.build(tf, np.array([0]))


def test_traceback_failure_is_counted():
    """A frontier whose recorded costs no arc explains: the traceback
    gives up at the last frame, warns and counts it."""
    tg, _, _, _, rng = graph_pair(4)
    ll = rng.normal(size=(1, 6, 10)).astype(np.float32)
    dec = D.BeamSparseDecoder(tg, beam=1e9, capacity=256, device="cpu")
    real = dec._decode_device

    def shifted(ac):
        fr_s, fr_c, shifts, s0, c0 = real(ac)
        return fr_s, fr_c + 5.0, shifts, s0, c0
    dec._decode_device = shifted
    out = dec.decode_batch(ll, 1.0)
    assert out[0] is not None and dec.stats["traceback_failures"] == 1


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    tg, _, _, _, _ = graph_pair(0, S=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.BeamSparseDecoder(tg)
