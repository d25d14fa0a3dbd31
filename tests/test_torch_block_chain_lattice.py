"""Port parity: lattice mode of the block-chain decoder of
kaldi_tpu_torch against the JAX reference (Pallas kernel b in interpret
mode).

The step's plain version must equal kernel b exactly on all five outputs
(adds, compares and selects only), equal costs included: the top-J list
depends on the order of insertion there, and both sides insert the
blocks in ascending order.  The device post-pass must give equal bits,
a_best and alpha_fin; its cumulative sums are taken in another order than
XLA's, so am_cs is held to atol 1e-4.  decode_batch_lattice must give
lattices with equal state counts and equal arcs (ilabel, olabel,
nextstate) per state; weights and final weights are held to atol 1e-4
(the acoustic part of a self-span arc is a difference of two cumulative
sums).  The port's lattice best path must give the words of the port's
best-path decode, and its cost within 1e-3."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas

from kaldi_tpu.decoder.block_chain import BlockChainDecoder as JaxDecoder
from kaldi_tpu_torch.decoder.block_chain import BlockChainDecoder
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.ops.block_chain_lattice_step import (
    block_chain_lattice_step, block_chain_lattice_step_reference)
from kaldi_tpu_torch.ops.block_chain_step import INF
from test_torch_block_chain import _random_step_inputs, graphs


def _jax_kernel_b(monkeypatch, jdec, B, J):
    """Capture the pallas_call kernel b that _make_lattice_step builds."""
    captured = []
    orig = pallas.pallas_call

    def spy(*args, **kwargs):
        fn = orig(*args, **kwargs)
        captured.append(fn)
        return fn

    monkeypatch.setattr(pallas, "pallas_call", spy)
    jdec._make_lattice_step(B, J)
    assert len(captured) == 1
    return captured[0]


def _lattice_step_inputs(rng, dec, B, t):
    cost, ovr, amf, ams = _random_step_inputs(rng, dec, B)
    ent = rng.integers(0, t + 1, size=cost.shape).astype(np.float32)
    return cost, ent, ovr, amf, ams


def _both_steps(monkeypatch, jg, tg, B, J, t, planes):
    """Kernel b (interpret mode) and the port's plain version on the same
    planes -> (five JAX outputs, five port outputs) as numpy arrays."""
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    assert (dec.Up, dec.Vp) == (jdec.Up, jdec.Vp)
    kernel_b = _jax_kernel_b(monkeypatch, jdec, B, J)
    cost, ent, ovr, amf, ams = planes(dec)
    first_f = jg.row_is_first.astype(np.float32)[:, None]
    want = kernel_b(np.full((1,), t, np.int32), cost, ent, ovr, amf, ams,
                    first_f, np.asarray(jdec._bigram_ends))
    got = block_chain_lattice_step_reference(
        t, *(torch.from_numpy(a) for a in (cost, ent, ovr, amf, ams)),
        dec._first, dec._bigram_ends, dec._end_src,
        torch.ones(B, dtype=torch.bool), J=J)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


NAMES = ("new", "ent_new", "rc", "ru", "re")


@pytest.mark.parametrize("seed,B,J", [(0, 3, 4), (1, 5, 2)])
def test_lattice_step_plain_equals_kernel_b(monkeypatch, seed, B, J):
    jg, tg = graphs(seed)
    rng = np.random.default_rng(seed + 11)
    t = 5 + seed
    want, got = _both_steps(
        monkeypatch, jg, tg, B, J, t,
        lambda dec: _lattice_step_inputs(rng, dec, B, t))
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    rc, ru, re = want[2:]
    assert (rc[J - 1] < INF).any()           # full lists exist
    assert (rc[0] >= INF).any()              # and empty ones (pad slots)
    assert len(np.unique(ru)) > 2 and (re == t).any()


def test_lattice_step_plain_equals_kernel_b_on_ties(monkeypatch):
    """Every block holds the same columns and the bigram costs are one
    constant, so the candidates of blocks 0, 1 and 2 meet at equal cost;
    blocks 3 and 7 are lowered, so that later, smaller candidates displace
    entries of equal cost (the sequential insertion ends with blocks
    [7, 3, 2, 0], where a sort by (cost, block) would give [7, 3, 0, 1]).
    The lists must match entry for entry."""
    jg, tg = graphs(2)
    jg.bigram[:] = 1.25
    tg.bigram[:] = 1.25
    B, J, t = 3, 4, 6
    rng = np.random.default_rng(23)

    def planes(dec):
        cost, ent, ovr, amf, ams = _lattice_step_inputs(rng, dec, B, t)
        cost[:] = cost[0]
        ovr[:] = ovr[0]
        for plane in (cost, ovr):
            plane[4:] += 1.0
            plane[3] -= 2.0
            plane[7] -= 5.0
        return cost, ent, ovr, amf, ams

    want, got = _both_steps(monkeypatch, jg, tg, B, J, t, planes)
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    rc, ru = want[2], want[3]
    live = rc[J - 1] < INF
    # a displaced entry passes its equals: block order is not kept
    assert ((rc[2] == rc[3]) & (ru[2] > ru[3]) & live).any()


def test_lattice_step_freezes_inactive_lanes_and_refuses_aliasing():
    _, tg = graphs(2)
    dec = BlockChainDecoder(tg, device="cpu")
    B, J, t = 4, 3, 2
    rng = np.random.default_rng(5)
    cost, ent, ovr, amf, ams = [
        torch.from_numpy(a) for a in _lattice_step_inputs(rng, dec, B, t)]
    tables = (dec._first, dec._bigram_ends, dec._end_src)
    active = torch.tensor([True, False, True, False])
    new, ent_new = torch.empty_like(cost), torch.empty_like(ent)
    out = block_chain_lattice_step(t, cost, ent, ovr, amf, ams, *tables,
                                   active, J=J, new=new, ent_new=ent_new)
    assert out[0] is new and out[1] is ent_new
    assert torch.equal(new[:, :, ~active], cost[:, :, ~active])
    assert torch.equal(ent_new[:, :, ~active], ent[:, :, ~active])
    all_on = block_chain_lattice_step_reference(
        t, cost, ent, ovr, amf, ams, *tables,
        torch.ones(B, dtype=torch.bool), J=J)
    assert torch.equal(new[:, :, active], all_on[0][:, :, active])
    assert torch.equal(ent_new[:, :, active], all_on[1][:, :, active])
    assert not torch.equal(new[:, :, active], cost[:, :, active])
    for a, b in zip(out[2:], all_on[2:]):        # lists ignore `active`
        assert torch.equal(a, b)
    for bad in (dict(new=cost), dict(ent_new=ent), dict(new=ent),
                dict(new=new, ent_new=new)):
        with pytest.raises(ValueError, match="alias"):
            block_chain_lattice_step(t, cost, ent, ovr, amf, ams, *tables,
                                     active, J=J, **bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_lat_post_matches_jax(seed):
    jg, tg = graphs(seed)
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    V, Up, Vp = tg.V, dec.Up, dec.Vp
    T, J, B, beam = 7, 4, 3, 6.0
    rng = np.random.default_rng(seed + 3)
    exp_w = (rng.normal(size=(T, J, V, B)) * 4 + 20).astype(np.float32)
    exp_w[rng.random(exp_w.shape) < 0.2] = INF
    alpha = (rng.normal(size=(T, Up, B)) * 4 + 18).astype(np.float32)
    alpha[:, V:] = INF
    am_rs = rng.normal(size=(T, Vp, B)).astype(np.float32)
    lengths = np.array([T, T - 3, 0], np.int32)
    want = jdec._make_lat_post(B, J, beam)(exp_w, alpha, am_rs, lengths)
    got = dec._lat_post(torch.from_numpy(exp_w), torch.from_numpy(alpha),
                        torch.from_numpy(am_rs),
                        torch.from_numpy(lengths.astype(np.int64)), beam)
    bits, a_best, alpha_fin, am_cs = [np.asarray(w) for w in want]
    assert 0 < np.unpackbits(bits).sum() < bits.size * 8
    np.testing.assert_array_equal(got[0].numpy(), bits)
    np.testing.assert_array_equal(got[1].numpy(), a_best)
    np.testing.assert_array_equal(got[2].numpy(), alpha_fin)
    np.testing.assert_allclose(got[3].numpy(), am_cs, rtol=0, atol=1e-4)


def assert_lattices_match(got, want, atol=1e-4):
    assert got.num_states == want.num_states
    assert got.start == want.start
    for s in range(want.num_states):
        assert [(a.ilabel, a.olabel, a.nextstate) for a in got.arcs[s]] == \
            [(a.ilabel, a.olabel, a.nextstate) for a in want.arcs[s]], s
        for a, r in zip(got.arcs[s], want.arcs[s]):
            np.testing.assert_allclose(a.weight, r.weight, rtol=0, atol=atol)
        if np.isfinite(want.finals[s][0]):
            np.testing.assert_allclose(got.finals[s], want.finals[s],
                                       rtol=0, atol=atol)
        else:
            assert got.finals[s] == want.finals[s]


CASES = {
    "seed0": dict(seed=0, B=2, T=8),
    "seed1": dict(seed=1, B=2, T=8),
    "ragged": dict(seed=2, B=3, T=9, lengths=[9, 6, 3]),
    "scaled": dict(seed=4, B=2, T=10, acoustic_scale=0.7,
                   graph=dict(V=12, num_pdfs=64, max_pron=6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_batch_lattice_matches_jax(case):
    c = CASES[case]
    jg, tg = graphs(c["seed"], **c.get("graph", {}))
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    rng = np.random.default_rng(c["seed"] + 30)
    B, T = c["B"], c["T"]
    ll = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)
    kw = dict(acoustic_scale=c.get("acoustic_scale", 1.0),
              lengths=c.get("lengths"))
    want = jdec.decode_batch_lattice(ll, lattice_beam=20.0, J=4, **kw)
    stats = {}
    got = dec.decode_batch_lattice(ll, lattice_beam=20.0, J=4, stats=stats,
                                   **kw)
    assert sorted(stats) == ["assemble_s", "fwd_s", "gather_s",
                             "n_survivors", "post_s", "selfseg_s",
                             "unpack_s"]
    assert stats["n_survivors"] > 0
    best = dec.decode_batch(ll, **kw)
    lengths = c.get("lengths") or [T] * B
    for b in range(B):
        assert want[b] is not None and got[b] is not None
        assert_lattices_match(got[b], want[b])
        words0, _tids, cost0 = best[b]
        ali, words1, cost1 = lattice_best_path(got[b])
        assert words1 == words0
        assert len(ali) == lengths[b]
        assert abs(cost1 - cost0) < 1e-3, f"{cost1} vs {cost0}"
        # alternatives exist at a wide beam
        assert got[b].num_arcs() > len(words0) + lengths[b]


def test_decode_one_utterance_and_tid2pdf():
    jg, tg = graphs(1)
    dec = BlockChainDecoder(tg, device="cpu")
    ll = np.random.default_rng(9).normal(
        size=(6, jg.num_pdfs)).astype(np.float32)
    assert dec.decode(ll, 0.9) == dec.decode_batch(ll[None], 0.9)[0]
    ref = JaxDecoder(jg, interpret=True).decode(ll, 0.9)
    assert dec.decode(ll, 0.9)[:2] == ref[:2]
    np.testing.assert_array_equal(tg.tid2pdf, jg.tid2pdf)


@pytest.mark.parametrize("scale,beam,seed,n_none", [(6.0, 8.0, 1, 0),
                                                   (10.0, 4.0, 3, 2)])
def test_narrow_beam_lattice_can_miss_the_viterbi_path_as_in_jax(
        scale, beam, seed, n_none):
    """With peaked acoustics and a narrow lattice beam the lattice need
    not hold the Viterbi path, and a lane can end without a lattice: the
    final states are word ends reached in the last frame, and the
    per-frame beam can cut the way to them.  The port follows the
    reference there: the same lanes have no lattice, the others have
    equal lattices (weights atol 1e-4), and in both the lattice's best
    path costs between the Viterbi cost and that plus the beam (tolerance
    1e-3)."""
    from kaldi_tpu.lat.functions import lattice_best_path as jax_best_path
    jg, tg = graphs(4, V=12, num_pdfs=64, max_pron=6)
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    ll = (np.random.default_rng(seed).normal(size=(8, 30, 64))
          * scale).astype(np.float32)
    best = dec.decode_batch(ll)
    want = jdec.decode_batch_lattice(ll, lattice_beam=beam)
    got = dec.decode_batch_lattice(ll, lattice_beam=beam)
    assert [lat is None for lat in got] == [lat is None for lat in want]
    assert sum(lat is None for lat in got) == n_none
    missed = 0
    for b in range(8):
        if got[b] is None:
            continue
        assert_lattices_match(got[b], want[b])
        _ali, words, cost = lattice_best_path(got[b])
        assert (words, cost) == jax_best_path(got[b])[1:]
        assert best[b][2] - 1e-3 <= cost <= best[b][2] + beam + 1e-3
        missed += abs(cost - best[b][2]) > 1e-3
    assert 0 < missed < 8
