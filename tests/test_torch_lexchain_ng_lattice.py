"""Port parity: lattice mode of the n-gram lexchain decoder of
kaldi_tpu_torch (`NgramLexDecoder.decode_batch_lattice`) against the JAX
reference, on the CPU, on the small graphs of test_torch_lexchain_ng.py.

The frame dumps must equal the reference's element for element where
their values are finite (the port selects the pool, the word-end events
and the finals exactly; JAX's approx_min_k computes the same on the CPU).
decode_batch_lattice must give lattices with equal state counts and
starts and, per state, equal arcs (ilabel, olabel, nextstate); weights
and final weights are held to atol 1e-4 (the reference's span acoustics
are differences of float32 prefix sums, the port's of float64 ones).
The parity cases run at lattice_beam 20: the port keeps every captured
word-end event for the exact alpha + beta pruning of the assembly, where
the reference first drops the events whose cost exceeds the lane's
final best plus the beam, which also drops in-beam paths whose cost to
go is negative (test_falling_costs_keep_their_lattices).

The properties of tests/test_lexchain_ng_lattice.py hold for the port:
the best path is kept (equal to decode_batch with the same pool), the
arc count grows with the beam, n-best costs are no less than the Viterbi
cost, a small event cap keeps the best path, and every final state sits
at the lane's last frame.  The port's events also hold the word ends of
the best path whatever their rank in their frame
(test_best_path_word_ends_enter_the_events): on the main path's V=20,000
graph, 64 events a frame without them leave 3 of the 128 test lanes with
other words (chip_main_path.py, probe_reference_events)."""

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.lexchain_ng import BIG as JAX_BIG
from kaldi_tpu.decoder.lexchain_ng import NgramLexDecoder as JaxDecoder
from kaldi_tpu_torch.decoder.lexchain_ng import (IBIG, INF, SLOT_SENTINEL,
                                                 NgramLexDecoder)
from kaldi_tpu_torch.lat.functions import (lattice_best_path, lattice_nbest,
                                           lattice_state_times)
from test_torch_block_chain_lattice import assert_lattices_match
from test_torch_lexchain_ng import graphs

CASES = {
    "nosil_ctx1_variants": dict(seed=0, use_sil=False, ctx=1, extra=1),
    "sil_ctx3": dict(seed=1, use_sil=True, ctx=3, extra=0),
    "sil_ctx1_variants": dict(seed=2, use_sil=True, ctx=1, extra=1),
    "nosil_ctx3": dict(seed=3, use_sil=False, ctx=3, extra=0),
    "ragged_empty_lane": dict(seed=4, use_sil=True, ctx=3, extra=1,
                              lengths=[9, 5, 0]),
    "scaled": dict(seed=5, use_sil=True, ctx=1, extra=0,
                   acoustic_scale=0.7),
    "J2_cap8": dict(seed=2, V=8, use_sil=True, ctx=3, extra=1, J=2,
                    event_cap=8),
}


def case_inputs(c, B=3, T=9):
    jg, tg, rng = graphs(c["seed"], V=c.get("V", 6), use_sil=c["use_sil"],
                         ctx=c["ctx"], extra_variants=c["extra"])
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    kw = dict(acoustic_scale=c.get("acoustic_scale", 1.0),
              lengths=c.get("lengths"), J=c.get("J", 4),
              event_cap=c.get("event_cap", 64))
    return jg, tg, ll, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_batch_lattice_matches_jax(case):
    jg, tg, ll, kw = case_inputs(CASES[case])
    want = JaxDecoder(jg).decode_batch_lattice(ll, lattice_beam=20.0, **kw)
    stats = {}
    got = NgramLexDecoder(tg, device="cpu").decode_batch_lattice(
        ll, lattice_beam=20.0, stats=stats, **kw)
    assert sorted(stats) == ["assemble_s", "fwd_s", "n_events", "pool_s"]
    assert stats["n_events"] > 0
    lengths = kw["lengths"] or [ll.shape[1]] * ll.shape[0]
    for b, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None) == (lengths[b] == 0), b
        if w is not None:
            assert_lattices_match(g, w)
            assert g.num_arcs() > lengths[b]        # alternatives


def _jax_dumps(jg, ll, K, L, lengths):
    """The reference's lattice forward (roots, shadows, shadow start
    frames and the 13 frame dumps) as numpy arrays."""
    import jax.numpy as jnp
    jdec = JaxDecoder(jg)
    B, T, _ = ll.shape
    fwd = jdec._make_lattice_step(B, K, L, float(JAX_BIG))
    Nr, U = jg.Nr, jg.U
    am = jnp.transpose(jnp.asarray(ll) * -1.0, (1, 2, 0))
    active = jnp.asarray(np.arange(T)[:, None] < np.asarray(lengths)[None])
    out = fwd(jnp.full((Nr, B), INF, jnp.float32),
              jnp.zeros((Nr, B), jnp.float32),
              jnp.full((U + 1, B), INF, jnp.float32).at[U].set(0.0),
              jnp.full((U + 1, B), INF, jnp.float32),
              jnp.full((U + 1, B), -1.0, jnp.float32), am, active)
    roots, sil, sil_t, ys = out
    return [np.asarray(x) for x in (roots, sil, sil_t)], \
        [np.asarray(y) for y in ys]


DUMPS = ("ids", "vals", "pslot", "p_fromsil", "p_srct", "nval", "nslot",
         "n_fromsil", "n_srct", "n_srcval", "ev_ids", "ev_val", "ev_te")


@pytest.mark.parametrize("seed,use_sil,extra", [(2, True, 1), (3, False, 0)])
def test_frame_dumps_and_finals_match_jax(seed, use_sil, extra):
    """Each dump plane equal to the reference's where its value is
    finite (the pool planes where the pool value is, the events' where
    the event value is, the null state's where nval is), with a pool of
    K=5 rows a frame and L=7 events, so that both selections cut, and no
    unit forced into the events (the reference's selection); the
    final planes equal and the finals' selection equal to
    approx_min_k's where the finals are finite."""
    jg, tg, rng = graphs(seed, V=8, use_sil=use_sil, ctx=3,
                         extra_variants=extra)
    B, T, K, L = 3, 10, 5, 7
    ll = (rng.normal(size=(B, T, tg.num_pdfs)) * 2).astype(np.float32)
    lengths = [T, 6, 3]
    (j_roots, j_sil, j_silt), ys = _jax_dumps(jg, ll, K, L, lengths)
    dec = NgramLexDecoder(tg, device="cpu")
    am = torch.as_tensor(-ll).permute(1, 2, 0).contiguous()
    active = torch.as_tensor(np.arange(T)[:, None]
                             < np.asarray(lengths)[None])
    no_force = torch.full((T, B), -1)
    roots, sil, sil_t, outs = dec._forward_lattice(am, active, K, L,
                                                   no_force)
    for got, want in ((roots, j_roots), (sil, j_sil), (sil_t, j_silt)):
        np.testing.assert_array_equal(got.numpy(), want)
    live = {"pool": ys[1] < INF / 2, "null": ys[5] < INF / 2,
            "ev": ys[11] < INF / 2}
    assert live["pool"].any() and (~live["pool"]).any()
    assert live["ev"].all(axis=2).any() and (~live["ev"]).any()
    for name, want in zip(DUMPS, ys):
        got = outs[name].numpy()
        assert got.shape == want.shape, name
        mask = live["ev" if name.startswith("ev") else
                    "null" if name.startswith("n") else "pool"]
        np.testing.assert_array_equal(got[mask], want[mask], err_msg=name)
    # the finals: each lane's 2(U+1) root and shadow finals, the 32
    # smallest (fewer here), in approx_min_k's order
    U = tg.U
    fv, slot, is_sil, stime, best = (x.numpy() for x in
                                     dec._finals(roots, sil, sil_t))
    eos = tg.eos_of_slot()[:, None]
    allfin = np.concatenate([j_roots + eos,
                             j_sil + eos if use_sil else
                             np.full_like(j_roots, INF)], 0)
    w_fv, w_fi = (np.asarray(x) for x in
                  jax.lax.approx_min_k(allfin.T, min(32, 2 * (U + 1))))
    np.testing.assert_allclose(fv, w_fv, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(best, w_fv.min(axis=1))
    fin = w_fv < INF / 2                # INF entries come in any order
    assert fin.any()
    np.testing.assert_array_equal(is_sil[fin], (w_fi >= U + 1)[fin])
    np.testing.assert_array_equal(
        slot[fin], np.where(w_fi >= U + 1, w_fi - (U + 1), w_fi)[fin])
    np.testing.assert_array_equal(
        stime, np.take_along_axis(j_silt.T, np.clip(slot, 0, U), 1))


def test_raw_slot_decodes_the_fold_encoding():
    dec = NgramLexDecoder(graphs(0)[1], device="cpu")
    enc = torch.tensor([-1, 0, 1, 6, 7, SLOT_SENTINEL], dtype=torch.int32)
    assert dec._raw_slot(enc).tolist() == [-1, 0, 0, 3, 3, IBIG]


def test_pool_chunks_give_the_values_of_one_pass():
    """The survivor pools in chunks of one survivor equal one pass."""
    jg, tg, ll, kw = case_inputs(CASES["sil_ctx1_variants"])
    dec = NgramLexDecoder(tg, device="cpu")
    one = dec.decode_batch_lattice(ll, lattice_beam=20.0, **kw)
    chunked = NgramLexDecoder(tg, device="cpu")
    chunked.POOL_CHUNK_BYTES = 1
    calls = []
    inner = chunked._pool_chunk
    chunked._pool_chunk = lambda *a: calls.append(1) or inner(*a)
    stats = {}
    got = chunked.decode_batch_lattice(ll, lattice_beam=20.0, stats=stats,
                                       **kw)
    assert len(calls) == stats["n_events"] > 1
    for g, w in zip(got, one):
        assert_lattices_match(g, w, atol=0.0)


def _hyp_check(lat, hyp, T):
    ali, words, cost = lattice_best_path(lat)
    assert words == hyp[0]
    assert abs(cost - hyp[2]) <= 1e-3 * max(1.0, abs(hyp[2]))
    assert len(ali) == T


@pytest.mark.parametrize("seed,use_sil,ctx", [
    (0, False, 1), (1, True, 3), (2, True, 1), (3, False, 3)])
def test_best_path_preserved(seed, use_sil, ctx):
    _, tg, rng = graphs(seed, use_sil=use_sil, ctx=ctx)
    dec = NgramLexDecoder(tg, device="cpu")
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll, prune_k=128)
    lats = dec.decode_batch_lattice(ll, lattice_beam=20.0, J=4)
    for b in range(B):
        assert best[b] is not None and lats[b] is not None
        _hyp_check(lats[b], best[b], T)


def test_beam_monotone_and_alternatives():
    _, tg, rng = graphs(5, V=8, use_sil=True, ctx=3)
    dec = NgramLexDecoder(tg, device="cpu")
    ll = rng.normal(size=(1, 10, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll)[0]
    sizes = []
    for beam in (2.0, 8.0, 25.0):
        lat = dec.decode_batch_lattice(ll, lattice_beam=beam, J=4)[0]
        assert lat is not None
        _hyp_check(lat, best, 10)
        sizes.append(lat.num_arcs())
    assert sizes[0] <= sizes[1] <= sizes[2]
    assert sizes[2] > sizes[0]


def test_nbest_costs_are_no_less_than_viterbi():
    _, tg, rng = graphs(7, V=6, use_sil=True, ctx=1)
    dec = NgramLexDecoder(tg, device="cpu")
    ll = rng.normal(size=(1, 8, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll)[0]
    lat = dec.decode_batch_lattice(ll, lattice_beam=30.0, J=4)[0]
    costs = [p[2] for p in lattice_nbest(lat, n=8)]
    assert len(costs) == 8
    assert abs(min(costs) - best[2]) < 1e-3
    assert all(c >= best[2] - 1e-3 for c in costs)
    assert costs == sorted(costs)


@pytest.mark.parametrize("seed,J,cap,beam", [
    (2, 2, 8, 6.0), (0, 4, 1, 8.0), (4, 2, 1, 8.0), (5, 4, 2, 8.0)])
def test_event_cap_keeps_best_path(seed, J, cap, beam):
    _, tg, rng = graphs(seed, V=8, use_sil=True, ctx=3)
    dec = NgramLexDecoder(tg, device="cpu")
    ll = rng.normal(size=(2, 10, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll)
    lats = dec.decode_batch_lattice(ll, lattice_beam=beam, J=J,
                                    event_cap=cap)
    for b in range(2):
        assert lats[b] is not None
        _hyp_check(lats[b], best[b], 10)


def test_best_path_word_ends_enter_the_events():
    """One event a frame: the reference keeps each frame's cheapest word
    end only, and no lane's lattice holds its best path; the port's
    events also hold the best path's word ends, so every lattice does."""
    jg, tg, rng = graphs(2, V=8, use_sil=True, ctx=3, extra_variants=1)
    ll = rng.normal(size=(3, 12, tg.num_pdfs)).astype(np.float32)
    dec = NgramLexDecoder(tg, device="cpu")
    best = dec.decode_batch(ll, prune_k=128)
    kw = dict(lattice_beam=8.0, event_cap=1)
    for ref, h in zip(JaxDecoder(jg).decode_batch_lattice(ll, **kw), best):
        assert ref is None or lattice_best_path(ref)[1] != h[0]
    for lat, h in zip(dec.decode_batch_lattice(ll, **kw), best):
        _hyp_check(lat, h, 12)


def test_state_times_reach_each_lane_length():
    _, tg, rng = graphs(4, use_sil=True, ctx=3)
    dec = NgramLexDecoder(tg, device="cpu")
    lengths = [9, 7, 4]
    ll = rng.normal(size=(3, 9, tg.num_pdfs)).astype(np.float32)
    for lat, n in zip(dec.decode_batch_lattice(ll, lengths=lengths), lengths):
        times = lattice_state_times(lat)
        assert max(times) == n and min(times) == 0
        finals = [s for s in range(lat.num_states) if lat.is_final(s)]
        assert finals and all(times[s] == n for s in finals)


def test_falling_costs_keep_their_lattices():
    """Loglikes shifted up, as a chain model's are: the path cost falls
    frame by frame, so all but the last frames' events cost more than
    the final best plus the beam.  The reference keeps those few events
    and gives lane 0 no lattice (on the main path's V=20,000 graph with
    the flagship model no event at all is within that beam:
    chip_main_path.py, probe_survivor_rule); the port's lattices hold the
    best path of decode_batch."""
    jg, tg, rng = graphs(1, use_sil=True, ctx=3, extra_variants=1)
    ll = (rng.normal(size=(2, 12, tg.num_pdfs)) + 4.0).astype(np.float32)
    dec = NgramLexDecoder(tg, device="cpu")
    best = dec.decode_batch(ll, prune_k=128)
    assert all(h[2] < -20.0 for h in best)
    ref_stats, stats = {}, {}
    assert JaxDecoder(jg).decode_batch_lattice(ll, stats=ref_stats)[0] \
        is None
    lats = dec.decode_batch_lattice(ll, stats=stats)
    assert stats["n_events"] > 5 * ref_stats["n_events"]
    for lat, h in zip(lats, best):
        _hyp_check(lat, h, 12)
