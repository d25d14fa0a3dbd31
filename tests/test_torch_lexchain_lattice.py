"""Port parity: lattice mode of the LexChain decoder of kaldi_tpu_torch
(`LexChainDecoder.decode_batch_lattice`) against the JAX reference, on
the CPU, on the small graphs of test_torch_lexchain.py.

The forward frame dumps (rmin, src_time, entry, end_cand, arr_te,
take_end, roots) and the backward pass's (bentry, broots) must equal the
reference's element for element where their values are finite; the
survivor pools the reference's on the same survivors, and their j=0
value the forward's entry bit for bit (the arc expansion's alphas are
differences against it).  decode_batch_lattice must give lattices with
equal state counts and starts and, per state, equal arcs (ilabel,
olabel, nextstate); weights and final weights are held to atol 1e-4
(the reference's self-extension acoustics are differences of float32
prefix sums, the port's of float64 ones).  The parity cases run at
lattice_beam 20.

The properties of tests/test_lexchain_lattice.py hold for the port: the
best path is kept (decode_batch's words and cost), with and without
determinization, every path spans the lane's frames, the arc count grows
with the beam, and n-best costs are no less than the Viterbi cost.  The
survivor cut is an exact alpha + beta test, so it also holds where path
costs fall frame by frame (test_falling_costs_keep_the_best_path)."""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.lexchain import LexChainDecoder as JaxDecoder
from kaldi_tpu_torch.decoder.lexchain import INF, LexChainDecoder
from kaldi_tpu_torch.lat.functions import (determinize_lattice_pruned,
                                           lattice_best_path, lattice_nbest,
                                           lattice_state_times)
from test_torch_block_chain_lattice import assert_lattices_match
from test_torch_lexchain import graphs

CASES = {
    "nosil": dict(seed=0, use_sil=False),
    "sil": dict(seed=1, use_sil=True),
    "variants": dict(seed=2, use_sil=True, extra_variants=4),
    "nosil_variants": dict(seed=3, use_sil=False, extra_variants=3),
    "ragged_empty_lane": dict(seed=4, use_sil=True, lengths=[9, 5, 0]),
    "scaled": dict(seed=5, use_sil=True, acoustic_scale=0.7),
    "J2": dict(seed=6, use_sil=True, extra_variants=2, J=2),
    "model_tables": dict(seed=7, use_sil=True, model=True),
    "buckets": dict(seed=8, use_sil=True, V=12, n_expl=60, buckets=True),
}
STATS = ["assemble_s", "bwd_scan_s", "expand_s", "fwd_s", "fwd_scan_s",
         "gather_s", "n_arcs", "n_arrival", "n_entry", "n_nodes",
         "n_word_surv", "nodegather_s", "post_s", "unpack_s"]


def case_inputs(c, B=3, T=9):
    kw = dict(use_sil=c["use_sil"], sil_phone=5, sil_prob=0.4,
              extra_variants=c.get("extra_variants", 1),
              V=c.get("V", 7), n_expl=c.get("n_expl", 12))
    if c.get("model"):
        kw.update(model=True, sil_phone=2, V=5, n_expl=8)
        kw.pop("sil_prob")
    jg, tg, rng = graphs(c["seed"], **kw)
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    kw = dict(acoustic_scale=c.get("acoustic_scale", 1.0),
              lengths=c.get("lengths"), J=c.get("J", 4))
    return jg, tg, ll, kw


def port_decoder(tg, c):
    dec = LexChainDecoder(tg, device="cpu")
    if c.get("buckets"):
        assert dec._use_dense_corr and len(dec._buckets) > 1
        dec._use_dense_corr = False
    return dec


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_batch_lattice_matches_jax(case):
    c = CASES[case]
    jg, tg, ll, kw = case_inputs(c)
    jdec = JaxDecoder(jg)
    if c.get("buckets"):
        jdec._use_dense_corr = False
    want = jdec.decode_batch_lattice(ll, lattice_beam=20.0, **kw)
    stats = {}
    got = port_decoder(tg, c).decode_batch_lattice(
        ll, lattice_beam=20.0, stats=stats, **kw)
    assert sorted(stats) == STATS
    assert stats["n_arcs"] > 0 and stats["n_entry"] >= stats["n_word_surv"]
    lengths = kw["lengths"] or [ll.shape[1]] * ll.shape[0]
    for b, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None) == (lengths[b] == 0), b
        if w is not None:
            assert_lattices_match(g, w)
            assert g.num_arcs() > lengths[b]        # alternatives


def _inputs(ll, lengths):
    """The frame loops' inputs: am (T, pdfs, B) costs, active (T, B)."""
    T = ll.shape[1]
    am = torch.as_tensor(-ll).permute(1, 2, 0).contiguous()
    active = torch.as_tensor(np.arange(T)[:, None]
                             < np.asarray(lengths)[None])
    return am, active


def _jax_passes(jg, ll, lengths):
    """The reference's lattice forward (final roots, shadows, shadow start
    frames and its 8 frame dumps) and backward (bentry, broots), run
    directly, as numpy arrays."""
    import jax.numpy as jnp
    jdec = JaxDecoder(jg)
    B, T, _ = ll.shape
    N, P = jg.N, jg.P
    am = jnp.transpose(jnp.asarray(ll) * -1.0, (1, 2, 0))
    active = jnp.asarray(np.arange(T)[:, None] < np.asarray(lengths)[None])
    fwd = jdec._make_lattice_step(B, 4)
    out = fwd(jnp.full((N, B), INF, jnp.float32),
              jnp.zeros((N, B), jnp.float32),
              jnp.full((P + 1, B), INF, jnp.float32).at[P].set(0.0),
              jnp.full((P + 1, B), INF, jnp.float32),
              jnp.full((P + 1, B), -1.0, jnp.float32), am, active)
    binit = jnp.broadcast_to(jnp.asarray(
        jg.lm.eos[jdec._ctx_word].astype(np.float32))[:, None], (P + 1, B))
    bys = jdec._make_backward_step(B)(
        binit, binit if jg.use_sil else jnp.full_like(binit, INF), am,
        active)
    return ([np.asarray(x) for x in out[:3]],
            [np.asarray(y) for y in out[3]], [np.asarray(y) for y in bys])


DUMPS = ("rmin", "src_time", "entry", "end_cand", "arr_te", "take_end",
         "roots")


@pytest.mark.parametrize("seed,use_sil,extra", [(2, True, 2), (3, False, 0),
                                                (9, True, 1)])
def test_frame_dumps_and_betas_match_jax(seed, use_sil, extra):
    """Each forward dump equal to the reference's where its value is
    finite (the planes of a cost where that cost is; rmin's where rmin
    is, for src_time; end_cand's for arr_te and take_end), and each
    backward dump where it is finite; the final planes equal."""
    jg, tg, rng = graphs(seed, V=8, n_expl=20, use_sil=use_sil,
                         sil_phone=5, sil_prob=0.4, extra_variants=extra)
    B, T = 3, 10
    ll = (rng.normal(size=(B, T, tg.num_pdfs)) * 2).astype(np.float32)
    lengths = [T, 6, 3]
    (j_roots, j_sil, j_silt), ys, (j_bentry, j_broots) = _jax_passes(
        jg, ll, lengths)
    dec = LexChainDecoder(tg, device="cpu")
    am, active = _inputs(ll, lengths)
    roots, sil, sil_t, outs = dec._forward_lattice(am, active)
    bys = dec._backward(am, active)
    for got, want in ((roots, j_roots), (sil, j_sil), (sil_t, j_silt)):
        np.testing.assert_array_equal(got.numpy(), want)
    finite = {"rmin": ys[0] < INF / 2, "entry": ys[2] < INF / 2,
              "end_cand": ys[3] < INF / 2, "roots": ys[6] < INF / 2}
    assert all(m.any() for m in finite.values())
    assert (~finite["end_cand"]).any()
    masks = dict(finite, src_time=finite["rmin"], arr_te=finite["end_cand"],
                 take_end=finite["end_cand"])
    for name, want in zip(DUMPS, ys):
        got = outs[name].numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got[masks[name]], want[masks[name]],
                                      err_msg=name)
    for name, want in (("bentry", j_bentry), ("broots", j_broots)):
        got = bys[name].numpy()
        live = want < INF / 2
        assert got.shape == want.shape and live.any(), name
        np.testing.assert_array_equal(got[live], want[live], err_msg=name)
        np.testing.assert_array_equal(got >= INF / 2, ~live, err_msg=name)


@pytest.mark.parametrize("seed,use_sil,J", [(1, True, 4), (0, False, 3),
                                            (6, True, 2)])
def test_survivor_pools_match_jax_and_entry(seed, use_sil, J):
    """The top-J pools at every survivor of the alpha + beta cut: j=0
    is the forward's entry bit for bit (torch.equal), and every column
    equals the reference's pools on the same survivors; the survivors
    are the reference's bitmask set, in its bit order."""
    import jax.numpy as jnp
    jg, tg, rng = graphs(seed, V=9, n_expl=25, use_sil=use_sil,
                         sil_phone=5, sil_prob=0.4, extra_variants=2)
    B, T, beam = 3, 11, 6.0
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = [T, 8, 5]
    dec = LexChainDecoder(tg, device="cpu")
    am, active = _inputs(ll, lengths)
    roots, sil, _, ys = dec._forward_lattice(am, active)
    fin = roots + dec._eos
    if use_sil:
        fin = torch.cat([fin, sil + dec._eos], 0)
    best = fin.amin(dim=0)
    bys = dec._backward(am, active)
    keep, _ = dec._lat_post(ys, bys, best, active, beam)
    st, sw, sb = dec._bit_order_nonzero(keep)
    assert 0 < len(st) < keep.numel()
    key = (st * keep.shape[1] + sw // 8) * B * 8 + sb * 8 + sw % 8
    assert (np.diff(key) > 0).all()
    pools = dec._surv_pools(ys, bys["bentry"], best, st, sw, sb, J, beam)
    ecv = torch.as_tensor(pools[0])
    assert torch.equal(ecv[:, 0], ys["entry"][st, sw, sb])
    assert pools[4][:, 0].all() and not pools[4].all()
    _, jys, (j_bentry, _) = _jax_passes(jg, ll, lengths)
    jdec = JaxDecoder(jg)
    want = jdec._make_surv_pools(B, J, beam)(
        jnp.asarray(jys[0]), jnp.asarray(jys[1]), jnp.asarray(j_bentry),
        jnp.asarray(best.numpy()), jnp.asarray(st), jnp.asarray(sw),
        jnp.asarray(sb))
    for got, w in zip(pools, want):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_pool_chunks_give_the_values_of_one_pass():
    jg, tg, ll, kw = case_inputs(CASES["variants"])
    one = LexChainDecoder(tg, device="cpu").decode_batch_lattice(
        ll, lattice_beam=20.0, **kw)
    chunked = LexChainDecoder(tg, device="cpu")
    chunked.POOL_CHUNK_BYTES = 1
    calls = []
    inner = chunked._pool_chunk
    chunked._pool_chunk = lambda *a: calls.append(1) or inner(*a)
    stats = {}
    got = chunked.decode_batch_lattice(ll, lattice_beam=20.0, stats=stats,
                                       **kw)
    assert len(calls) == stats["n_word_surv"] > 1
    for g, w in zip(got, one):
        assert_lattices_match(g, w, atol=0.0)


def _hyp_check(lat, hyp, T, rel=1e-4):
    ali, words, cost = lattice_best_path(lat)
    assert words == hyp[0]
    assert abs(cost - hyp[2]) <= rel * max(1.0, abs(hyp[2]))
    assert len(ali) == T


@pytest.mark.parametrize("seed,use_sil", [(0, False), (1, True), (2, True),
                                          (3, False)])
def test_best_path_preserved(seed, use_sil):
    """The lattice's best path is decode_batch's (words, cost, one tid a
    frame), alternatives exist, and determinization keeps the best
    path."""
    _, tg, rng = graphs(seed, use_sil=use_sil, sil_phone=5, sil_prob=0.4)
    dec = LexChainDecoder(tg, device="cpu")
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll)
    lats = dec.decode_batch_lattice(ll, lattice_beam=20.0, J=4)
    for b in range(B):
        assert best[b] is not None and lats[b] is not None
        _hyp_check(lats[b], best[b], T)
        assert lats[b].num_arcs() > len(best[b][0]) + T
        det = determinize_lattice_pruned(lats[b], beam=10.0)
        _, words, cost = lattice_best_path(det)
        assert words == best[b][0]
        assert abs(cost - best[b][2]) < 1e-4 * max(1.0, abs(best[b][2]))


def test_beam_monotone():
    """A smaller lattice beam gives a (weakly) smaller lattice, and the
    best path survives every beam."""
    _, tg, rng = graphs(5, use_sil=True, sil_phone=5, sil_prob=0.4)
    dec = LexChainDecoder(tg, device="cpu")
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
    """Every lattice path is a real path: its cost is no less than the
    Viterbi cost, and the cheapest is the Viterbi path."""
    _, tg, rng = graphs(6, use_sil=True, sil_phone=5, sil_prob=0.4)
    dec = LexChainDecoder(tg, device="cpu")
    ll = rng.normal(size=(1, 8, tg.num_pdfs)).astype(np.float32)
    best = dec.decode_batch(ll)[0]
    lat = dec.decode_batch_lattice(ll, lattice_beam=25.0, J=4)[0]
    costs = [p[2] for p in lattice_nbest(lat, n=10)]
    assert len(costs) == 10
    assert costs == sorted(costs)
    assert abs(costs[0] - best[2]) < 1e-4 * max(1.0, abs(best[2]))
    assert all(c >= best[2] - 1e-4 for c in costs)


def test_falling_costs_keep_the_best_path():
    """Loglikes shifted up, as a chain model's are: every path's cost
    falls frame by frame (the cost to go is negative).  The survivor cut
    tests alpha + the exact beta against the final best, so the lattices
    hold decode_batch's path, equal to the reference's."""
    jg, tg, rng = graphs(1, use_sil=True, sil_phone=5, sil_prob=0.4,
                         extra_variants=2)
    ll = (rng.normal(size=(2, 12, tg.num_pdfs)) + 4.0).astype(np.float32)
    dec = LexChainDecoder(tg, device="cpu")
    best = dec.decode_batch(ll)
    assert all(h[2] < -20.0 for h in best)
    lats = dec.decode_batch_lattice(ll, lattice_beam=8.0)
    want = JaxDecoder(jg).decode_batch_lattice(ll, lattice_beam=8.0)
    for lat, w, h in zip(lats, want, best):
        assert lat is not None
        _hyp_check(lat, h, 12)
        assert_lattices_match(lat, w)


def test_state_times_reach_each_lane_length():
    _, tg, rng = graphs(4, use_sil=True, sil_phone=5, sil_prob=0.4)
    dec = LexChainDecoder(tg, device="cpu")
    lengths = [9, 7, 4]
    ll = rng.normal(size=(3, 9, tg.num_pdfs)).astype(np.float32)
    for lat, n in zip(dec.decode_batch_lattice(ll, lengths=lengths),
                      lengths):
        times = lattice_state_times(lat)
        assert max(times) == n and min(times) == 0
        finals = [s for s in range(lat.num_states) if lat.is_final(s)]
        assert finals and all(times[s] == n for s in finals)


def test_tables_match_jax_and_errors():
    """The reverse buckets and the backward pass's row helpers equal the
    reference's; a short pdf axis is refused; no frame, no lattice."""
    jg, tg, rng = graphs(8, V=12, n_expl=60, use_sil=True, sil_phone=5,
                         extra_variants=3)
    jd, td = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    assert len(td._rev_buckets) == len(jd._rev_buckets) > 1
    for (ts, tc), (js, jc) in zip(td._rev_buckets, jd._rev_buckets):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc[:, :, 0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td._rev_inv_perm.numpy(),
                                  np.asarray(jd._rev_inv_perm))
    for name in ("is_end_row", "var_of_row", "first_row_of_var", "k1_mask",
                 "tr_fwd_pad", "tr_self_pad"):
        np.testing.assert_array_equal(getattr(td, "_" + name).numpy(),
                                      np.asarray(jd._c[name]), err_msg=name)
    np.testing.assert_array_equal(td._ctx_word, jd._ctx_word)
    ll = rng.normal(size=(2, 6, tg.num_pdfs)).astype(np.float32)
    with pytest.raises(ValueError, match="pdf dim"):
        td.decode_batch_lattice(ll[:, :, :5])
    assert td.decode_batch_lattice(ll[:, :0]) == [None, None]
    assert td.decode_batch_lattice(ll, lengths=[0, 0]) == [None, None]
