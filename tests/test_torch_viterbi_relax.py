"""Port parity: the padded in-arc relaxation of kaldi_tpu_torch
(`ops/viterbi_relax.py`) against the JAX package's `ops/pallas_viterbi.py`:
`build_incoming_table` array for array, and the plain version `relax_padded`
against jnp `relax_padded` and against Pallas kernel c (`pallas_relax` in
interpret mode).

Tolerance: rtol 1e-6 on live states (three float32 roundings a candidate
in the same order on both sides; XLA may fuse the multiply into the
subtraction, which moves the last bit), and `> INF / 2` on states with no
live in-arc (2e30 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.ops import pallas_viterbi as jx
from kaldi_tpu_torch.ops import viterbi_relax as vr


def make_problem(seed=0, B=4, S=12, A=40, P=6, dead_states=0):
    """Random arcs over S states; the last `dead_states` states get no
    in-arc."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, A).astype(np.int32)
    dst = rng.integers(0, S - dead_states, A).astype(np.int32)
    w = rng.uniform(0, 2, A).astype(np.float32)
    pdf = rng.integers(0, P, A).astype(np.int32)
    cost = rng.uniform(0, 5, (B, S + 1)).astype(np.float32)
    cost[:, S] = vr.INF
    ll = rng.normal(size=(B, P)).astype(np.float32)
    return src, dst, w, pdf, cost, ll


def tens(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_relaxed_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = want < vr.INF / 2
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6)
    assert (got[~live] > vr.INF / 2).all()
    assert np.isfinite(got).all()


def test_inf_is_the_reference_value():
    assert vr.INF == jx.INF and vr.INF.dtype == np.float32


@pytest.mark.parametrize("seed,S,A", [(0, 12, 40), (1, 20, 70), (2, 7, 3),
                                      (3, 5, 0), (4, 300, 5000),
                                      (5, 2000, 3000)])
def test_build_incoming_table_equals_jax(seed, S, A):
    src, dst, w, pdf, _, _ = make_problem(seed, S=S, A=A)
    want = jx.build_incoming_table(S, src, dst, w, pdf)
    got = vr.build_incoming_table(S, src, dst, w, pdf)
    assert got[3] == want[3] and got[3] & (got[3] - 1) == 0
    for g, r in zip(got[:3], want[:3]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    vr.check_tables(got[0], got[2], 6)


@pytest.mark.parametrize("seed,B,S,A,scale", [
    (0, 4, 12, 40, 0.5), (1, 19, 21, 70, 1.0), (2, 3, 13, 13, 0.7)])
def test_plain_matches_jnp_and_pallas_kernel_c(seed, B, S, A, scale):
    """S = 21 and 13 are not multiples of the Pallas state block (8); two
    states have no in-arc and end above INF / 2."""
    src, dst, w, pdf, cost, ll = make_problem(seed, B=B, S=S, A=A,
                                              dead_states=2)
    in_src, in_w, in_pdf, _ = vr.build_incoming_table(S, src, dst, w, pdf)
    got = vr.relax_padded(*tens(cost, in_src, in_w, in_pdf, ll), scale)
    args = [jnp.asarray(a) for a in (cost, in_src, in_w, in_pdf, ll)]
    want = jx.relax_padded(*args, scale)
    assert (np.asarray(want)[:, -2:] > vr.INF / 2).all()
    assert_relaxed_close(got.numpy(), want)
    kernel_c = jx.pallas_relax(*args, scale, state_block=8, interpret=True)
    assert_relaxed_close(got.numpy(), kernel_c)


def test_k_equal_one():
    """A table with at most one in-arc a state (K = 1)."""
    S, B, P = 9, 5, 4
    rng = np.random.default_rng(7)
    dst = rng.permutation(S)[:6].astype(np.int32)
    src = rng.integers(0, S, 6).astype(np.int32)
    w = rng.uniform(0, 2, 6).astype(np.float32)
    pdf = rng.integers(0, P, 6).astype(np.int32)
    cost = rng.uniform(0, 5, (B, S + 1)).astype(np.float32)
    cost[:, S] = vr.INF
    ll = rng.normal(size=(B, P)).astype(np.float32)
    in_src, in_w, in_pdf, K = vr.build_incoming_table(S, src, dst, w, pdf)
    assert K == 1
    got = vr.relax_padded(*tens(cost, in_src, in_w, in_pdf, ll), 1.0)
    want = jx.relax_padded(*[jnp.asarray(a) for a in
                             (cost, in_src, in_w, in_pdf, ll)], 1.0)
    assert_relaxed_close(got.numpy(), want)


def test_per_lane_tables_equal_a_loop_over_lanes():
    """(B, S, K) tables, one a lane, against the shared-table form called
    lane by lane: the same arithmetic, so exactly equal."""
    B, S, P = 5, 11, 6
    tabs, costs, lls = [], [], []
    for b in range(B):
        src, dst, w, pdf, cost, ll = make_problem(10 + b, B=1, S=S,
                                                  A=8 + 6 * b, P=P)
        tabs.append(vr.build_incoming_table(S, src, dst, w, pdf))
        costs.append(cost)
        lls.append(ll)
    K = max(t[3] for t in tabs)
    assert len({t[3] for t in tabs}) > 1

    def pad(a, fill):
        out = np.full((S, K), fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out

    in_src = np.stack([pad(t[0], S) for t in tabs])
    in_w = np.stack([pad(t[1], vr.INF) for t in tabs])
    in_pdf = np.stack([pad(t[2], 0) for t in tabs])
    cost, ll = np.concatenate(costs), np.concatenate(lls)
    got = vr.relax_padded(*tens(cost, in_src, in_w, in_pdf, ll), 0.9)
    for b in range(B):
        one = vr.relax_padded(*tens(cost[b:b + 1], in_src[b], in_w[b],
                                    in_pdf[b], ll[b:b + 1]), 0.9)
        assert torch.equal(got[b:b + 1], one)


@pytest.mark.parametrize("per_lane", [False, True])
def test_closure_mode(per_lane):
    """No acoustic term, and the result is min(old, update); against the
    reference's eps_close body in jnp (`batched_viterbi.py:130-135`)."""
    src, dst, w, _, cost, _ = make_problem(4, B=3, S=10, A=9)
    in_src, in_w, _, _ = vr.build_incoming_table(10, src, dst, w,
                                                 np.zeros_like(src))
    if per_lane:
        in_src, in_w = (np.stack([a] * 3) for a in (in_src, in_w))
    got = vr.relax_padded(*tens(cost, in_src, in_w))
    idx = in_src if per_lane else np.stack([in_src] * 3)
    prev = jnp.take_along_axis(jnp.asarray(cost), idx.reshape(3, -1),
                               axis=1).reshape(idx.shape)
    upd = jnp.min(prev + jnp.asarray(in_w if per_lane else in_w[None]),
                  axis=-1)
    want = np.asarray(jnp.minimum(jnp.asarray(cost)[:, :-1], upd))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < cost[:, :-1]).any() and (want == cost[:, :-1]).any()


def test_out_argument_strided_views_and_dead_column():
    """`out` with S+1 columns gets the dead column too (INF after an
    emitting step, the old value after a closure step), and lanes-fastest
    views give the same numbers as contiguous arrays."""
    S, B = 12, 4
    src, dst, w, pdf, cost, ll = make_problem(5, B=B, S=S)
    in_src, in_w, in_pdf, _ = vr.build_incoming_table(S, src, dst, w, pdf)
    t_cost, t_src, t_w, t_pdf, t_ll = tens(cost, in_src, in_w, in_pdf, ll)
    want = vr.relax_padded(t_cost, t_src, t_w, t_pdf, t_ll, 0.5)
    cost_lf = t_cost.T.contiguous().T                # strides (1, B)
    ll_lf = t_ll.T.contiguous().T
    assert not cost_lf.is_contiguous()
    out = torch.zeros((S + 1, B)).T
    got = vr.viterbi_relax(cost_lf, t_src, t_w, t_pdf, ll_lf, 0.5, out=out)
    assert torch.equal(got, want) and torch.equal(out[:, :S], want)
    assert (out[:, S] == float(vr.INF)).all()
    t_cost[:, S] = 7.0
    out2 = torch.zeros((B, S + 1))
    got2 = vr.viterbi_relax(t_cost, t_src, t_w, out=out2)
    assert torch.equal(got2, vr.relax_padded(t_cost, t_src, t_w))
    assert (out2[:, S] == 7.0).all()
    out3 = torch.zeros((B, S))
    vr.viterbi_relax(t_cost, t_src, t_w, out=out3)
    assert torch.equal(out3, got2)


def test_cpu_call_counts_no_launch():
    src, dst, w, pdf, cost, ll = make_problem(6)
    in_src, in_w, in_pdf, _ = vr.build_incoming_table(12, src, dst, w, pdf)
    before = vr.launches
    vr.viterbi_relax(*tens(cost, in_src, in_w, in_pdf, ll), 1.0)
    assert vr.launches == before


def test_check_tables_rejects_bad_indices():
    in_src = np.array([[0, 3], [2, 2]], np.int32)        # S = 2: 3 > S
    with pytest.raises(ValueError, match="in_src"):
        vr.check_tables(in_src, None, None)
    ok = np.array([[0, 2], [1, 2]], np.int32)
    with pytest.raises(ValueError, match="in_pdf"):
        vr.check_tables(ok, np.array([[0, 5], [1, 0]], np.int32), 5)
    vr.check_tables(ok, np.array([[0, 4], [1, 0]], np.int32), 5)


def degree_problem(seed, B, S, K, P, per_lane):
    """Tables whose states have in-degrees 0, 1, K-1 and K (and random
    ones), costs with INF entries, loglikes."""
    rng = np.random.default_rng(seed)
    tabs, degs = [], []
    for _ in range(B if per_lane else 1):
        deg = rng.integers(0, K + 1, S)
        deg[:4] = rng.permutation([0, 1, max(K - 1, 0), K])
        dst = np.repeat(np.arange(S), deg).astype(np.int32)
        perm = rng.permutation(len(dst))         # arcs in no order
        dst = dst[perm]
        src = rng.integers(0, S, len(dst)).astype(np.int32)
        w = rng.uniform(0, 2, len(dst)).astype(np.float32)
        pdf = rng.integers(0, P, len(dst)).astype(np.int32)
        tab = vr.build_incoming_table(S, src, dst, w, pdf)
        assert tab[3] == K
        tabs.append(tab)
        degs.append(deg)
    arrs = [np.stack([t[i] for t in tabs]) for i in range(3)]
    deg = np.stack(degs)
    if not per_lane:
        arrs, deg = [a[0] for a in arrs], deg[0]
    cost = rng.uniform(0, 50, (B, S + 1)).astype(np.float32)
    cost[rng.random(cost.shape) < 0.3] = vr.INF
    cost[:, S] = vr.INF
    ll = (rng.normal(size=(B, P)) * 4).astype(np.float32)
    return arrs, deg, cost, ll


def live_walk_model(cost, in_src, in_w, in_pdf, ll, scale, in_deg):
    """The CUDA kernel's plan in numpy float32: each state takes its live
    prefix and, when it has a dead slot, slot K-1 for all of them.  Three
    roundings a candidate, in the plain version's order."""
    B, S, K = cost.shape[0], in_src.shape[-2], in_src.shape[-1]
    out = np.empty((B, S), np.float32)
    for b in range(B):
        tab = (lambda a: a if a.ndim == 2 else a[b])
        src, w, deg = tab(in_src), tab(in_w), (in_deg if in_deg.ndim == 1
                                               else in_deg[b])
        for s in range(S):
            d = int(deg[s])
            ks = list(range(d)) + ([K - 1] if d < K else [])
            cand = cost[b, src[s, ks]] + w[s, ks]
            if in_pdf is None:
                out[b, s] = min(cost[b, s], cand.min())
            else:
                ac = np.float32(scale) * ll[b, tab(in_pdf)[s, ks]]
                out[b, s] = (cand - ac).min()
    return out


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("seed,B,S,K", [(0, 3, 9, 4), (1, 5, 14, 8),
                                        (2, 2, 6, 1), (3, 4, 11, 2)])
def test_live_counts_equal_the_in_degrees(seed, B, S, K, per_lane):
    (in_src, in_w, in_pdf), deg, _, _ = degree_problem(seed, B, S, K, 5,
                                                       per_lane)
    got = vr.live_counts(in_src, in_w, in_pdf)
    assert got.dtype == np.int32 and got.shape == in_src.shape[:-1]
    np.testing.assert_array_equal(got, deg)
    assert {0, 1, K - 1, K} <= set(got.ravel().tolist())
    # an epsilon table has no pdf; pdf 0 on a live arc is still live
    np.testing.assert_array_equal(vr.live_counts(in_src, in_w), deg)
    np.testing.assert_array_equal(
        vr.live_counts(in_src, in_w, np.zeros_like(in_pdf)), deg)


@pytest.mark.parametrize("per_lane", [False, True])
def test_live_counts_raise_on_a_hole(per_lane):
    (in_src, in_w, in_pdf), deg, _, _ = degree_problem(4, 3, 9, 4, 5,
                                                       per_lane)
    s = int(np.argwhere((deg if deg.ndim == 1 else deg[1]) == 1)[0, 0])
    at = (s,) if not per_lane else (1, s)
    # move the state's one live slot behind a dead one
    for a, dead in ((in_src, 9), (in_w, vr.INF), (in_pdf, 0)):
        a[at + (2,)] = a[at + (0,)]
        a[at + (0,)] = dead
    in_pdf[at + (2,)] = 1
    with pytest.raises(ValueError, match="live slot after a dead one"):
        vr.live_counts(in_src, in_w, in_pdf)


@pytest.mark.parametrize("big_ll0", [False, True])
@pytest.mark.parametrize("seed,B,S,K,scale,per_lane", [
    (0, 3, 9, 4, 1.0, False), (1, 5, 14, 8, 0.3, False),
    (2, 2, 6, 1, 0.3, False), (3, 4, 11, 2, 0.7, True),
    (4, 3, 13, 16, 1.0, True)])
def test_live_walk_model_equals_plain_and_jax(seed, B, S, K, scale, per_lane,
                                              big_ll0):
    """The kernel's plan (live prefix + one dead slot) against the port's
    plain version over all K slots (exactly equal) and against the JAX
    package's jnp version and Pallas kernel c in interpret mode (the
    tolerance of test_plain_matches_jnp_and_pallas_kernel_c), emitting and
    closure; with ll[:, 0] = 1e25 a dead slot's candidate is not 2e30."""
    (in_src, in_w, in_pdf), deg, cost, ll = degree_problem(seed, B, S, K, 5,
                                                           per_lane)
    if big_ll0:
        ll[:, 0] = 1e25
    t_deg = torch.from_numpy(deg)
    model = live_walk_model(cost, in_src, in_w, in_pdf, ll, scale, deg)
    plain = vr.relax_padded(*tens(cost, in_src, in_w, in_pdf, ll), scale,
                            in_deg=t_deg)
    np.testing.assert_array_equal(model, plain.numpy())
    if big_ll0:
        no_arc = model[np.broadcast_to(deg, (B, S)) == 0]
        assert (no_arc < vr.INF + vr.INF).all() and (no_arc > vr.INF).all()
    model_c = live_walk_model(cost, in_src, in_w, None, None, 1.0, deg)
    plain_c = vr.relax_padded(*tens(cost, in_src, in_w), in_deg=t_deg)
    np.testing.assert_array_equal(model_c, plain_c.numpy())
    # the wrapper on CPU tensors, with and without the counts
    assert torch.equal(vr.viterbi_relax(*tens(cost, in_src, in_w, in_pdf, ll),
                                        scale, in_deg=t_deg), plain)
    assert torch.equal(vr.PreparedRelax(*tens(in_src, in_w), in_deg=t_deg)(
        torch.from_numpy(cost)), plain_c)
    # the JAX package's functions take one (S, K) table: lane by lane for
    # one table a lane
    for b in (range(B) if per_lane else [slice(None)]):
        rows = slice(b, b + 1) if per_lane else b
        tabs = [a[b] if per_lane else a for a in (in_src, in_w, in_pdf)]
        args = [jnp.asarray(a) for a in (cost[rows], tabs[0], tabs[1],
                                         tabs[2], ll[rows])]
        want = np.asarray(jx.relax_padded(*args, scale))
        kernel_c = jx.pallas_relax(*args, scale, state_block=8,
                                   interpret=True)
        if big_ll0:
            # candidates of 1e25 and 2e30: nothing ends above INF / 2 only
            np.testing.assert_allclose(model[rows], want, rtol=1e-6)
            np.testing.assert_allclose(model[rows], kernel_c, rtol=1e-6)
        else:
            assert_relaxed_close(model[rows], want)
            assert_relaxed_close(model[rows], kernel_c)


def test_prepared_relax_on_cpu_equals_plain_and_checks_nothing_twice():
    src, dst, w, pdf, cost, ll = make_problem(8)
    in_src, in_w, in_pdf, _ = vr.build_incoming_table(12, src, dst, w, pdf)
    deg = torch.from_numpy(vr.live_counts(in_src, in_w, in_pdf))
    t_cost, t_src, t_w, t_pdf, t_ll = tens(cost, in_src, in_w, in_pdf, ll)
    plan = vr.PreparedRelax(t_src, t_w, t_pdf, 0.6, deg)
    before = vr.launches
    out = torch.zeros((4, 13))
    got = plan(t_cost, t_ll, out=out)
    assert vr.launches == before
    assert torch.equal(got, vr.relax_padded(t_cost, t_src, t_w, t_pdf, t_ll,
                                            0.6))
    assert torch.equal(out[:, :12], got) and (out[:, 12] == vr.INF).all()
    with pytest.raises(ValueError, match="K >= 1"):
        vr.PreparedRelax(t_src[:, :0], t_w[:, :0])
    # a cost row on another device than the tables is refused by name
    with pytest.raises(ValueError, match="the tables on cpu"):
        plan(torch.empty((4, 13), device="meta"), t_ll)


@pytest.mark.parametrize("closure", [False, True])
def test_each_call_gives_a_function_the_prepared_form(closure):
    """`each_call(f)` makes, from a table set, the callable that
    `PreparedRelax` makes: same arguments, same results, and every call
    hands `f` the tables, the scale and the live counts again."""
    src, dst, w, pdf, cost, ll = make_problem(9)
    in_src, in_w, in_pdf, _ = vr.build_incoming_table(12, src, dst, w, pdf)
    deg = torch.from_numpy(vr.live_counts(in_src, in_w, in_pdf))
    t_cost, t_src, t_w, t_pdf, t_ll = tens(cost, in_src, in_w, in_pdf, ll)
    seen = []

    def relax(*args, **kw):
        seen.append((len(args), sorted(kw)))
        assert kw["in_deg"] is deg
        return vr.relax_padded(*args, **kw)

    tables = (t_src, t_w, None if closure else t_pdf, 0.6, deg)
    rows = (t_cost,) if closure else (t_cost, t_ll)
    step, plan = vr.each_call(relax)(*tables), vr.PreparedRelax(*tables)
    out = torch.zeros((4, 13))
    got = step(*rows, out=out)
    assert torch.equal(got, plan(*rows))
    assert torch.equal(out[:, :12], got)
    assert torch.equal(step(*rows), got)
    assert seen == [(3 if closure else 6, ["in_deg", "out"])] * 2


def identity_tables(S=6, KN=2, KE=4):
    """An all-dead epsilon table and an emitting table with one chain arc
    a state (a dead slot everywhere): the closure step is the identity.
    -> [ne_in_src, ne_in_w, ne_deg, e_in_src, e_in_w, e_deg]"""
    ne_src = np.full((S, KN), S, np.int32)
    ne_w = np.full((S, KN), vr.INF, np.float32)
    e_src = np.full((S, KE), S, np.int32)
    e_w = np.full((S, KE), vr.INF, np.float32)
    e_src[:, 0] = np.maximum(np.arange(S) - 1, 0)
    e_w[:, 0] = 0.5
    return [ne_src, ne_w, np.zeros(S, np.int32), e_src, e_w,
            np.ones(S, np.int32)]


def test_closure_is_identity_accepts_dead_tables_and_self_arcs():
    tabs = identity_tables()
    ne_src, ne_w, ne_deg, e_src, e_w, e_deg = tabs
    assert vr.closure_is_identity(*tabs)
    # the pad arc of `DeviceGraph.padded`: the last state to itself, INF
    ne_src[5, 0], ne_w[5, 0], ne_deg[5] = 5, vr.INF, 1
    assert vr.closure_is_identity(*tabs)
    # a self-arc of any weight >= 0 never wins either
    ne_src[2, 0], ne_w[2, 0], ne_deg[2] = 2, 0.0, 1
    assert vr.closure_is_identity(*tabs)
    # a state whose emitting slots are all live, one of them of ordinary
    # weight from a state that has a dead slot: still at most 2e30
    e_src[3], e_w[3], e_deg[3] = [2, 5, 6, 3], [0.5, vr.INF, 1.0, 2.0], 4
    assert vr.closure_is_identity(*tabs)
    # one table a lane
    assert vr.closure_is_identity(*[np.stack([a] * 3) for a in tabs])


@pytest.mark.parametrize("case", [
    "real_arc", "inf_arc_between_states", "negative_self_arc",
    "full_state_of_inf_arcs", "full_state_fed_by_full_states"])
def test_closure_is_identity_rejects(case):
    tabs = identity_tables()
    ne_src, ne_w, ne_deg, e_src, e_w, e_deg = tabs
    if case == "real_arc":
        ne_src[3, 0], ne_w[3, 0], ne_deg[3] = 1, 0.5, 1
    elif case == "inf_arc_between_states":
        # lowers an unreachable state's 2e30 to 1e30
        ne_src[3, 0], ne_w[3, 0], ne_deg[3] = 1, vr.INF, 1
    elif case == "negative_self_arc":
        ne_src[3, 0], ne_w[3, 0], ne_deg[3] = 3, -0.5, 1
    elif case == "full_state_of_inf_arcs":
        # all slots live and INF (pad arcs): INF more every frame, and a
        # dead epsilon slot would lower it to 2e30
        e_src[2], e_w[2], e_deg[2] = 2, vr.INF, 4
    else:
        # ordinary weights, but only from states that have no dead slot
        e_src[2], e_w[2], e_deg[2] = 3, 1.0, 4
        e_src[3], e_w[3], e_deg[3] = 2, 1.0, 4
    assert not vr.closure_is_identity(*tabs)
    if case.startswith("full_state"):
        # with the pad self-arc in its only epsilon slot the state is free
        tabs[0], tabs[1] = ne_src[:, :1].copy(), ne_w[:, :1].copy()
        for s in (2, 3):
            tabs[0][s, 0], tabs[1][s, 0], ne_deg[s] = s, vr.INF, 1
        assert vr.closure_is_identity(*tabs)
