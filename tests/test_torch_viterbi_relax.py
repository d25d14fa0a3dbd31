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
                                      (3, 5, 0)])
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
