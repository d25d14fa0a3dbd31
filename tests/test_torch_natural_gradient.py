"""Port parity: the online natural-gradient preconditioner
(kaldi_tpu_torch/nnet3/natural_gradient.py) against the JAX package's
optax transformation (kaldi_tpu/nnet3/natural_gradient.py), both paths
(low rank: power step, QR, rho, Woodbury; dense: EMA + eigh), on the
same gradients, in float64 (JAX under `jax.enable_x64`) and in float32.

Tolerances: each step's preconditioned gradient within 1e-9 (float64) or
1e-4 (float32: the QR's and eigh's rounding, amplified by the smoothed
inverse, reaches 2.4e-5) of its largest magnitude; the state's V V^T, s,
rho (low rank) or covariance (dense) the same (a QR or eigh may flip a
column of V, so V itself is not compared); the gradient's norm kept
within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kaldi_tpu.nnet3 import natural_gradient as jng
from kaldi_tpu_torch.nnet3 import natural_gradient as tng
from kaldi_tpu_torch.parallel import optim

SHAPES = {"w_in": (12, 40), "w_out": (70, 30), "bias": (30,),
          "w_small": (5, 6)}
RANK = 8


def grads_of(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in SHAPES.items():
        g = rng.normal(size=shp).astype(np.float32)
        if len(shp) == 2:
            # a few strong directions, as real gradients have
            ax = 0 if shp[0] <= shp[1] else 1
            d = shp[ax]
            basis = rng.normal(size=(d, 3)).astype(np.float32) * 4.0
            mix = rng.normal(size=(3, shp[1 - ax])).astype(np.float32)
            low = basis @ mix
            g = g + (low if ax == 0 else low.T)
        out[k] = g
    return out


TOL = {np.float64: 1e-9, np.float32: 1e-4}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


def jax_tree(tree, dtype):
    return {k: jnp.asarray(np.asarray(v, dtype)) for k, v in tree.items()}


def to_torch(tree, dtype=torch.float32):
    return {k: torch.tensor(np.asarray(v), dtype=dtype)
            for k, v in tree.items()}


def close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), \
        np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def same_state(t_state, j_state, rel=1e-5):
    for k in SHAPES:
        f, jf = t_state.fisher[k], j_state.fisher[k]
        if jf is None:
            assert f is None
        elif isinstance(jf, tuple):
            V, s, rho = (x.numpy() for x in f)
            jV, js, jrho = (np.asarray(x) for x in jf)
            close(V @ V.T, jV @ jV.T, rel)
            close(s, js, rel)
            close(rho, jrho, rel)
        else:
            close(f.numpy(), jf, rel)
    assert int(t_state.count) == int(j_state.count)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rank", [RANK, None])
def test_five_steps_match_optax(rank, dtype):
    jtx = jng.online_natural_gradient(rank=rank)
    ttx = tng.online_natural_gradient(rank=rank)
    params = grads_of(100)
    tol = TOL[dtype]
    with jax.enable_x64(dtype == np.float64):
        j_state = jtx.init(jax_tree(params, dtype))
        t_state = ttx.init(to_torch(params, TORCH[dtype]))
        kinds = {k: type(f).__name__ for k, f in t_state.fisher.items()}
        assert kinds["bias"] == "NoneType"
        if rank:
            assert kinds["w_in"] == kinds["w_out"] == "tuple"
            assert kinds["w_small"] == "Tensor"       # 5 <= rank: dense
        for step in range(5):
            g = grads_of(step)
            j_out, j_state = jtx.update(jax_tree(g, dtype), j_state)
            t_out, t_state = ttx.update(to_torch(g, TORCH[dtype]), t_state)
            for k in SHAPES:
                assert t_out[k].dtype == TORCH[dtype]
                close(t_out[k].numpy(), j_out[k], tol)
                # the norm is kept (the trace renormalisation)
                assert float(torch.linalg.norm(t_out[k])) == pytest.approx(
                    float(np.linalg.norm(g[k])), rel=1e-5)
            np.testing.assert_array_equal(t_out["bias"].numpy(), g["bias"])
            same_state(t_state, j_state, tol)


@pytest.mark.parametrize("rank", [RANK, None])
def test_state_converter_continues_from_jax(rank):
    """Two JAX steps, the state carried to the port by ng_state_from_numpy,
    three more steps of each from there."""
    jtx = jng.online_natural_gradient(rank=rank)
    ttx = tng.online_natural_gradient(rank=rank)
    j_state = jtx.init({k: jnp.asarray(v) for k, v in grads_of(1).items()})
    for step in range(2):
        _, j_state = jtx.update({k: jnp.asarray(v) for k, v in
                                 grads_of(step).items()}, j_state)
    fisher = {k: (None if f is None else
                  tuple(np.asarray(x) for x in f) if isinstance(f, tuple)
                  else np.asarray(f)) for k, f in j_state.fisher.items()}
    t_state = tng.ng_state_from_numpy(fisher, int(j_state.count))
    same_state(t_state, j_state)
    for step in range(2, 5):
        g = grads_of(step)
        j_out, j_state = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    j_state)
        t_out, t_state = ttx.update(to_torch(g), t_state)
        for k in SHAPES:
            close(t_out[k].numpy(), j_out[k])
    same_state(t_state, j_state)


def test_composes_with_sgd_as_optax():
    """chain(natural gradient, sgd) minimising a quadratic, 6 steps:
    the parameters of each step equal optax's."""
    rng = np.random.default_rng(7)
    A = {k: rng.normal(size=SHAPES[k]).astype(np.float32) for k in SHAPES}
    params = {k: np.zeros(SHAPES[k], np.float32) for k in SHAPES}
    jtx = optax.chain(jng.online_natural_gradient(rank=RANK), optax.sgd(0.1))
    ttx = optim.chain(tng.online_natural_gradient(rank=RANK), optim.sgd(0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = to_torch(params)
    j_state, t_state = jtx.init(jp), ttx.init(tp)

    def j_grad(p):
        return {k: 2.0 * (p[k] - A[k]) * (1.0 + jnp.arange(
            p[k].shape[-1], dtype=jnp.float32) / 7.0) for k in p}

    def t_grad(p):
        return {k: 2.0 * (p[k] - torch.tensor(A[k])) * (1.0 + torch.arange(
            p[k].shape[-1], dtype=torch.float32) / 7.0) for k in p}
    for _ in range(6):
        u, j_state = jtx.update(j_grad(jp), j_state, jp)
        jp = optax.apply_updates(jp, u)
        u, t_state = ttx.update(t_grad(tp), t_state, tp)
        tp = optim.apply_updates(tp, u)
        for k in SHAPES:
            close(tp[k].numpy(), jp[k], rel=1e-5)
    # it moved toward the minimum
    for k in SHAPES:
        assert np.abs(tp[k].numpy() - A[k]).mean() < np.abs(A[k]).mean()


def test_float64_state_follows_the_parameters():
    """The state takes the parameters' dtype: a float64 run agrees with
    the float32 one to float32's precision, and pg V V^T are invariant to
    flipping a column of V."""
    ttx = tng.online_natural_gradient(rank=RANK)
    g = grads_of(3)
    s32 = ttx.init(to_torch(g))
    s64 = ttx.init(to_torch(g, torch.float64))
    assert s64.fisher["w_in"][0].dtype == torch.float64
    o32, s32 = ttx.update(to_torch(g), s32)
    o64, s64 = ttx.update(to_torch(g, torch.float64), s64)
    for k in SHAPES:
        close(o32[k].numpy(), o64[k].numpy(), rel=1e-5)
    V, s, rho = s64.fisher["w_out"]
    flipped = V.clone()
    flipped[:, 0] = -flipped[:, 0]
    a = dict(s64.fisher)
    a["w_out"] = (flipped, s, rho)
    g2 = to_torch(grads_of(4), torch.float64)
    out_a, _ = ttx.update(g2, tng.NGState(a, s64.count))
    out_b, _ = ttx.update(g2, s64)
    close(out_a["w_out"].numpy(), out_b["w_out"].numpy(), rel=1e-12)
