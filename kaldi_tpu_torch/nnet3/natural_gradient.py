"""Online natural-gradient preconditioning (port of
`kaldi_tpu/nnet3/natural_gradient.py`; capability parity:
nnet3/natural-gradient-online.h:414 OnlineNaturalGradient and its use
in NaturalGradientAffineComponent).

The reference keeps a LOW-RANK online estimate of the Fisher matrix of
each affine component, F ~= V diag(s) V^T + rho I with rank R << D, and
multiplies gradients by the smoothed inverse (F + alpha tr(F)/D I)^{-1},
renormalized so that the update's magnitude is unchanged.  Here the
same structure is a gradient transformation of parallel/optim.py, over
a dict of tensors:

  - the basis V (D, R) and the eigenvalue estimates s follow the top
    eigenpairs of the EMA gradient covariance by one subspace (power)
    iteration a step, orthonormalized with a QR;
  - rho follows the residual (out-of-subspace) covariance mass;
  - the inverse is exact for that form by Woodbury:
      (rho' I + V S V^T)^{-1} g = (g - V c) / rho',
      c_i = s_i/(s_i + rho') (V^T g)_i
  - the preconditioned gradient is rescaled to keep ||g||.

rank=None (or rank >= D) takes the dense path: the EMA covariance and
its eigendecomposition.  A tensor that is not 2-D passes unchanged.
The state's tensors take the parameters' dtype and device; a QR or
eigh may flip the sign of a column of V from one library to another,
which changes neither the preconditioned gradient nor V V^T.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from kaldi_tpu_torch.parallel.optim import GradientTransformation


class NGState(NamedTuple):
    fisher: Any   # dict: per tensor (V, s, rho), a dense covariance or None
    count: Any


def _covariance_axis(shape):
    if len(shape) != 2:
        return None
    return 0 if shape[0] <= shape[1] else 1


def online_natural_gradient(alpha: float = 4.0,
                            decay: float = 0.95,
                            rank: Optional[int] = 32,
                            eps: float = 1e-8) -> GradientTransformation:
    def use_lowrank(d):
        return rank is not None and rank < d

    def init(params):
        def make(p):
            ax = _covariance_axis(p.shape)
            if ax is None:
                return None
            d = p.shape[ax]
            kw = dict(dtype=p.dtype, device=p.device)
            if use_lowrank(d):
                # deterministic initial basis: the first R coordinate axes
                return (torch.eye(d, rank, **kw), torch.zeros(rank, **kw),
                        torch.zeros((), **kw))
            return torch.zeros((d, d), **kw)
        return NGState({k: make(p) for k, p in params.items()}, 0)

    def precondition_lowrank(gm, st):
        """gm: (d, n) gradient with samples along columns."""
        V, s, rho = st
        d, n = gm.shape
        # EMA covariance action on the basis: one power-iteration step
        cov_V = gm @ (gm.T @ V) / n                      # (d, R)
        Y = decay * (V * s[None, :]) + (1 - decay) * cov_V
        Vn, Rr = torch.linalg.qr(Y)                      # (d,R), (R,R)
        sn = torch.abs(torch.diagonal(Rr))
        tr_cov = torch.sum(gm * gm) / n
        tr_est = decay * (torch.sum(s) + rho * (d - s.shape[0])) \
            + (1 - decay) * tr_cov
        rho_n = torch.clamp_min((tr_est - torch.sum(sn))
                                / max(d - sn.shape[0], 1), 0.0)
        # smoothed inverse via Woodbury
        damp = alpha * tr_est / d + eps
        denom = rho_n + damp
        proj = Vn.T @ gm                                 # (R, n)
        coef = (sn / (sn + denom))[:, None] * proj
        pg = (gm - Vn @ coef) / denom
        scale = torch.sqrt(torch.clamp_min(torch.sum(gm * gm), eps)
                           / torch.clamp_min(torch.sum(pg * pg), eps))
        return pg * scale, (Vn, sn, rho_n)

    def precondition_dense(gm, f):
        cov = gm @ gm.T / gm.shape[1]
        f = decay * f + (1 - decay) * cov
        d = f.shape[0]
        damp = alpha * torch.trace(f) / d + eps
        vals, vecs = torch.linalg.eigh(
            f + damp * torch.eye(d, dtype=f.dtype, device=f.device))
        inv = (vecs / vals) @ vecs.T
        pg = inv @ gm
        scale = torch.sqrt(torch.clamp_min(torch.sum(gm * gm), eps)
                           / torch.clamp_min(torch.sum(pg * pg), eps))
        return pg * scale, f

    def precondition(g, f):
        if f is None or g.ndim != 2:
            return g, f
        gm = g if _covariance_axis(g.shape) == 0 else g.T     # (d, n)
        if isinstance(f, tuple):
            pg, f = precondition_lowrank(gm, f)
        else:
            pg, f = precondition_dense(gm, f)
        return (pg if gm is g else pg.T), f

    def update(grads, state, params=None):
        outs = {k: precondition(g, state.fisher[k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                NGState({k: o[1] for k, o in outs.items()}, state.count + 1))

    return GradientTransformation(init, update)


def ng_state_from_numpy(fisher: Dict[Any, Any], count: int = 0,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> NGState:
    """An NGState from numpy: per tensor a (V, s, rho) triple, a dense
    covariance, or None (the JAX package's state, leaf for leaf), as
    tensors of `dtype` on `device`."""
    def conv(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def leaf(f):
        if f is None:
            return None
        if isinstance(f, (tuple, list)):
            return tuple(conv(x) for x in f)
        return conv(f)
    return NGState({k: leaf(f) for k, f in fisher.items()}, int(count))
