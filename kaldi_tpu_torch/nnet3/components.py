"""The chain TDNN-F building blocks, for inference and training (port of
`kaldi_tpu/nnet3/components.py`: BatchNorm, TdnnfLayer, Prefinal and
`constrain_orthonormal`).

Weights keep the reference's layouts so that flax variables load
without reshuffling, except that Dense kernels are stored transposed
((out, in), PyTorch's convention) and a TDNN-F layer keeps its two
factors in the concatenated layout of its concat-free form
(`TdnnfLayer.load_reference`, `reference_factors`).  Rounding follows
flax in a reduced dtype: a matmul rounds to the working dtype, its bias
add rounds again, and BatchNorm normalises in float32 against float32
statistics and rounds its output back to the input's dtype.

In training mode (`module.train()`) BatchNorm normalises with the batch's
statistics and updates its running ones as flax's BatchNorm does; the
parameters are created frozen (inference) and a trainer turns their
gradients on.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from kaldi_tpu_torch.device import full_f32


def constrain_orthonormal(m: torch.Tensor, scale: float = 1.0,
                          update_speed: float = 0.125) -> torch.Tensor:
    """One step of the semi-orthogonal constraint on a (rows <= cols)
    matrix: pushes M M^T toward scale^2 * I (nnet-utils.cc
    ConstrainOrthonormalInternal; floating scale when scale <= 0).
    Float32 products, TF32 off."""
    rows, cols = m.shape
    transposed = rows > cols
    if transposed:
        m = m.T
    with full_f32():
        p = m @ m.T
        if scale <= 0.0:
            # floating case: scale^2 = trace(P P^T)/trace(P)
            trace_p = torch.trace(p)
            trace_pp = torch.sum(p * p)
            scale2 = trace_pp / torch.clamp_min(trace_p, 1e-20)
        else:
            scale2 = torch.tensor(scale * scale, dtype=m.dtype,
                                  device=m.device)
        # rescale so that trace(P)/rows == scale2 first, which keeps the
        # fixed-point update stable from any initialization
        rows = p.shape[0]
        ratio = torch.trace(p) / torch.clamp_min(rows * scale2, 1e-20)
        ratio = torch.clamp_min(ratio, 1e-10)
        m = m * torch.rsqrt(ratio)
        p = p / ratio
        eye = torch.eye(rows, dtype=m.dtype, device=m.device) * scale2
        m = m - (4.0 * update_speed / scale2) * ((p - eye) @ m)
    return m.T if transposed else m


class Dense(nn.Module):
    """flax.linen.Dense: y = x @ kernel (+ bias), kernel given (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_dim), requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y


class BatchNorm(nn.Module):
    """Kaldi-style batchnorm: eps 1e-3, no learned scale or offset
    (nnet-normalize-component.h:159).  At inference it normalises with
    the running statistics.  In training mode it normalises with the
    batch's, as flax.linen.BatchNorm does: mean and biased variance over
    every axis but the last, the variance as E[x^2] - E[x]^2 clipped at
    0, and the running statistics become momentum * old + (1 - momentum)
    * batch."""

    def __init__(self, dim: int, epsilon: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float32))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # at least float32, as flax promotes (float64 stays float64)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(xf.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return y.to(x.dtype)


def _shift_right(x: torch.Tensor, ts: int) -> torch.Tensor:
    """out[:, t] = x[:, t - ts], the first frame replicated."""
    return torch.cat([x[:, :1].expand(-1, ts, -1), x[:, :-ts]], dim=1)


def _shift_left(x: torch.Tensor, ts: int) -> torch.Tensor:
    """out[:, t] = x[:, t + ts], the last frame replicated."""
    return torch.cat([x[:, ts:], x[:, -1:].expand(-1, ts, -1)], dim=1)


class TdnnfLayer(nn.Module):
    """Factorized TDNN layer: a down-projection over [t-ts, t] to the
    bottleneck, an up-projection over [t, t+ts], ReLU, BatchNorm, scaled
    bypass and optional frame subsampling.

    Concat-free form of the reference: both halves of a weight run as
    one matmul and the half that looks at another frame is shifted on
    its output, which equals shifting its input.  `linear` is
    (bn, 2D) in the reference and splits as reshape(bn, 2, D)."""

    def __init__(self, in_dim: int, dim: int, bottleneck_dim: int,
                 time_stride: int, subsample: int = 1,
                 bypass_scale: float = 0.66):
        super().__init__()
        self.in_dim, self.dim, self.bn = in_dim, dim, bottleneck_dim
        self.ts = time_stride
        self.subsample = subsample
        self.bypass_scale = bypass_scale
        k = 2 if time_stride else 1
        # rows of w_down: [half over t-ts ; half over t]; rows of w_up:
        # [half over t ; half over t+ts]
        self.w_down = nn.Parameter(torch.zeros(k * bottleneck_dim, in_dim),
                                   requires_grad=False)
        self.w_up = nn.Parameter(torch.zeros(k * dim, bottleneck_dim),
                                 requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=False)
        self.norm = BatchNorm(dim)

    def load_reference(self, linear: torch.Tensor,
                       affine: torch.Tensor) -> None:
        """linear (bn, k*D), affine (dim, k*bn) as the reference stores
        them."""
        bn, dim = self.bn, self.dim
        if self.ts:
            w1p = linear.reshape(bn, 2, self.in_dim)
            w2p = affine.reshape(dim, 2, bn)
            self.w_down.copy_(torch.cat([w1p[:, 0], w1p[:, 1]], dim=0))
            self.w_up.copy_(torch.cat([w2p[:, 0], w2p[:, 1]], dim=0))
        else:
            self.w_down.copy_(linear)
            self.w_up.copy_(affine)

    def reference_factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(linear (bn, k*D), affine (dim, k*bn)) in the reference's
        layout: the inverse of `load_reference`."""
        if not self.ts:
            return self.w_down, self.w_up
        bn, dim = self.bn, self.dim
        linear = torch.stack([self.w_down[:bn], self.w_down[bn:]], dim=1)
        affine = torch.stack([self.w_up[:dim], self.w_up[dim:]], dim=1)
        return linear.reshape(bn, 2 * self.in_dim), affine.reshape(dim,
                                                                   2 * bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ts, bn = self.ts, self.bn
        if ts:
            xw = x @ self.w_down.T                        # (B, T, 2bn)
            xa, xb = xw[..., :bn], xw[..., bn:]
            bottleneck = _shift_right(xa, ts) + xb
            yw = bottleneck @ self.w_up.T                 # (B, T, 2dim)
            ya, yb = yw[..., :self.dim], yw[..., self.dim:]
            y = ya + _shift_left(yb, ts) + self.bias
        else:
            y = (x @ self.w_down.T) @ self.w_up.T + self.bias
        y = self.norm(torch.relu(y))
        if self.in_dim == self.dim:
            y = y + self.bypass_scale * x
        if self.subsample > 1:
            y = y[:, ::self.subsample]
        return y


class Prefinal(nn.Module):
    """prefinal block: Dense + ReLU + BN, bottleneck Dense (no bias) +
    BN."""

    def __init__(self, in_dim: int, big_dim: int, small_dim: int):
        super().__init__()
        self.affine = Dense(in_dim, big_dim)
        self.bn1 = BatchNorm(big_dim)
        self.linear = Dense(big_dim, small_dim, bias=False)
        self.bn2 = BatchNorm(small_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(torch.relu(self.affine(x)))
        return self.bn2(self.linear(x))
