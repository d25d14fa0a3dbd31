"""Inference versions of the chain TDNN-F building blocks (port of
`kaldi_tpu/nnet3/components.py`: BatchNorm, TdnnfLayer, Prefinal).

Weights keep the reference's layouts so that flax variables load
without reshuffling, except that Dense kernels are stored transposed
((out, in), PyTorch's convention).  Rounding follows flax in a reduced
dtype: a matmul rounds to the working dtype, its bias add rounds again,
and BatchNorm normalises in float32 against float32 statistics and
rounds its output back to the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn


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
    """Kaldi-style batchnorm at inference: running statistics, eps 1e-3,
    no learned scale or offset (nnet-normalize-component.h:159)."""

    def __init__(self, dim: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float32))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.to(torch.float32) - self.mean) * \
            torch.rsqrt(self.var + self.epsilon)
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
