"""The nnet3 layer zoo, for inference and training (port of
`kaldi_tpu/nnet3/components.py`): the chain TDNN-F blocks (BatchNorm,
TdnnfLayer, Prefinal, `constrain_orthonormal`) and the layers the xconfig
models build (LstmpLayer, StatisticsPooling, GruLayer,
RestrictedAttention, Pnorm, ScaleAndOffset, SumBlock, and ConvSame for
the CNN layers), and the training-time draws: `dropout` (flax's
nn.Dropout) and `spec_augment`, each from an explicit torch.Generator.
The recurrent layers run as a frame loop and take and return their
carries as the flax layers do.

Weights keep the reference's layouts so that flax variables load
without reshuffling, except that Dense kernels are stored transposed
((out, in), PyTorch's convention) and a TDNN-F layer keeps its two
factors in the concatenated layout of its concat-free form
(`TdnnfLayer.load_reference`, `reference_factors`).  Rounding follows
flax in a reduced dtype: a matmul rounds to the working dtype, its bias
add rounds again, and BatchNorm normalises in float32 against float32
statistics and rounds its output back to the input's dtype.

Each module with weights reads its flax subtrees with
`load_flax(params, batch_stats)` and gives them back with `flax()` ->
(params, batch_stats), numpy float32 (None where flax keeps none).

In training mode (`module.train()`) BatchNorm normalises with the batch's
statistics and updates its running ones as flax's BatchNorm does; the
parameters are created frozen (inference) and a trainer turns their
gradients on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
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


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


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

    def load_flax(self, p: dict, s=None) -> None:
        self.weight.copy_(_tensor(p["kernel"]).T)
        if self.bias is not None:
            self.bias.copy_(_tensor(p["bias"]))

    def flax(self):
        d = {"kernel": _numpy(self.weight.T)}
        if self.bias is not None:
            d["bias"] = _numpy(self.bias)
        return d, None


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

    def load_flax(self, p, s: dict) -> None:
        self.mean.copy_(_tensor(s["bn"]["mean"]))
        self.var.copy_(_tensor(s["bn"]["var"]))

    def flax(self):
        return None, {"bn": {"mean": _numpy(self.mean),
                             "var": _numpy(self.var)}}


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

    def load_flax(self, p: dict, s: dict) -> None:
        self.load_reference(_tensor(p["linear"]), _tensor(p["affine"]))
        self.bias.copy_(_tensor(p["bias"]))
        self.norm.load_flax(None, s["BatchNorm_0"])

    def flax(self):
        linear, affine = self.reference_factors()
        return ({"linear": _numpy(linear), "affine": _numpy(affine),
                 "bias": _numpy(self.bias)},
                {"BatchNorm_0": self.norm.flax()[1]})

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

    def load_flax(self, p: dict, s: dict) -> None:
        self.affine.load_flax(p["affine"])
        self.linear.load_flax(p["linear"])
        self.bn1.load_flax(None, s["bn1"])
        self.bn2.load_flax(None, s["bn2"])

    def flax(self):
        return ({"affine": self.affine.flax()[0],
                 "linear": self.linear.flax()[0]},
                {"bn1": self.bn1.flax()[1], "bn2": self.bn2.flax()[1]})


class _FlaxParams:
    """load_flax / flax for a module whose parameters are flax's, name for
    name and layout for layout."""

    def load_flax(self, p: dict, s=None) -> None:
        for n, prm in self.named_parameters():
            prm.copy_(_tensor(p[n]))

    def flax(self):
        return {n: _numpy(prm) for n, prm in self.named_parameters()}, None


class LstmpLayer(_FlaxParams, nn.Module):
    """LSTM with recurrent and non-recurrent projection (the reference's
    LstmNonlinearityComponent + projection).  forward(x (B, T, D),
    init_state=None) -> ((B, T, rd + nd) projections, (c, r) carries).
    Flax's parameters: w_ifco (4cd, D + rd) over [x_t, r], b_ifco (4cd),
    w_proj (rd + nd, cd); the gates split as i, f, g, o."""

    def __init__(self, in_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int):
        super().__init__()
        self.in_dim, self.cd = in_dim, cell_dim
        self.rd, self.nd = recurrent_dim, nonrecurrent_dim
        self.w_ifco = nn.Parameter(
            torch.zeros(4 * cell_dim, in_dim + recurrent_dim),
            requires_grad=False)
        self.b_ifco = nn.Parameter(torch.zeros(4 * cell_dim),
                                   requires_grad=False)
        self.w_proj = nn.Parameter(
            torch.zeros(recurrent_dim + nonrecurrent_dim, cell_dim),
            requires_grad=False)

    def forward(self, x: torch.Tensor, init_state=None):
        B, T, D = x.shape
        cd, rd = self.cd, self.rd
        if init_state is None:
            c = x.new_zeros(B, cd)
            r = x.new_zeros(B, rd)
        else:
            c, r = init_state
        # the input half of every frame's gates in one product
        gx = x @ self.w_ifco[:, :D].T + self.b_ifco
        w_r = self.w_ifco[:, D:].T
        ys = []
        for t in range(T):
            i, f, g, o = (gx[:, t] + r @ w_r).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            proj = (torch.sigmoid(o) * torch.tanh(c)) @ self.w_proj.T
            r = proj[:, :rd]
            ys.append(proj)
        return torch.stack(ys, dim=1), (c, r)


class StatisticsPooling(nn.Module):
    """Mean and standard deviation over time (the x-vector stats layer,
    nnet-general-component.h:201/337): (B, T, D) -> (B, 2D).  The
    variance is the population variance; with a (B, T) mask it is
    E[x^2] - mean^2 over the frames the mask keeps.  Either is floored at
    epsilon before the square root."""

    def __init__(self, epsilon: float = 1e-10):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if mask is not None:
            m = mask[..., None].to(x.dtype)
            count = torch.clamp_min(m.sum(dim=1), 1.0)
            mean = (x * m).sum(dim=1) / count
            var = (x * x * m).sum(dim=1) / count - mean ** 2
        else:
            mean = x.mean(dim=1)
            var = x.var(dim=1, unbiased=False)
        std = torch.sqrt(torch.clamp_min(var, self.epsilon))
        return torch.cat([mean, std], dim=-1)


class GruLayer(_FlaxParams, nn.Module):
    """Projected GRU (the norm-OGRU family, nnet-combined-component.h:713):
    forward(x (B, T, D), init_state=None) -> ((B, T, pd) projections,
    final h).  Flax's parameters: w_zr (2cd, D + cd), b_zr, w_h
    (cd, D + cd), b_h, w_proj (pd, cd)."""

    def __init__(self, in_dim: int, cell_dim: int, projection_dim: int):
        super().__init__()
        self.in_dim, self.cd, self.pd = in_dim, cell_dim, projection_dim
        self.w_zr = nn.Parameter(torch.zeros(2 * cell_dim,
                                             in_dim + cell_dim),
                                 requires_grad=False)
        self.b_zr = nn.Parameter(torch.zeros(2 * cell_dim),
                                 requires_grad=False)
        self.w_h = nn.Parameter(torch.zeros(cell_dim, in_dim + cell_dim),
                                requires_grad=False)
        self.b_h = nn.Parameter(torch.zeros(cell_dim), requires_grad=False)
        self.w_proj = nn.Parameter(torch.zeros(projection_dim, cell_dim),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor, init_state=None):
        B, T, D = x.shape
        h = x.new_zeros(B, self.cd) if init_state is None else init_state
        zx = x @ self.w_zr[:, :D].T + self.b_zr
        hx = x @ self.w_h[:, :D].T + self.b_h
        w_zh, w_hh = self.w_zr[:, D:].T, self.w_h[:, D:].T
        ys = []
        for t in range(T):
            z, r = torch.sigmoid(zx[:, t] + h @ w_zh).chunk(2, dim=-1)
            hb = torch.tanh(hx[:, t] + (r * h) @ w_hh)
            h = (1 - z) * h + z * hb
            ys.append(h @ self.w_proj.T)
        return torch.stack(ys, dim=1), h


def _shift_edge(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, t] = x[:, t + k] along the time axis, the edge frame
    replicated."""
    if k == 0:
        return x
    T = x.shape[1]
    idx = torch.clamp(torch.arange(T, device=x.device) + k, 0, T - 1)
    return x.index_select(1, idx)


class RestrictedAttention(nn.Module):
    """Restricted self-attention (nnet-attention-component.h:106): each
    frame attends over [t - left * stride, t + right * stride], edges
    replicated at each offset, the logits divided by sqrt(key_dim) and
    the softmax taken over the window.  (B, T, D) -> (B, T, H * V)."""

    def __init__(self, in_dim: int, num_heads: int = 4, key_dim: int = 40,
                 value_dim: int = 40, num_left_inputs: int = 5,
                 num_right_inputs: int = 2, time_stride: int = 1):
        super().__init__()
        self.H, self.K, self.V = num_heads, key_dim, value_dim
        self.offsets = [o * time_stride for o in range(-num_left_inputs,
                                                       num_right_inputs + 1)]
        self.query = Dense(in_dim, num_heads * key_dim)
        self.key = Dense(in_dim, num_heads * key_dim)
        self.value = Dense(in_dim, num_heads * value_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        H, K, V = self.H, self.K, self.V
        q = self.query(x).reshape(B, T, H, K)
        k = self.key(x).reshape(B, T, H, K)
        v = self.value(x).reshape(B, T, H, V)
        scale = torch.sqrt(torch.tensor(float(K))).to(x.dtype)
        logits = torch.stack([(q * _shift_edge(k, o)).sum(-1) / scale
                              for o in self.offsets], dim=-1)   # B,T,H,W
        att = torch.softmax(logits, dim=-1)
        stacked = torch.stack([_shift_edge(v, o) for o in self.offsets],
                              dim=3)                            # B,T,H,W,V
        out = torch.einsum("bthw,bthwv->bthv", att, stacked)
        return out.reshape(B, T, H * V)

    def load_flax(self, p: dict, s=None) -> None:
        for n in ("query", "key", "value"):
            getattr(self, n).load_flax(p[n])

    def flax(self):
        return {n: getattr(self, n).flax()[0]
                for n in ("query", "key", "value")}, None


class Pnorm(nn.Module):
    """PnormComponent: y_j = (sum over group j of |x_i|^p + 1e-20)^(1/p)
    over consecutive groups of D / output_dim inputs."""

    def __init__(self, output_dim: int, p: float = 2.0):
        super().__init__()
        self.output_dim, self.p = output_dim, p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        if D % self.output_dim:
            raise ValueError(f"pnorm: {D} not divisible by "
                             f"{self.output_dim}")
        xg = x.reshape(x.shape[:-1] + (self.output_dim,
                                       D // self.output_dim))
        return torch.pow(torch.pow(xg.abs(), self.p).sum(-1) + 1e-20,
                         1.0 / self.p)


class ScaleAndOffset(_FlaxParams, nn.Module):
    """ScaleAndOffsetComponent: a learned scale and offset an element."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.offset = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset


class SumBlock(nn.Module):
    """SumBlockComponent: the sum of D / output_dim consecutive blocks of
    output_dim inputs, times scale."""

    def __init__(self, output_dim: int, scale: float = 1.0):
        super().__init__()
        self.output_dim, self.scale = output_dim, scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        if D % self.output_dim:
            raise ValueError("sum-block: dim mismatch")
        xg = x.reshape(x.shape[:-1] + (D // self.output_dim,
                                       self.output_dim))
        return self.scale * xg.sum(dim=-2)


class ConvSame(nn.Module):
    """flax.linen.Conv over (time, height) with padding="SAME" and strides
    (1, hsub), on (B, T, H, C) inputs (the CNN layers of
    `kaldi_tpu/nnet3/xconfig.py:249-267`): the kernel is HWIO (tk, hk, cin,
    nf) in flax and OIHW here.  SAME pads each axis by (out - 1) * stride
    + kernel - size in total, the smaller half before, as XLA does; torch's
    padding="same" refuses strides, so the padding is explicit."""

    def __init__(self, cin: int, nf: int, kernel, strides):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.weight = nn.Parameter(torch.zeros(nf, cin, *kernel),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(nf), requires_grad=False)

    @staticmethod
    def same_pads(size: int, k: int, s: int):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return total // 2, total - total // 2

    def forward(self, x4: torch.Tensor) -> torch.Tensor:
        x = x4.permute(0, 3, 1, 2)                          # B, C, T, H
        (tk, hk), (st, sh) = self.kernel, self.strides
        t0, t1 = self.same_pads(x.shape[2], tk, st)
        h0, h1 = self.same_pads(x.shape[3], hk, sh)
        y = F.conv2d(F.pad(x, (h0, h1, t0, t1)), self.weight, self.bias,
                     stride=(st, sh))
        return y.permute(0, 2, 3, 1)                        # B, T, H', nf

    def load_flax(self, p: dict, s=None) -> None:
        self.weight.copy_(_tensor(p["kernel"]).permute(3, 2, 0, 1))
        self.bias.copy_(_tensor(p["bias"]))

    def flax(self):
        return {"kernel": _numpy(self.weight.permute(2, 3, 1, 0)),
                "bias": _numpy(self.bias)}, None


def dropout_mask(shape, keep: float, gen: torch.Generator) -> torch.Tensor:
    """A Bernoulli(keep) boolean mask of `shape`, drawn from `gen` on
    its device."""
    return torch.rand(shape, generator=gen, device=gen.device) < keep


def dropout(x: torch.Tensor, rate: float,
            gen: torch.Generator) -> torch.Tensor:
    """flax's nn.Dropout in training: each element kept with
    probability 1 - rate and divided by it, the others 0."""
    keep = 1.0 - rate
    mask = dropout_mask(x.shape, keep, gen).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def spec_augment_draws(shape, gen: torch.Generator,
                       freq_mask_width: int = 10, num_freq_masks: int = 2,
                       time_mask_frac: float = 0.1, num_time_masks: int = 2):
    """The draws of `spec_augment` for features of `shape` (B, T, D),
    from `gen` on its device -> (f0, widths, t0, tw), each (B, masks):
    band starts in [0, max(D - width, 1)), band widths in [0, width],
    span starts in [0, max(T - max_w, 1)) and span lengths in [0, max_w],
    max_w = max(int(T * time_mask_frac), 1)."""
    B, T, D = shape
    dev = gen.device

    def randint(high, n):
        return torch.randint(0, high, (B, n), generator=gen, device=dev)
    f0 = randint(max(D - freq_mask_width, 1), num_freq_masks)
    widths = randint(freq_mask_width + 1, num_freq_masks)
    max_w = max(int(T * time_mask_frac), 1)
    t0 = randint(max(T - max_w, 1), num_time_masks)
    tw = randint(max_w + 1, num_time_masks)
    return f0, widths, t0, tw


def apply_spec_augment(feats: torch.Tensor, f0, widths, t0,
                       tw) -> torch.Tensor:
    """Zero the frequency bands [f0, f0 + widths) and the time spans
    [t0, t0 + tw) of each sequence of feats (B, T, D)."""
    B, T, D = feats.shape
    dev = feats.device
    f0, widths, t0, tw = (torch.as_tensor(a, device=dev)
                          for a in (f0, widths, t0, tw))
    d_idx = torch.arange(D, device=dev)[None, None, :]
    fmask = ((d_idx >= f0[..., None])
             & (d_idx < (f0 + widths)[..., None])).any(dim=1)     # (B, D)
    out = feats * (1.0 - fmask[:, None, :].to(feats.dtype))
    t_idx = torch.arange(T, device=dev)[None, None, :]
    tmask = ((t_idx >= t0[..., None])
             & (t_idx < (t0 + tw)[..., None])).any(dim=1)         # (B, T)
    return out * (1.0 - tmask[:, :, None].to(feats.dtype))


def spec_augment(feats: torch.Tensor, gen: torch.Generator,
                 freq_mask_width: int = 10, num_freq_masks: int = 2,
                 time_mask_frac: float = 0.1,
                 num_time_masks: int = 2) -> torch.Tensor:
    """SpecAugment-style masking (the reference's
    SpecAugmentTimeMaskComponent + GeneralDropout freq masking,
    nnet-general-component.h:1017): zero random frequency bands and
    time spans of feats (B, T, D), drawn from `gen`."""
    return apply_spec_augment(feats, *spec_augment_draws(
        feats.shape, gen, freq_mask_width, num_freq_masks, time_mask_frac,
        num_time_masks))
