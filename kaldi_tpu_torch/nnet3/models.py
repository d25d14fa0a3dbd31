"""Chain TDNN-F acoustic model (port of `kaldi_tpu/nnet3/models.py`
ChainTdnnf, the reference's flagship run_tdnn_1d.sh recipe: 17 TDNN-F
layers, 1536 / bottleneck 160, frame subsampling 3, chain + xent heads).

Weights live in flax's layout outside the model: `chain_tdnnf_init`
draws a fresh {"params", "batch_stats"} dict of numpy arrays with flax's
default initialisers, `recipes.bench_corpus.load_params` reads one, and
`chain_tdnnf_from_flax` builds the model from one (eval mode; a trainer
calls `.train()` and turns the gradients on).  `chain_tdnnf_to_flax`
gives the dict back.

With `dropout` > 0 the model drops each TDNN-F layer's outputs in
training mode, as flax's nn.Dropout does (a Bernoulli keep mask divided
by 1 - p), the masks drawn from the generator in `dropout_gen` (on the
model's device), which a trainer sets; eval mode is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.nnet3.components import (BatchNorm, Dense, Prefinal,
                                              TdnnfLayer, dropout)


@dataclass(frozen=True)
class ChainTdnnfConfig:
    feat_dim: int = 40
    ivector_dim: int = 0
    num_pdfs: int = 3456
    hidden_dim: int = 1536
    bottleneck_dim: int = 160
    prefinal_dim: int = 256
    num_layers: int = 17
    # layer index (1-based among tdnnf layers) after which to subsample
    subsample_layer: int = 8
    frame_subsampling_factor: int = 3
    # dropout after each TDNN-F layer, in training mode only
    dropout: float = 0.0

    def time_strides(self) -> Sequence[int]:
        out = []
        for i in range(1, self.num_layers + 1):
            if i <= 3:
                out.append(1)
            elif i == 4:
                out.append(0)
            else:
                out.append(3 if i > self.subsample_layer else 1)
        return out


class ChainTdnnf(nn.Module):
    """forward(feats (B, T, feat_dim), ivectors (B, ivector_dim) or
    None) -> (chain_out, xent_out), each (B, ceil(T/sub), num_pdfs).
    Inputs are cast to the model's dtype, as flax promotes them."""

    def __init__(self, cfg: ChainTdnnfConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_dim
        self.input_affine = Dense(cfg.feat_dim + cfg.ivector_dim, H)
        self.input_bn = BatchNorm(H)
        self.tdnnf = nn.ModuleList()
        for i, ts in enumerate(cfg.time_strides(), start=1):
            sub = (cfg.frame_subsampling_factor
                   if i == cfg.subsample_layer else 1)
            self.tdnnf.append(TdnnfLayer(H, H, cfg.bottleneck_dim, ts, sub))
        self.prefinal_chain = Prefinal(H, H, cfg.prefinal_dim)
        self.output_affine = Dense(cfg.prefinal_dim, cfg.num_pdfs)
        self.prefinal_xent = Prefinal(H, H, cfg.prefinal_dim)
        self.output_xent_affine = Dense(cfg.prefinal_dim, cfg.num_pdfs)
        self.dropout_gen: Optional[torch.Generator] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.input_affine.weight.dtype

    def body(self, feats: torch.Tensor,
             ivectors: Optional[torch.Tensor] = None) -> torch.Tensor:
        drop = self.cfg.dropout > 0 and self.training
        if drop and self.dropout_gen is None:
            raise KaldiTpuError("ChainTdnnf: dropout in training mode draws "
                                "from `dropout_gen`; set a torch.Generator")
        x = feats.to(self.dtype)
        if ivectors is not None and self.cfg.ivector_dim:
            iv = ivectors.to(self.dtype)[:, None, :].expand(
                -1, x.shape[1], -1)
            x = torch.cat([x, iv], dim=-1)
        x = self.input_bn(torch.relu(self.input_affine(x)))
        for layer in self.tdnnf:
            x = layer(x)
            if drop:
                x = dropout(x, self.cfg.dropout, self.dropout_gen)
        return x

    def chain(self, feats: torch.Tensor,
              ivectors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chain head alone (what decoding reads)."""
        return self.output_affine(self.prefinal_chain(
            self.body(feats, ivectors)))

    def forward(self, feats: torch.Tensor,
                ivectors: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.body(feats, ivectors)
        chain_out = self.output_affine(self.prefinal_chain(x))
        xent_out = self.output_xent_affine(self.prefinal_xent(x))
        return chain_out, torch.log_softmax(xent_out, dim=-1)


def _lecun_normal(shape, gen: torch.Generator) -> np.ndarray:
    """flax's lecun_normal for a Dense kernel (in, out): a normal
    truncated to (-2, 2) with the standard deviation sqrt(1/in) over the
    truncated normal's own (0.8796...)."""
    std = float(np.sqrt(1.0 / shape[0])) / .87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return t.numpy()


def _glorot_uniform(shape, gen: torch.Generator) -> np.ndarray:
    """flax's glorot_uniform for a (rows, cols) parameter: uniform in
    +-sqrt(6 / (rows + cols))."""
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-limit, limit, generator=gen)
    return t.numpy()


def chain_tdnnf_init(cfg: ChainTdnnfConfig,
                     gen: torch.Generator) -> dict:
    """Fresh {"params", "batch_stats"} in flax's layout (numpy float32),
    drawn from `gen` with flax's defaults: lecun_normal Dense kernels,
    glorot_uniform TDNN-F factors, zero biases, BatchNorm statistics 0
    and 1.  Not the numbers flax draws (another generator), the same
    distributions."""
    H, bn = cfg.hidden_dim, cfg.bottleneck_dim

    def dense(n_in, n_out, bias=True):
        d = {"kernel": _lecun_normal((n_in, n_out), gen)}
        if bias:
            d["bias"] = np.zeros(n_out, np.float32)
        return d

    def stats(dim):
        return {"bn": {"mean": np.zeros(dim, np.float32),
                       "var": np.ones(dim, np.float32)}}

    params = {"input_affine": dense(cfg.feat_dim + cfg.ivector_dim, H)}
    batch_stats = {"input_bn": stats(H)}
    for i, ts in enumerate(cfg.time_strides(), start=1):
        k = 2 if ts else 1
        params[f"tdnnf{i}"] = {
            "linear": _glorot_uniform((bn, k * H), gen),
            "affine": _glorot_uniform((H, k * bn), gen),
            "bias": np.zeros(H, np.float32)}
        batch_stats[f"tdnnf{i}"] = {"BatchNorm_0": stats(H)}
    for head, out in (("chain", "output_affine"),
                      ("xent", "output_xent_affine")):
        params[f"prefinal_{head}"] = {
            "affine": dense(H, H),
            "linear": dense(H, cfg.prefinal_dim, bias=False)}
        batch_stats[f"prefinal_{head}"] = {"bn1": stats(H),
                                           "bn2": stats(cfg.prefinal_dim)}
        params[out] = dense(cfg.prefinal_dim, cfg.num_pdfs)
    return {"params": params, "batch_stats": batch_stats}


def _heads(model: ChainTdnnf):
    """(flax name, module) of each module with weights, in flax's names."""
    yield "input_affine", model.input_affine
    yield "input_bn", model.input_bn
    for i, layer in enumerate(model.tdnnf, start=1):
        yield f"tdnnf{i}", layer
    for name in ("prefinal_chain", "prefinal_xent", "output_affine",
                 "output_xent_affine"):
        yield name, getattr(model, name)


def chain_tdnnf_to_flax(model: ChainTdnnf) -> dict:
    """The model's {"params", "batch_stats"} in flax's layout, as numpy
    float32: the inverse of `chain_tdnnf_from_flax`."""
    params, stats = {}, {}
    for name, mod in _heads(model):
        p, s = mod.flax()
        if p is not None:
            params[name] = p
        if s is not None:
            stats[name] = s
    return {"params": params, "batch_stats": stats}


def chain_tdnnf_from_flax(cfg: ChainTdnnfConfig, variables: dict,
                          dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None) -> ChainTdnnf:
    """Build an eval-mode ChainTdnnf from flax variables
    {"params": ..., "batch_stats": ...} (numpy arrays, flax Dense kernels
    (in, out)).  Parameters are cast to `dtype`; BatchNorm statistics
    stay float32, as the reference keeps them."""
    dev = resolve_device(device)
    params, stats = variables["params"], variables["batch_stats"]
    model = ChainTdnnf(cfg)
    with torch.no_grad():
        for name, mod in _heads(model):
            mod.load_flax(params.get(name), stats.get(name))
    model.eval()
    # parameters to `dtype`, BatchNorm buffers stay float32
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model.to(dev)
