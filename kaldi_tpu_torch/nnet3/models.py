"""Chain TDNN-F acoustic model, inference only (port of
`kaldi_tpu/nnet3/models.py` ChainTdnnf, the reference's flagship
run_tdnn_1d.sh recipe: 17 TDNN-F layers, 1536 / bottleneck 160,
frame subsampling 3, chain + xent heads).

`chain_tdnnf_from_flax` is the one way weights enter the model: it
takes the {"params", "batch_stats"} dict of numpy arrays that
`recipes.bench_corpus.load_params` or flax's `model.init` gives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.nnet3.components import (BatchNorm, Dense, Prefinal,
                                              TdnnfLayer)


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

    @property
    def dtype(self) -> torch.dtype:
        return self.input_affine.weight.dtype

    def body(self, feats: torch.Tensor,
             ivectors: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = feats.to(self.dtype)
        if ivectors is not None and self.cfg.ivector_dim:
            iv = ivectors.to(self.dtype)[:, None, :].expand(
                -1, x.shape[1], -1)
            x = torch.cat([x, iv], dim=-1)
        x = self.input_bn(torch.relu(self.input_affine(x)))
        for layer in self.tdnnf:
            x = layer(x)
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

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32))

    def dense(mod: Dense, p: dict) -> None:
        mod.weight.copy_(t(p["kernel"]).T)
        if mod.bias is not None:
            mod.bias.copy_(t(p["bias"]))

    def bn(mod: BatchNorm, s: dict) -> None:
        mod.mean.copy_(t(s["bn"]["mean"]))
        mod.var.copy_(t(s["bn"]["var"]))

    def prefinal(mod: Prefinal, p: dict, s: dict) -> None:
        dense(mod.affine, p["affine"])
        dense(mod.linear, p["linear"])
        bn(mod.bn1, s["bn1"])
        bn(mod.bn2, s["bn2"])

    with torch.no_grad():
        dense(model.input_affine, params["input_affine"])
        bn(model.input_bn, stats["input_bn"])
        for i, layer in enumerate(model.tdnnf, start=1):
            p = params[f"tdnnf{i}"]
            layer.load_reference(t(p["linear"]), t(p["affine"]))
            layer.bias.copy_(t(p["bias"]))
            bn(layer.norm, stats[f"tdnnf{i}"]["BatchNorm_0"])
        prefinal(model.prefinal_chain, params["prefinal_chain"],
                 stats["prefinal_chain"])
        dense(model.output_affine, params["output_affine"])
        prefinal(model.prefinal_xent, params["prefinal_xent"],
                 stats["prefinal_xent"])
        dense(model.output_xent_affine, params["output_xent_affine"])
    model.eval()
    # parameters to `dtype`, BatchNorm buffers stay float32
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model.to(dev)
