"""xconfig models in PyTorch (port of `kaldi_tpu/nnet3/xconfig.py`; the
layer language of the reference's recipes, steps/libs/nnet3/xconfig/
basic_layers.py:20 and friends).

Layer types: input, fixed-affine-layer / affine-layer, relu-batchnorm-
layer (and -dropout-, relu-renorm-), batchnorm-component, no-op-component,
linear-component, tdnnf-layer, lstm-layer / lstmp-layer (and the fast-
variants), conv-relu-batchnorm-layer / cnn-layer, gru-layer,
attention-relu-renorm-layer / attention-layer, stats-layer,
prefinal-layer and output-layer.  A type outside this list raises when
the model is built, naming it.

Descriptors in input=: bare names, name@k, Append(...) (an integer inside
reads __prev__, the previous layer's output, shifted), Offset(x, k),
ReplaceIndex(x, t, 0), Sum(a, b, ...), Scale(s, x) and IfDefined(x).  A
time offset replicates the edge frame (`_shift`), as the reference does.

The module keeps flax's parameter names: `xconfig_from_flax` builds it
from a {"params", "batch_stats"} tree of numpy arrays (`tdnn1_affine`,
`tdnn1_bn`, `tdnnf3/linear`, `lstm1/w_ifco`, ...) and `xconfig_to_flax`
gives the tree back.  `chain_tdnnf_xconfig` writes the chain TDNN-F of a
ChainTdnnfConfig as xconfig text and `chain_tdnnf_variables_to_xconfig`
renames a ChainTdnnf tree into it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.nnet3.components import (BatchNorm, ConvSame, Dense,
                                              GruLayer, LstmpLayer, Prefinal,
                                              RestrictedAttention,
                                              StatisticsPooling, TdnnfLayer)

# ---------------------------------------------------------------------------
# parsing


@dataclass
class XLayer:
    layer_type: str
    name: str
    opts: Dict[str, str]

    def get(self, key, default=None):
        return self.opts.get(key, default)

    def get_int(self, key, default=None):
        v = self.opts.get(key)
        return int(v) if v is not None else default

    def get_float(self, key, default=None):
        v = self.opts.get(key)
        return float(v) if v is not None else default


def parse_xconfig(text: str,
                  substitutions: Optional[Dict[str, str]] = None
                  ) -> List[XLayer]:
    layers = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if substitutions:
            for k, v in substitutions.items():
                line = line.replace(f"${k}", str(v))
        parts = _split_opts(line)
        opts: Dict[str, str] = {}
        for p in parts[1:]:
            if "=" not in p:
                raise KaldiTpuError(f"bad xconfig option {p!r} in: {raw}")
            k, v = p.split("=", 1)
            opts[k] = v
        name = opts.get("name")
        if name is None:
            raise KaldiTpuError(f"xconfig line missing name=: {raw}")
        layers.append(XLayer(parts[0], name, opts))
    return layers


def _split_opts(line: str) -> List[str]:
    """Split on spaces outside parentheses (Append(-1, 0, 1) stays
    whole)."""
    out, depth, cur = [], 0, []
    for ch in line:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == " " and depth == 0:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


# ---------------------------------------------------------------------------
# descriptor evaluation, over tensors or (when building) over their dims


class _Dim(int):
    """A feature dimension standing in for a tensor while the model is
    built: shifts, Sum and Scale keep the first operand's, Append adds
    them up."""


def _shift(x, k: int):
    """Time shift with edge replication: output[t] = input[t + k]."""
    if k == 0 or isinstance(x, _Dim):
        return x
    if k > 0:
        return torch.cat([x[:, k:], x[:, -1:].expand(-1, k, -1)], dim=1)
    k = -k
    return torch.cat([x[:, :1].expand(-1, k, -1), x[:, :-k]], dim=1)


def _cat(parts):
    if isinstance(parts[0], _Dim):
        return _Dim(sum(parts))
    return torch.cat(parts, dim=-1)


def _eval_descriptor(desc: str, tensors: Dict, default: str):
    desc = desc.strip()
    if not desc:
        desc = default
    return _eval_expr(desc, tensors)


def _split_args(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _eval_expr(expr: str, tensors: Dict):
    expr = expr.strip()
    m = re.match(r"^(\w[\w-]*)\((.*)\)$", expr, re.S)
    if not m:
        # a plain name, possibly with an @offset ("tdnn1@-3")
        if "@" in expr:
            name, off = expr.split("@")
            return _shift(tensors[name], int(off))
        if expr not in tensors:
            raise KaldiTpuError(f"unknown descriptor input {expr!r}")
        return tensors[expr]
    func, args = m.group(1), _split_args(m.group(2))
    if func == "Append":
        return _cat([_shift(tensors["__prev__"], int(a))
                     if re.fullmatch(r"-?\d+", a) else _eval_expr(a, tensors)
                     for a in args])
    if func == "Offset":
        return _shift(_eval_expr(args[0], tensors), int(args[1]))
    if func == "ReplaceIndex":
        # ReplaceIndex(ivector, t, 0): an input constant over time
        return _eval_expr(args[0], tensors)
    if func == "Sum":
        acc = _eval_expr(args[0], tensors)
        for a in args[1:]:
            x = _eval_expr(a, tensors)
            acc = acc if isinstance(acc, _Dim) else acc + x
        return acc
    if func == "Scale":
        x = _eval_expr(args[1], tensors)
        return x if isinstance(x, _Dim) else float(args[0]) * x
    if func == "IfDefined":
        try:
            return _eval_expr(args[0], tensors)
        except KaldiTpuError:
            prev = tensors["__prev__"]
            return prev if isinstance(prev, _Dim) else torch.zeros_like(prev)
    raise KaldiTpuError(f"unsupported descriptor function {func!r}")


# ---------------------------------------------------------------------------
# model


_RELU_BN = ("relu-batchnorm-layer", "relu-batchnorm-dropout-layer",
            "relu-renorm-layer")
_LSTM = ("lstm-layer", "lstmp-layer", "fast-lstm-layer", "fast-lstmp-layer")


class XconfigModel(nn.Module):
    """Sequential evaluation of parsed xconfig layers, in eval mode.
    forward(inputs: name -> (B, T, dim) tensor, or (B, dim) broadcast over
    time, as i-vectors are) -> {output-layer name: (B, T', dim)}.  The
    inputs are cast to the model's dtype and device.  `input_dims` gives
    the dims of input layers that do not state dim=."""

    def __init__(self, layers: Sequence[XLayer],
                 input_dims: Optional[Dict[str, int]] = None):
        super().__init__()
        self.layers = tuple(layers)
        self.mods = nn.ModuleDict()
        dims: Dict[str, _Dim] = {}
        prev = None
        for layer in self.layers:
            lt, name = layer.layer_type, layer.name
            if prev is not None:
                dims["__prev__"] = dims[prev]
            if lt == "input":
                d = layer.get_int("dim", (input_dims or {}).get(name))
                if d is None:
                    raise KaldiTpuError(f"input {name} has no dim")
                dims[name] = _Dim(d)
            else:
                x = _eval_descriptor(layer.get("input", ""), dims,
                                     default=prev)
                dims[name] = _Dim(self._build(layer, int(x)))
            prev = name
        self.eval()

    def _build(self, layer: XLayer, D: int) -> int:
        """Make `layer`'s modules for an input of dim D; -> its output
        dim."""
        lt, name, mods = layer.layer_type, layer.name, self.mods
        if lt in _RELU_BN:
            dim = layer.get_int("dim")
            mods[f"{name}_affine"] = Dense(D, dim)
            mods[f"{name}_bn"] = BatchNorm(dim)
            return dim
        if lt in ("fixed-affine-layer", "affine-layer"):
            dim = layer.get_int("dim", D)
            mods[f"{name}_affine"] = Dense(D, dim)
            return dim
        if lt == "linear-component":
            dim = layer.get_int("dim")
            mods[f"{name}_linear"] = Dense(D, dim, bias=False)
            return dim
        if lt == "batchnorm-component":
            mods[f"{name}_bn"] = BatchNorm(D)
            return D
        if lt == "no-op-component":
            return D
        if lt == "tdnnf-layer":
            dim = layer.get_int("dim")
            mods[name] = TdnnfLayer(
                D, dim, layer.get_int("bottleneck-dim"),
                layer.get_int("time-stride", 1),
                layer.get_int("subsample", 1),
                layer.get_float("bypass-scale", 0.66))
            return dim
        if lt in _LSTM:
            cell = layer.get_int("cell-dim")
            rec = layer.get_int("recurrent-projection-dim", max(cell // 4, 1))
            nonrec = layer.get_int("non-recurrent-projection-dim", rec)
            mods[name] = LstmpLayer(D, cell, rec, nonrec)
            return rec + nonrec
        if lt in ("conv-relu-batchnorm-layer", "cnn-layer"):
            hin = layer.get_int("height-in", D)
            nf = layer.get_int("num-filters-out")
            hsub = layer.get_int("height-subsample-out", 1)
            mods[f"{name}_conv"] = ConvSame(
                D // hin, nf, (layer.get_int("time-kernel", 3),
                               layer.get_int("height-kernel", 3)), (1, hsub))
            out = -(-hin // hsub) * nf
            mods[f"{name}_bn"] = BatchNorm(out)
            return out
        if lt == "gru-layer":
            cell = layer.get_int("cell-dim")
            proj = layer.get_int("recurrent-projection-dim",
                                 max(cell // 4, 1))
            mods[name] = GruLayer(D, cell, proj)
            return proj
        if lt in ("attention-relu-renorm-layer", "attention-layer"):
            att = RestrictedAttention(
                D, num_heads=layer.get_int("num-heads", 4),
                key_dim=layer.get_int("key-dim", 40),
                value_dim=layer.get_int("value-dim", 40),
                num_left_inputs=layer.get_int("num-left-inputs", 5),
                num_right_inputs=layer.get_int("num-right-inputs", 2),
                time_stride=layer.get_int("time-stride", 1))
            mods[name] = att
            mods[f"{name}_bn"] = BatchNorm(att.H * att.V)
            return att.H * att.V
        if lt == "stats-layer":
            mods[name] = StatisticsPooling()
            return 2 * D
        if lt == "prefinal-layer":
            small = layer.get_int("small-dim", 192)
            mods[name] = Prefinal(D, layer.get_int("big-dim", 1024), small)
            return small
        if lt == "output-layer":
            dim = layer.get_int("dim")
            mods[f"{name}_affine"] = Dense(D, dim)
            return dim
        raise KaldiTpuError(f"unsupported xconfig layer type {lt!r} "
                            f"(layer {name})")

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        dev, dtype, mods = self.device, self.dtype, self.mods
        vals = {k: torch.as_tensor(v).to(dev, dtype)
                for k, v in inputs.items()}
        T = max(v.shape[1] for v in vals.values() if v.dim() == 3)
        tensors = {k: v[:, None, :].expand(-1, T, -1) if v.dim() == 2 else v
                   for k, v in vals.items()}
        outputs: Dict[str, torch.Tensor] = {}
        prev = None
        for layer in self.layers:
            lt, name = layer.layer_type, layer.name
            if prev is not None:
                tensors["__prev__"] = tensors[prev]
            if lt == "input":
                if name not in tensors:
                    raise KaldiTpuError(f"missing input {name}")
                prev = name
                continue
            x = _eval_descriptor(layer.get("input", ""), tensors,
                                 default=prev)
            if lt in _RELU_BN:
                x = mods[f"{name}_bn"](torch.relu(mods[f"{name}_affine"](x)))
            elif lt in ("fixed-affine-layer", "affine-layer"):
                x = mods[f"{name}_affine"](x)
            elif lt == "linear-component":
                x = mods[f"{name}_linear"](x)
            elif lt == "batchnorm-component":
                x = mods[f"{name}_bn"](x)
            elif lt in ("tdnnf-layer", "prefinal-layer"):
                x = mods[name](x)
            elif lt in _LSTM or lt == "gru-layer":
                x, _ = mods[name](x)
            elif lt in ("conv-relu-batchnorm-layer", "cnn-layer"):
                B, Tx, Dx = x.shape
                hin = layer.get_int("height-in", Dx)
                y = torch.relu(mods[f"{name}_conv"](
                    x.reshape(B, Tx, hin, Dx // hin)))
                x = mods[f"{name}_bn"](y.reshape(B, Tx, -1))
            elif lt in ("attention-relu-renorm-layer", "attention-layer"):
                x = mods[f"{name}_bn"](torch.relu(mods[name](x)))
            elif lt == "stats-layer":
                x = mods[name](x)[:, None, :].expand(-1, x.shape[1], -1)
            elif lt == "output-layer":
                y = mods[f"{name}_affine"](x)
                if layer.get("include-log-softmax", "true") == "true":
                    y = torch.log_softmax(y, dim=-1)
                outputs[name] = y
                x = y
            tensors[name] = x
            prev = name
        return outputs


def _layers_of(layers: Union[str, Sequence[XLayer]],
               substitutions: Optional[Dict[str, str]] = None
               ) -> List[XLayer]:
    return (parse_xconfig(layers, substitutions) if isinstance(layers, str)
            else list(layers))


def build_xconfig_model(text: str,
                        substitutions: Optional[Dict[str, str]] = None,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> XconfigModel:
    """The model of an xconfig text with zero weights (BatchNorm
    statistics 0 and 1), in eval mode, on `device` (CUDA unless the
    caller names the CPU)."""
    dev = resolve_device(device)
    return XconfigModel(_layers_of(text, substitutions)).to(dev, dtype)


# ---------------------------------------------------------------------------
# weights in flax's layout


def xconfig_from_flax(layers: Union[str, Sequence[XLayer]], variables: dict,
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32,
                      substitutions: Optional[Dict[str, str]] = None
                      ) -> XconfigModel:
    """The xconfig model (text or parsed layers) with the weights of a
    JAX {"params", "batch_stats"} tree of numpy arrays, in eval mode on
    `device`.  Parameters are cast to `dtype`; BatchNorm statistics stay
    float32 unless `dtype` is wider, as the reference keeps them."""
    dev = resolve_device(device)
    model = XconfigModel(_layers_of(layers, substitutions))
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        for key, mod in model.mods.items():
            if hasattr(mod, "load_flax"):
                mod.load_flax(params.get(key), stats.get(key))
    for prm in model.parameters():
        prm.data = prm.data.to(dtype)
    if dtype == torch.float64:
        model.double()
    return model.to(dev)


def xconfig_to_flax(model: XconfigModel) -> dict:
    """The model's {"params", "batch_stats"} in flax's layout (numpy
    float32): the inverse of `xconfig_from_flax`."""
    params: dict = {}
    stats: dict = {}
    for key, mod in model.mods.items():
        if hasattr(mod, "flax"):
            p, s = mod.flax()
            if p is not None:
                params[key] = p
            if s is not None:
                stats[key] = s
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# the chain TDNN-F as xconfig


def chain_tdnnf_xconfig(cfg) -> str:
    """xconfig text of a ChainTdnnfConfig (nnet3/models.py): the input
    (with an "ivector" input appended when cfg.ivector_dim), tdnn1 as
    relu-batchnorm-layer, the TDNN-F stack with cfg.time_strides() and
    the subsampling at cfg.subsample_layer, and the chain and xent heads,
    each a prefinal-layer over the last TDNN-F layer and an output-layer
    (log-softmax on the xent head only)."""
    H, n = cfg.hidden_dim, cfg.num_layers
    lines = [f"input dim={cfg.feat_dim} name=input"]
    first = ""
    if cfg.ivector_dim:
        lines.append(f"input dim={cfg.ivector_dim} name=ivector")
        first = " input=Append(input,ivector)"
    lines.append(f"relu-batchnorm-layer name=tdnn1 dim={H}{first}")
    for i, ts in enumerate(cfg.time_strides(), start=1):
        sub = (f" subsample={cfg.frame_subsampling_factor}"
               if i == cfg.subsample_layer else "")
        lines.append(f"tdnnf-layer name=tdnnf{i} dim={H} "
                     f"bottleneck-dim={cfg.bottleneck_dim} time-stride={ts} "
                     f"bypass-scale=0.66{sub}")
    last = f"tdnnf{n}" if n else "tdnn1"
    for head, out, softmax in (("chain", "output", "false"),
                               ("xent", "output-xent", "true")):
        lines.append(f"prefinal-layer name=prefinal-{head} input={last} "
                     f"big-dim={H} small-dim={cfg.prefinal_dim}")
        lines.append(f"output-layer name={out} dim={cfg.num_pdfs} "
                     f"include-log-softmax={softmax}")
    return "\n".join(lines) + "\n"


# ChainTdnnf's module names -> chain_tdnnf_xconfig's
_CHAIN_TDNNF_NAMES = {"input_affine": "tdnn1_affine", "input_bn": "tdnn1_bn",
                      "prefinal_chain": "prefinal-chain",
                      "prefinal_xent": "prefinal-xent",
                      "output_affine": "output_affine",
                      "output_xent_affine": "output-xent_affine"}


def chain_tdnnf_variables_to_xconfig(variables: dict) -> dict:
    """A ChainTdnnf {"params", "batch_stats"} tree (flagship_params.npz)
    renamed into chain_tdnnf_xconfig's module names; the arrays are
    shared."""
    return {col: {_CHAIN_TDNNF_NAMES.get(k, k): v for k, v in tree.items()}
            for col, tree in variables.items()}
