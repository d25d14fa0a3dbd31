"""Compile an imported Nnet3Graph to a PyTorch module (port of
`kaldi_tpu/nnet3/jax_bridge.py`).

The component zoo maps onto torch ops over (B, T, dim) tensors whose
parameters are buffers on the device; the node graph is lowered once, at
compile time, to a straight program of steps.  Acyclic nodes are whole
(B, T, dim) operations.  The recurrent group of a TDNN-LSTM/GRU (the
nodes on cycles through IfDefined(Offset(..., -k)), plus the acyclic
nodes between them) runs as a Python frame loop: each frame reads its
group nodes' rows of earlier frames (the carry: the last max-delay rows
of each node, zero before t=0 as IfDefined gives) and computes this
frame's rows in dependency order.  torch has no lax.scan; the loop is a
few launches a group node a frame, not captured in a CUDA graph.

Semantics are Nnet3Graph.forward's and jax_bridge's: time offsets clamp
to [0, T-1] of the padded batch, recurrent references before t=0 are
zero.  Every component type without a mapping raises at compile time,
and no path falls back to the host evaluator (the caller asks for
Nnet3Graph.forward explicitly).

Two things the JAX executor gets from XLA are done here by the lowering:
  * memory: XLA frees a node's value after its last use, while eager
    torch would keep every (B, T, 1536) activation of a 17-layer TDNN-F
    alive in a cache (~40 GB at 128 lanes x 1000 frames).  The program
    counts each value's consumers at compile time and drops the value
    after its last one;
  * common subexpressions: the exported TDNN-F's bypass is a nested
    Sum(Scale(0.66, prev), tdnnfN.batchnorm), 17 deep by the last layer
    and read by each layer's linear and both prefinal heads.  Descriptor
    values are keyed by their canonical string, so each is computed once
    a call.

Usage:

    net = compile_graph(graph, "output", device="cuda")
    out = net(feats)                 # (B, T, D) -> (B, T, out_dim)
    out = net(feats, ivectors)       # ivectors (B, ivector_dim)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.nnet3.mdl_io import Component, Desc, Nnet3Graph, \
    _desc_refs


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Fn(nn.Module):
    """One component's forward, fn(self, x), over its buffers."""

    def __init__(self, fn: Callable, **buffers: torch.Tensor):
        super().__init__()
        self.fn = fn
        for name, value in buffers.items():
            self.register_buffer(name, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self, x)


class _Seq(nn.Module):
    """CompositeComponent: its sub-components in turn."""

    def __init__(self, subs: List[nn.Module]):
        super().__init__()
        self.subs = nn.ModuleList(subs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for s in self.subs:
            x = s(x)
        return x


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """x[:, clip(t + off, 0, T - 1)] along dim 1, as one copy (no index
    tensor to upload)."""
    if off == 0:
        return x
    T = x.shape[1]
    k = min(abs(off), T)
    if off > 0:
        edge = x[:, T - 1:T].expand(-1, k, *x.shape[2:])
        return torch.cat([x[:, k:], edge], 1)
    edge = x[:, :1].expand(-1, k, *x.shape[2:])
    return torch.cat([edge, x[:, :T - k]], 1)


_AFFINE = ("AffineComponent", "NaturalGradientAffineComponent",
           "FixedAffineComponent")
_IDENTITY = ("NoOpComponent", "GeneralDropoutComponent", "DropoutComponent",
             "ClipGradientComponent", "DistributeComponent",
             "SpecAugmentTimeMaskComponent")


def _comp_rowfn(comp: Component) -> Optional[nn.Module]:
    """The forward of a per-frame component, x (..., D) -> (..., D'), or
    None if the component is time-structured (jax_bridge._comp_rowfn)."""
    f = comp.fields
    t = type(comp).TYPE
    if t in _AFFINE:
        return _Fn(lambda m, x: F.linear(x, m.W, m.b),
                   W=_f32(f["LinearParams"]), b=_f32(f["BiasParams"]))
    if t == "LinearComponent":
        return _Fn(lambda m, x: F.linear(x, m.W), W=_f32(f["Params"]))
    if t == "RectifiedLinearComponent":
        return _Fn(lambda m, x: torch.relu(x))
    if t == "SigmoidComponent":
        return _Fn(lambda m, x: torch.sigmoid(x))
    if t == "TanhComponent":
        return _Fn(lambda m, x: torch.tanh(x))
    if t == "LogSoftmaxComponent":
        return _Fn(lambda m, x: torch.log_softmax(x, dim=-1))
    if t == "SoftmaxComponent":
        return _Fn(lambda m, x: torch.softmax(x, dim=-1))
    if t in _IDENTITY:
        return _Fn(lambda m, x: x)
    if t == "BackpropTruncationComponent":
        s = float(f.get("Scale", 1.0))
        return _Fn(lambda m, x: x * s)
    if t == "BatchNormComponent":
        eps = float(f.get("Epsilon", 1e-3))
        rms = float(f.get("TargetRms", 1.0))
        if float(f.get("Count", 0)) > 0:
            # test mode, as the reference's decode binaries set it at
            # load (nnet3-compute.cc:112): (x - mean) (var + eps)^-1/2 rms
            mean = _f32(f["StatsMean"])
            scale = rms / torch.sqrt(_f32(f["StatsVar"]) + eps)
            return _Fn(lambda m, x: (x - m.mean) * m.scale, mean=mean,
                       scale=scale)

        def bn(m, x):
            # no statistics (a fresh model): normalize by this pass's
            # rows, as jax_bridge does (the reference would invent random
            # statistics here, nnet-normalize-component.cc)
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims) - mean * mean
            return (x - mean) * (rms / torch.sqrt(var + eps))
        return _Fn(bn)
    if t == "ScaleAndOffsetComponent":
        return _Fn(lambda m, x: x * m.s + m.o, s=_f32(f["Scales"]),
                   o=_f32(f["Offsets"]))
    if t == "NormalizeComponent":
        d = int(f.get("BlockDim", f["InputDim"]))
        rms = float(f.get("TargetRms", 1.0))
        add_log = bool(f.get("AddLogStddev", False))

        def norm(m, x):
            shp = x.shape[:-1]
            xb = x.reshape(*shp, -1, d)
            ss = torch.clamp((xb * xb).sum(-1), min=2.0 ** -66)
            scaled = xb * (rms / torch.sqrt(ss / d))[..., None]
            if add_log:
                # per block [block_dim values, log stddev]
                # (nnet-normalize-component.cc:137-147)
                ls = 0.5 * torch.log(ss / d)[..., None]
                scaled = torch.cat([scaled, ls], dim=-1)
            return scaled.reshape(*shp, -1)
        return _Fn(norm)
    if t in ("PerElementScaleComponent",
             "NaturalGradientPerElementScaleComponent"):
        return _Fn(lambda m, x: x * m.p, p=_f32(f["Params"]))
    if t == "PerElementOffsetComponent":
        off = np.asarray(f["Offsets"], np.float32)
        return _Fn(lambda m, x: x + (m.off.repeat(x.shape[-1] // m.off.numel())
                                     if x.shape[-1] != m.off.numel()
                                     else m.off), off=_f32(off))
    if t == "FixedScaleComponent":
        return _Fn(lambda m, x: x * m.s, s=_f32(f["Scales"]))
    if t == "FixedBiasComponent":
        return _Fn(lambda m, x: x + m.b, b=_f32(f["Bias"]))
    if t == "PermuteComponent":
        cm = torch.as_tensor(np.asarray(f["ColumnMap"], np.int64))
        return _Fn(lambda m, x: x.index_select(-1, m.cm), cm=cm)
    if t == "SumGroupComponent":
        sizes = list(f["Sizes"])
        idx = np.repeat(np.arange(len(sizes)), sizes)
        M = np.zeros((int(sum(sizes)), len(sizes)), np.float32)
        M[np.arange(len(idx)), idx] = 1.0
        return _Fn(lambda m, x: x @ m.M, M=_f32(M))
    if t == "ElementwiseProductComponent":
        od = int(f["OutputDim"])
        return _Fn(lambda m, x: torch.prod(
            x.reshape(*x.shape[:-1], -1, od), dim=-2))
    if t == "PnormComponent":
        od = int(f["OutputDim"])
        return _Fn(lambda m, x: torch.sqrt(
            (x.reshape(*x.shape[:-1], od, -1) ** 2).sum(-1)))
    if t == "SumBlockComponent":
        od = int(f["OutputDim"])
        s = float(f.get("Scale", 1.0))
        return _Fn(lambda m, x: x.reshape(*x.shape[:-1], -1, od).sum(-2) * s)
    if t in ("ConstantComponent", "ConstantFunctionComponent"):
        return _Fn(lambda m, x: m.out.expand(*x.shape[:-1], m.out.numel()),
                   out=_f32(f["Output"]).reshape(-1))
    if t == "BlockAffineComponent":
        nb = int(f["NumBlocks"])
        W = np.asarray(f["LinearParams"], np.float32)
        od, bin_ = W.shape[0] // nb, W.shape[1]
        return _Fn(lambda m, x: torch.einsum(
            "...nb,nob->...no", x.reshape(*x.shape[:-1], nb, bin_), m.W)
            .reshape(*x.shape[:-1], -1) + m.b,
            W=_f32(W.reshape(nb, od, bin_)), b=_f32(f["BiasParams"]))
    if t in ("RepeatedAffineComponent",
             "NaturalGradientRepeatedAffineComponent"):
        nr = int(f["NumRepeats"])
        return _Fn(lambda m, x: F.linear(
            x.reshape(*x.shape[:-1], nr, m.W.shape[1]), m.W, m.b)
            .reshape(*x.shape[:-1], -1),
            W=_f32(f["LinearParams"]), b=_f32(f["BiasParams"]))
    if t == "LstmNonlinearityComponent":
        C = np.asarray(f["Params"]).shape[1]
        use_dropout = bool(f.get("UseDropout", False))

        def lstm(m, x):
            i_part, f_part, c_part, o_part, c_prev = (
                x[..., k * C:(k + 1) * C] for k in range(5))
            W = m.W
            i_t = torch.sigmoid(i_part + W[0] * c_prev)
            f_t = torch.sigmoid(f_part + W[1] * c_prev)
            if use_dropout:
                i_t = i_t * x[..., 5 * C:5 * C + 1]
                f_t = f_t * x[..., 5 * C + 1:5 * C + 2]
            c_t = f_t * c_prev + i_t * torch.tanh(c_part)
            o_t = torch.sigmoid(o_part + W[2] * c_t)
            if use_dropout:
                o_t = o_t * x[..., 5 * C + 2:5 * C + 3]
            return torch.cat([c_t, o_t * torch.tanh(c_t)], dim=-1)
        return _Fn(lstm, W=_f32(f["Params"]))
    if t == "GruNonlinearityComponent":
        C = int(f["CellDim"])
        R = int(f["RecurrentDim"])

        def gru(m, x):
            z = x[..., :C]
            r = x[..., C:C + R]
            hpart = x[..., C + R:2 * C + R]
            c_prev = x[..., 2 * C + R:3 * C + R]
            s_prev = x[..., 3 * C + R:]
            h = torch.tanh(hpart + F.linear(s_prev * r, m.W))
            return torch.cat([h, (1.0 - z) * h + z * c_prev], dim=-1)
        return _Fn(gru, W=_f32(f["w_h"]))
    if t == "OutputGruNonlinearityComponent":
        C = int(f["CellDim"])

        def ogru(m, x):
            z, hpart, c_prev = x[..., :C], x[..., C:2 * C], x[..., 2 * C:]
            h = torch.tanh(hpart + m.w * c_prev)
            return torch.cat([h, (1.0 - z) * h + z * c_prev], dim=-1)
        return _Fn(ogru, w=_f32(f["w_h"]))
    if t == "MaxpoolingComponent":
        ix, iy, iz, px, py, pz, sx, sy, sz = (
            int(f[k]) for k in type(comp).WRITE_ORDER)
        nx, ny, nz = (1 + (ix - px) // sx, 1 + (iy - py) // sy,
                      1 + (iz - pz) // sz)

        def mp(m, x):
            lead = x.shape[:-1]
            xt = x.reshape(*lead, ix, iy, iz)
            out = None
            for dx in range(px):
                for dy in range(py):
                    for dz in range(pz):
                        sub = xt[..., dx:dx + nx * sx:sx, dy:dy + ny * sy:sy,
                                 dz:dz + nz * sz:sz]
                        out = sub if out is None else torch.maximum(out, sub)
            return out.reshape(*lead, nx * ny * nz)
        return _Fn(mp)
    if t == "CompositeComponent":
        subs = [_comp_rowfn(c) for c in comp.sub_components]
        if any(s is None for s in subs):
            return None
        return _Seq(subs)
    return None


def _comp_timefn(comp: Component) -> Optional[nn.Module]:
    """The forward of a time-structured component, x (B, T, D) -> (B, T,
    D') (jax_bridge._comp_timefn), or None."""
    f = comp.fields
    t = type(comp).TYPE
    if t == "TdnnComponent":
        offsets = [int(o) for o in f["TimeOffsets"]]
        W = np.asarray(f["LinearParams"], np.float32)
        bias = np.asarray(f.get("BiasParams", np.zeros(0)), np.float32)
        has_bias = bias.size > 0
        K, out_dim = len(offsets), W.shape[0]
        D = W.shape[1] // K
        if D <= out_dim:
            # splice the (narrower) shifted inputs, one product
            def tdnn(m, x):
                xs = torch.cat([_shift(x, o) for o in offsets], -1)
                return F.linear(xs, m.W, m.b if has_bias else None)
            return _Fn(tdnn, W=_f32(W), b=_f32(bias))
        # a wide input (the TDNN-F's linear, 1536 -> 160): one product
        # with the offsets' blocks stacked as rows, then the narrower
        # outputs shifted and summed; no (B, T, K x D) splice
        Wk = W.reshape(out_dim, K, D).transpose(1, 0, 2).reshape(K * out_dim,
                                                                  D)

        def tdnn_wide(m, x):
            y = F.linear(x, m.W)
            out = None
            for k, o in enumerate(offsets):
                term = _shift(y[..., k * out_dim:(k + 1) * out_dim], o)
                out = term if out is None else out + term
            return out + m.b if has_bias else out
        return _Fn(tdnn_wide, W=_f32(Wk), b=_f32(bias))
    if t == "TimeHeightConvolutionComponent":
        mdl = f["Model"]
        fin, fout = mdl["num_filters_in"], mdl["num_filters_out"]
        hin, hout = mdl["height_in"], mdl["height_out"]
        sub = mdl["height_subsample_out"]
        W = np.asarray(f["LinearParams"], np.float32)
        b = np.asarray(f["BiasParams"], np.float32)
        taps = []                       # (dt, source heights, valid mask)
        for k, (dt, dh) in enumerate(mdl["offsets"]):
            h_src = np.arange(hout) * sub + dh
            valid = (h_src >= 0) & (h_src < hin)
            if valid.any():
                taps.append((k, int(dt), np.clip(h_src, 0, hin - 1), valid))
        buffers = {"b": _f32(b)}
        for k, _dt, h_src, valid in taps:
            buffers[f"W{k}"] = _f32(W[:, k * fin:(k + 1) * fin])
            buffers[f"h{k}"] = torch.as_tensor(h_src.astype(np.int64))
            buffers[f"v{k}"] = _f32(valid.astype(np.float32))[:, None]

        def conv(m, x):
            B, T = x.shape[0], x.shape[1]
            xb = x.reshape(B, T, hin, fin)
            out = x.new_zeros((B, T, hout, fout))
            for k, dt, _h, _v in taps:
                src = _shift(xb, dt).index_select(2, getattr(m, f"h{k}"))
                src = src * getattr(m, f"v{k}")
                out = out + torch.einsum("bthf,of->btho", src,
                                         getattr(m, f"W{k}"))
            if b.size == hout * fout:
                out = out + m.b.reshape(hout, fout)
            elif b.size:
                out = out + m.b
            return out.reshape(B, T, -1)
        return _Fn(conv, **buffers)
    if t == "StatisticsExtractionComponent":
        ip = int(f.get("InputPeriod", 1))
        op = int(f.get("OutputPeriod", 1))
        k = max(op // ip, 1)
        var = bool(f.get("IncludeVarinance", True))

        def ext(m, x):
            B, T = x.shape[0], x.shape[1]
            hi = torch.clamp(torch.arange(T, device=x.device) + k, max=T)
            lo = torch.arange(T, device=x.device)
            cols = [(hi - lo).to(x.dtype)[None, :, None].expand(B, T, 1)]
            for v in ((x, x * x) if var else (x,)):
                cs = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))
                cols.append(cs[:, hi] - cs[:, lo])
            return torch.cat(cols, dim=-1)
        return _Fn(ext)
    if t == "StatisticsPoolingComponent":
        ip = int(f.get("InputPeriod", 1))
        left = int(f["LeftContext"])
        right = int(f["RightContext"])
        nlog = int(f.get("NumLogCountFeatures", 0))
        stddevs = bool(f.get("OutputStddevs", True))
        floor = float(f.get("VarianceFloor", 1e-10))

        def pool(m, x):
            B, T, SD = x.shape
            D = (SD - 1) // 2 if stddevs else SD - 1
            t_arr = np.arange(T)
            if ip == 1:
                # a range sum over input frames [t - left, t + right]
                cs = F.pad(torch.cumsum(x, dim=1), (0, 0, 1, 0))
                lo = torch.as_tensor(np.maximum(0, t_arr - left),
                                     device=x.device)
                hi = torch.as_tensor(np.minimum(T - 1, t_arr + right) + 1,
                                     device=x.device)
                stats = cs[:, hi] - cs[:, lo]
            else:
                stats = None
                for phase in range(0, left + right + 1, ip):
                    pos = t_arr - left + phase
                    keep = (pos >= 0) & (pos <= t_arr + right) & (pos < T)
                    src = torch.as_tensor(np.clip(pos, 0, T - 1),
                                          device=x.device)
                    mask = torch.as_tensor(keep.astype(np.float32),
                                           device=x.device)[None, :, None]
                    term = x[:, src] * mask
                    stats = term if stats is None else stats + term
            count = torch.clamp(stats[..., :1], min=1e-10)
            mean = stats[..., 1:1 + D] / count
            cols = []
            if nlog:
                cols.append(torch.log(count).expand(B, T, nlog))
            cols.append(mean)
            if stddevs:
                vv = stats[..., 1 + D:1 + 2 * D] / count - mean * mean
                cols.append(torch.sqrt(torch.clamp(vv, min=floor)))
            return torch.cat(cols, dim=-1)
        return _Fn(pool)
    if t == "RestrictedAttentionComponent":
        H = int(f["NumHeads"])
        kd = int(f["KeyDim"])
        vd = int(f["ValueDim"])
        L = int(f["NumLeftInputs"])
        R = int(f["NumRightInputs"])
        stride = int(f["TimeStride"])
        out_ctx = bool(f.get("OutputContext", False))
        key_scale = float(f.get("KeyScale", 1.0))
        ctx = L + 1 + R
        blk = 2 * kd + ctx + vd

        def attn(m, x):
            outs = []
            for h in range(H):
                xb = x[..., h * blk:(h + 1) * blk]
                keys = xb[..., :kd]
                values = xb[..., kd:kd + vd]
                query = xb[..., kd + vd:]
                q_key, q_ctx = query[..., :kd], query[..., kd:]
                scores = [key_scale * (q_key * _shift(keys, (j - L) * stride))
                          .sum(-1) + q_ctx[..., j] for j in range(ctx)]
                c = torch.softmax(torch.stack(scores, dim=-1), dim=-1)
                out = None
                for j in range(ctx):
                    term = c[..., j:j + 1] * _shift(values, (j - L) * stride)
                    out = term if out is None else out + term
                outs.append(torch.cat([out, c], -1) if out_ctx else out)
            return torch.cat(outs, dim=-1)
        return _Fn(attn)
    return None


def _reachable(starts, g: Dict[str, List[str]]) -> set:
    seen = set(starts)
    work = list(starts)
    while work:
        v = work.pop()
        for w in g.get(v, []):
            if w not in seen:
                seen.add(w)
                work.append(w)
    return seen


class _Frame:
    """State of one frame-loop run: rows of the group nodes by frame,
    the external (B, T, dim) inputs, zero rows for t < 0."""

    __slots__ = ("rows", "ext", "zeros", "B", "T")


class CompiledGraph(nn.Module):
    """An Nnet3Graph as a PyTorch module (see the module docstring).
    forward(feats (B, T, D), ivector (B, dim) or None) -> (B, T, out)."""

    def __init__(self, graph: Nnet3Graph, output_name: str = "output",
                 device: torch.device = torch.device("cpu")):
        super().__init__()
        self._device = device
        node_of = graph.node_of
        recurrent = graph._recurrent_nodes()
        deps = {n.name: [r for r in (_desc_refs(n.desc)
                                     if n.desc is not None else [])
                         if r in node_of] for n in graph.nodes}
        rev: Dict[str, List[str]] = {}
        for v, ws in deps.items():
            for w in ws:
                rev.setdefault(w, []).append(v)
        group = (recurrent | (_reachable(recurrent, rev)
                              & _reachable(recurrent, deps))
                 if recurrent else set())

        self.comps = nn.ModuleDict()
        self._comp_key: Dict[str, str] = {}
        per_frame = set()
        for i, (name, comp) in enumerate(graph.components.items()):
            mod = _comp_rowfn(comp)
            if mod is not None:
                per_frame.add(name)
            else:
                mod = _comp_timefn(comp)
                if mod is None:
                    raise KaldiTpuError(
                        f"compile_graph: no torch mapping for component "
                        f"type {type(comp).TYPE}")
            self._comp_key[name] = f"c{i}"
            self.comps[f"c{i}"] = mod

        dims: Dict[str, int] = {}
        for name in group:
            node = node_of[name]
            if node.kind == "component":
                comp = graph.components[node.component]
                if node.component not in per_frame:
                    raise KaldiTpuError(
                        f"compile_graph: component {node.component} "
                        f"({type(comp).TYPE}) is on a recurrence cycle but "
                        f"has no per-frame mapping")
                probe = comp.forward(np.zeros((1, comp.input_dim),
                                              np.float32))
                dims[name] = probe.shape[1]
            elif node.kind == "dim-range":
                dims[name] = node.dim
            else:
                raise KaldiTpuError(
                    f"compile_graph: node {name!r} of kind {node.kind} on "
                    f"a recurrence cycle")
        self._group_dims = dims
        self._node_of = node_of
        self._group = group
        self._steps: List[Tuple[str, str, object, List[str]]] = []
        self._lower(output_name)
        self.to(device)

    # -- lowering: the node graph as a straight program ------------------

    def _lower(self, output_name: str) -> None:
        steps = self._steps
        node_of, group = self._node_of, self._group
        done: Dict[str, str] = {}        # node name or descriptor -> slot
        scan_args: List[str] = []

        def need_node(name: str) -> str:
            if name in done:
                return done[name]
            if name in group:
                need_scan()
                return name
            node = node_of.get(name)
            if node is None:
                raise KaldiTpuError(f"compile_graph: no node {name!r}")
            if node.kind == "input":
                if name not in ("input", "ivector"):
                    raise KaldiTpuError(
                        f"compile_graph: unknown input {name!r}")
                steps.append((name, name, node.dim, []))
                slot = name
            elif node.kind == "component":
                a = need_desc(node.desc)
                steps.append((name, "comp", self._comp_key[node.component],
                              [a]))
                slot = name
            elif node.kind == "dim-range":
                a = need_node(node.desc.args[0])
                steps.append((name, "range", (node.dim_offset,
                                              node.dim_offset + node.dim),
                              [a]))
                slot = name
            else:                                   # output node: an alias
                slot = need_desc(node.desc)
            done[name] = slot
            return slot

        def need_desc(d: Desc) -> str:
            if d.op == "node":
                return need_node(d.args[0])
            if d.op in ("IfDefined", "Failover", "Switch"):
                return need_desc(d.args[0])
            key = repr(d)
            if key in done:
                return done[key]
            if d.op == "Append":
                steps.append((key, "cat", None,
                              [need_desc(a) for a in d.args]))
            elif d.op == "Offset":
                steps.append((key, "shift", int(d.args[1]),
                              [need_desc(d.args[0])]))
            elif d.op == "Sum":
                steps.append((key, "sum", None,
                              [need_desc(a) for a in d.args]))
            elif d.op == "Scale":
                steps.append((key, "scale", float(d.args[0]),
                              [need_desc(d.args[1])]))
            elif d.op == "Const":
                steps.append((key, "const", (float(d.args[0]),
                                             int(d.args[1])), []))
            elif d.op == "ReplaceIndex":
                steps.append((key, "index", int(d.args[2]),
                              [need_desc(d.args[0])]))
            elif d.op == "Round":
                steps.append((key, "round", int(d.args[1]),
                              [need_desc(d.args[0])]))
            else:
                raise KaldiTpuError(f"compile_graph: unsupported op {d.op}")
            done[key] = key
            return key

        def need_scan() -> None:
            if "__scan__" in done:
                return
            done["__scan__"] = "__scan__"
            self._compile_frame()
            for name in self._ext_names:
                scan_args.append(need_node(name))
            steps.append(("__scan__", "scan", None, scan_args))

        out = need_node(output_name)
        uses: Dict[str, int] = {out: 1}        # the output is never freed
        for _out, _op, _payload, args in steps:
            for a in args:
                uses[a] = uses.get(a, 0) + 1
        self._uses = uses
        self._out_slot = out

    # -- the recurrent group's frame program ------------------------------

    def _compile_frame(self) -> None:
        """Per-frame row functions of the group nodes, in dependency
        order within a frame; the external nodes they read; each group
        node's largest delay."""
        node_of, group = self._node_of, self._group
        ext_names: List[str] = []
        max_delay = {name: 1 for name in group}

        def row_fn(d: Desc, off: int) -> Callable:
            op = d.op
            if op == "node":
                n = d.args[0]
                if n in group:
                    if off > 0:
                        raise KaldiTpuError(
                            f"compile_graph: non-causal recurrence on {n}")
                    if off < 0:
                        max_delay[n] = max(max_delay[n], -off)
                    return lambda S, t: (S.rows[n][t + off] if t + off >= 0
                                         else S.zeros[n])
                if n not in ext_names:
                    ext_names.append(n)
                return lambda S, t: S.ext[n][:, min(max(t + off, 0),
                                                    S.T - 1)]
            if op == "Offset":
                return row_fn(d.args[0], off + int(d.args[1]))
            if op in ("IfDefined", "Switch", "Failover"):
                return row_fn(d.args[0], off)
            if op == "Append":
                fs = [row_fn(a, off) for a in d.args]
                return lambda S, t: torch.cat([g(S, t) for g in fs], -1)
            if op == "Sum":
                fs = [row_fn(a, off) for a in d.args]

                def total(S, t):
                    out = fs[0](S, t)
                    for g in fs[1:]:
                        out = out + g(S, t)
                    return out
                return total
            if op == "Scale":
                alpha, g = float(d.args[0]), row_fn(d.args[1], off)
                return lambda S, t: alpha * g(S, t)
            if op == "Const":
                value, dim = float(d.args[0]), int(d.args[1])
                return lambda S, t: torch.full(
                    (S.B, dim), value, dtype=torch.float32,
                    device=self._device_of())
            raise KaldiTpuError(
                f"compile_graph: op {op} unsupported inside a recurrence")

        def same_frame_deps(d: Desc, off: int, out: List[str]) -> None:
            if d.op == "node":
                if d.args[0] in group and off == 0:
                    out.append(d.args[0])
                return
            if d.op == "Offset":
                same_frame_deps(d.args[0], off + int(d.args[1]), out)
                return
            for a in d.args:
                if isinstance(a, Desc):
                    same_frame_deps(a, off, out)

        order: List[str] = []
        state: Dict[str, int] = {}              # 1 in progress, 2 done

        def visit(name: str) -> None:
            if state.get(name) == 2:
                return
            if state.get(name) == 1:
                raise KaldiTpuError(
                    f"compile_graph: zero-delay cycle at {name!r}")
            state[name] = 1
            node = node_of[name]
            deps: List[str] = []
            if node.kind == "dim-range":
                deps = [node.desc.args[0]]
            else:
                same_frame_deps(node.desc, 0, deps)
            for dep in deps:
                visit(dep)
            state[name] = 2
            order.append(name)

        for name in sorted(group):
            visit(name)
        program = []
        for name in order:
            node = node_of[name]
            if node.kind == "component":
                program.append((name, self._comp_key[node.component],
                                row_fn(node.desc, 0)))
            else:
                program.append((name, None, (node.desc.args[0],
                                             node.dim_offset,
                                             node.dim_offset + node.dim)))
        self._frame_program = program
        self._ext_names = ext_names
        self._max_delay = max_delay

    def _device_of(self) -> torch.device:
        for b in self.buffers():
            return b.device
        return self._device

    def _run_scan(self, vals: Dict[str, torch.Tensor], B: int, T: int,
                  device: torch.device) -> None:
        S = _Frame()
        S.B, S.T = B, T
        S.ext = {n: vals[n] for n in self._ext_names}
        S.zeros = {n: torch.zeros((B, d), dtype=torch.float32, device=device)
                   for n, d in self._group_dims.items()}
        S.rows = {n: [] for n in self._group}
        keep = {n for n in self._group if self._uses.get(n, 0) > 0}
        for t in range(T):
            for name, comp_key, fn in self._frame_program:
                if comp_key is not None:
                    row = self.comps[comp_key](fn(S, t))
                else:
                    src, a, b = fn
                    row = S.rows[src][t][..., a:b]
                S.rows[name].append(row)
            # the carry: rows older than a node's largest delay are not
            # read again unless the node is consumed after the loop
            for name in self._group:
                old = t + 1 - self._max_delay[name] - 1
                if name not in keep and old >= 0:
                    S.rows[name][old] = None
        for name in keep:
            vals[name] = torch.stack(S.rows[name], dim=1)

    # -- execution ---------------------------------------------------------

    def forward(self, feats: torch.Tensor,
                ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = self._device_of()
        with torch.inference_mode(), full_f32():
            feats = torch.as_tensor(feats).to(device, torch.float32)
            B, T = feats.shape[0], feats.shape[1]
            vals: Dict[str, torch.Tensor] = {}
            left = dict(self._uses)
            for out, op, payload, args in self._steps:
                xs = [vals[a] for a in args]
                if op == "input":
                    val = feats
                elif op == "ivector":
                    if ivector is None:
                        raise KaldiTpuError("model needs an ivector input")
                    iv = torch.as_tensor(ivector).to(device, torch.float32)
                    val = iv.reshape(B, -1)[:, None, :].expand(B, T, payload)
                elif op == "comp":
                    val = self.comps[payload](xs[0])
                elif op == "range":
                    val = xs[0][..., payload[0]:payload[1]]
                elif op == "cat":
                    val = torch.cat(xs, dim=-1)
                elif op == "shift":
                    val = _shift(xs[0], payload)
                elif op == "sum":
                    val = xs[0]
                    for x in xs[1:]:
                        val = val + x
                elif op == "scale":
                    val = payload * xs[0]
                elif op == "const":
                    val = torch.full((B, T, payload[1]), payload[0],
                                     dtype=torch.float32, device=device)
                elif op == "index":
                    row = min(max(payload, 0), T - 1)
                    val = xs[0][:, row:row + 1].expand(xs[0].shape)
                elif op == "round":
                    idx = (torch.arange(T, device=device) // payload) * payload
                    val = xs[0].index_select(1, idx)
                else:                                       # scan
                    self._run_scan(vals, B, T, device)
                    val = None
                if val is not None:
                    vals[out] = val
                for a in args:
                    left[a] -= 1
                    if left[a] == 0:
                        del vals[a]
            return vals[self._out_slot]


def compile_graph(graph: Nnet3Graph, output_name: str = "output",
                  device: DeviceLike = None) -> CompiledGraph:
    """The graph as a CompiledGraph on `device` (CUDA unless the caller
    names the CPU).  Raises for component types without a mapping."""
    return CompiledGraph(graph, output_name, resolve_device(device))
