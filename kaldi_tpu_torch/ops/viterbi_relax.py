"""Batched Viterbi relaxation over a padded incoming-arc table: the CUDA
kernel `csrc/viterbi_relax.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel of `kaldi_tpu/ops/pallas_viterbi.py`,
`pallas_relax` (body :82-91, pallas_call :93), and keeps numpy copies of
that module's `INF` and `build_incoming_table`.

The decoder's per-frame hot op is, for every lane b and state s:

    new[b, s] = min_k ( cost[b, in_src[s, k]] + in_w[s, k]
                        - scale * loglikes[b, in_pdf[s, k]] )

over the padded incoming-arc table built once at pack time: K is the
largest in-degree rounded up to a power of two, and dead slots carry
`src = S` (a dead state whose cost the caller keeps at INF), `w = INF`,
`pdf = 0`.  INF is 1e30, not infinity: a dead candidate is the finite
2e30, and a state with no live in-arc ends there.

`relax_padded` and `viterbi_relax` take the same arguments:
  cost        (B, S+1) f32, column S the dead state
  in_src      (S, K) i32 shared by all lanes, or (B, S, K), one a lane
  in_w        f32, in_pdf i32: the shape of in_src
  loglikes_t  (B, P) f32
  out         optional (B, S) or (B, S+1) f32 to write into; with S+1
              columns the dead column is written too
and return the (B, S) relaxed costs (a view of `out` when given).
With `in_pdf=None` they compute the epsilon-closure step instead: no
acoustic term, and the result is `min(cost[:, :S], update)` (the dead
column of `out` then keeps the old value).

cost, loglikes_t and out may be strided views: the batched decoder keeps
its tables lanes-fastest and passes transposed views, so that a warp of
the kernel reads one table entry and 32 neighbouring lanes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.ops import _build

INF = np.float32(1e30)

# calls that launched the CUDA kernel (not the plain version)
launches = 0


def build_incoming_table(num_states, src, dst, weight, pdf
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad incoming arcs per destination to a power-of-two K.
    Returns (in_src (S,K) int32, in_w (S,K) f32, in_pdf (S,K) int32, K).
    Dead slots: src = S (a dead state the caller keeps at INF),
    w = INF, pdf = 0."""
    S = num_states
    counts = np.zeros(S, np.int64)
    np.add.at(counts, dst, 1)
    kmax = int(counts.max(initial=1))
    K = 1
    while K < kmax:
        K *= 2
    in_src = np.full((S, K), S, np.int32)
    in_w = np.full((S, K), INF, np.float32)
    in_pdf = np.zeros((S, K), np.int32)
    fill = np.zeros(S, np.int64)
    for a in range(len(src)):
        d = dst[a]
        j = fill[d]
        in_src[d, j] = src[a]
        in_w[d, j] = weight[a]
        in_pdf[d, j] = pdf[a]
        fill[d] += 1
    return in_src, in_w, in_pdf, K


def _gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, C), idx (S, K) or (B, S, K) -> x[b, idx[(b,) s, k]]."""
    B = x.shape[0]
    if idx.dim() == 2:
        flat = x.index_select(1, idx.reshape(-1).long())
    else:
        flat = torch.gather(x, 1, idx.reshape(B, -1).long())
    return flat.reshape(B, *idx.shape[-2:])


def _finish(new: torch.Tensor, dead: Optional[torch.Tensor],
            out: Optional[torch.Tensor], S: int) -> torch.Tensor:
    if out is None:
        return new
    out[:, :S] = new
    if out.shape[1] == S + 1:
        out[:, S] = INF.item() if dead is None else dead
    return out[:, :S]


def relax_padded(cost, in_src, in_w, in_pdf=None, loglikes_t=None,
                 acoustic_scale: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, on any device: gathers, adds and `amin`."""
    S = in_src.shape[-2]
    shared = in_src.dim() == 2
    prev = _gather_cols(cost, in_src)                       # (B, S, K)
    cand = prev + (in_w[None] if shared else in_w)
    if in_pdf is None:
        new = torch.minimum(cost[:, :S], torch.amin(cand, dim=-1))
        return _finish(new, cost[:, S].clone(), out, S)
    ac = _gather_cols(loglikes_t, in_pdf)                   # (B, S, K)
    cand = cand - acoustic_scale * ac
    return _finish(torch.amin(cand, dim=-1), None, out, S)


def _span(t: torch.Tensor) -> Tuple[int, int, int]:
    """(storage address, first element, last element) that t touches."""
    first = t.storage_offset()
    last = first
    for n, st in zip(t.shape, t.stride()):
        if st < 0:
            raise ValueError("negative strides are not supported")
        last += (n - 1) * st
    return t.untyped_storage().data_ptr(), first, last


def _check(name: str, t: torch.Tensor, shape, dtype, device,
           contiguous: bool) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, cost on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib: ctypes.CDLL):
    fn = lib.viterbi_relax
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll, ll, p, p, p, ll, p, ll, ll, ctypes.c_float,
                       p, ll, ll, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def viterbi_relax(cost, in_src, in_w, in_pdf=None, loglikes_t=None,
                  acoustic_scale: float = 1.0,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One relaxation.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise).  Table indices are not checked here:
    whoever builds the tables checks `in_src <= S` and `in_pdf < P` once
    (`check_tables`)."""
    if cost.device.type == "cpu":
        return relax_padded(cost, in_src, in_w, in_pdf, loglikes_t,
                            acoustic_scale, out)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    dev = cost.device
    if cost.dim() != 2 or in_src.dim() not in (2, 3):
        raise ValueError("cost must be (B, S+1) and in_src (S, K) or "
                         "(B, S, K)")
    B = cost.shape[0]
    S, K = in_src.shape[-2:]
    closure = in_pdf is None
    if closure != (loglikes_t is None):
        raise ValueError("in_pdf and loglikes_t go together: both for an "
                         "emitting step, neither for a closure step")
    tshape = (S, K) if in_src.dim() == 2 else (B, S, K)
    _check("cost", cost, (B, S + 1), torch.float32, dev, False)
    _check("in_src", in_src, tshape, torch.int32, dev, True)
    _check("in_w", in_w, tshape, torch.float32, dev, True)
    if not closure:
        _check("in_pdf", in_pdf, tshape, torch.int32, dev, True)
        if loglikes_t.dim() != 2:
            raise ValueError("loglikes_t must be (B, P)")
        _check("loglikes_t", loglikes_t, (B, loglikes_t.shape[1]),
               torch.float32, dev, False)
    if out is None:
        out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if out.dim() != 2 or out.shape[1] not in (S, S + 1):
        raise ValueError(f"out must be (B, S) or (B, S+1), got "
                         f"{tuple(out.shape)}")
    _check("out", out, (B, out.shape[1]), torch.float32, dev, False)
    o_store, o_first, o_last = _span(out)
    c_store, c_first, c_last = _span(cost)
    if o_store == c_store and o_first <= c_last and c_first <= o_last:
        raise ValueError("out must not overlap cost (a relaxation reads "
                         "other states' old costs while it writes)")
    fn = _bind(_build.load("viterbi_relax"))
    ll = cost if closure else loglikes_t        # closure: never read
    pdf = in_src if closure else in_pdf
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cost.data_ptr(), cost.stride(0), cost.stride(1),
                in_src.data_ptr(), in_w.data_ptr(), pdf.data_ptr(),
                0 if in_src.dim() == 2 else S * K, ll.data_ptr(),
                ll.stride(0), ll.stride(1), float(acoustic_scale),
                out.data_ptr(), out.stride(0), out.stride(1), B, S, K,
                out.shape[1], int(closure), stream)
    if rc != 0:
        raise RuntimeError(f"viterbi_relax kernel launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out[:, :S]


def check_tables(in_src: np.ndarray, in_pdf: Optional[np.ndarray],
                 num_pdfs: Optional[int]) -> None:
    """Raise unless every source index is a state or the dead state and
    every pdf index is a column of the loglikes.  Called once where the
    tables are made, so that no launch has to look."""
    S = in_src.shape[-2]
    if in_src.size and (in_src.min() < 0 or in_src.max() > S):
        raise ValueError(f"in_src outside [0, {S}]")
    if in_pdf is not None and in_pdf.size and (
            in_pdf.min() < 0 or in_pdf.max() >= num_pdfs):
        raise ValueError(f"in_pdf outside [0, {num_pdfs})")
