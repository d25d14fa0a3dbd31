"""Exact Viterbi frame step over the block-chain layout: the CUDA kernel
`csrc/block_chain_step.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel of `kaldi_tpu/decoder/block_chain.py`,
`BlockChainDecoder._make_step` (body :296-343, pallas_call :345-377).
The step is bound by memory traffic: it must read the old (Up, N, B)
float32 cost plane and write the new one, plus an (Up, N/8, B) plane of
packed decisions, with a few adds and compares per element.  The CUDA
design (see the source) streams the plane once with coalesced lane-
fastest accesses and fuses the lane freeze, and replaces the TPU's
sequential-grid running min by two small grids: partial mins over
chunks of blocks, then a fold of the chunks in ascending order.

Inputs (all on one device, contiguous):
  cost         (Up, N, B) f32   old cost plane, N a multiple of 8
  ovr          (Up, B)    f32   root costs per context block
  amf, ams     (N, B)     f32   forward / self-loop acoustic costs
  first        (N,)       bool  rows that enter from the block's root
  bigram_ends  (Up, Vp)   f32   LN2 + bigram cost, in word-end order
  end_src      (Vp,)      i32   word-end source: chain row >= 0, -1 the
                                root (one-phone word), -2 a pad slot
  active       (B,)       bool  lanes still consuming frames
Outputs: new cost (Up, N, B) f32 (inactive lanes keep their old column),
bits (Up, N/8, B) u8 (bit r of byte i: row 8i+r took the forward arc),
rootexp (Vp, B) f32 and rootarg (Vp, B) i32 (best word-end candidate
over blocks and its block; the lowest block wins ties; INF and 0 when
nothing beats INF).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.ops import _build

LN2 = float(np.log(2.0))
INF = 1e30

# calls that launched the CUDA kernel (not the plain version)
launches = 0
# context blocks per partial min of the word-end reduction
REDUCE_CHUNK = 32

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def block_chain_step_reference(cost, ovr, amf, ams, first, bigram_ends,
                               end_src, active,
                               new: Optional[torch.Tensor] = None,
                               bits: Optional[torch.Tensor] = None
                               ) -> Outputs:
    """Plain PyTorch version of the step, on any device.  Writes into
    `new` / `bits` when given."""
    Up, N, B = cost.shape
    rolled = torch.roll(cost, 1, dims=1)
    fwd_src = torch.where(first[None, :, None], ovr[:, None, :], rolled)
    fwd_cand = fwd_src + (LN2 + amf)
    self_cand = cost + (LN2 + ams)
    take_fwd = fwd_cand < self_cand
    relaxed = torch.where(take_fwd, fwd_cand, self_cand)
    relaxed = torch.where(active[None, None, :], relaxed, cost)
    weights = (1 << torch.arange(8, device=cost.device,
                                 dtype=torch.int32))[:, None]
    packed = (take_fwd.view(Up, N // 8, 8, B).to(torch.int32)
              * weights).sum(dim=2).to(torch.uint8)
    # word-end candidates out of every block of the OLD plane
    src = cost.index_select(1, end_src.clamp(min=0).to(torch.int64))
    src = torch.where((end_src == -1)[None, :, None], ovr[:, None, :], src)
    src = torch.where((end_src == -2)[None, :, None],
                      torch.full_like(src, INF), src)
    cand = src + bigram_ends[:, :, None]                 # (Up, Vp, B)
    low = torch.amin(cand, dim=0)
    arg = torch.argmin(cand, dim=0)      # first minimum: the lowest block
    beat = low < INF
    rootexp = torch.where(beat, low, torch.full_like(low, INF))
    rootarg = torch.where(beat, arg, torch.zeros_like(arg)).to(torch.int32)
    if new is not None:
        new.copy_(relaxed)
        relaxed = new
    if bits is not None:
        bits.copy_(packed)
        packed = bits
    return relaxed, packed, rootexp, rootarg


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, cost on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib: ctypes.CDLL):
    fn = lib.block_chain_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def block_chain_step(cost, ovr, amf, ams, first, bigram_ends, end_src,
                     active, new: Optional[torch.Tensor] = None,
                     bits: Optional[torch.Tensor] = None) -> Outputs:
    """One frame of the block-chain Viterbi.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if cost.device.type == "cpu":
        return block_chain_step_reference(cost, ovr, amf, ams, first,
                                          bigram_ends, end_src, active,
                                          new, bits)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    dev = cost.device
    if cost.dim() != 3:
        raise ValueError("cost must be (Up, N, B)")
    Up, N, B = cost.shape
    if N % 8:
        raise ValueError(f"N={N} must be a multiple of 8")
    Vp = bigram_ends.shape[-1]
    _check("cost", cost, (Up, N, B), torch.float32, dev)
    _check("ovr", ovr, (Up, B), torch.float32, dev)
    _check("amf", amf, (N, B), torch.float32, dev)
    _check("ams", ams, (N, B), torch.float32, dev)
    _check("first", first, (N,), torch.bool, dev)
    _check("bigram_ends", bigram_ends, (Up, Vp), torch.float32, dev)
    _check("end_src", end_src, (Vp,), torch.int32, dev)
    _check("active", active, (B,), torch.bool, dev)
    if new is None:
        new = torch.empty_like(cost)
    if bits is None:
        bits = torch.empty((Up, N // 8, B), dtype=torch.uint8, device=dev)
    _check("new", new, (Up, N, B), torch.float32, dev)
    _check("bits", bits, (Up, N // 8, B), torch.uint8, dev)
    if new.data_ptr() == cost.data_ptr():
        raise ValueError("new must not alias cost (the step reads the old "
                         "plane while it writes the new one)")
    rootexp = torch.empty((Vp, B), dtype=torch.float32, device=dev)
    rootarg = torch.empty((Vp, B), dtype=torch.int32, device=dev)
    n_chunks = -(-Up // REDUCE_CHUNK)
    pbest = torch.empty((n_chunks, Vp, B), dtype=torch.float32, device=dev)
    parg = torch.empty((n_chunks, Vp, B), dtype=torch.int32, device=dev)
    fn = _bind(_build.load("block_chain_step"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cost.data_ptr(), ovr.data_ptr(), amf.data_ptr(),
                ams.data_ptr(), first.data_ptr(), bigram_ends.data_ptr(),
                end_src.data_ptr(), active.data_ptr(), new.data_ptr(),
                bits.data_ptr(), rootexp.data_ptr(), rootarg.data_ptr(),
                pbest.data_ptr(), parg.data_ptr(), Up, N, B, Vp,
                REDUCE_CHUNK, stream)
    if rc != 0:
        raise RuntimeError(f"block_chain_step kernel launch failed: "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return new, bits, rootexp, rootarg
