"""Lattice-mode Viterbi frame step over the block-chain layout: the CUDA
kernel `csrc/block_chain_lattice_step.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel of `kaldi_tpu/decoder/block_chain.py`,
`BlockChainDecoder._make_lattice_step` (body :480-545, pallas_call
:547-579).  It is the relaxation of `ops.block_chain_step` without the
decision bits, carrying a word-entry-frame plane through the roll and the
select, and it keeps per word-end slot a sorted list of the J best
(cost, context block, entry frame) predecessors over all blocks.  The
step is bound by memory traffic: two (Up, N, B) float32 planes read and
two written.

Inputs (all on one device, contiguous):
  t            int              frame index (the entry frame of a word
                                entered in this frame)
  cost, ent    (Up, N, B) f32   old cost and entry-frame planes, N a
                                multiple of 8
  ovr          (Up, B)    f32   root costs per context block
  amf, ams     (N, B)     f32   forward / self-loop acoustic costs
  first        (N,)       bool  rows that enter from the block's root
  bigram_ends  (Up, Vp)   f32   LN2 + bigram cost, in word-end order
  end_src      (Vp,)      i32   word-end source: chain row >= 0, -1 the
                                root (one-phone word), -2 a pad slot
  active       (B,)       bool  lanes still consuming frames
Outputs: new cost and entry planes (Up, N, B) f32 (inactive lanes keep
their old columns), and rc, ru, re (J, Vp, B) f32: per word-end slot the
J best candidates' cost, block and entry frame, by ascending cost;
(INF, 0, 0) where fewer than J candidates beat INF.

The list is built as the TPU kernel builds it: the blocks' candidates are
inserted in ascending block order; a candidate moves in at the first slot
it beats with strict <, and the entry it displaces goes on down the list
under the same rule.  A displaced entry passes entries of equal cost, so
among equal costs the outcome depends on the order of insertion, and both
versions here keep that order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from kaldi_tpu_torch.ops import _build
from kaldi_tpu_torch.ops.block_chain_step import INF, LN2, _check

# calls that launched the CUDA kernel (not the plain version)
launches = 0
# the largest J the CUDA build holds (the lists live in registers)
MAX_J = 8

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def block_chain_lattice_step_reference(
        t: int, cost, ent, ovr, amf, ams, first, bigram_ends, end_src,
        active, J: int = 4, new: Optional[torch.Tensor] = None,
        ent_new: Optional[torch.Tensor] = None) -> Outputs:
    """Plain PyTorch version of the step, on any device.  Writes into
    `new` / `ent_new` when given."""
    Up, N, B = cost.shape
    Vp = bigram_ends.shape[-1]
    tf = float(t)
    is_first = first[None, :, None]
    fwd_src = torch.where(is_first, ovr[:, None, :],
                          torch.roll(cost, 1, dims=1))
    fwd_ent = torch.where(is_first, tf, torch.roll(ent, 1, dims=1))
    fwd_cand = fwd_src + (LN2 + amf)
    self_cand = cost + (LN2 + ams)
    take_fwd = fwd_cand < self_cand
    on = active[None, None, :]
    relaxed = torch.where(on, torch.where(take_fwd, fwd_cand, self_cand),
                          cost)
    entered = torch.where(on, torch.where(take_fwd, fwd_ent, ent), ent)
    # word-end candidates out of every block of the OLD planes
    rows = end_src.clamp(min=0).to(torch.int64)
    one_phone = (end_src == -1)[None, :, None]
    pad = (end_src == -2)[None, :, None]
    src = torch.where(one_phone, ovr[:, None, :], cost.index_select(1, rows))
    cand = torch.where(pad, INF, src) + bigram_ends[:, :, None]  # (Up,Vp,B)
    cand_e = torch.where(one_phone, tf, ent.index_select(1, rows))
    cand_e = torch.where(pad, 0.0, cand_e)
    # insert block after block into the J sorted planes
    rc = [torch.full((Vp, B), INF, dtype=torch.float32, device=cost.device)
          for _ in range(J)]
    ru = [torch.zeros_like(rc[0]) for _ in range(J)]
    re = [torch.zeros_like(rc[0]) for _ in range(J)]
    for u in range(Up):
        xc, xe = cand[u], cand_e[u]
        xu = torch.full_like(xc, float(u))
        for j in range(J):
            better = xc < rc[j]
            rc[j], xc = (torch.where(better, xc, rc[j]),
                         torch.where(better, rc[j], xc))
            ru[j], xu = (torch.where(better, xu, ru[j]),
                         torch.where(better, ru[j], xu))
            re[j], xe = (torch.where(better, xe, re[j]),
                         torch.where(better, re[j], xe))
    if new is not None:
        new.copy_(relaxed)
        relaxed = new
    if ent_new is not None:
        ent_new.copy_(entered)
        entered = ent_new
    return (relaxed, entered, torch.stack(rc), torch.stack(ru),
            torch.stack(re))


def _bind(lib: ctypes.CDLL):
    fn = lib.block_chain_lattice_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def block_chain_lattice_step(
        t: int, cost, ent, ovr, amf, ams, first, bigram_ends, end_src,
        active, J: int = 4, new: Optional[torch.Tensor] = None,
        ent_new: Optional[torch.Tensor] = None) -> Outputs:
    """One frame of the lattice-mode block-chain Viterbi.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    planes = [cost, ent] + [p for p in (new, ent_new) if p is not None]
    if len({p.data_ptr() for p in planes}) != len(planes):
        raise ValueError("new and ent_new must not alias cost, ent or each "
                         "other (the step reads the old planes while it "
                         "writes the new ones)")
    if cost.device.type == "cpu":
        return block_chain_lattice_step_reference(
            t, cost, ent, ovr, amf, ams, first, bigram_ends, end_src, active,
            J, new, ent_new)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    dev = cost.device
    if cost.dim() != 3:
        raise ValueError("cost must be (Up, N, B)")
    Up, N, B = cost.shape
    if N % 8:
        raise ValueError(f"N={N} must be a multiple of 8")
    if not 1 <= J <= MAX_J:
        raise ValueError(f"J={J}: the CUDA build holds J in 1..{MAX_J}")
    Vp = bigram_ends.shape[-1]
    _check("cost", cost, (Up, N, B), torch.float32, dev)
    _check("ent", ent, (Up, N, B), torch.float32, dev)
    _check("ovr", ovr, (Up, B), torch.float32, dev)
    _check("amf", amf, (N, B), torch.float32, dev)
    _check("ams", ams, (N, B), torch.float32, dev)
    _check("first", first, (N,), torch.bool, dev)
    _check("bigram_ends", bigram_ends, (Up, Vp), torch.float32, dev)
    _check("end_src", end_src, (Vp,), torch.int32, dev)
    _check("active", active, (B,), torch.bool, dev)
    if new is None:
        new = torch.empty_like(cost)
    if ent_new is None:
        ent_new = torch.empty_like(ent)
    _check("new", new, (Up, N, B), torch.float32, dev)
    _check("ent_new", ent_new, (Up, N, B), torch.float32, dev)
    rc = torch.empty((J, Vp, B), dtype=torch.float32, device=dev)
    ru = torch.empty_like(rc)
    re = torch.empty_like(rc)
    fn = _bind(_build.load("block_chain_lattice_step"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_code = fn(int(t), cost.data_ptr(), ent.data_ptr(), ovr.data_ptr(),
                     amf.data_ptr(), ams.data_ptr(), first.data_ptr(),
                     bigram_ends.data_ptr(), end_src.data_ptr(),
                     active.data_ptr(), new.data_ptr(), ent_new.data_ptr(),
                     rc.data_ptr(), ru.data_ptr(), re.data_ptr(), Up, N, B,
                     Vp, J, stream)
    if rc_code != 0:
        raise RuntimeError(f"block_chain_lattice_step kernel launch failed: "
                           f"CUDA error {rc_code}")
    global launches
    launches += 1
    return new, ent_new, rc, ru, re
