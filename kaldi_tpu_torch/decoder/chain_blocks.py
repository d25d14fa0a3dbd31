"""The frame blocks that the two entry-LM chain decoders share
(`decoder/lexchain.py` LexChainDecoder, `decoder/lexchain_ng.py`
NgramLexDecoder): both lay a graph out as chain rows (a pronunciation's
phones but the last), roots ("in the last phone", one a pronunciation or
a unit, plus the sentence-begin root as the last row) and optional
silence shadows, and differ only in how a word's entry cost is computed.

A subclass sets, as (rows, 1) or (rows,) tensors on its device:
`_pdf_fwd_row`, `_pdf_self_row`, `_fwd_extra`, `_self_extra` (the rows'
transition costs, BIG on pad rows), `_first_rows` and `_first_units`
(each first row and the row of the entry plane it is entered from),
`_end_row`, `_end_is_row`, `_pdf_end`, `_tr_end`, `_pdf_root_self`,
`_tr_root_self` and `_bit_weights`; and `g`, a graph with the silence
fields.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.graph_direct import INF


class ChainBlocks:
    """Shared helpers of the chain decoders' frame and follow pass."""

    device: torch.device

    @staticmethod
    def _select(vm: torch.Tensor, K: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each lane's K smallest of vm (VC, B), in the reference's
        `top_k` order: ascending value, ties by lower row.  The f32
        value's bits, made order-preserving as an int32, and the row
        form one int64 key, so the selection has no ties.
        -> (rows (B, K) int64, values (B, K) f32)."""
        v = vm.T.contiguous()
        bits = v.view(torch.int32)
        key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
        rows = torch.arange(v.shape[1], device=v.device)
        keys = torch.topk((key << 32) | rows, K, dim=1, largest=False,
                          sorted=True).values
        ids = keys & 0xFFFFFFFF
        return ids, v.gather(1, ids)

    def _pack_bits(self, dec: torch.Tensor, npad: int) -> torch.Tensor:
        """dec (n, B) bool -> (npad, B) uint8, bit i of byte j = row
        8j + i."""
        n, B = dec.shape
        d = torch.zeros((npad * 8, B), dtype=torch.uint8, device=dec.device)
        d[:n] = dec
        return (d.view(npad, 8, B) * self._bit_weights).sum(
            dim=1, dtype=torch.uint8)

    def _relax_rows(self, cost, am_t, ent_unit):
        """The row relaxation: roll(1) with the word-entry overwrite of
        first rows, min against the self-loop.  -> (new cost (rows, B),
        take_fwd (rows, B) bool)."""
        amf = am_t.index_select(0, self._pdf_fwd_row) + self._fwd_extra
        ams = am_t.index_select(0, self._pdf_self_row) + self._self_extra
        fwd_src = torch.roll(cost, 1, 0)
        fwd_src[self._first_rows] = ent_unit.index_select(
            0, self._first_units)
        fwd_cand = fwd_src + amf
        self_cand = cost + ams
        take_fwd = fwd_cand < self_cand
        return torch.where(take_fwd, fwd_cand, self_cand), take_fwd

    def _relax_roots(self, cost, roots, am_t, ent_root):
        """Roots: the word-end arc (from the last row, or from the entry
        plane ent_root (roots - 1, B) where the pronunciation has one
        phone) against the root's self-loop; the begin root (the last)
        goes to INF.  -> (roots, end_cand and take_end (roots - 1, B))."""
        am_end = am_t.index_select(0, self._pdf_end) + self._tr_end
        end_src = torch.where(self._end_is_row[:, None],
                              cost.index_select(0, self._end_row), ent_root)
        end_cand = end_src + am_end
        self_r = roots[:-1] + am_t.index_select(0, self._pdf_root_self) \
            + self._tr_root_self
        take_end = end_cand < self_r
        roots_new = torch.cat([torch.where(take_end, end_cand, self_r),
                               roots.new_full((1, roots.shape[1]),
                                              float(INF))], 0)
        return roots_new, end_cand, take_end

    def _relax_sil(self, roots, sil, am_t):
        """Silence shadows (use_sil): entered from their roots or held.
        -> (shadows, sil_take bool), both shaped as roots."""
        g = self.g
        # the reference's `roots + sil_cost + sil_tr_fwd + am`: XLA folds
        # the two scalars into one float32 constant first, so the same sum
        # here gives its shadows bit for bit
        enter = float(np.float32(g.sil_cost) + np.float32(g.sil_tr_fwd))
        sil_in = roots + enter + am_t[g.sil_pdf_fwd][None, :]
        sil_self = sil + g.sil_tr_self + am_t[g.sil_pdf_self][None, :]
        sil_take = sil_in < sil_self
        return torch.where(sil_take, sil_in, sil_self), sil_take

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
