"""Block-chain device decoder: exact batched Viterbi for lexicon-shaped
decoding graphs (port of `kaldi_tpu/decoder/block_chain.py`: best-path
mode and lattice mode).

The graph is the direct HCLG of a bigram LM x lexicon x 1-state chain
topology, with pronunciations stored as unshared linear chains bucketed
by length.  States are laid out (context u, chain row n) so that, within
a context block, a row's in-arcs come from itself (self-loop), the
previous row, or the block's root: relaxation is a roll by one and a
min.  Word-end rows of each length bucket sit at a fixed stride, so
the cross-block word transitions into the V roots are a min over
blocks of strided rows.

Per frame, `ops.block_chain_step` (a CUDA kernel on the card) relaxes
the (Up, N, B) cost plane, packs one decision bit per state, and reduces
the word-end candidates; a few tensor ops update the roots.  Every
frame's bits stay on the device, and a device follow pass walks them
backward, so only the (T, B) state trajectory reaches the host.

Lattice mode: per frame, `ops.block_chain_lattice_step` carries each
state's word-entry frame beside its cost and keeps, per word, the J best
(cost, context, entry frame) predecessors.  These per-frame dumps stay on
the device; a device post-pass prunes them to the lattice beam and packs a
survivor bitmask, the host fetches the survivors with a few gathers and
assembles one word lattice per lane.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.graph_direct import FlatGraph, _pdf_hash
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.fstext.fst import Arc, LatticeWeight, VectorFst
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.ops.block_chain_lattice_step import \
    block_chain_lattice_step
from kaldi_tpu_torch.ops.block_chain_step import INF, LN2, block_chain_step


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class BlockChainGraph:
    """Direct HCLG in block-chain layout (numpy copy of the reference's
    BlockChainGraph.build).

    States: chain rows id = u*N + n for u in [0, U), n in [0, N);
    roots id = U*N + u (u < V: word-u root; u = V: sentence begin).
    N is padded to a multiple of 8 with inert rows."""
    prons: List[np.ndarray]          # per word, 1-based phone ids
    bigram: np.ndarray               # (U, V) -log P(w|u), U = V+1
    eos_cost: np.ndarray             # (V,)
    num_pdfs: int
    # derived (set by build):
    word_order: np.ndarray = field(default=None)   # layout index -> word
    N: int = 0                       # padded rows per block
    n_true: int = 0
    row_word: np.ndarray = field(default=None)     # (N,) word (or -1)
    row_pos: np.ndarray = field(default=None)      # (N,) j within chain
    row_phone: np.ndarray = field(default=None)    # (N,) phone (0 pad)
    row_is_first: np.ndarray = field(default=None)  # (N,) bool, j == 0
    end_row: np.ndarray = field(default=None)      # (V,) chain-end row, -1 k=1
    seg_lens: List[Tuple[int, int, int]] = field(default_factory=list)
    pdf_fwd_row: np.ndarray = field(default=None)   # (N,)
    pdf_self_row: np.ndarray = field(default=None)  # (N,)
    pdf_wend_fwd: np.ndarray = field(default=None)  # (V,) word-end fwd pdf
    pdf_root_self: np.ndarray = field(default=None)  # (V,)

    @property
    def V(self) -> int:
        return len(self.prons)

    @property
    def U(self) -> int:
        return self.V + 1

    @property
    def num_states(self) -> int:
        return self.U * self.N + self.U

    @classmethod
    def build(cls, prons: Sequence[np.ndarray], bigram: np.ndarray,
              eos_cost=2.0, num_pdfs: int = 3456) -> "BlockChainGraph":
        V = len(prons)
        if bigram.shape != (V + 1, V):
            raise ValueError(f"bigram shape {bigram.shape}")
        prons = [np.asarray(p, np.int32) for p in prons]
        if any(len(p) < 1 for p in prons):
            raise ValueError("empty pronunciation")
        eos = np.broadcast_to(np.asarray(eos_cost, np.float32), (V,)).copy()
        g = cls(prons=list(prons), bigram=np.asarray(bigram, np.float32),
                eos_cost=eos, num_pdfs=num_pdfs)
        lens = np.array([len(p) for p in prons])
        # layout order: words sorted by pron length (stable)
        order = np.argsort(lens, kind="stable")
        g.word_order = order.astype(np.int32)
        row_word, row_pos, row_phone = [], [], []
        end_row = np.full(V, -1, np.int64)
        seg_lens = []
        off = 0
        for k in sorted(set(lens.tolist())):
            members = order[lens[order] == k]
            if k == 1:
                continue           # no chain rows
            for w in members:
                p = prons[w]
                for j in range(k - 1):
                    row_word.append(w)
                    row_pos.append(j)
                    row_phone.append(int(p[j]))
                end_row[w] = off + (k - 1) - 1
                off += k - 1
            seg_lens.append((k, len(members),
                             off - len(members) * (k - 1)))
        n_true = off
        N = max(8, _round_up(n_true, 8))
        pad = N - n_true
        row_word += [-1] * pad
        row_pos += [0] * pad
        row_phone += [0] * pad
        g.N = N
        g.n_true = n_true
        g.row_word = np.asarray(row_word, np.int32)
        g.row_pos = np.asarray(row_pos, np.int32)
        g.row_phone = np.asarray(row_phone, np.int32)
        g.row_is_first = (g.row_pos == 0) & (g.row_word >= 0)
        g.end_row = end_row
        g.seg_lens = seg_lens
        # forward pdf of row (u, n): phone row_phone[n] entering (w, j),
        # hashed on (phone, word*16+pos) like a context-dependent tree
        ctxkey = g.row_word.astype(np.int64) * 16 + g.row_pos
        g.pdf_fwd_row = _pdf_hash(g.row_phone, ctxkey, num_pdfs, salt=1)
        g.pdf_self_row = _pdf_hash(g.row_phone, ctxkey, num_pdfs, salt=2)
        last_phone = np.array([int(p[-1]) for p in prons], np.int32)
        wkey = np.arange(V, dtype=np.int64) * 16 + 15
        g.pdf_wend_fwd = _pdf_hash(last_phone, wkey, num_pdfs, salt=1)
        g.pdf_root_self = _pdf_hash(last_phone, wkey, num_pdfs, salt=2)
        return g

    # -- tids (forward tid = pdf+1, self-loop tid = num_pdfs+pdf+1) ------
    def fwd_tid(self, pdf: int) -> int:
        return int(pdf) + 1

    def self_tid(self, pdf: int) -> int:
        return self.num_pdfs + int(pdf) + 1

    @property
    def tid2pdf(self) -> np.ndarray:
        return np.concatenate([[0], np.arange(self.num_pdfs),
                               np.arange(self.num_pdfs)]).astype(np.int32)

    def to_flat_graph(self) -> FlatGraph:
        """Equivalent FlatGraph (for host decoders / cross-tests).
        State numbering identical to the device layout."""
        U, N, V = self.U, self.N, self.V
        root0 = U * N
        src, dst, ilab, olab, wgt = [], [], [], [], []

        def add(s, d, tid, ol, w):
            src.append(s)
            dst.append(d)
            ilab.append(tid)
            olab.append(ol)
            wgt.append(w)

        for u in range(U):
            base = u * N
            for n in range(self.n_true):
                j = int(self.row_pos[n])
                s = base + n
                # self-loop
                add(s, s, self.self_tid(self.pdf_self_row[n]), 0, LN2)
                # in-arc (fwd): from previous row or root u
                p = base + n - 1 if j > 0 else root0 + u
                add(p, s, self.fwd_tid(self.pdf_fwd_row[n]), 0, LN2)
            # word transitions into each root w
            for w in range(V):
                e = int(self.end_row[w])
                s = base + e if e >= 0 else root0 + u
                add(s, root0 + w, self.fwd_tid(self.pdf_wend_fwd[w]),
                    w + 1, float(self.bigram[u, w]) + LN2)
        for w in range(V):
            r = root0 + w
            add(r, r, self.self_tid(self.pdf_root_self[w]), 0, LN2)
        S = U * N + U
        finals = np.full(S, INF, np.float32)
        finals[root0:root0 + V] = self.eos_cost
        words = ["<eps>"] + [f"W{w:05d}" for w in range(V)]
        return FlatGraph(np.asarray(src, np.int32), np.asarray(dst, np.int32),
                         np.asarray(ilab, np.int32), np.asarray(olab, np.int32),
                         np.asarray(wgt, np.float32), finals,
                         start=root0 + V, tid2pdf=self.tid2pdf,
                         num_pdfs=self.num_pdfs, words=words)


Hyp = Optional[Tuple[List[int], List[int], float]]
StepFn = Callable[..., Tuple[torch.Tensor, ...]]


class BlockChainDecoder:
    """Batched exact Viterbi over a BlockChainGraph.
    decode_batch(loglikes (B, T, P)) -> per lane (words, tids, cost);
    decode_batch_lattice(...) -> per lane a word Lattice.

    step, lattice_step: the frame steps of the two modes,
    `ops.block_chain_step` and `ops.block_chain_lattice_step` by default
    (the CUDA kernels for CUDA tensors); their `_reference` versions run
    the plain versions on the card, for comparison."""

    def __init__(self, graph: BlockChainGraph, device: DeviceLike = None,
                 step: StepFn = block_chain_step,
                 lattice_step: StepFn = block_chain_lattice_step):
        g = graph
        self.g = g
        self.device = resolve_device(device)
        self.step = step
        self.lattice_step = lattice_step
        dev = self.device
        U, V, N = g.U, g.V, g.N
        self.Vp = _round_up(max(V, 8), 8)
        self.Up = _round_up(U, 8)
        Vp, Up = self.Vp, self.Up
        order = g.word_order
        lens = np.array([len(p) for p in g.prons])
        k1_words = order[lens[order] == 1].astype(np.int32)
        seg_words = [order[lens[order] == k].astype(np.int32)
                     for (k, _vk, _off) in g.seg_lens]
        # word-end order: one-phone words, then each length segment
        ends_words = np.concatenate([k1_words] + seg_words)
        assert len(ends_words) == V
        word_to_endpos = np.empty(V, np.int64)
        word_to_endpos[ends_words] = np.arange(V)
        # where each word-end candidate is read: -1 the block's root
        # (one-phone word), the chain-end row of its segment, -2 pad
        end_src = np.full(Vp, -2, np.int32)
        end_src[:len(k1_words)] = -1
        pos = len(k1_words)
        for (_k, vk, off) in g.seg_lens:
            km1 = _k - 1
            end_src[pos:pos + vk] = off + np.arange(vk) * km1 + km1 - 1
            pos += vk
        bigp = np.full((Up, Vp), INF, np.float32)
        bigp[:U, :V] = (g.bigram + LN2)[:, ends_words]
        eosp = np.full(Vp, INF, np.float32)
        eosp[:V] = g.eos_cost

        def tens(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        i64 = torch.int64
        self._first = tens(g.row_is_first, torch.bool)
        self._bigram_ends = tens(bigp, torch.float32)
        self._end_src = tens(end_src, torch.int32)
        self._word_to_endpos = tens(word_to_endpos, i64)
        self._pdf_fwd_row = tens(g.pdf_fwd_row, i64)
        self._pdf_self_row = tens(g.pdf_self_row, i64)
        self._pdf_wend_ends = tens(np.pad(g.pdf_wend_fwd[ends_words],
                                          (0, Vp - V)), i64)
        self._pdf_root_self = tens(g.pdf_root_self, i64)
        self._pdf_root_self_pad = tens(np.pad(g.pdf_root_self, (0, Vp - V)),
                                       i64)
        self._eos = tens(eosp, torch.float32)
        # follow-pass tables
        self._end_row = tens(g.end_row, i64)
        self._k1_mask = tens(g.end_row < 0, torch.bool)

    # ------------------------------------------------------------------
    def _forward(self, am: torch.Tensor, active: torch.Tensor,
                 carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """am (T, P, B) f32, active (T, B) bool, carry: the (cost (Up, N,
        B), roots (Up, B)) to resume from, or None for a fresh start at
        the begin root; the frame loop writes into the carried cost plane
        -> ((cost, roots) after the last frame, (bits (T, Up, N/8, B) u8,
        root argmin contexts (T, V, B), root self-loop flags (T, V, B)))."""
        g = self.g
        V, N, Up = g.V, g.N, self.Up
        T, _, B = am.shape
        dev = self.device
        if carry is None:
            cur = torch.full((Up, N, B), INF, dtype=torch.float32,
                             device=dev)
            ovr = torch.full((Up, B), INF, dtype=torch.float32, device=dev)
            ovr[V] = 0.0                                # begin root
        else:
            cur, ovr = carry
        nxt = torch.empty_like(cur)
        bits = torch.empty((T, Up, N // 8, B), dtype=torch.uint8,
                           device=dev)
        args = torch.empty((T, V, B), dtype=torch.int32, device=dev)
        selfs = torch.empty((T, V, B), dtype=torch.bool, device=dev)
        ovr_pad = torch.full((Up - V, B), INF, dtype=torch.float32,
                             device=dev)
        for t in range(T):
            am_t = am[t]
            act = active[t]
            amf = am_t.index_select(0, self._pdf_fwd_row)
            ams = am_t.index_select(0, self._pdf_self_row)
            _, _, rootexp, rootarg = self.step(
                cur, ovr, amf, ams, self._first, self._bigram_ends,
                self._end_src, act, new=nxt, bits=bits[t])
            # root update, word-end order -> word order
            exp_cand = rootexp + am_t.index_select(0, self._pdf_wend_ends) \
                + 0.0
            exp_w = exp_cand.index_select(0, self._word_to_endpos)
            args[t] = rootarg.index_select(0, self._word_to_endpos)
            self_c = ovr[:V] + LN2 + am_t.index_select(0, self._pdf_root_self)
            take_self = self_c <= exp_w
            selfs[t] = take_self
            root_new = torch.cat(
                [torch.where(take_self, self_c, exp_w), ovr_pad], dim=0)
            ovr = torch.where(act[None, :], root_new, ovr)   # lane freeze
            cur, nxt = nxt, cur
        return (cur, ovr), (bits, args, selfs)

    def _follow(self, bits, args, selfs, active, final_state):
        """Walk the decisions backward: -> (state before frame 0 (B,),
        states (T, B), the state after consuming each frame)."""
        g = self.g
        U, V, N = g.U, g.V, g.N
        root0 = U * N
        T, _, _, B = bits.shape
        lane = torch.arange(B, device=self.device)
        states = torch.empty((T, B), dtype=torch.int64, device=self.device)
        cur = final_state
        for t in range(T - 1, -1, -1):
            states[t] = cur
            is_root = cur >= root0
            # chain-row predecessor
            u_c = torch.clamp(cur // N, 0, U - 1)
            n_c = torch.clamp(cur % N, 0, N - 1)
            byte = bits[t, u_c, n_c >> 3, lane].to(torch.int64)
            bit = (byte >> (n_c & 7)) & 1
            chain_prev = torch.where(
                bit == 1,
                torch.where(self._first[n_c], root0 + u_c, cur - 1),
                cur)
            # root predecessor
            w_r = torch.clamp(cur - root0, 0, V - 1)
            u_win = args[t, w_r, lane].to(torch.int64)
            is_begin = cur == root0 + V
            root_prev = torch.where(
                selfs[t, w_r, lane] | is_begin,
                cur,
                torch.where(self._k1_mask[w_r], root0 + u_win,
                            u_win * N + self._end_row[w_r]))
            prev = torch.where(is_root, root_prev, chain_prev)
            cur = torch.where(active[t], prev, cur)
        return cur, states

    # ------------------------------------------------------------------
    def decode_batch(self, loglikes, acoustic_scale: float = 1.0,
                     lengths: Optional[Sequence[int]] = None
                     ) -> List[Hyp]:
        """loglikes (B, T, P): a tensor (moved to this decoder's device)
        or a numpy array; lengths (B,) valid frames.  -> per lane
        (word ids, tids, cost), or None when no path survives."""
        g = self.g
        U, V, N = g.U, g.V, g.N
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, P = ll.shape
        if P < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {P} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            (_, ovr), (bits, args, selfs) = self._forward(am, active)
            # best final root per lane
            total = ovr[:V] + self._eos[:V, None]
            best_w = torch.argmin(total, dim=0)
            best_cost = torch.amin(total, dim=0)
            final_state = U * N + best_w
            first_state, states = self._follow(bits, args, selfs, active,
                                               final_state)
            states = states.cpu().numpy()                # (T, B)
            first_state = first_state.cpu().numpy()
            best_cost = best_cost.cpu().numpy()
        return self._traceback(states, first_state, best_cost, lengths)

    def _traceback(self, states, first_state, best_cost, lengths
                   ) -> List[Hyp]:
        g = self.g
        U, V, N = g.U, g.V, g.N
        root0 = U * N
        out: List[Hyp] = []
        for b in range(len(lengths)):
            Tb = int(lengths[b])
            if best_cost[b] >= INF / 2:
                out.append(None)
                continue
            # states[t, b] = state after consuming frame t; first_state is
            # the state before frame 0 (must be the begin root)
            traj = [int(first_state[b])] + \
                [int(states[t, b]) for t in range(Tb)]
            if traj[0] != root0 + V:
                out.append(None)
                continue
            words: List[int] = []
            tids: List[int] = []
            for t in range(1, Tb + 1):
                prev, cur = traj[t - 1], traj[t]
                if cur >= root0:                       # at a root
                    w = cur - root0
                    if prev == cur:                    # root self-loop
                        tids.append(g.self_tid(g.pdf_root_self[w]))
                    else:                              # word-final arc
                        tids.append(g.fwd_tid(g.pdf_wend_fwd[w]))
                        words.append(w + 1)
                else:
                    n = cur % N
                    if prev == cur:
                        tids.append(g.self_tid(g.pdf_self_row[n]))
                    else:
                        tids.append(g.fwd_tid(g.pdf_fwd_row[n]))
            out.append((words, tids, float(best_cost[b])))
        return out

    def decode(self, loglikes, acoustic_scale: float = 1.0) -> Hyp:
        return self.decode_batch(loglikes[None], acoustic_scale)[0]

    # -- lattice mode ----------------------------------------------------
    def _forward_lattice(self, am: torch.Tensor, active: torch.Tensor,
                         J: int):
        """am (T, P, B) f32, active (T, B) bool -> the per-frame dumps,
        all on the device: exp_w, arg_w, ent_w (T, J, V, B) f32 (per word
        the J best predecessors' cost, context block and entry frame),
        ovr_all (T, Up, B) (root costs after each frame) and am_rs
        (T, Vp, B) (root self-loop acoustic costs)."""
        g = self.g
        V, N, Up, Vp = g.V, g.N, self.Up, self.Vp
        T, _, B = am.shape
        dev = self.device

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        cur = torch.full((Up, N, B), INF, dtype=torch.float32, device=dev)
        cur_e = torch.zeros_like(cur)
        nxt, nxt_e = torch.empty_like(cur), torch.empty_like(cur)
        ovr = torch.full((Up, B), INF, dtype=torch.float32, device=dev)
        ovr[V] = 0.0                                    # begin root
        exp_w, arg_w, ent_w = f32(T, J, V, B), f32(T, J, V, B), \
            f32(T, J, V, B)
        ovr_all, am_rs_all = f32(T, Up, B), f32(T, Vp, B)
        ovr_pad = torch.full((Up - V, B), INF, dtype=torch.float32,
                             device=dev)
        for t in range(T):
            am_t = am[t]
            act = active[t]
            amf = am_t.index_select(0, self._pdf_fwd_row)
            ams = am_t.index_select(0, self._pdf_self_row)
            am_rs = torch.index_select(am_t, 0, self._pdf_root_self_pad,
                                       out=am_rs_all[t])
            _, _, rc, ru, re = self.lattice_step(
                t, cur, cur_e, ovr, amf, ams, self._first,
                self._bigram_ends, self._end_src, act, J=J, new=nxt,
                ent_new=nxt_e)
            # word-end order -> word order
            exp_all = rc + am_t.index_select(0, self._pdf_wend_ends)[None]
            torch.index_select(exp_all, 1, self._word_to_endpos,
                               out=exp_w[t])
            torch.index_select(ru, 1, self._word_to_endpos, out=arg_w[t])
            torch.index_select(re, 1, self._word_to_endpos, out=ent_w[t])
            best = exp_w[t, 0]
            self_c = ovr[:V] + LN2 + am_rs[:V]
            take_self = self_c <= best
            root_new = torch.cat(
                [torch.where(take_self, self_c, best), ovr_pad], dim=0)
            ovr = torch.where(act[None, :], root_new, ovr)   # lane freeze
            ovr_all[t] = ovr
            cur, nxt = nxt, cur
            cur_e, nxt_e = nxt_e, cur_e
        return exp_w, arg_w, ent_w, ovr_all, am_rs_all

    def _lat_post(self, exp_w, alpha, am_rs, lengths, beam: float):
        """Device-side pruning and packing after the lattice forward:
        only a survivor bitmask and small per-frame reductions cross to
        the host; survivor payloads are fetched afterwards with targeted
        gathers.  exp_w (T, J, V, B), alpha (T, Up, B), am_rs (T, Vp, B),
        lengths (B,) i64 -> bits (T, J*Vp/8, B) u8 (little-endian bit
        order), a_best (T, B), alpha_fin (Up, B), am_cs (T, Vp, B)."""
        V, Vp = self.g.V, self.Vp
        T, J, _, B = exp_w.shape
        a_best = torch.amin(alpha[:, :V, :], dim=1)          # (T, B)
        keep = exp_w <= (a_best[:, None, None, :] + beam)
        keepp = torch.nn.functional.pad(keep, (0, 0, 0, Vp - V))
        flat = keepp.reshape(T, (J * Vp) // 8, 8, B).to(torch.int32)
        w8 = (1 << torch.arange(8, dtype=torch.int32,
                                device=exp_w.device))[None, None, :, None]
        bits = (flat * w8).sum(dim=2).to(torch.uint8)
        idx = torch.clamp(lengths - 1, min=0)
        alpha_fin = alpha[idx, :, torch.arange(B, device=alpha.device)].T
        am_cs = torch.cumsum(am_rs, dim=0)                   # (T, Vp, B)
        return bits, a_best, alpha_fin, am_cs

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _gather3(self, exp_w, arg_w, ent_w, ovr_all, t, j, w, b):
        """Fetch survivor payloads exp/arg/ent at (t, j, w, b) and the
        source alpha ovr[ent-1, arg, b]; the chained dependency stays on
        the device."""
        ti, ji, wi, bi = (self._index(x) for x in (t, j, w, b))
        ev = exp_w[ti, ji, wi, bi]
        av = arg_w[ti, ji, wi, bi]
        env = ent_w[ti, ji, wi, bi]
        te = env.to(torch.int64)
        u = torch.clamp(av.to(torch.int64), 0, self.Up - 1)
        src = ovr_all[torch.clamp(te - 1, min=0), u, bi]
        src = torch.where(te >= 1, src, 0.0)
        return tuple(x.cpu().numpy() for x in (ev, av, env, src))

    def _gather2(self, arr, i0, i1, b) -> np.ndarray:
        """Fetch arr[i0, i1, b] (alpha sources / am cumsums)."""
        return arr[self._index(i0), self._index(i1),
                   self._index(b)].cpu().numpy()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_batch_lattice(self, loglikes, acoustic_scale: float = 1.0,
                             lengths: Optional[Sequence[int]] = None,
                             lattice_beam: float = 8.0, J: int = 4,
                             stats: Optional[Dict[str, float]] = None
                             ) -> List[Optional[VectorFst]]:
        """Full-lattice decode: returns per lane a word Lattice
        (ilabel=tid, olabel=word, weights (graph, acoustic)) pruned to
        `lattice_beam`, or None.  Word alternatives carry exact costs
        and exact (graph, acoustic) splits; within-word alignments of
        non-best paths distribute self-loop frames on the last chain
        row.

        The dense per-frame dumps stay on the device; the host receives
        a survivor bitmask (T*J*Vp/8 bytes per lane) plus per-survivor
        gathers.  stats, when given, receives the seconds of each stage
        (fwd_s, post_s, unpack_s, gather_s, selfseg_s, assemble_s) and
        n_survivors."""
        g = self.g
        U, V = g.U, g.V
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, P = ll.shape
        if P < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {P} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        _t0 = time.perf_counter()
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            exp_w, arg_w, ent_w, ovr_all, am_rs = self._forward_lattice(
                am, active, J)
            self._sync()
            if stats is not None:
                stats["fwd_s"] = time.perf_counter() - _t0
            _t0 = time.perf_counter()
            bits_d, a_best_d, alpha_fin_d, am_cs_d = self._lat_post(
                exp_w, ovr_all, am_rs, self._index(lengths), lattice_beam)
            bits = bits_d.cpu().numpy()          # (T, J*Vp/8, B) uint8
            alpha_fin = alpha_fin_d.cpu().numpy()  # (Up, B)
        if stats is not None:
            stats["post_s"] = time.perf_counter() - _t0
        _t0 = time.perf_counter()
        # unpack survivor indices (all lanes at once)
        u8 = np.unpackbits(bits.transpose(2, 0, 1).reshape(B, T, -1),
                           axis=2, bitorder="little")
        u8 = u8.reshape(B, T, J, self.Vp)[:, :, :, :V]
        bs, ts, js, ws = np.nonzero(u8)
        # filter t >= lengths[b]
        m = ts < lengths[bs]
        bs, ts, js, ws = bs[m], ts[m], js[m], ws[m]
        if stats is not None:
            stats["unpack_s"] = time.perf_counter() - _t0
            stats["n_survivors"] = len(ts)
        _t0 = time.perf_counter()
        with torch.inference_mode():
            cvals, uvals, tevals, a_src = self._gather3(
                exp_w, arg_w, ent_w, ovr_all, ts, js, ws, bs)
        uvals = np.rint(uvals).astype(np.int64)
        tevals = np.rint(tevals).astype(np.int64)
        # vectorized validity filter
        begin = tevals == 0
        valid = np.isfinite(cvals) & (cvals < INF / 2)
        valid &= np.where(begin, uvals == U - 1, uvals < U - 1)
        valid &= begin | (np.isfinite(a_src) & (a_src < INF / 2))
        bs, ts, ws = bs[valid], ts[valid], ws[valid]
        cvals, uvals, tevals = cvals[valid], uvals[valid], tevals[valid]
        a_src, begin = a_src[valid], begin[valid]
        arc_cost = (cvals - a_src).astype(np.float64)

        # node table per lane: (w, t) word-end nodes, encoded w*T + t
        dst_key = ws * T + ts
        src_key = np.where(begin, -1, uvals * T + (tevals - 1))
        lane_nodes: List[np.ndarray] = []
        lane_info = []
        for b in range(B):
            sel = np.nonzero(bs == b)[0]
            keys = np.unique(np.concatenate(
                [dst_key[sel], src_key[sel][~begin[sel]]]))
            lane_nodes.append(keys)
            lane_info.append(sel)
        # batched node-alpha gather: alpha[t, w, b] for every node
        all_keys = np.concatenate(lane_nodes)
        all_nb = np.concatenate([np.full(len(k), b, np.int64)
                                 for b, k in enumerate(lane_nodes)])
        with torch.inference_mode():
            node_alpha_all = self._gather2(ovr_all, all_keys % T,
                                           all_keys // T, all_nb)
        if stats is not None:
            stats["gather_s"] = time.perf_counter() - _t0
        _t0 = time.perf_counter()
        # batched am-cumsum gather for per-word consecutive self spans
        self_src_l, self_dst_l, self_b, self_t0, self_t1, self_w = \
            [], [], [], [], [], []
        off = 0
        node_off = []
        for b in range(B):
            node_off.append(off)
            keys = lane_nodes[b]
            kw, kt = keys // T, keys % T
            # consecutive node times within each word: keys are sorted
            # by (w, t) already (encoded w*T + t)
            if len(keys) > 1:
                same_w = kw[1:] == kw[:-1]
                idx = np.nonzero(same_w)[0]
                self_src_l.append(idx + off)
                self_dst_l.append(idx + 1 + off)
                self_b.append(np.full(len(idx), b, np.int64))
                self_t0.append(kt[idx])
                self_t1.append(kt[idx + 1])
                self_w.append(kw[idx])
            off += len(keys)
        if self_b:
            s_src = np.concatenate(self_src_l)
            s_dst = np.concatenate(self_dst_l)
            s_b = np.concatenate(self_b)
            s_t0 = np.concatenate(self_t0)
            s_t1 = np.concatenate(self_t1)
            s_w = np.concatenate(self_w)
            with torch.inference_mode():
                hi = self._gather2(am_cs_d, s_t1, s_w, s_b)
                lo = self._gather2(am_cs_d, s_t0, s_w, s_b)
            s_ac = (hi - lo).astype(np.float64)
        else:
            s_src = s_dst = s_b = s_t0 = s_t1 = s_w = \
                np.zeros(0, np.int64)
            s_ac = np.zeros(0)
        if stats is not None:
            stats["selfseg_s"] = time.perf_counter() - _t0
        _t0 = time.perf_counter()
        lats: List[Optional[VectorFst]] = []
        for b in range(B):
            sel = lane_info[b]
            keys = lane_nodes[b]
            n0 = node_off[b]
            ssel = np.nonzero(s_b == b)[0]
            lats.append(self._assemble_lane_pruned(
                int(lengths[b]), T, keys,
                node_alpha_all[n0:n0 + len(keys)],
                ts[sel], ws[sel], uvals[sel], tevals[sel],
                cvals[sel], a_src[sel], arc_cost[sel], begin[sel],
                s_src[ssel] - n0, s_dst[ssel] - n0, s_t0[ssel],
                s_t1[ssel], s_w[ssel], s_ac[ssel],
                alpha_fin[:, b], lattice_beam))
        if stats is not None:
            stats["assemble_s"] = time.perf_counter() - _t0
        return lats

    def _assemble_lane_pruned(self, Tb, T, node_keys, node_alpha,
                              ts, ws, uvals, tevals, cvals, a_src,
                              arc_cost, begin, ss, sd, st0, st1, sw,
                              s_ac, alpha_fin, beam):
        """Host lattice assembly for one lane with exact alpha+beta
        lattice-beam pruning on the word-level survivor graph before
        any FST objects are built."""
        g = self.g
        V = g.V
        if Tb == 0 or len(node_keys) == 0:
            return None
        fin = alpha_fin[:V] + g.eos_cost
        best = float(fin.min())
        if not np.isfinite(best) or best >= INF / 2:
            return None
        cutoff = best + beam + 1e-4
        n = len(node_keys)
        node_w = node_keys // T
        node_t = node_keys % T
        # word-arc endpoints as node indices
        dst_i = np.searchsorted(node_keys, ws * T + ts)
        src_i = np.where(begin, -1,
                         np.searchsorted(node_keys,
                                         np.where(begin, 0, uvals) * T
                                         + (tevals - 1)))
        # ---- beta (backward best completion) over the node graph ----
        beta = np.full(n, np.inf)
        last = node_t == Tb - 1
        beta[last] = g.eos_cost[node_w[last]]
        self_cost = (st1 - st0) * LN2 + s_ac
        # group arcs by source frame, process frames descending
        a_src_t = np.where(begin, -1, tevals - 1)
        for f in range(Tb - 2, -1, -1):
            wa = np.nonzero(a_src_t == f)[0]
            if len(wa):
                cand = arc_cost[wa] + beta[dst_i[wa]]
                np.minimum.at(beta, src_i[wa], cand)
            sa = np.nonzero(st0 == f)[0]
            if len(sa):
                cand = self_cost[sa] + beta[sd[sa]]
                np.minimum.at(beta, ss[sa], cand)
        # ---- prune ----
        na = node_alpha.astype(np.float64)
        keep_node = na + beta <= cutoff
        keep_arc = np.where(
            begin, arc_cost + beta[dst_i] <= cutoff,
            a_src.astype(np.float64) + arc_cost + beta[dst_i] <= cutoff)
        keep_arc &= keep_node[dst_i]
        if not keep_arc.any():
            return None
        # ---- build ----
        lat = VectorFst(LatticeWeight)
        nodes: Dict[int, int] = {}

        def node_state(i):
            s = nodes.get(i)
            if s is None:
                s = lat.add_state()
                nodes[i] = s
            return s

        start = lat.add_state()
        lat.set_start(start)
        prons = g.prons
        raw_big = g.bigram
        for i in np.nonzero(keep_arc)[0]:
            t, w = int(ts[i]), int(ws[i])
            u = int(uvals[i])
            te = int(tevals[i])
            c = float(cvals[i])
            src = start if begin[i] else node_state(int(src_i[i]))
            dur = t - te + 1
            graph = float(raw_big[u, w]) + dur * LN2
            acoustic = c - float(a_src[i]) - graph
            dst = node_state(int(dst_i[i]))
            k = len(prons[w])
            tids = []
            e = int(g.end_row[w])
            if e >= 0:
                first_row = e - (k - 2)
                tids = [g.fwd_tid(g.pdf_fwd_row[r])
                        for r in range(first_row, e + 1)]
                tids += [g.self_tid(g.pdf_self_row[e])] * (dur - k)
            tids.append(g.fwd_tid(g.pdf_wend_fwd[w]))
            cur = src
            for q, tid in enumerate(tids):
                lastq = q == len(tids) - 1
                nxt = dst if lastq else lat.add_state()
                wgt = (graph, acoustic) if q == 0 else (0.0, 0.0)
                lat.add_arc(cur, Arc(tid, (w + 1) if q == 0 else 0,
                                     wgt, nxt))
                cur = nxt
        # self-extension arcs re-linked across pruned-away nodes:
        # within a word, connect consecutive KEPT nodes; span costs are
        # partial sums of the consecutive raw segments
        kept_set = set(int(i) for i in nodes)
        for w in np.unique(sw):
            seg_sel = np.nonzero(sw == w)[0]
            if not len(seg_sel):
                continue
            # chain of nodes for this word, in time order
            first = int(ss[seg_sel[0]])
            prev_kept = first if first in kept_set else None
            prev_t = int(node_t[first])
            run_ac = 0.0
            for i in seg_sel:
                nxt_node = int(sd[i])
                run_ac += float(s_ac[i])
                if nxt_node in kept_set:
                    if prev_kept is not None:
                        t0, t1 = prev_t, int(node_t[nxt_node])
                        gcost = (t1 - t0) * LN2
                        tid = g.self_tid(g.pdf_root_self[int(w)])
                        cur = nodes[prev_kept]
                        dsts = nodes[nxt_node]
                        for tt in range(t0 + 1, t1 + 1):
                            lastq = tt == t1
                            nxt2 = dsts if lastq else lat.add_state()
                            wgt = (gcost, run_ac) if tt == t0 + 1 \
                                else (0.0, 0.0)
                            lat.add_arc(cur, Arc(tid, 0, wgt, nxt2))
                            cur = nxt2
                    prev_kept = nxt_node
                    prev_t = int(node_t[nxt_node])
                    run_ac = 0.0
        # finals
        for i, s in nodes.items():
            if int(node_t[i]) == Tb - 1:
                lat.set_final(s, (float(g.eos_cost[int(node_w[i])]),
                                  0.0))
        connect(lat)
        if lat.num_states == 0 or lat.start is None:
            return None
        return lat
