"""Block-chain device decoder: exact batched Viterbi for lexicon-shaped
decoding graphs (port of `kaldi_tpu/decoder/block_chain.py`, best-path
mode).

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

Lattice mode (`_make_lattice_step`, Pallas kernel b) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.ops.block_chain_step import INF, LN2, block_chain_step


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pdf_hash(a: np.ndarray, b: np.ndarray, num_pdfs: int,
              salt: int) -> np.ndarray:
    h = (np.asarray(a, np.uint64) * np.uint64(2654435761)
         + np.asarray(b, np.uint64) * np.uint64(40503)
         + np.uint64(salt) * np.uint64(97))
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((h >> np.uint64(17)) % np.uint64(num_pdfs)).astype(np.int32)


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


Hyp = Optional[Tuple[List[int], List[int], float]]
StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]]


class BlockChainDecoder:
    """Batched exact Viterbi over a BlockChainGraph.
    decode_batch(loglikes (B, T, P)) -> per lane (words, tids, cost).

    step: the frame step, `ops.block_chain_step` by default (the CUDA
    kernel for CUDA tensors); `block_chain_step_reference` runs the plain
    version on the card, for comparison."""

    def __init__(self, graph: BlockChainGraph, device: DeviceLike = None,
                 step: StepFn = block_chain_step):
        g = graph
        self.g = g
        self.device = resolve_device(device)
        self.step = step
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
        self._eos = tens(eosp, torch.float32)
        # follow-pass tables
        self._end_row = tens(g.end_row, i64)
        self._k1_mask = tens(g.end_row < 0, torch.bool)

    # ------------------------------------------------------------------
    def _forward(self, am: torch.Tensor, active: torch.Tensor):
        """am (T, P, B) f32, active (T, B) bool -> final roots (Up, B)
        and the per-frame decisions: bits (T, Up, N/8, B) u8, root
        argmin contexts (T, V, B) and root self-loop flags (T, V, B)."""
        g = self.g
        V, N, Up = g.V, g.N, self.Up
        T, _, B = am.shape
        dev = self.device
        cur = torch.full((Up, N, B), INF, dtype=torch.float32, device=dev)
        nxt = torch.empty_like(cur)
        ovr = torch.full((Up, B), INF, dtype=torch.float32, device=dev)
        ovr[V] = 0.0                                    # begin root
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
        return ovr, bits, args, selfs

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
            ovr, bits, args, selfs = self._forward(am, active)
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
