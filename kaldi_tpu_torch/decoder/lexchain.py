"""Entry-LM shared-lexicon decoder: batched Viterbi over (real lexicon) x
(sparse backoff bigram) x (chain topology) graphs (port of
`kaldi_tpu/decoder/lexchain.py`: `LexChainGraph` and `LexChainDecoder`
in best-path and lattice mode).

The LM weight is applied at word ENTRY (the weight-pushing freedom of
HCLG), so the lexicon block is context-free:

  * ONE shared block of chain rows: variant p with k phones contributes
    k-1 rows (a row means "consumed >= 1 frame of its phone"; the
    word-final forward arc consumes the first frame of the LAST phone);
  * one root per pronunciation variant ("consumed >= 1 frame of the
    variant's last phone", carrying that phone's self-loop) plus a
    sentence-begin root;
  * optional per-root silence shadows (the optional inter-word silence
    of the L composition);
  * word entry at frame t relaxes over all roots r:
        entry[w] = min_r(root[r] + cost(w | word(r)))
    with the sparse backoff decomposition
        cost(w|u) = min(explicit(u, w), bo(u) + uni(w))
    so a frame costs O(N + V + E): one backoff reduction and a
    segmented min over the explicit bigram arcs (lm/bigram.py).

States: N + (P+1) + (P+1) (rows + roots + shadows).  The search is exact
by default; with `prune_k` each lane expands only the explicit arcs of
its top-K in-beam LM contexts a frame.

The device side is PyTorch ops, lanes last ((rows, B) planes, as the
reference lays them out): a Python frame loop writes each frame's
decisions into tensors allocated before the loop (chain rows one bit a
frame, forward vs self-loop; roots and shadows one bool; entries the
winning source root, or in pruned search the frame's candidate pool),
and a device follow pass walks them backward, so only the (T, B) state
trajectory reaches the host.

Lattice mode (`decode_batch_lattice`) runs a forward frame loop that
dumps each frame's root/shadow minimum, source frames, entry values and
word-end arrivals, and an exact backward (beta) frame loop over the same
graph; a word entry survives when its alpha + beta is within the beam of
the lane's best final cost.  Each survivor's top-J entry sources are
recomputed from the dumps on the device (the j=0 candidate is the
forward's entry bit for bit), and each lane's word lattice is assembled
on the host: exact beta over the word-event node graph, pruning, FST
emission.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.chain_blocks import ChainBlocks
from kaldi_tpu_torch.decoder.graph_direct import INF, LN2, FlatGraph
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.fstext.fst import Arc, LatticeWeight, VectorFst
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice
from kaldi_tpu_torch.lm.bigram import BigramBackoffLm

BIG = np.float32(1e10)
_log = logging.getLogger(__name__)

Hyp = Optional[Tuple[List[int], List[int], float]]
Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Prune = Optional[Tuple[int, float]]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class LexChainGraph:
    """Shared-lexicon decoding graph with entry-applied sparse LM.

    State numbering (to_flat_graph / traceback):
      [0, N)                      chain rows (variant interiors)
      N + p, p in [0, P)          variant roots
      N + P                       sentence-begin root (start)
      N + P + 1 + p, p in [0, P]  silence shadows (if use_sil;
                                  shadow P = initial silence)
    """
    prons: List[np.ndarray]          # per variant, 1-based phone ids
    pron_word: np.ndarray            # (P,) word id in [0, V)
    pron_cost: np.ndarray            # (P,) -ln pron prob
    lm: BigramBackoffLm
    num_pdfs: int
    words: List[str]                 # id -> word, [0] = "<eps>"
    use_sil: bool = False
    sil_phone: int = 0
    sil_cost: float = LN2            # -ln P(take optional silence)
    nosil_cost: float = 0.0          # -ln P(skip optional silence)
    # --- derived row layout (set by _layout) ---
    N: int = 0
    n_true: int = 0
    row_var: np.ndarray = field(default=None)     # (N,) variant or -1
    row_pos: np.ndarray = field(default=None)
    row_phone: np.ndarray = field(default=None)
    row_is_first: np.ndarray = field(default=None)
    row_word: np.ndarray = field(default=None)    # (N,) word of variant
    end_row: np.ndarray = field(default=None)     # (P,) or -1 if k==1
    # --- acoustic/transition tables ---
    pdf_fwd_row: np.ndarray = field(default=None)   # (N,)
    pdf_self_row: np.ndarray = field(default=None)  # (N,)
    tid_fwd_row: np.ndarray = field(default=None)
    tid_self_row: np.ndarray = field(default=None)
    tr_fwd_row: np.ndarray = field(default=None)    # (N,) -ln p
    tr_self_row: np.ndarray = field(default=None)
    pdf_end: np.ndarray = field(default=None)       # (P,) last-phone fwd
    tid_end: np.ndarray = field(default=None)
    tr_end: np.ndarray = field(default=None)
    pdf_root_self: np.ndarray = field(default=None)  # (P,)
    tid_root_self: np.ndarray = field(default=None)
    tr_root_self: np.ndarray = field(default=None)
    sil_pdf_fwd: int = 0
    sil_pdf_self: int = 0
    sil_tid_fwd: int = 0
    sil_tid_self: int = 0
    sil_tr_fwd: float = LN2
    sil_tr_self: float = LN2
    tid2pdf: np.ndarray = field(default=None)

    # ------------------------------------------------------------------
    @property
    def V(self) -> int:
        return self.lm.V

    @property
    def P(self) -> int:
        return len(self.prons)

    @property
    def num_states(self) -> int:
        base = self.N + self.P + 1
        return base + (self.P + 1 if self.use_sil else 0)

    @property
    def start_state(self) -> int:
        return self.N + self.P

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, prons: Sequence[np.ndarray], lm: BigramBackoffLm,
              pron_word: Optional[Sequence[int]] = None,
              pron_cost: Optional[Sequence[float]] = None,
              tm=None, tree=None, num_pdfs: Optional[int] = None,
              use_sil: bool = False, sil_phone: int = 0,
              sil_prob: float = 0.5) -> "LexChainGraph":
        """Build from pronunciations + sparse LM.

        With (tm, tree): real pdf-ids from the tree (monophone, 1-state
        chain topology) and real transition-ids and probabilities from
        the TransitionModel.  Without: synthetic pdf numbering
        fwd=2*(phone-1), self=2*(phone-1)+1 and tids pdf+1 /
        num_pdfs+pdf+1."""
        P = len(prons)
        prons = [np.asarray(p, np.int32) for p in prons]
        if any(len(p) < 1 for p in prons):
            raise ValueError("empty pronunciation")
        if pron_word is None:
            if P != lm.V:
                raise ValueError(f"{P} prons vs V={lm.V}; pass pron_word")
            pron_word = np.arange(P, dtype=np.int32)
        pron_word = np.asarray(pron_word, np.int32)
        if pron_cost is None:
            pron_cost = np.zeros(P, np.float32)
        g = cls(prons=list(prons), pron_word=pron_word,
                pron_cost=np.asarray(pron_cost, np.float32), lm=lm,
                num_pdfs=0, words=["<eps>"] + list(lm.words),
                use_sil=use_sil, sil_phone=sil_phone,
                sil_cost=float(-np.log(sil_prob)) if use_sil else LN2,
                nosil_cost=float(-np.log(1.0 - sil_prob))
                if use_sil else 0.0)
        g._layout()
        if tm is not None and tree is not None:
            g._tables_from_model(tm, tree)
            g.num_pdfs = tree.num_pdfs
        else:
            max_phone = max(int(p.max()) for p in prons)
            if use_sil:
                max_phone = max(max_phone, sil_phone)
            g.num_pdfs = num_pdfs or 2 * max_phone
            g._tables_synthetic()
        _log.info("LexChainGraph: V=%d P=%d rows=%d (N=%d) states=%d "
                  "explicit-bigrams=%d", g.V, P, g.n_true, g.N,
                  g.num_states, lm.num_explicit)
        return g

    def _layout(self) -> None:
        row_var, row_pos, row_phone = [], [], []
        end_row = np.full(self.P, -1, np.int64)
        for p_i, p in enumerate(self.prons):
            k = len(p)
            for j in range(k - 1):
                row_var.append(p_i)
                row_pos.append(j)
                row_phone.append(int(p[j]))
            if k >= 2:
                end_row[p_i] = len(row_var) - 1
        self.n_true = len(row_var)
        self.N = max(8, _round_up(self.n_true, 8))
        pad = self.N - self.n_true
        row_var += [-1] * pad
        row_pos += [0] * pad
        row_phone += [0] * pad
        self.row_var = np.asarray(row_var, np.int32)
        self.row_pos = np.asarray(row_pos, np.int32)
        self.row_phone = np.asarray(row_phone, np.int32)
        self.row_is_first = (self.row_pos == 0) & (self.row_var >= 0)
        self.row_word = np.where(self.row_var >= 0,
                                 self.pron_word[np.maximum(self.row_var, 0)],
                                 -1).astype(np.int32)
        self.end_row = end_row

    def _tables_synthetic(self) -> None:
        def fwd_pdf(ph):
            return (2 * (ph - 1)) % self.num_pdfs

        def self_pdf(ph):
            return (2 * (ph - 1) + 1) % self.num_pdfs
        ph = np.maximum(self.row_phone, 1)
        self.pdf_fwd_row = fwd_pdf(ph).astype(np.int32)
        self.pdf_self_row = self_pdf(ph).astype(np.int32)
        self.tid_fwd_row = (self.pdf_fwd_row + 1).astype(np.int32)
        self.tid_self_row = (self.num_pdfs + self.pdf_self_row + 1
                             ).astype(np.int32)
        self.tr_fwd_row = np.full(self.N, LN2, np.float32)
        self.tr_self_row = np.full(self.N, LN2, np.float32)
        last = np.asarray([int(p[-1]) for p in self.prons], np.int32)
        self.pdf_end = fwd_pdf(last).astype(np.int32)
        self.tid_end = (self.pdf_end + 1).astype(np.int32)
        self.tr_end = np.full(self.P, LN2, np.float32)
        self.pdf_root_self = self_pdf(last).astype(np.int32)
        self.tid_root_self = (self.num_pdfs + self.pdf_root_self + 1
                              ).astype(np.int32)
        self.tr_root_self = np.full(self.P, LN2, np.float32)
        if self.use_sil:
            self.sil_pdf_fwd = int(fwd_pdf(self.sil_phone))
            self.sil_pdf_self = int(self_pdf(self.sil_phone))
            self.sil_tid_fwd = self.sil_pdf_fwd + 1
            self.sil_tid_self = self.num_pdfs + self.sil_pdf_self + 1
        self.tid2pdf = np.concatenate(
            [[0], np.arange(self.num_pdfs),
             np.arange(self.num_pdfs)]).astype(np.int32)

    def _tables_from_model(self, tm, tree) -> None:
        """Real pdf/tid/transition-prob tables from a (TransitionModel,
        ContextDependency) with the 1-state chain topology (reference
        steps/nnet3/chain/gen_topo.py)."""
        phones = sorted(set(int(x) for x in self.row_phone if x > 0)
                        | {int(p[-1]) for p in self.prons}
                        | ({self.sil_phone} if self.use_sil else set()))
        fwd_pdf, self_pdf, fwd_tid, self_tid = {}, {}, {}, {}
        fwd_tr, self_tr = {}, {}
        for ph in phones:
            p0 = tree.compute([ph], 0)
            p1 = tree.compute([ph], 1)
            ts = tm.tuple_to_transition_state(ph, 0, p0, p1)
            sl = tm.self_loop_of(ts)
            fw = None
            for idx in range(tm.num_transition_indices(ts)):
                tid = tm.pair_to_transition_id(ts, idx)
                if not tm.is_self_loop(tid):
                    fw = tid
                    break
            if fw is None or not sl:
                raise ValueError(f"phone {ph}: not chain topology")
            fwd_pdf[ph], self_pdf[ph] = p0, p1
            fwd_tid[ph], self_tid[ph] = fw, sl
            fwd_tr[ph] = -tm.get_transition_log_prob(fw)
            self_tr[ph] = -tm.get_transition_log_prob(sl)

        def tab(d, idx_phones, dtype=np.int32):
            return np.asarray([d.get(int(ph), 0) for ph in idx_phones],
                              dtype)
        self.pdf_fwd_row = tab(fwd_pdf, self.row_phone)
        self.pdf_self_row = tab(self_pdf, self.row_phone)
        self.tid_fwd_row = tab(fwd_tid, self.row_phone)
        self.tid_self_row = tab(self_tid, self.row_phone)
        self.tr_fwd_row = tab(fwd_tr, self.row_phone, np.float32)
        self.tr_self_row = tab(self_tr, self.row_phone, np.float32)
        last = [int(p[-1]) for p in self.prons]
        self.pdf_end = tab(fwd_pdf, last)
        self.tid_end = tab(fwd_tid, last)
        self.tr_end = tab(fwd_tr, last, np.float32)
        self.pdf_root_self = tab(self_pdf, last)
        self.tid_root_self = tab(self_tid, last)
        self.tr_root_self = tab(self_tr, last, np.float32)
        if self.use_sil:
            sp = self.sil_phone
            self.sil_pdf_fwd = fwd_pdf[sp]
            self.sil_pdf_self = self_pdf[sp]
            self.sil_tid_fwd = fwd_tid[sp]
            self.sil_tid_self = self_tid[sp]
            self.sil_tr_fwd = fwd_tr[sp]
            self.sil_tr_self = self_tr[sp]
        n_tids = tm.num_transition_ids
        self.tid2pdf = np.asarray(
            [0] + [tm.transition_id_to_pdf(t)
                   for t in range(1, n_tids + 1)], np.int32)

    # ------------------------------------------------------------------
    def entry_cost_table(self) -> np.ndarray:
        """(P+1, V) effective word-entry cost from each root context
        (host reference; row P = sentence begin)."""
        dense = self.lm.dense_cost()            # (V+1, V)
        ctx = np.concatenate([self.pron_word, [self.lm.V]])
        return dense[ctx]

    def eos_of_root(self) -> np.ndarray:
        """(P+1,) end-of-sentence cost per root."""
        ctx = np.concatenate([self.pron_word, [self.lm.V]])
        return self.lm.eos[ctx]

    def to_flat_graph(self) -> FlatGraph:
        """Equivalent FlatGraph for host decoders (exactness tests).
        Word-entry arcs carry the olabel and the (densified) LM cost:
        one min-arc per (root, word) pair, tropical-equivalent to the
        explicit+backoff pair."""
        N, P = self.N, self.P
        root0 = N
        begin = N + P
        sil0 = N + P + 1
        ent = self.entry_cost_table()            # (P+1, V)
        eos = self.eos_of_root()
        src, dst, ilab, olab, wgt = [], [], [], [], []

        def add(s, d, tid, ol, w):
            src.append(s)
            dst.append(d)
            ilab.append(int(tid))
            olab.append(int(ol))
            wgt.append(float(w))

        sources = [(root0 + p, p) for p in range(P)] + [(begin, P)]
        if self.use_sil:
            sources += [(sil0 + p, p) for p in range(P + 1)]
        # chain interior
        for n in range(self.n_true):
            v = int(self.row_var[n])
            w = int(self.row_word[n])
            add(n, n, self.tid_self_row[n], 0, self.tr_self_row[n])
            if self.row_is_first[n]:
                for (s, ctx) in sources:
                    extra = self.nosil_cost if s < sil0 or not self.use_sil \
                        else 0.0
                    if s == begin and not self.use_sil:
                        extra = 0.0
                    add(s, n, self.tid_fwd_row[n], w + 1,
                        ent[ctx, w] + self.pron_cost[v] + extra
                        + self.tr_fwd_row[n])
            else:
                add(n - 1, n, self.tid_fwd_row[n], 0, self.tr_fwd_row[n])
        # word-final arcs into roots
        for p in range(P):
            w = int(self.pron_word[p])
            e = int(self.end_row[p])
            if e >= 0:
                add(e, root0 + p, self.tid_end[p], 0, self.tr_end[p])
            else:
                for (s, ctx) in sources:
                    extra = self.nosil_cost if (s < sil0
                                                or not self.use_sil) else 0.0
                    add(s, root0 + p, self.tid_end[p], w + 1,
                        ent[ctx, w] + self.pron_cost[p] + extra
                        + self.tr_end[p])
            add(root0 + p, root0 + p, self.tid_root_self[p], 0,
                self.tr_root_self[p])
        # silence shadows
        if self.use_sil:
            for p in range(P + 1):
                r = root0 + p if p < P else begin
                add(r, sil0 + p, self.sil_tid_fwd, 0,
                    self.sil_cost + self.sil_tr_fwd)
                add(sil0 + p, sil0 + p, self.sil_tid_self, 0,
                    self.sil_tr_self)
        finals = np.full(self.num_states, INF, np.float32)
        for p in range(P):
            finals[root0 + p] = eos[p]
        if self.use_sil:
            for p in range(P + 1):
                finals[sil0 + p] = eos[p]
        return FlatGraph(np.asarray(src, np.int32),
                         np.asarray(dst, np.int32),
                         np.asarray(ilab, np.int32),
                         np.asarray(olab, np.int32),
                         np.asarray(wgt, np.float32), finals,
                         start=begin, tid2pdf=self.tid2pdf,
                         num_pdfs=self.num_pdfs, words=self.words)


class LexChainDecoder(ChainBlocks):
    """Batched Viterbi over a LexChainGraph in PyTorch ops.

    decode_batch(loglikes (B, T, num_pdfs)) -> per lane (word_ids, tids,
    cost); word_ids index graph.words (1-based).  Exact by default;
    beam-pruned with `prune_k`."""

    VC_D = 16         # explicit arcs per virtual-context row
    # lattice mode: device bytes of a chunk of survivor pools
    POOL_CHUNK_BYTES = 1 << 30

    def __init__(self, graph: LexChainGraph, device: DeviceLike = None):
        g = graph
        self.g = g
        self.device = resolve_device(device)
        dev = self.device
        V = g.V
        lm = g.lm

        def tens(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        i64, f32 = torch.int64, torch.float32
        # explicit arcs at root level, padded so every word has >= 1 arc
        # (a dummy from context 0 with BIG cost); sorted by destination
        counts = np.bincount(lm.expl_dst, minlength=V)
        dst = np.concatenate([lm.expl_dst,
                              np.nonzero(counts == 0)[0].astype(np.int32)])
        srcw = np.concatenate([lm.expl_src,
                               np.zeros((counts == 0).sum(), np.int32)])
        cost = np.concatenate([lm.expl_cost,
                               np.full((counts == 0).sum(), BIG,
                                       np.float32)])
        order = np.argsort(dst, kind="stable")
        dst, srcw, cost = dst[order], srcw[order], cost[order]
        # bucketed-CSR layout of the exact entry relaxation: words grouped
        # by in-degree class (next pow2), each bucket a dense (n_words,
        # class) table of (source word, cost): the segmented min is one
        # gather and one reduction a class
        indeg = np.bincount(dst, minlength=V)
        seg_start = np.concatenate([[0], np.cumsum(indeg)[:-1]])
        classes = np.maximum(1, 1 << np.ceil(
            np.log2(np.maximum(indeg, 1))).astype(np.int64))
        self._buckets: List[Tuple[torch.Tensor, torch.Tensor]] = []
        perm = []
        for c in sorted(set(classes.tolist())):
            wsel = np.nonzero(classes == c)[0]
            src_tab = np.zeros((len(wsel), c), np.int64)
            cost_tab = np.full((len(wsel), c), BIG, np.float32)
            for row, w in enumerate(wsel):
                s0, d = int(seg_start[w]), int(indeg[w])
                src_tab[row, :d] = srcw[s0:s0 + d]
                cost_tab[row, :d] = cost[s0:s0 + d]
            self._buckets.append((tens(src_tab, i64), tens(cost_tab, f32)))
            perm.append(wsel)
        perm = np.concatenate(perm) if perm else np.zeros(0, np.int64)
        inv_perm = np.empty(V, np.int64)
        inv_perm[perm] = np.arange(V)
        self._bucket_inv_perm = tens(inv_perm, i64)
        # the dense (V, maxdeg) arc table (BIG-padded; the buckets'
        # candidates, so the mins agree bitwise)
        maxdeg = int(indeg.max()) if V else 1
        srcw_tab = np.zeros((V, maxdeg), np.int64)
        costw_tab = np.full((V, maxdeg), BIG, np.float32)
        for w_i in range(V):
            s0, d = int(seg_start[w_i]), int(indeg[w_i])
            srcw_tab[w_i, :d] = srcw[s0:s0 + d]
            costw_tab[w_i, :d] = cost[s0:s0 + d]
        self._srcw_tab = tens(srcw_tab, i64)
        self._costw_tab = tens(costw_tab[:, :, None], f32)
        # the exact forward takes the dense table when its padding is
        # modest: one gather and one reduction a frame instead of one of
        # each a class; at large V with skewed in-degree the buckets stay
        self._use_dense_corr = V * maxdeg <= 8 * max(len(dst), 1)
        # explicit arcs by SOURCE context (V+1 contexts, <s> last)
        order2 = np.argsort(srcw, kind="stable")
        s2, d2, c2 = srcw[order2], dst[order2], cost[order2]
        outdeg = np.bincount(s2, minlength=V + 1)
        start2 = np.concatenate([[0], np.cumsum(outdeg)[:-1]])
        # reverse buckets of the lattice backward pass: contexts grouped by
        # out-degree class (next pow2), each a dense (n_contexts, class)
        # table of (destination word, cost); every context appears once
        # (out-degree 0: a BIG dummy in the class-1 bucket)
        classes2 = np.maximum(1, 1 << np.ceil(
            np.log2(np.maximum(outdeg, 1))).astype(np.int64))
        self._rev_buckets: List[Tuple[torch.Tensor, torch.Tensor]] = []
        perm2 = []
        for c in sorted(set(classes2.tolist())):
            usel = np.nonzero(classes2 == c)[0]
            dtab = np.zeros((len(usel), c), np.int64)
            ctab = np.full((len(usel), c), BIG, np.float32)
            for row, u in enumerate(usel):
                s0, d = int(start2[u]), int(outdeg[u])
                dtab[row, :d] = d2[s0:s0 + d]
                ctab[row, :d] = c2[s0:s0 + d]
            self._rev_buckets.append((tens(dtab, i64),
                                      tens(ctab[:, :, None], f32)))
            perm2.append(usel)
        perm2 = np.concatenate(perm2)
        inv2 = np.empty(V + 1, np.int64)
        inv2[perm2] = np.arange(V + 1)
        self._rev_inv_perm = tens(inv2, i64)
        # variant table: word -> its variant roots, padded by repeating the
        # first entry (duplicates do not change a min); the root -> word
        # fold is one gather and a min over the <= maxvar axis
        wcounts = np.bincount(g.pron_word, minlength=V)
        self._word_has_var = tens(wcounts > 0, torch.bool)[:, None]
        vlists: Dict[int, List[int]] = {}
        for p_i, w_i in enumerate(g.pron_word.tolist()):
            vlists.setdefault(int(w_i), []).append(p_i)
        maxvar = max((len(v) for v in vlists.values()), default=1)
        vtab = np.zeros((V, maxvar), np.int64)
        for w_i in range(V):
            lst = vlists.get(w_i, [0])
            vtab[w_i] = lst + [lst[0]] * (maxvar - len(lst))
        self._vtab = tens(vtab, i64)
        self._maxvar = maxvar
        # --- row and root constants -------------------------------------
        pad_big = np.where(g.row_var < 0, BIG, 0.0).astype(np.float32)
        first_extra = np.where(
            g.row_is_first,
            g.pron_cost[np.maximum(g.row_var, 0)], 0.0).astype(np.float32)
        fr = np.nonzero(g.row_is_first)[0]
        self._first_rows = tens(fr, i64)
        self._first_units = tens(g.row_word[fr], i64)
        self._row_word = tens(np.maximum(g.row_word, 0), i64)
        self._row_first = tens(g.row_is_first, torch.bool)
        self._pdf_fwd_row = tens(g.pdf_fwd_row, i64)
        self._pdf_self_row = tens(g.pdf_self_row, i64)
        self._fwd_extra = tens((g.tr_fwd_row + pad_big + first_extra
                                )[:, None], f32)
        self._self_extra = tens((g.tr_self_row + pad_big)[:, None], f32)
        self._end_row = tens(np.maximum(g.end_row, 0), i64)
        self._end_is_row = tens(g.end_row >= 0, torch.bool)
        self._pdf_end = tens(g.pdf_end, i64)
        self._tr_end = tens(g.tr_end[:, None], f32)
        self._end_word = tens(g.pron_word, i64)
        self._end_pron_cost = tens(g.pron_cost[:, None], f32)
        self._pdf_root_self = tens(g.pdf_root_self, i64)
        self._tr_root_self = tens(g.tr_root_self[:, None], f32)
        # --- row helpers of the lattice backward pass -------------------
        is_end = np.zeros(g.N, bool)
        is_end[g.end_row[g.end_row >= 0]] = True
        self._is_end_row = tens(is_end[:, None], torch.bool)
        self._var_of_row = tens(np.maximum(g.row_var, 0), i64)
        klen = np.asarray([len(p) for p in g.prons])
        self._first_row_of_var = tens(
            np.where(g.end_row >= 0, g.end_row - (klen - 2), 0), i64)
        self._k1_mask = tens((g.end_row < 0)[:, None], torch.bool)
        self._tr_fwd_pad = tens((g.tr_fwd_row + pad_big)[:, None], f32)
        self._tr_self_pad = tens((g.tr_self_row + pad_big)[:, None], f32)
        # per-root LM context data (roots 0..P-1 = variants, P = <s>)
        ctx_word = np.concatenate([g.pron_word, [V]]).astype(np.int64)
        self._ctx_word = ctx_word
        self._ctxw = tens(ctx_word, i64)
        self._eos_root = lm.eos[ctx_word]                     # (P+1,) host
        self._root_bo = tens(lm.bo[ctx_word][:, None], f32)
        self._lm_bo = tens(lm.bo[:, None], f32)                # (V+1, 1)
        self._uni = tens(lm.uni[:, None], f32)
        self._uni_flat = tens(lm.uni, f32)
        self._eos = tens(lm.eos[ctx_word][:, None], f32)
        self._nosil = float(np.float32(g.nosil_cost if g.use_sil else 0.0))
        # made once: a host tensor copied in the frame loop would wait for
        # the card
        self._bit_weights = tens(1 << np.arange(8), torch.uint8).view(1, 8, 1)
        # --- virtual-context rows of the pruned entry expansion: the
        # explicit arcs by source, a context of out-degree d split into
        # ceil(d / VC_D) rows that share its root value, so the per-frame
        # top-K is over fixed-shape rows and the K winners expand as a
        # dense (K, VC_D) gather + scatter-min; pad rows point at the INF
        # context slot V+1
        D = self.VC_D
        vc_ctx, vc_dst, vc_cost = [], [], []
        for u in range(V + 1):
            s0, d = int(start2[u]), int(outdeg[u])
            for off in range(0, d, D):
                k = min(off + D, d) - off
                vc_ctx.append(u)
                vc_dst.append(np.concatenate(
                    [d2[s0 + off:s0 + off + k], np.zeros(D - k, np.int64)]))
                vc_cost.append(np.concatenate(
                    [c2[s0 + off:s0 + off + k],
                     np.full(D - k, BIG, np.float32)]))
        while len(vc_ctx) < 8:
            vc_ctx.append(V + 1)
            vc_dst.append(np.zeros(D, np.int64))
            vc_cost.append(np.full(D, BIG, np.float32))
        self.VC = len(vc_ctx)
        self._vc_ctx = tens(np.asarray(vc_ctx, np.int64), i64)
        self._vc_dst = tens(np.asarray(vc_dst, np.int64), i64)
        self._vc_cost = tens(np.asarray(vc_cost, np.float32), f32)

    # ------------------------------------------------------------------
    def _fold_words(self, rmin: torch.Tensor):
        """Variant roots -> word level: each word's min over its variant
        roots (first index on ties, INF for a word without one) ->
        (value (V, B), winning root (V, B) int64)."""
        B = rmin.shape[1]
        V, mv = self.g.V, self._maxvar
        rv = rmin.index_select(0, self._vtab.reshape(-1)).view(V, mv, B)
        rword_v, am1 = rv.min(dim=1)
        return (torch.where(self._word_has_var, rword_v, float(INF)),
                self._vtab.gather(1, am1))

    def _rarg_ext(self, rword_a: torch.Tensor, extra: int) -> torch.Tensor:
        """The source-root table of the entry planes: each word's winning
        variant root, then `extra` rows of the begin root P, (V + extra,
        B) int64."""
        return torch.cat([rword_a, rword_a.new_full(
            (extra, rword_a.shape[1]), self.g.P)], 0)

    def _entry_exact(self, rmin, rword_v, rword_a, base, garg):
        """Explicit-bigram corrections over every arc (dense table or
        buckets): -> (entry (V, B), its source root (V, B) int64)."""
        g = self.g
        B = rmin.shape[1]
        rword_ext = torch.cat([rword_v, rmin[g.P:g.P + 1]], 0)   # (V+1, B)
        rarg_ext = self._rarg_ext(rword_a, 1)
        if self._use_dense_corr:
            V, maxdeg = self._srcw_tab.shape
            cand = rword_ext.index_select(0, self._srcw_tab.reshape(-1)
                                          ).view(V, maxdeg, B) \
                + self._costw_tab
            corr, win = cand.min(dim=1)
            sw_win = self._srcw_tab.gather(1, win)
        else:
            parts_v, parts_sw = [], []
            for src_tab, cost_tab in self._buckets:
                nw, c = src_tab.shape
                cand = rword_ext.index_select(0, src_tab.reshape(-1)
                                              ).view(nw, c, B) \
                    + cost_tab[:, :, None]
                v, win = cand.min(dim=1)
                parts_v.append(v)
                parts_sw.append(src_tab.gather(1, win))
            corr = torch.cat(parts_v, 0).index_select(
                0, self._bucket_inv_perm)
            sw_win = torch.cat(parts_sw, 0).index_select(
                0, self._bucket_inv_perm)
        corr_a = rarg_ext.gather(0, sw_win)
        take_corr = corr < base
        entry = torch.where(take_corr, corr, base)
        return entry, torch.where(take_corr, corr_a, garg[None, :])

    def _entry_pruned(self, rmin, rword_v, rword_a, base, pick_sil, garg,
                      K: int, beam: float):
        """Each lane's K best in-beam virtual-context rows, their arcs
        scatter-min'd into the entry plane.  -> (entry (V, B), the pool's
        rows (B, K), values (B, K), source roots (B, K) and whether each
        came from a shadow, and whether the backoff source did (B,))."""
        g = self.g
        V = g.V
        B = rmin.shape[1]
        dev = rmin.device
        lane = torch.arange(B, device=dev)
        rword_ext = torch.cat([rword_v, rmin[g.P:g.P + 1],
                               rmin.new_full((1, B), float(INF))], 0)
        rarg_ext = self._rarg_ext(rword_a, 2)                   # (V+2, B)
        vvals = rword_ext.index_select(0, self._vc_ctx)        # (VC, B)
        cutoff = rmin.amin(dim=0) + beam
        vm = torch.where(vvals <= cutoff[None, :], vvals, float(INF))
        ids, vals = self._select(vm, K)                        # (B, K)
        dsts = self._vc_dst[ids]                               # (B, K, D)
        cand = vals[:, :, None] + self._vc_cost[ids]
        corr = torch.full((V * B,), float(INF), device=dev)
        corr.scatter_reduce_(0, (dsts * B + lane[:, None, None]).reshape(-1),
                             cand.reshape(-1), "amin")
        entry = torch.minimum(corr.view(V, B), base)
        root_k = rarg_ext.reshape(-1)[self._vc_ctx[ids] * B
                                      + lane[:, None]]         # (B, K)
        sil_flat = pick_sil.reshape(-1)
        sil_k = sil_flat[root_k * B + lane[:, None]]
        g_sil = sil_flat[garg * B + lane]
        return entry, ids, vals, root_k, sil_k, g_sil

    def _frame(self, cost, roots, sil, am_t, act, prune: Prune,
               outs: Dict[str, torch.Tensor], t: int):
        """One frame: cost (N, B), roots and sil (P+1, B), am_t (pdfs, B)
        (costs, -scale x loglikes), act (B,) -> the new planes; the
        frame's decisions are written into outs[...][t]."""
        g = self.g
        # --- source combination: root vs its silence shadow ------------
        radj = roots + self._nosil
        if g.use_sil:
            rmin = torch.minimum(radj, sil)
            pick_sil = sil < radj
        else:
            rmin = radj
            pick_sil = torch.zeros_like(radj, dtype=torch.bool)
        rword_v, rword_a = self._fold_words(rmin)
        # --- backoff entry: the best root + its context's backoff ------
        gval, garg = (rmin + self._root_bo).min(dim=0)
        base = gval[None, :] + self._uni                       # (V, B)
        if prune is None:
            entry, entry_arg = self._entry_exact(rmin, rword_v, rword_a,
                                                 base, garg)
            dumps = {"entry_arg": entry_arg, "pick_sil": pick_sil}
        else:
            entry, ids, vals, root_k, sil_k, g_sil = self._entry_pruned(
                rmin, rword_v, rword_a, base, pick_sil, garg, *prune)
            dumps = {"ids": ids, "vals": vals, "root_k": root_k,
                     "sil_k": sil_k, "gval": gval, "garg": garg,
                     "g_sil": g_sil}
        # --- chain rows, roots, silence shadows --------------------------
        new_cost, take_fwd = self._relax_rows(cost, am_t, entry)
        ent_root = entry.index_select(0, self._end_word) + \
            self._end_pron_cost
        roots_new, _, take_end = self._relax_roots(cost, roots, am_t,
                                                   ent_root)
        dumps["bits"] = self._pack_bits(take_fwd, g.N // 8)
        dumps["take_end"] = take_end
        if g.use_sil:
            sil_new, sil_take = self._relax_sil(roots, sil, am_t)
            dumps["sil_take"] = sil_take
        else:
            sil_new = sil
        for name, value in dumps.items():
            outs[name][t] = value          # int64 indices stored as int32
        keep = act[None, :]
        return (torch.where(keep, new_cost, cost),
                torch.where(keep, roots_new, roots),
                torch.where(keep, sil_new, sil))

    def _dump_shapes(self, B: int, prune: Prune) -> Dict[str, tuple]:
        g = self.g
        P = g.P
        shapes = {"bits": ((g.N // 8, B), torch.uint8),
                  "take_end": ((P, B), torch.bool)}
        if g.use_sil:
            shapes["sil_take"] = ((P + 1, B), torch.bool)
        if prune is None:
            shapes.update(entry_arg=((g.V, B), torch.int32),
                          pick_sil=((P + 1, B), torch.bool))
        else:
            K = prune[0]
            shapes.update(ids=((B, K), torch.int64),
                          vals=((B, K), torch.float32),
                          root_k=((B, K), torch.int32),
                          sil_k=((B, K), torch.bool),
                          gval=((B,), torch.float32),
                          garg=((B,), torch.int32),
                          g_sil=((B,), torch.bool))
        return shapes

    def _prune(self, prune_k: Optional[int], prune_beam: float) -> Prune:
        """None (exact) or (K, beam) with K at most the row count."""
        if prune_k is None:
            return None
        return int(min(int(prune_k), self.VC)), float(prune_beam)

    def _forward(self, am: torch.Tensor, active: torch.Tensor,
                 prune: Prune = None, carry: Optional[Carry] = None):
        """am (T, pdfs, B) costs, active (T, B), prune (None or (K,
        beam)), carry: the (cost (N, B), roots (P+1, B), shadows (P+1, B))
        to resume from, or None for a fresh start at the begin root ->
        ((cost, roots, shadows) after the last frame, the per-frame
        dumps: bits (T, N/8, B) uint8, take_end (T, P, B) and sil_take
        (T, P+1, B) bool; exact: entry_arg (T, V, B) int32 and pick_sil
        (T, P+1, B) bool; pruned: the pool ids (T, B, K) int64, vals f32,
        root_k int32 and sil_k bool, and the backoff source's gval f32,
        garg int32 and g_sil bool (T, B))."""
        g = self.g
        N, P = g.N, g.P
        T, _, B = am.shape
        dev = self.device
        outs = {name: torch.empty((T,) + shape, dtype=dtype, device=dev)
                for name, (shape, dtype) in
                self._dump_shapes(B, prune).items()}
        if carry is None:
            cost = torch.full((N, B), float(INF), device=dev)
            roots = torch.full((P + 1, B), float(INF), device=dev)
            roots[P] = 0.0
            sil = torch.full((P + 1, B), float(INF), device=dev)
        else:
            cost, roots, sil = carry
        for t in range(T):
            cost, roots, sil = self._frame(cost, roots, sil, am[t],
                                           active[t], prune, outs, t)
        return (cost, roots, sil), outs

    def _entry_src(self, ys: Dict[str, torch.Tensor], t: int,
                   w: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
        """The state each lane entered word w (B,) from in frame t: a
        root, a silence shadow or the begin root."""
        g = self.g
        N, P = g.N, g.P
        if "entry_arg" in ys:
            p_src = ys["entry_arg"][t][w, lane].to(torch.int64)
            from_sil = ys["pick_sil"][t][p_src, lane]
        else:
            # the winning source among the frame's stored pool: the same
            # candidates the forward scatter-min reduced, so the min value
            # is the forward's entry bitwise
            D = self.VC_D
            ids = ys["ids"][t]
            cand = ys["vals"][t][:, :, None] + self._vc_cost[ids]
            candw = torch.where(self._vc_dst[ids] == w[:, None, None], cand,
                                float(INF)).reshape(len(lane), -1)
            cmin, amin = candw.min(dim=1)
            k_win = (amin // D)[:, None]
            use_corr = cmin < ys["gval"][t] + self._uni_flat[w]
            p_src = torch.where(
                use_corr, ys["root_k"][t].gather(1, k_win)[:, 0],
                ys["garg"][t]).to(torch.int64)
            from_sil = torch.where(use_corr,
                                   ys["sil_k"][t].gather(1, k_win)[:, 0],
                                   ys["g_sil"][t])
        return torch.where(from_sil, N + P + 1 + p_src,
                           torch.where(p_src == P, N + P, N + p_src))

    def _follow(self, ys: Dict[str, torch.Tensor], active: torch.Tensor,
                final_state: torch.Tensor):
        """Walk the dumps backward from each lane's final state -> (the
        state before frame 0 (B,), states (T, B): the state after each
        frame)."""
        g = self.g
        N, P = g.N, g.P
        root0, begin, sil0 = N, N + P, N + P + 1
        T = active.shape[0]
        B = final_state.shape[0]
        dev = self.device
        lane = torch.arange(B, device=dev)
        states = torch.empty((T, B), dtype=torch.int64, device=dev)
        cur = final_state
        for t in range(T - 1, -1, -1):
            states[t] = cur
            is_row = cur < N
            is_shadow = cur >= sil0
            is_begin = cur == begin
            n_c = cur.clamp(0, N - 1)
            p_c = (cur - root0).clamp(0, P - 1)
            # a row or a root state's entry source, where it was entered
            w = torch.where(is_row, self._row_word[n_c], self._end_word[p_c])
            entry = self._entry_src(ys, t, w, lane)
            byte = ys["bits"][t][n_c >> 3, lane].to(torch.int64)
            bit = (byte >> (n_c & 7)) & 1
            row_prev = torch.where(
                bit == 1, torch.where(self._row_first[n_c], entry, cur - 1),
                cur)
            root_prev = torch.where(
                ys["take_end"][t][p_c, lane],
                torch.where(self._end_is_row[p_c], self._end_row[p_c],
                            entry), cur)
            if g.use_sil:
                ps = (cur - sil0).clamp(0, P)
                sh_prev = torch.where(
                    ys["sil_take"][t][ps, lane],
                    torch.where(ps == P, begin, root0 + ps), cur)
            else:
                sh_prev = cur
            prev = torch.where(is_row, row_prev,
                               torch.where(is_shadow, sh_prev,
                                           torch.where(is_begin, cur,
                                                       root_prev)))
            cur = torch.where(active[t], prev, cur)
        return cur, states

    def _final_state(self, roots, sil):
        """Each lane's best final (a root or a shadow, with its final
        cost) -> (its state (B,) int64, its cost (B,))."""
        g = self.g
        N, P = g.N, g.P
        fin_root = roots + self._eos
        fin_sil = sil + self._eos if g.use_sil else \
            torch.full_like(fin_root, float(INF))
        best_cost, best_i = torch.cat([fin_root, fin_sil], 0).min(dim=0)
        final_state = torch.where(
            best_i <= P, torch.where(best_i == P, N + P, N + best_i),
            N + P + 1 + (best_i - (P + 1)))
        return final_state, best_cost

    # ------------------------------------------------------------------
    def decode_batch(self, loglikes, acoustic_scale: float = 1.0,
                     lengths: Optional[Sequence[int]] = None,
                     prune_k: Optional[int] = None,
                     prune_beam: float = float(BIG),
                     exact_topk: bool = False,
                     stats: Optional[Dict[str, float]] = None
                     ) -> List[Hyp]:
        """loglikes (B, T, pdfs): a tensor (moved to this decoder's
        device) or a numpy array; lengths (B,) valid frames.  prune_k:
        expand only each lane's top-K in-beam LM contexts' explicit arcs
        a frame (None: exact); prune_beam: contexts worse than the
        frame's best + beam are dropped before the top-K.  The selection
        is always exact (`exact_topk` is accepted for the reference's
        interface: its approximate selection is a TPU device).  stats,
        when given, receives fwd_s, fol_s and traceback_s (each stage
        ends with a sync).  -> per lane (word ids, tids, cost), or None
        when no path survives."""
        g = self.g
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, npdf = ll.shape
        if npdf < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {npdf} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        prune = self._prune(prune_k, prune_beam)
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            t0 = time.perf_counter()
            (_, roots, sil), ys = self._forward(am, active, prune)
            if stats is not None:
                self._sync()
                stats["fwd_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            final_state, best_cost = self._final_state(roots, sil)
            first_state, states = self._follow(ys, active, final_state)
            states = states.cpu().numpy()
            first_state = first_state.cpu().numpy()
            best_cost = best_cost.cpu().numpy()
        if stats is not None:
            stats["fol_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        out = self._traceback(states, first_state, best_cost, lengths)
        if stats is not None:
            stats["traceback_s"] = time.perf_counter() - t0
        return out

    def _traceback(self, states, first_state, best_cost, lengths
                   ) -> List[Hyp]:
        """Host numpy: each lane's tids and words from its state
        trajectory, vectorized over (frames, lanes).  A lane whose path
        does not start at the begin root, or passes through it again,
        gets None."""
        g = self.g
        N, P = g.N, g.P
        root0, begin, sil0 = N, N + P, N + P + 1
        T, B = states.shape
        if T == 0:
            return [None if best_cost[b] >= INF / 2 else ([], [],
                    float(best_cost[b])) for b in range(B)]
        prev = np.vstack([first_state[None, :], states[:-1]])
        cur = states
        self_loop = prev == cur
        is_row = cur < N
        is_shadow = cur >= sil0
        n_c = np.clip(cur, 0, N - 1)
        p_c = np.clip(cur - root0, 0, P - 1)
        tid_all = np.where(
            is_row,
            np.where(self_loop, g.tid_self_row[n_c], g.tid_fwd_row[n_c]),
            np.where(
                is_shadow,
                np.where(self_loop, g.sil_tid_self, g.sil_tid_fwd),
                np.where(self_loop, g.tid_root_self[p_c], g.tid_end[p_c])))
        word_all = np.where(
            is_row & ~self_loop & g.row_is_first[n_c] & (prev >= N),
            g.row_word[n_c] + 1,
            np.where(~is_row & ~is_shadow & ~self_loop
                     & (g.end_row[p_c] < 0), g.pron_word[p_c] + 1, 0))
        hit_begin = cur == begin
        out: List[Hyp] = []
        for b in range(B):
            Tb = int(lengths[b])
            if best_cost[b] >= INF / 2:
                out.append(None)
                continue
            if Tb > 0 and (int(first_state[b]) != begin
                           or hit_begin[:Tb, b].any()):
                out.append(None)
                continue
            wv = word_all[:Tb, b]
            out.append((wv[wv > 0].tolist(), tid_all[:Tb, b].tolist(),
                        float(best_cost[b])))
        return out

    def decode(self, loglikes, acoustic_scale: float = 1.0) -> Hyp:
        return self.decode_batch(loglikes[None], acoustic_scale)[0]

    # ==================================================================
    # Lattice mode: a forward frame loop with per-frame dumps, an exact
    # backward (beta) frame loop, the alpha + beta survivor cut, top-J
    # entry pools at the survivors, host assembly of each lane's word
    # lattice (nodes are (variant root, frame) word-end events; word arcs
    # carry the entry sources: a root, a silence shadow or the begin root,
    # with exact cost splits; optional-silence frames ride on the entry
    # arc, the source-time gap giving their span).
    # ==================================================================
    def _entry_value(self, rmin: torch.Tensor) -> torch.Tensor:
        """A lattice frame's word-entry value (V, B): the backoff source
        against every explicit arc, each candidate one add of the same
        operands as the survivor pools', so their j=0 value equals it bit
        for bit (mins are exact: the dense table and the buckets agree)."""
        g = self.g
        V, P = g.V, g.P
        B = rmin.shape[1]
        rword_v = rmin.index_select(0, self._vtab.reshape(-1)).view(
            V, self._maxvar, B).amin(dim=1)
        rword_v = torch.where(self._word_has_var, rword_v, float(INF))
        base = (rmin + self._root_bo).amin(dim=0)[None, :] + self._uni
        rword_ext = torch.cat([rword_v, rmin[P:P + 1]], 0)      # (V+1, B)
        if self._use_dense_corr:
            maxdeg = self._srcw_tab.shape[1]
            corr = (rword_ext.index_select(0, self._srcw_tab.reshape(-1))
                    .view(V, maxdeg, B) + self._costw_tab).amin(dim=1)
        else:
            corr = torch.cat([
                (rword_ext.index_select(0, src.reshape(-1)).view(
                    *src.shape, B) + cst[:, :, None]).amin(dim=1)
                for src, cst in self._buckets], 0).index_select(
                    0, self._bucket_inv_perm)
        return torch.minimum(corr, base)

    def _frame_lattice(self, planes, am_t, act, t: int,
                       outs: Dict[str, torch.Tensor]):
        """One lattice frame.  planes = (cost, ent (N, B), roots, sil,
        sil_t (P+1, B)): ent holds each row's entry frame, sil_t each
        shadow's start frame.  The frame's dumps are written into
        outs[...][t]; -> the new planes (inactive lanes frozen)."""
        cost, ent, roots, sil, sil_t = planes
        g = self.g
        tf = float(t)
        radj = roots + self._nosil
        if g.use_sil:
            rmin = torch.minimum(radj, sil)
            src_time = torch.where(sil < radj, sil_t, tf - 1.0)
        else:
            rmin = radj
            src_time = torch.full_like(radj, tf - 1.0)
        entry = self._entry_value(rmin)
        # rows, with the entry frame riding beside the cost
        new_cost, take_fwd = self._relax_rows(cost, am_t, entry)
        fwd_ent = torch.roll(ent, 1, 0).index_fill_(0, self._first_rows, tf)
        new_ent = torch.where(take_fwd, fwd_ent, ent)
        ent_root = entry.index_select(0, self._end_word) + \
            self._end_pron_cost
        roots_new, end_cand, take_end = self._relax_roots(cost, roots, am_t,
                                                          ent_root)
        arr_te = torch.where(self._end_is_row[:, None],
                             ent.index_select(0, self._end_row), tf)
        if g.use_sil:
            sil_new, sil_take = self._relax_sil(roots, sil, am_t)
            sil_t_new = torch.where(sil_take, tf - 1.0, sil_t)
        else:
            sil_new, sil_t_new = sil, sil_t
        keep = act[None, :]
        roots_new = torch.where(keep, roots_new, roots)
        for name, value in (("rmin", rmin), ("src_time", src_time),
                            ("entry", entry), ("end_cand", end_cand),
                            ("arr_te", arr_te), ("take_end", take_end),
                            ("roots", roots_new)):
            outs[name][t] = value
        return (torch.where(keep, new_cost, cost),
                torch.where(keep, new_ent, ent), roots_new,
                torch.where(keep, sil_new, sil),
                torch.where(keep, sil_t_new, sil_t))

    def _forward_lattice(self, am: torch.Tensor, active: torch.Tensor):
        """am (T, pdfs, B) costs, active (T, B) -> final roots, shadows and
        shadow start frames (P+1, B), and the per-frame dumps (T, ., B):
        rmin and src_time (P+1) f32 (each root's min against its shadow,
        the frame its path left the word), entry (V) f32, the word-end
        arrivals' end_cand and arr_te (entry frame) (P) f32 and take_end
        (P) bool, and roots (P+1) f32 after the frame."""
        g = self.g
        N, P, V = g.N, g.P, g.V
        T, _, B = am.shape
        dev = self.device
        f32 = torch.float32
        shapes = {"rmin": (P + 1, f32), "src_time": (P + 1, f32),
                  "entry": (V, f32), "end_cand": (P, f32),
                  "arr_te": (P, f32), "take_end": (P, torch.bool),
                  "roots": (P + 1, f32)}
        outs = {name: torch.empty((T, rows, B), dtype=dtype, device=dev)
                for name, (rows, dtype) in shapes.items()}
        roots = torch.full((P + 1, B), float(INF), device=dev)
        roots[P] = 0.0
        planes = (torch.full((N, B), float(INF), device=dev),
                  torch.zeros((N, B), device=dev), roots,
                  torch.full((P + 1, B), float(INF), device=dev),
                  torch.full((P + 1, B), -1.0, device=dev))
        for t in range(T):
            planes = self._frame_lattice(planes, am[t], active[t], t, outs)
        _, _, roots, sil, sil_t = planes
        return roots, sil, sil_t, outs

    def _frame_backward(self, carry, am_t, act, t: int,
                        outs: Dict[str, torch.Tensor]):
        """One backward frame: carry = the betas (rows (N, B), roots and
        shadows (P+1, B)) AFTER frame t -> the betas before it.  Dumps
        bentry[t] (V, B), the best completion cost of entering word w in
        frame t (pronunciation, first frame and the word's interior), and
        broots[t] (P, B), each variant root's beta after frame t."""
        bcost, broots, bsil = carry
        g = self.g
        P, V = g.P, g.V
        B = bcost.shape[1]
        amf = am_t.index_select(0, self._pdf_fwd_row) + self._tr_fwd_pad
        ams = am_t.index_select(0, self._pdf_self_row) + self._tr_self_pad
        am_end = am_t.index_select(0, self._pdf_end) + self._tr_end
        am_rs = am_t.index_select(0, self._pdf_root_self) + \
            self._tr_root_self
        fr = self._first_row_of_var
        cand_var = torch.where(
            self._k1_mask, am_end + broots[:P],
            amf.index_select(0, fr) + bcost.index_select(0, fr)) \
            + self._end_pron_cost
        bentry = cand_var.index_select(0, self._vtab.reshape(-1)).view(
            V, self._maxvar, B).amin(dim=1)
        bentry = torch.where(self._word_has_var, bentry, float(INF))
        outs["bentry"][t] = bentry
        outs["broots"][t] = broots[:P]
        # rows: the self-loop, or the next row (the word end's root)
        vr = self._var_of_row
        next_val = torch.where(
            self._is_end_row,
            am_end.index_select(0, vr) + broots.index_select(0, vr),
            torch.roll(amf, -1, 0) + torch.roll(bcost, -1, 0))
        bcost_new = torch.minimum(ams + bcost, next_val)
        # roots: the self-loop, or leave the word: backoff or explicit
        h = (self._uni + bentry).amin(dim=0)                    # (B,)
        expl_u = torch.cat([
            (bentry.index_select(0, dst.reshape(-1)).view(*dst.shape, B)
             + cst).amin(dim=1) for dst, cst in self._rev_buckets],
            0).index_select(0, self._rev_inv_perm)              # (V+1, B)
        wordexit = torch.minimum(self._lm_bo + h[None, :],
                                 expl_u).index_select(0, self._ctxw)
        root_self = torch.cat([am_rs + broots[:P],
                               broots.new_full((1, B), float(INF))], 0)
        broots_new = torch.minimum(root_self, wordexit + self._nosil)
        if g.use_sil:
            sil_in = (g.sil_cost + g.sil_tr_fwd) + \
                am_t[g.sil_pdf_fwd][None, :] + bsil
            broots_new = torch.minimum(broots_new, sil_in)
            bsil_new = torch.minimum(
                g.sil_tr_self + am_t[g.sil_pdf_self][None, :] + bsil,
                wordexit)
        else:
            bsil_new = bsil
        keep = act[None, :]
        return (torch.where(keep, bcost_new, bcost),
                torch.where(keep, broots_new, broots),
                torch.where(keep, bsil_new, bsil))

    def _backward(self, am: torch.Tensor, active: torch.Tensor):
        """The exact backward pass, frames in reverse, from each root's
        and shadow's end-of-sentence cost -> dumps bentry (T, V, B) and
        broots (T, P, B) f32 (see _frame_backward)."""
        g = self.g
        N, P, V = g.N, g.P, g.V
        T, _, B = am.shape
        dev = self.device
        binit = self._eos.expand(P + 1, B)
        carry = (torch.full((N, B), float(INF), device=dev), binit.clone(),
                 binit.clone() if g.use_sil else
                 torch.full((P + 1, B), float(INF), device=dev))
        outs = {"bentry": torch.empty((T, V, B), device=dev),
                "broots": torch.empty((T, P, B), device=dev)}
        for t in range(T - 1, -1, -1):
            carry = self._frame_backward(carry, am[t], active[t], t, outs)
        return outs

    @staticmethod
    def _bit_order_nonzero(mask: torch.Tensor) -> Tuple[np.ndarray, ...]:
        """The set entries of mask (T, R, B) in the reference's order of
        its packed survivor bits: (frame, byte of 8 rows, lane, bit) ->
        host (t, row, lane) int64."""
        T, R, B = mask.shape
        Rp = _round_up(R, 8)
        if Rp != R:
            mask = torch.cat([mask, mask.new_zeros((T, Rp - R, B))], 1)
        nz = torch.nonzero(mask.view(T, Rp // 8, 8, B).permute(0, 1, 3, 2))
        nz = nz.cpu().numpy()
        return nz[:, 0], nz[:, 1] * 8 + nz[:, 3], nz[:, 2]

    @staticmethod
    def _lat_post(ys, bys, best, active, beam: float):
        """The survivor cut after both passes: a word entry survives when
        its exact alpha + beta is within `beam` of its lane's best final
        cost, and an arrival (a taken word end) when its cost + the
        root's beta is; frames past a lane's length are out.  -> the
        masks (T, V, B) and (T, P, B)."""
        cut = best + beam + 1e-3                                  # (B,)
        live = active[:, None, :]
        keep = (ys["entry"] + bys["bentry"] <= cut) & live
        arr_keep = ys["take_end"] & live & \
            (ys["end_cand"] + bys["broots"] <= cut)
        return keep, arr_keep

    def _surv_pools(self, ys, bentry, best, st, sw, sb, J: int,
                    beam: float):
        """The top-J entry candidates of each survivor (frame st, word sw,
        lane sb; host int64 arrays), from the frame's rmin and src_time
        dumps: the backoff pool (the top J roots plus their context's
        backoff), the explicit pool over the word's arcs, the merge's top
        J of 2J (backoff first on ties), and the per-candidate beam cut
        (alpha + bentry within the beam; j=0 always kept: it defines the
        survivor).  Ties go to the first column (argmin).  In chunks of at
        most POOL_CHUNK_BYTES.  -> host (S, J) value f32, source root
        (f32), source frame (f32), LM cost (f32) and keep (bool)."""
        V, P = self.g.V, self.g.P
        maxdeg = self._srcw_tab.shape[1]
        per = max(1, self.POOL_CHUNK_BYTES
                  // (16 * (V * self._maxvar + 2 * maxdeg + 4 * (P + 1))))
        parts = []
        for lo in range(0, len(st), per):
            idx = [torch.as_tensor(x[lo:lo + per], device=self.device)
                   for x in (st, sw, sb)]
            parts.append([c.cpu().numpy() for c in self._pool_chunk(
                ys, bentry, best, *idx, J, beam)])
        if not parts:
            return [np.zeros((0, J), dt) for dt in
                    (np.float32,) * 4 + (bool,)]
        return [np.concatenate(cols) for cols in zip(*parts)]

    def _pool_chunk(self, ys, bentry, best, st, sw, sb, J: int,
                    beam: float):
        """_surv_pools on one chunk of survivors (device tensors)."""
        V, P = self.g.V, self.g.P
        S = st.shape[0]
        inf = float(INF)
        rmin_s = ys["rmin"][st, :, sb]                          # (S, P+1)
        srct_s = ys["src_time"][st, :, sb]
        # backoff pool: the top J root sources
        pool_m = rmin_s + self._root_bo[:, 0]
        bo = []
        for _ in range(J):
            m, a = pool_m.min(dim=1)
            col = a[:, None]
            rsrc = rmin_s.gather(1, col)[:, 0]
            bo.append((m, a.to(torch.float32), srct_s.gather(1, col)[:, 0],
                       m - rsrc))
            pool_m.scatter_(1, col, inf)
        bo_v, bo_a, bo_t, bo_lm = (torch.stack(c, 1) for c in zip(*bo))
        # fold roots to word level
        mv = self._maxvar
        rword_v, am1 = rmin_s[:, self._vtab.reshape(-1)].view(
            S, V, mv).min(dim=2)
        rword_a = self._vtab.reshape(-1)[
            torch.arange(V, device=st.device)[None, :] * mv + am1]
        rword_v = torch.where(self._word_has_var[:, 0], rword_v, inf)
        rword_ext = torch.cat([rword_v, rmin_s[:, P:P + 1]], 1)  # (S, V+1)
        rarg_ext = torch.cat([rword_a, rword_a.new_full((S, 1), P)], 1)
        time_ext = torch.cat([srct_s.gather(1, rword_a),
                              srct_s[:, P:P + 1]], 1)
        # explicit pool: this word's arc rows
        stab = self._srcw_tab[sw]                            # (S, maxdeg)
        ctab = self._costw_tab[sw, :, 0]
        cand = rword_ext.gather(1, stab) + ctab
        ex = []
        for _ in range(J):
            m, a = cand.min(dim=1)
            col = a[:, None]
            ex.append((m, stab.gather(1, col)[:, 0],
                       ctab.gather(1, col)[:, 0]))
            cand.scatter_(1, col, inf)
        ex_v, ex_sw, ex_lm = (torch.stack(c, 1) for c in zip(*ex))
        ex_a = rarg_ext.gather(1, ex_sw).to(torch.float32)
        ex_t = time_ext.gather(1, ex_sw)
        # merge: top J of 2J, the backoff pool first
        uni_s = self._uni_flat[sw][:, None]
        all_v = torch.cat([bo_v + uni_s, ex_v], 1)
        all_a = torch.cat([bo_a, ex_a], 1)
        all_t = torch.cat([bo_t, ex_t], 1)
        all_lm = torch.cat([bo_lm + uni_s, ex_lm], 1)
        out = []
        for _ in range(J):
            m, a = all_v.min(dim=1)
            col = a[:, None]
            out.append((m, all_a.gather(1, col)[:, 0],
                        all_t.gather(1, col)[:, 0],
                        all_lm.gather(1, col)[:, 0]))
            all_v.scatter_(1, col, inf)
        ecv, esv, etv, elv = (torch.stack(c, 1) for c in zip(*out))
        cut = best[sb] + beam + 1e-3
        valid = ecv + bentry[st, sw, sb][:, None] <= cut[:, None]
        valid[:, 0] = True
        return ecv, esv, etv, elv, valid

    def decode_batch_lattice(self, loglikes, acoustic_scale: float = 1.0,
                             lengths: Optional[Sequence[int]] = None,
                             lattice_beam: float = 8.0, J: int = 4,
                             stats: Optional[Dict[str, float]] = None
                             ) -> List[Optional[Lattice]]:
        """Word-lattice decode: per lane a Lattice (ilabel = tid, olabel =
        word id, weights (graph, acoustic)) pruned to `lattice_beam`, or
        None.  Each word arc keeps up to J entry sources.  Within-word
        alignments of non-best entry sources reuse the winner's time span
        (self-loop frames on the last chain row), as in the block-chain
        lattice.  stats, when given, receives the stages' seconds
        (fwd_scan_s, bwd_scan_s, post_s, fwd_s = the three, unpack_s,
        gather_s, expand_s, nodegather_s, assemble_s; the device stages
        end with a sync) and sizes (n_arrival, n_word_surv, n_entry,
        n_arcs, n_nodes)."""
        g = self.g
        P, V = g.P, g.V
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, npdf = ll.shape
        if npdf < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {npdf} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        if T == 0:
            return [None] * B
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            t0 = time.perf_counter()
            roots_fin, sil_fin, sil_t_fin, ys = self._forward_lattice(am,
                                                                      active)
            if stats is not None:
                self._sync()
                stats["fwd_scan_s"] = time.perf_counter() - t0
                t1 = time.perf_counter()
            # the lane's best final cost: the anchor of the beam cut
            fin = roots_fin + self._eos
            if g.use_sil:
                fin = torch.cat([fin, sil_fin + self._eos], 0)
            best = fin.amin(dim=0)
            bys = self._backward(am, active)
            if stats is not None:
                self._sync()
                stats["bwd_scan_s"] = time.perf_counter() - t1
                t1 = time.perf_counter()
            keep, arr_keep = self._lat_post(ys, bys, best, active,
                                            lattice_beam)
            lane = torch.arange(B, device=self.device)
            last = torch.as_tensor(np.maximum(lengths - 1, 0),
                                   device=self.device)
            alpha_fin = ys["roots"][last, :, lane].T.cpu().numpy()  # (P+1,B)
            # the self-extension acoustics are differences of these
            # prefix sums: float64, whose rounding no pruning decision
            # sees (float32's reaches 1e-4 at |sum| ~ 1e3)
            am_cs = torch.cumsum(am.index_select(1, self._pdf_root_self)
                                 .to(torch.float64), dim=0)     # (T, P, B)
            sil_fin = sil_fin.cpu().numpy()
            sil_t_fin = sil_t_fin.cpu().numpy()
            if stats is not None:
                self._sync()
                stats["post_s"] = time.perf_counter() - t1
                stats["fwd_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            (st, sw, sb), (at_, ap, ab) = (self._bit_order_nonzero(m)
                                           for m in (keep, arr_keep))
            del keep, arr_keep
        if stats is not None:
            stats["unpack_s"] = time.perf_counter() - t0
            stats["n_arrival"] = len(ab)
        t0 = time.perf_counter()
        dev = self.device

        def gather(planes, *idx):
            """planes[i][t, r, b] at host index arrays -> host arrays."""
            ix = [torch.as_tensor(x, device=dev) for x in idx]
            return [p[ix[0], ix[1], ix[2]].cpu().numpy() for p in planes]

        with torch.inference_mode():
            # arrival payloads first: their entry frames drive the
            # force-keep
            arrc, arrte = gather((ys["end_cand"], ys["arr_te"]), at_, ap,
                                 ab)
        arrte = np.rint(arrte).astype(np.int64)
        word_of_var = g.pron_word.astype(np.int64)
        # each arrival's (lane, entry frame, word) key.  Force-keep: the
        # word entry feeding every kept arrival survives, or the Viterbi
        # path itself is lost when the beam cut is tight
        arr_key = (ab * T + np.maximum(arrte, 0)) * V + word_of_var[ap]
        have_key = np.unique((sb * T + st) * V + sw)
        missing = np.setdiff1d(np.unique(arr_key), have_key,
                               assume_unique=True)
        if len(missing):
            sb = np.concatenate([sb, missing // (T * V)])
            st = np.concatenate([st, (missing // V) % T])
            sw = np.concatenate([sw, missing % V])
        if stats is not None:
            stats["n_word_surv"] = len(sb)
        with torch.inference_mode():
            ecv2, esv2, etv2, elv2, valid2 = self._surv_pools(
                ys, bys["bentry"], best, st, sw, sb, J, lattice_beam)
            # the winning (j=0) entry value of each arrival
            entry_win, = gather((ys["entry"],), np.maximum(arrte, 0),
                                word_of_var[ap], ab)
        keepf = valid2.reshape(-1)
        sb, st, sw = (np.repeat(x, J)[keepf] for x in (sb, st, sw))
        ecv, esv, etv, elv = (x.reshape(-1)[keepf] for x in
                              (ecv2, esv2, etv2, elv2))
        if stats is not None:
            stats["n_entry"] = len(sb)
            stats["gather_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # arc expansion: each arrival joins the sorted survivor span of
        # its (lane, entry frame, word) key
        surv_key = (sb * T + st) * V + sw
        order = np.argsort(surv_key, kind="stable")
        surv_key_s = surv_key[order]
        fin_ok = np.isfinite(entry_win) & (entry_win < INF / 2)
        lo = np.searchsorted(surv_key_s, arr_key)
        hi = np.searchsorted(surv_key_s, arr_key, side="right")
        counts = np.where(fin_ok, hi - lo, 0)
        total = int(counts.sum())
        arr_i = np.repeat(np.arange(len(ab)), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int64)
        sidx = order[lo[arr_i] + (np.arange(total) - starts[arr_i])]
        # float32 as the reference computes it: alpha at the arrival via
        # candidate j = the arrival's cost - the winner's entry + the
        # candidate's entry
        a_cost = (arrc[arr_i] - entry_win[arr_i]
                  + ecv[sidx]).astype(np.float64)
        a_lm = elv[sidx].astype(np.float64)
        a_srcp = np.rint(esv[sidx]).astype(np.int64)
        a_srct = np.rint(etv[sidx]).astype(np.int64)
        a_dstp, a_dstt, a_te, a_b = ap[arr_i], at_[arr_i], arrte[arr_i], \
            ab[arr_i]
        ok = np.isfinite(a_cost) & (a_cost < INF / 2)
        (a_cost, a_lm, a_srcp, a_srct, a_dstp, a_dstt, a_te, a_b) = (
            x[ok] for x in (a_cost, a_lm, a_srcp, a_srct, a_dstp, a_dstt,
                            a_te, a_b))
        if stats is not None:
            stats["expand_s"] = time.perf_counter() - t0
            stats["n_arcs"] = len(a_cost)
        t0 = time.perf_counter()
        # the global node set: arrivals, arc sources, final anchors; one
        # gather of their alphas and prefix sums
        eosr = self._eos_root
        fin_r_all = alpha_fin[:P, :] + eosr[:P, None]            # (P, B)
        if g.use_sil:
            fin_s_all = sil_fin[:P, :] + eosr[:P, None]
            fin_beg_all = sil_fin[P, :] + eosr[P]
        else:
            fin_s_all = np.full((P, B), np.inf, np.float32)
            fin_beg_all = np.full(B, np.inf, np.float32)
        best_all = np.minimum(np.minimum(fin_r_all.min(0), fin_s_all.min(0)),
                              fin_beg_all)
        cutoff_all = best_all + lattice_beam + 1e-4
        src_ok = ~((a_srcp >= P) | (a_srct < 0))
        fp, fb = np.nonzero(fin_r_all <= cutoff_all[None, :])
        gk = [(a_b * P + a_dstp) * T + a_dstt,
              ((a_b * P + a_srcp) * T + a_srct)[src_ok],
              (fb * P + fp) * T + (lengths[fb] - 1)]
        if g.use_sil:
            sp, sb2 = np.nonzero(fin_s_all <= cutoff_all[None, :])
            tsrc = np.rint(sil_t_fin[sp, sb2]).astype(np.int64)
            gk.append(((sb2 * P + sp) * T + tsrc)[tsrc >= 0])
        gkeys = np.unique(np.concatenate(gk)).astype(np.int64)
        n_b, n_p, n_t = gkeys // (P * T), (gkeys // T) % P, gkeys % T
        with torch.inference_mode():
            node_alpha_all, node_amcs_all = gather(
                (ys["roots"], am_cs), n_t, n_p, n_b)
        del ys, bys, am_cs
        if stats is not None:
            stats["nodegather_s"] = time.perf_counter() - t0
            stats["n_nodes"] = len(gkeys)
        t0 = time.perf_counter()
        lats = []
        for b in range(B):
            sel = np.nonzero(a_b == b)[0]
            nsel = np.nonzero(n_b == b)[0]
            lats.append(self._assemble_lane(
                int(lengths[b]), T, a_srcp[sel], a_srct[sel], a_dstp[sel],
                a_dstt[sel], a_cost[sel], a_lm[sel], a_te[sel],
                gkeys[nsel] % (P * T), node_alpha_all[nsel],
                node_amcs_all[nsel], alpha_fin[:, b], sil_fin[:, b],
                sil_t_fin[:, b], lattice_beam))
        if stats is not None:
            stats["assemble_s"] = time.perf_counter() - t0
        return lats

    def _assemble_lane(self, Tb, T, a_srcp, a_srct, a_dstp, a_dstt, a_cost,
                       a_lm, a_te, node_keys, node_alpha, node_amcs,
                       alpha_fin, sil_fin, sil_t_fin, beam):
        """Host assembly of one lane's lattice with exact alpha + beta
        pruning on the word-event node graph.  The arcs arrive expanded
        and the node alphas and prefix sums gathered (decode_batch_lattice
        batches both over the lanes); node_keys = p * T + t, sorted."""
        g = self.g
        P = g.P
        if Tb == 0 or len(a_cost) == 0 or len(node_keys) == 0:
            return None
        eosr = self._eos_root                              # (P+1,)
        fin_r = alpha_fin[:P] + eosr[:P]
        fin_s = sil_fin[:P] + eosr[:P] if g.use_sil else np.full(P, np.inf)
        fin_s_begin = sil_fin[P] + eosr[P] if g.use_sil else np.inf
        best = min(float(np.min(fin_r)), float(np.min(fin_s)),
                   float(fin_s_begin))
        if not np.isfinite(best) or best >= INF / 2:
            return None
        cutoff = best + beam + 1e-4
        # ---- node set (start node = -1: p == P or t < 0 on the source
        # side) --------------------------------------------------------
        src_is_start = (a_srcp >= P) | (a_srct < 0)
        src_keys = np.where(src_is_start, -1, a_srcp * T + a_srct)
        node_p = node_keys // T
        node_t = node_keys % T
        node_alpha = node_alpha.astype(np.float64)
        n = len(node_keys)
        src_i = np.where(src_is_start, -1,
                         np.searchsorted(node_keys, src_keys))
        dst_i = np.searchsorted(node_keys, a_dstp * T + a_dstt)
        # ---- self-extension arcs between consecutive same-p nodes -----
        ss = np.nonzero(node_p[1:] == node_p[:-1])[0]
        sd = ss + 1
        s_ac = node_amcs[sd] - node_amcs[ss]
        s_cost = (node_t[sd] - node_t[ss]) * \
            np.asarray(g.tr_root_self, np.float64)[node_p[ss]] + s_ac
        # ---- final-silence arcs: a path may end inside a silence shadow,
        # an arc from node (p, sil_t_fin[p]) over the trailing frames ---
        fin_sil_arcs = []
        if g.use_sil:
            for p in range(P + 1):
                val = fin_s[p] if p < P else fin_s_begin
                if not np.isfinite(val) or val > cutoff:
                    continue
                t_src = int(round(float(sil_t_fin[p])))
                src = -1 if (p >= P or t_src < 0) else \
                    int(np.searchsorted(node_keys, p * T + t_src))
                if src >= 0 and (src >= n
                                 or node_keys[src] != p * T + t_src):
                    continue          # source node not in the graph
                fin_sil_arcs.append((src, p, t_src, float(sil_fin[p])))
        # ---- beta over the node graph ---------------------------------
        beta = np.full(n, np.inf)
        last = node_t == Tb - 1
        beta[last] = eosr[node_p[last]]
        arc_src_t = np.where(src_is_start, -1, a_srct)
        arc_delta = a_cost - np.where(src_is_start, 0.0,
                                      node_alpha[np.maximum(src_i, 0)])
        for (src, p, _t_src, _val) in fin_sil_arcs:
            if src >= 0:
                fv = fin_s[p] if p < P else fin_s_begin
                beta[src] = min(beta[src], fv - node_alpha[src])
        for f in range(Tb - 1, -2, -1):
            if len(ss):
                m_s = node_t[ss] == f
                if m_s.any():
                    np.minimum.at(beta, ss[m_s],
                                  s_cost[m_s] + beta[sd[m_s]])
            wa = np.nonzero(arc_src_t == f)[0]
            if len(wa):
                np.minimum.at(beta, src_i[wa],
                              arc_delta[wa] + beta[dst_i[wa]])
        # ---- prune + build --------------------------------------------
        keep_node = node_alpha + beta <= cutoff
        lat = VectorFst(LatticeWeight)
        nodes: Dict[int, int] = {}
        start = lat.add_state()
        lat.set_start(start)

        def node_state(i):
            s = nodes.get(i)
            if s is None:
                s = lat.add_state()
                nodes[i] = s
            return s

        def emit_chain(cur, dst_state, p, te, t, olabel, graph, acous):
            """The arcs of one word instance of variant p over frames
            [te, t]."""
            e = int(g.end_row[p])
            k = len(g.prons[p])
            tids = []
            if e >= 0:
                first_row = e - (k - 2)
                tids = [int(g.tid_fwd_row[r])
                        for r in range(first_row, e + 1)]
                tids += [int(g.tid_self_row[e])] * (t - te + 1 - k)
            tids.append(int(g.tid_end[p]))
            for q, tid in enumerate(tids):
                nxt = dst_state if q == len(tids) - 1 else lat.add_state()
                lat.add_arc(cur, Arc(tid, olabel if q == 0 else 0,
                                     (graph, acous) if q == 0
                                     else (0.0, 0.0), nxt))
                cur = nxt

        def emit_sil(cur, n_frames):
            for q in range(n_frames):
                nxt = lat.add_state()
                lat.add_arc(cur, Arc(
                    int(g.sil_tid_fwd if q == 0 else g.sil_tid_self), 0,
                    (0.0, 0.0), nxt))
                cur = nxt
            return cur

        src_alpha_arr = np.where(src_is_start, 0.0,
                                 node_alpha[np.maximum(src_i, 0)])
        keep_arc = keep_node[dst_i] & \
            (src_is_start | keep_node[np.maximum(src_i, 0)]) & \
            (src_alpha_arr + arc_delta + beta[dst_i] <= cutoff)
        for i in np.nonzero(keep_arc)[0]:
            src_t = int(a_srct[i])
            p, t, te = int(a_dstp[i]), int(a_dstt[i]), int(a_te[i])
            cur = start if src_is_start[i] else node_state(int(src_i[i]))
            dst = node_state(int(dst_i[i]))
            n_sil = (te - 1) - src_t
            k = len(g.prons[p])
            e = int(g.end_row[p])
            # the graph cost of the word arc: LM, pronunciation, the
            # chain's transitions, and the optional silence before it
            gcost = float(a_lm[i]) + float(g.pron_cost[p]) + \
                float(g.tr_end[p])
            if e >= 0:
                first_row = e - (k - 2)
                gcost += float(np.sum(g.tr_fwd_row[first_row:e + 1]))
                gcost += (t - te + 1 - k) * float(g.tr_self_row[e])
            if n_sil > 0:
                gcost += g.sil_cost + g.sil_tr_fwd + \
                    (n_sil - 1) * g.sil_tr_self
            else:
                gcost += g.nosil_cost
            acous = float(arc_delta[i]) - gcost
            if n_sil > 0:
                # the silence frames carry no weight: the split across
                # arcs is a convention, the totals are exact
                cur = emit_sil(cur, n_sil)
            emit_chain(cur, dst, p, te, t, int(g.pron_word[p]) + 1,
                       gcost, acous)
        # self-extension arcs
        for k2 in range(len(ss)):
            i0, i1 = int(ss[k2]), int(sd[k2])
            if not (keep_node[i0] and keep_node[i1]):
                continue
            if node_alpha[i0] + s_cost[k2] + beta[i1] > cutoff:
                continue
            cur = nodes.get(i0)
            if cur is None:
                continue
            p = int(node_p[i0])
            t0, t1 = int(node_t[i0]), int(node_t[i1])
            dstn = node_state(i1)
            gc = (t1 - t0) * float(g.tr_root_self[p])
            for q in range(t0 + 1, t1 + 1):
                nxt = dstn if q == t1 else lat.add_state()
                lat.add_arc(cur, Arc(int(g.tid_root_self[p]), 0,
                                     (gc, float(s_ac[k2])) if q == t0 + 1
                                     else (0.0, 0.0), nxt))
                cur = nxt
        # finals
        for i, s in list(nodes.items()):
            if int(node_t[i]) == Tb - 1:
                lat.set_final(s, (float(eosr[int(node_p[i])]), 0.0))
        # final-silence arcs
        for (src, p, t_src, sil_alpha) in fin_sil_arcs:
            if src >= 0 and src not in nodes:
                continue
            cur = start if src < 0 else nodes[src]
            src_alpha = 0.0 if src < 0 else float(node_alpha[src])
            n_frames = (Tb - 1) - t_src
            if n_frames <= 0:
                continue
            gcost = g.sil_cost + g.sil_tr_fwd + \
                (n_frames - 1) * g.sil_tr_self
            nxt = lat.add_state()
            lat.add_arc(cur, Arc(int(g.sil_tid_fwd), 0,
                                 (gcost, (sil_alpha - src_alpha) - gcost),
                                 nxt))
            for _ in range(1, n_frames):
                nn = lat.add_state()
                lat.add_arc(nxt, Arc(int(g.sil_tid_self), 0, (0.0, 0.0),
                                     nn))
                nxt = nn
            lat.set_final(nxt, (float(eosr[min(p, P)]), 0.0))
        connect(lat)
        if lat.num_states == 0 or lat.start is None:
            return None
        return lat
