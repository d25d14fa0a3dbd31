"""N-gram lexchain: batched device Viterbi over (context-dependent tree)
x (sparse backoff trigram) x (chain topology) graphs (port of
`kaldi_tpu/decoder/lexchain_ng.py`: `NgramLexGraph` and
`NgramLexDecoder` in best-path and lattice mode).

With a trigram the future depends on the LM state (word pair), so exact
search keeps word interiors separate per reachable LM state.  The graph
is decoded over UNITS:

  unit = (pronunciation variant p, LM history state h)

where h ranges over the LM states whose last word is word(p): pair
states (u, word(p)) plus the unigram state word(p) (lm/trigram.py).  A
unit is a row chain (phones 1..k-1) ending in a root ("in last phone").
Every state has one forward and one self arc; all word-entry arcs are
computed per frame by factored LM folds instead of materialized arcs:

  sval[s]     = min over slots (roots) of state s
  unival[u]   = min(sval[uni u], min_{(x,u)} sval[pair] + bo2)
  nval        = min_u unival[u] + bo1[u]                   (null state)
  ent_pair[(v,w)] = min( trigram arcs from pooled pair states,
                         bigram arcs from pooled uni states )
  ent_uni[w]  = nval + uni[w]

Destinations follow the ARPA-FST convention, so the search is exact
Viterbi over the equivalent composed graph (`to_flat_graph`, held
against the host FasterDecoder in the tests).  Arc expansion is pruned
per frame to each lane's top-K in-beam source rows; with K covering all
rows the search is exact.

Within a pronunciation the phone context is static, so rows carry the
context-dependent pdf/transition ids of a trained tree over the
word-internal window (padded with 0 at word boundaries).

The device side is PyTorch ops, lanes last ((rows, B) planes, as the
reference lays them out): a Python frame loop writes each frame's
decisions (bit-packed) and its expansion pool into tensors allocated
before the loop, and a device follow pass walks them backward, so only
the (T, B) state trajectory reaches the host.  Lattice mode runs the same
blocks with fixed-capacity dumps a frame (the pool, the cheapest word
ends), gathers each surviving word end's best entries on the card, and
assembles each lane's word lattice on the host.
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
from kaldi_tpu_torch.lm.trigram import TrigramBackoffLm

BIG = np.float32(1e10)
# the fold tree's slot sentinel: the reference's finite-f32 payload
# 0x7F000000 less its bias 0x40000000, so an empty entry decodes to the
# same slot
SLOT_SENTINEL = 0x7F000000 - 0x40000000
# the lattice step's raw-slot sentinel (an empty fold entry)
IBIG = 2 ** 31 - 1
_log = logging.getLogger(__name__)

Hyp = Optional[Tuple[List[int], List[int], float]]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class NgramLexGraph:
    """Unit-expanded lexicon graph with factored trigram entry.

    State numbering (to_flat_graph / traceback):
      [0, Nr)                  rows (unit interiors, unit-major)
      Nr + i, i in [0, U)      unit roots
      Nr + U                   sentence-begin root
      Nr + U + 1 + i           silence shadows (if use_sil; i in
                               [0, U], shadow U = initial silence)
    """
    prons: List[np.ndarray]
    pron_word: np.ndarray            # (P,)
    pron_cost: np.ndarray            # (P,)
    lm: TrigramBackoffLm
    num_pdfs: int
    words: List[str]
    use_sil: bool = False
    sil_phone: int = 0
    sil_cost: float = LN2
    nosil_cost: float = 0.0
    # --- unit layout (set by _layout) ---
    U: int = 0                       # number of units
    unit_var: np.ndarray = field(default=None)   # (U,) variant
    unit_hist: np.ndarray = field(default=None)  # (U,) LM state id
    unit_word: np.ndarray = field(default=None)  # (U,)
    Nr: int = 0
    n_rows_true: int = 0
    row_unit: np.ndarray = field(default=None)   # (Nr,) unit or -1
    row_pos: np.ndarray = field(default=None)
    row_is_first: np.ndarray = field(default=None)
    end_row: np.ndarray = field(default=None)    # (U,) or -1 if k==1
    # --- acoustic/transition tables (per row / per unit) ---
    pdf_fwd_row: np.ndarray = field(default=None)
    pdf_self_row: np.ndarray = field(default=None)
    tid_fwd_row: np.ndarray = field(default=None)
    tid_self_row: np.ndarray = field(default=None)
    tr_fwd_row: np.ndarray = field(default=None)
    tr_self_row: np.ndarray = field(default=None)
    pdf_end: np.ndarray = field(default=None)    # (U,)
    tid_end: np.ndarray = field(default=None)
    tr_end: np.ndarray = field(default=None)
    pdf_root_self: np.ndarray = field(default=None)
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
    def S(self) -> int:
        """LM state count: pair states + uni states (incl <s>)."""
        return self.lm.SP + self.V + 1

    @property
    def num_states(self) -> int:
        base = self.Nr + self.U + 1
        return base + (self.U + 1 if self.use_sil else 0)

    @property
    def start_state(self) -> int:
        return self.Nr + self.U

    def uni_state(self, w: int) -> int:
        return self.lm.SP + w

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, prons: Sequence[np.ndarray], lm: TrigramBackoffLm,
              pron_word: Optional[Sequence[int]] = None,
              pron_cost: Optional[Sequence[float]] = None,
              tm=None, tree=None, num_pdfs: Optional[int] = None,
              use_sil: bool = False, sil_phone: int = 0,
              sil_prob: float = 0.5,
              synth_context: int = 1) -> "NgramLexGraph":
        """With (tm, tree): context-dependent pdf/tid tables from the
        trained tree over word-internal windows (0-padded at word
        boundaries).  Without: synthetic context-hashed tables of
        width `synth_context` (1 = monophone)."""
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
            g._tables_synthetic(max_phone, synth_context)
        _log.info("NgramLexGraph: V=%d P=%d units=%d rows=%d states=%d "
                  "(LM: %d pairs, %d bi, %d tri)", g.V, P, g.U,
                  g.n_rows_true, g.num_states, lm.SP, lm.num_explicit_bi,
                  lm.num_explicit_tri)
        return g

    # ------------------------------------------------------------------
    def _layout(self) -> None:
        lm = self.lm
        V = lm.V
        P = len(self.prons)
        # histories per word: pair states (u, w) in sp order, then
        # uni(w) — vectorized (U can reach 1e5+ at vocabulary scale)
        SP = lm.SP
        pv = lm.pair_v.astype(np.int64)
        order = np.argsort(pv, kind="stable")      # sps grouped by v
        n_pairs_of_word = np.bincount(pv, minlength=V + 1)
        word_off = np.concatenate([[0], np.cumsum(n_pairs_of_word)])
        pw = self.pron_word.astype(np.int64)
        k_units = n_pairs_of_word[pw] + 1          # per pron
        self.U = int(k_units.sum())
        unit_var = np.repeat(np.arange(P, dtype=np.int32), k_units)
        # within-pron unit index j: j < k-1 -> pair order[word_off[w]+j],
        # j == k-1 -> uni state
        u_off = np.concatenate([[0], np.cumsum(k_units)])
        j_in = np.arange(self.U, dtype=np.int64) - u_off[unit_var]
        is_uni = j_in == (k_units[unit_var] - 1)
        pair_idx = order[np.minimum(
            word_off[pw[unit_var]] + j_in,
            len(order) - 1 if len(order) else 0)] if SP else \
            np.zeros(self.U, np.int64)
        unit_hist = np.where(is_uni, SP + pw[unit_var], pair_idx)
        self.unit_var = unit_var.astype(np.int32)
        self.unit_hist = unit_hist.astype(np.int32)
        self.unit_word = self.pron_word[self.unit_var]
        # rows, unit-major: unit u of pron length k owns k-1 rows
        pron_len = np.asarray([len(p) for p in self.prons], np.int64)
        k_rows = pron_len[self.unit_var] - 1
        row_unit = np.repeat(np.arange(self.U, dtype=np.int32), k_rows)
        r_off = np.concatenate([[0], np.cumsum(k_rows)])
        row_pos = (np.arange(len(row_unit), dtype=np.int64)
                   - r_off[row_unit])
        end_row = np.where(k_rows >= 1, r_off[1:] - 1, -1)
        self.n_rows_true = len(row_unit)
        self.Nr = max(8, _round_up(self.n_rows_true, 8))
        pad = self.Nr - self.n_rows_true
        self.row_unit = np.pad(row_unit.astype(np.int32), (0, pad),
                               constant_values=-1)
        self.row_pos = np.pad(row_pos.astype(np.int32), (0, pad))
        self.row_is_first = (self.row_pos == 0) & (self.row_unit >= 0)
        self.end_row = end_row

    # ------------------------------------------------------------------
    def _phone_windows(self, pron: np.ndarray, N: int, P: int
                       ) -> List[List[int]]:
        """Word-internal context windows for every phone of `pron`
        (0-padded outside the word, context-dep.cc convention for
        out-of-window positions)."""
        padded = [0] * P + [int(x) for x in pron] + [0] * (N - P - 1)
        return [padded[i:i + N] for i in range(len(pron))]

    def _tables_synthetic(self, max_phone: int, ctx: int) -> None:
        """Deterministic context-hashed pdf tables: ctx=1 reproduces
        the monophone scheme fwd=2(p-1), self=2(p-1)+1; ctx=3 hashes
        the word-internal triphone window so context-dependence is
        exercised without a trained tree."""
        def pdf_pair(window):
            if ctx == 1:
                p = window[0]
                return (2 * (p - 1)) % self.num_pdfs, \
                       (2 * (p - 1) + 1) % self.num_pdfs
            l, p, r = window
            h = (l * 131 + p * 7 + r * 31)
            return (2 * h) % self.num_pdfs, (2 * h + 1) % self.num_pdfs

        Nr, U = self.Nr, self.U
        # per-variant flat tables + vectorized gather (as in
        # _tables_from_model)
        nP = len(self.prons)
        var_off = np.zeros(nP + 1, np.int64)
        flat_rows: List[Tuple] = []
        end_tab = np.zeros((nP, 2), np.int64)
        for p_i, pron in enumerate(self.prons):
            wins = self._phone_windows(pron, 3 if ctx == 3 else 1,
                                       1 if ctx == 3 else 0)
            flat_rows.extend(pdf_pair(w) for w in wins[:-1])
            var_off[p_i + 1] = len(flat_rows)
            end_tab[p_i] = pdf_pair(wins[-1])
        flat = np.asarray(flat_rows, np.int64).reshape(-1, 2)
        n_true = self.n_rows_true
        ru = self.row_unit[:n_true].astype(np.int64)
        fi = var_off[self.unit_var[ru].astype(np.int64)] \
            + self.row_pos[:n_true].astype(np.int64)
        self.pdf_fwd_row = np.pad(flat[fi, 0].astype(np.int32),
                                  (0, Nr - n_true))
        self.pdf_self_row = np.pad(flat[fi, 1].astype(np.int32),
                                   (0, Nr - n_true))
        uv = self.unit_var.astype(np.int64)
        self.pdf_end = end_tab[uv, 0].astype(np.int32)
        self.pdf_root_self = end_tab[uv, 1].astype(np.int32)
        self.tid_fwd_row = (self.pdf_fwd_row + 1).astype(np.int32)
        self.tid_self_row = (self.num_pdfs + self.pdf_self_row + 1
                             ).astype(np.int32)
        self.tid_end = (self.pdf_end + 1).astype(np.int32)
        self.tid_root_self = (self.num_pdfs + self.pdf_root_self + 1
                              ).astype(np.int32)
        self.tr_fwd_row = np.full(Nr, LN2, np.float32)
        self.tr_self_row = np.full(Nr, LN2, np.float32)
        self.tr_end = np.full(U, LN2, np.float32)
        self.tr_root_self = np.full(U, LN2, np.float32)
        if self.use_sil:
            f, s = pdf_pair([0, self.sil_phone, 0] if ctx == 3
                            else [self.sil_phone])
            self.sil_pdf_fwd, self.sil_pdf_self = int(f), int(s)
            self.sil_tid_fwd = self.sil_pdf_fwd + 1
            self.sil_tid_self = self.num_pdfs + self.sil_pdf_self + 1
        self.tid2pdf = np.concatenate(
            [[0], np.arange(self.num_pdfs),
             np.arange(self.num_pdfs)]).astype(np.int32)

    def _tables_from_model(self, tm, tree) -> None:
        """Real pdf/tid/prob tables from a trained (TransitionModel,
        ContextDependency) with the 1-state chain topology, over
        word-internal context windows (reference: the tree answers any
        window via EventMap, tree/context-dep.h:59; chain topology
        gen_topo.py)."""
        N, P = tree.context_width(), tree.central_position()
        cache: Dict[Tuple[Tuple[int, ...], int], Tuple] = {}

        def lookup(window):
            key = tuple(window)
            if key in cache:
                return cache[key]
            ph = window[P] if len(window) > P else window[0]
            p0 = tree.compute(window, 0)
            p1 = tree.compute(window, 1)
            ts = tm.tuple_to_transition_state(ph, 0, p0, p1)
            sl = tm.self_loop_of(ts)
            fw = None
            for idx in range(tm.num_transition_indices(ts)):
                tid = tm.pair_to_transition_id(ts, idx)
                if not tm.is_self_loop(tid):
                    fw = tid
                    break
            if fw is None or sl is None:
                raise ValueError(f"window {window}: not chain topology")
            out = (p0, p1, fw, sl, -tm.get_transition_log_prob(fw),
                   -tm.get_transition_log_prob(sl))
            cache[key] = out
            return out

        Nr, U = self.Nr, self.U
        # per-variant flat row tables + end tables, then one vectorized
        # gather per output array (U can reach 1e5+ at vocabulary scale)
        nP = len(self.prons)
        var_off = np.zeros(nP + 1, np.int64)
        flat_rows: List[Tuple] = []
        end_tab = np.zeros((nP, 6), np.float64)
        for p_i, pron in enumerate(self.prons):
            wins = self._phone_windows(pron, N, P)
            flat_rows.extend(lookup(w) for w in wins[:-1])
            var_off[p_i + 1] = len(flat_rows)
            end_tab[p_i] = lookup(wins[-1])
        flat = np.asarray(flat_rows, np.float64).reshape(-1, 6)
        n_true = self.n_rows_true
        ru = self.row_unit[:n_true].astype(np.int64)
        fi = var_off[self.unit_var[ru].astype(np.int64)] \
            + self.row_pos[:n_true].astype(np.int64)

        def pad_i(col, fill=0):
            return np.pad(flat[fi, col].astype(np.int32),
                          (0, Nr - n_true), constant_values=fill)

        def pad_f(col):
            return np.pad(flat[fi, col].astype(np.float32),
                          (0, Nr - n_true), constant_values=LN2)

        self.pdf_fwd_row = pad_i(0)
        self.pdf_self_row = pad_i(1)
        self.tid_fwd_row = pad_i(2)
        self.tid_self_row = pad_i(3)
        self.tr_fwd_row = pad_f(4)
        self.tr_self_row = pad_f(5)
        uv = self.unit_var.astype(np.int64)
        self.pdf_end = end_tab[uv, 0].astype(np.int32)
        self.pdf_root_self = end_tab[uv, 1].astype(np.int32)
        self.tid_end = end_tab[uv, 2].astype(np.int32)
        self.tid_root_self = end_tab[uv, 3].astype(np.int32)
        self.tr_end = end_tab[uv, 4].astype(np.float32)
        self.tr_root_self = end_tab[uv, 5].astype(np.float32)
        if self.use_sil:
            w = [0] * P + [self.sil_phone] + [0] * (N - P - 1)
            p0, p1, fw, sl, tf, ts_ = lookup(w)
            self.sil_pdf_fwd, self.sil_pdf_self = p0, p1
            self.sil_tid_fwd, self.sil_tid_self = fw, sl
            self.sil_tr_fwd, self.sil_tr_self = tf, ts_
        n_tids = tm.num_transition_ids
        self.tid2pdf = np.asarray(
            [0] + [tm.transition_id_to_pdf(t)
                   for t in range(1, n_tids + 1)], np.int32)

    # ------------------------------------------------------------------
    def _entry_arcs_host(self):
        """Host enumeration of word-entry moves for to_flat_graph:
        list of (src_kind, src_idx, dst_unit, cost) where src_kind is
        'slot' (unit root), 'begin', and costs follow the per-
        destination ARPA-FST semantics (tests only; O(U^2)-ish)."""
        lm = self.lm
        V, SP = lm.V, lm.SP
        fold = {}
        for u, w, cc in zip(lm.fold_src, lm.fold_dst, lm.fold_cost):
            fold[(int(u), int(w))] = float(cc)

        def from_uni_to_uni(u, w):
            cands = [float(lm.bo1[u]) + float(lm.uni[w])]
            if (u, w) in fold:
                cands.append(fold[(u, w)])
            return min(cands)

        # source states: per unit its hist; begin = uni(<s>)
        src_states = list(self.unit_hist) + [lm.SP + V]
        out = []
        for dst_u in range(self.U):
            h = int(self.unit_hist[dst_u])
            w = int(self.unit_word[dst_u])
            pc = float(self.pron_cost[int(self.unit_var[dst_u])])
            for si, s in enumerate(src_states):
                s = int(s)
                cost = None
                if h < SP:                      # pair destination (u',w)
                    need_u = int(lm.pair_u[h])
                    if s < SP:                  # pair source (x,y)
                        # arcs from s land in pairs (y, w): need y==u'
                        if int(lm.pair_v[s]) == need_u:
                            cands = []
                            m = (lm.tri_src == s) & (lm.tri_dst == h)
                            if m.any():
                                cands.append(float(lm.tri_cost[m].min()))
                            if lm.ent_bi_cost[h] < BIG / 2:
                                cands.append(float(lm.bo2[s])
                                             + float(lm.ent_bi_cost[h]))
                            cost = min(cands) if cands else None
                    else:                       # uni source
                        u = s - SP
                        if u == need_u and lm.ent_bi_cost[h] < BIG / 2:
                            cost = float(lm.ent_bi_cost[h])
                else:                           # uni destination
                    if s < SP:
                        y = int(lm.pair_v[s])
                        cands = [float(lm.bo2[s])
                                 + from_uni_to_uni(y, w)]
                        m = (lm.tri_src == s) & (lm.tri_dst == SP + w)
                        if m.any():
                            cands.append(float(lm.tri_cost[m].min()))
                        cost = min(cands)
                    else:
                        cost = from_uni_to_uni(s - SP, w)
                if cost is not None and cost < BIG / 2:
                    out.append((si, dst_u, cost + pc))
        return out

    def eos_of_slot(self) -> np.ndarray:
        """(U+1,) final cost per unit root (+ begin)."""
        eos_u, eos_p = self.lm.eos_state_cost()
        s = np.concatenate([self.unit_hist, [self.lm.SP + self.V]])
        allc = np.concatenate([eos_p, eos_u])
        return allc[s].astype(np.float32)

    def to_flat_graph(self):
        """Statically expanded FlatGraph (host exactness tests)."""
        Nr, U = self.Nr, self.U
        root0 = Nr
        begin = Nr + U
        sil0 = Nr + U + 1
        src, dst, ilab, olab, wgt = [], [], [], [], []

        def add(s, d, tid, ol, w):
            src.append(s)
            dst.append(d)
            ilab.append(int(tid))
            olab.append(int(ol))
            wgt.append(float(w))

        entry = self._entry_arcs_host()
        # entry arcs: into first row (k>=2) or root (k==1)
        for (si, dst_u, cost) in entry:
            w_out = int(self.unit_word[dst_u]) + 1
            e = int(self.end_row[dst_u])
            srcs = [(root0 + si if si < U else begin,
                     self.nosil_cost if self.use_sil else 0.0)]
            if self.use_sil:
                srcs.append((sil0 + si, 0.0))
            if si == U and not self.use_sil:
                srcs = [(begin, 0.0)]
            for (s_state, extra) in srcs:
                if e >= 0:
                    k = len(self.prons[int(self.unit_var[dst_u])])
                    first = e - (k - 2)
                    add(s_state, first, self.tid_fwd_row[first], w_out,
                        cost + extra + self.tr_fwd_row[first])
                else:
                    add(s_state, root0 + dst_u, self.tid_end[dst_u],
                        w_out, cost + extra + self.tr_end[dst_u])
        # interior rows
        for n in range(self.n_rows_true):
            u_i = int(self.row_unit[n])
            add(n, n, self.tid_self_row[n], 0, self.tr_self_row[n])
            if not self.row_is_first[n]:
                add(n - 1, n, self.tid_fwd_row[n], 0, self.tr_fwd_row[n])
        # last interior row -> root
        for u_i in range(U):
            e = int(self.end_row[u_i])
            if e >= 0:
                add(e, root0 + u_i, self.tid_end[u_i], 0,
                    self.tr_end[u_i])
            add(root0 + u_i, root0 + u_i, self.tid_root_self[u_i], 0,
                self.tr_root_self[u_i])
        # silence shadows
        if self.use_sil:
            for i in range(U + 1):
                r = root0 + i if i < U else begin
                add(r, sil0 + i, self.sil_tid_fwd, 0,
                    self.sil_cost + self.sil_tr_fwd)
                add(sil0 + i, sil0 + i, self.sil_tid_self, 0,
                    self.sil_tr_self)
        eos = self.eos_of_slot()
        finals = np.full(self.num_states, INF, np.float32)
        for i in range(U):
            finals[root0 + i] = eos[i]
        if self.use_sil:
            for i in range(U + 1):
                finals[sil0 + i] = eos[i]
        return FlatGraph(np.asarray(src, np.int32),
                         np.asarray(dst, np.int32),
                         np.asarray(ilab, np.int32),
                         np.asarray(olab, np.int32),
                         np.asarray(wgt, np.float32), finals,
                         start=begin, tid2pdf=self.tid2pdf,
                         num_pdfs=self.num_pdfs, words=self.words)



class NgramLexDecoder(ChainBlocks):
    """Batched Viterbi over an NgramLexGraph in PyTorch ops.

    decode_batch(loglikes (B, T, num_pdfs)) -> per lane
    (word_ids, tids, cost); exact when the pool covers all
    virtual-context rows (the default), beam-pruned otherwise."""

    VC_D = 16         # arcs per virtual-context row
    FOLD_D = 16       # fan-in of the backoff fold tree
    # lattice mode: the survivor pools are computed in chunks whose
    # candidate planes (about this many bytes a candidate) stay under this
    POOL_CHUNK_BYTES = 2 << 30
    POOL_BYTES_A_CANDIDATE = 48

    def __init__(self, graph: NgramLexGraph, device: DeviceLike = None):
        g = graph
        self.g = g
        self.device = resolve_device(device)
        dev = self.device
        lm = g.lm
        V, SP, U = g.V, lm.SP, g.U
        S = g.S

        def tens(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        i64, f32 = torch.int64, torch.float32
        # --- slot -> state fold tables --------------------------------
        hist_ext = np.concatenate([g.unit_hist,
                                   [g.uni_state(V)]]).astype(np.int64)
        self._hist_ext = tens(hist_ext, i64)
        # when every LM state has exactly one slot (single-pronunciation
        # lexicons: unit (p, h) <-> state h, the begin slot <-> <s>) the
        # slot -> state fold is a gather by the inverse permutation
        self._hist_inv = None
        if len(hist_ext) == S and len(np.unique(hist_ext)) == S:
            inv = np.empty(S, np.int64)
            inv[hist_ext] = np.arange(S)
            self._hist_inv = tens(inv, i64)
        # --- virtual-context rows -------------------------------------
        # All explicit arcs by SOURCE state with ENCODED destinations:
        # dst < SP = pair state, dst in [SP, SP+V) = folded to
        # uni(dst-SP).  Sources: pair states (trigram arcs) and uni
        # states (bigram arcs into pair states + folded bigrams).  Each
        # virtual row holds one source and <= D of its arcs; the pool is
        # selected over rows.
        D = self.VC_D
        m2 = np.nonzero(lm.ent_bi_cost < BIG / 2)[0]
        src_all = np.concatenate([
            lm.tri_src.astype(np.int64),
            SP + lm.pair_u[m2].astype(np.int64),
            SP + lm.fold_src.astype(np.int64)])
        dst_all = np.concatenate([
            lm.tri_dst.astype(np.int64), m2.astype(np.int64),
            SP + lm.fold_dst.astype(np.int64)])
        cost_all = np.concatenate([
            lm.tri_cost, lm.ent_bi_cost[m2], lm.fold_cost]
        ).astype(np.float32)
        n_rows = 0
        if len(src_all):
            order = np.argsort(src_all, kind="stable")
            s_s, d_s, c_s = src_all[order], dst_all[order], cost_all[order]
            new_grp = np.empty(len(s_s), bool)
            new_grp[0] = True
            new_grp[1:] = s_s[1:] != s_s[:-1]
            grp_start = np.maximum.accumulate(
                np.where(new_grp, np.arange(len(s_s)), 0))
            pos = np.arange(len(s_s)) - grp_start
            gid = np.cumsum(new_grp) - 1
            grp_rows = -(-np.bincount(gid) // D)
            grp_row_off = np.concatenate([[0], np.cumsum(grp_rows)[:-1]])
            row_of_arc = grp_row_off[gid] + pos // D
            col_of_arc = pos % D
            n_rows = int(grp_rows.sum())
        n_vc = max(8, n_rows)
        vc_src = np.full(n_vc, S, np.int64)        # the INF row by default
        vc_dst = np.zeros((n_vc, D), np.int64)
        vc_cost = np.full((n_vc, D), BIG, np.float32)
        if n_rows:
            vc_src[row_of_arc] = s_s
            vc_dst[row_of_arc, col_of_arc] = d_s
            vc_cost[row_of_arc, col_of_arc] = c_s
        self.VC = n_vc
        self._vc_src = tens(vc_src, i64)
        self._vc_dst = tens(vc_dst, i64)
        self._vc_cost = tens(vc_cost, f32)
        # --- per-unit constants ---------------------------------------
        self._unit_is_pair = tens(g.unit_hist < SP, torch.bool)
        self._unit_pair = tens(np.where(g.unit_hist < SP, g.unit_hist, 0),
                               i64)
        self._unit_uni_word = tens(g.unit_word, i64)
        self._unit_pron_cost = tens(
            g.pron_cost[g.unit_var].astype(np.float32)[:, None], f32)
        self._uni = tens(lm.uni, f32)
        self._bo1 = tens(lm.bo1, f32)
        # --- pairs-of-word reduction tree -----------------------------
        # The backoff closure needs, for every word w, the min over pair
        # states (u, w) of sval + bo2: a segmented min, computed as a
        # static FOLD_D-ary gather tree over the pairs sorted by word.
        # Value and slot planes ride the tree together, so the winner's
        # traceback slot falls out without a scatter.
        D2 = self.FOLD_D
        perm = np.argsort(lm.pair_v, kind="stable")
        counts = np.bincount(lm.pair_v, minlength=V).astype(np.int64)
        # identity when the LM numbers pairs sorted by word (it does)
        self._fold_perm = None if SP == 0 or (perm == np.arange(SP)).all() \
            else tens(perm, i64)
        self._bo2_sorted = tens(lm.bo2[perm][:, None], f32) if SP else None
        levels: List[np.ndarray] = []
        cur_counts = counts
        cur_off = np.concatenate([[0], np.cumsum(cur_counts)])
        cur_len = SP
        while SP and cur_counts.max(initial=0) > 1:
            new_counts = -(-cur_counts // D2)
            R = int(new_counts.sum())
            row_word = np.repeat(np.arange(V), new_counts)
            new_off = np.concatenate([[0], np.cumsum(new_counts)])
            row_in_word = np.arange(R, dtype=np.int64) - new_off[row_word]
            base = cur_off[row_word] + row_in_word * D2
            cand = base[:, None] + np.arange(D2)[None, :]
            valid = cand < (cur_off[row_word]
                            + cur_counts[row_word])[:, None]
            levels.append(np.where(valid, cand, cur_len))
            cur_counts = new_counts
            cur_off = new_off
            cur_len = R
        # per-word entry of the last level (the sentinel cur_len for a
        # word without pairs); index V (the BOS uni state) takes the
        # direct value
        fin = np.where(cur_counts > 0, cur_off[:-1], cur_len)
        self._fold_levels = [tens(lv, i64) for lv in levels]
        self._fold_fin = tens(np.concatenate([fin, [cur_len]]), i64)
        # --- row and root constants -----------------------------------
        pad_big = np.where(g.row_unit < 0, BIG, 0.0).astype(np.float32)
        fr = np.nonzero(g.row_is_first)[0]
        self._first_rows = tens(fr, i64)
        self._first_units = tens(g.row_unit[fr], i64)
        self._row_unit = tens(np.maximum(g.row_unit, 0), i64)
        self._row_first = tens(g.row_is_first, torch.bool)
        self._pdf_fwd_row = tens(g.pdf_fwd_row, i64)
        self._pdf_self_row = tens(g.pdf_self_row, i64)
        self._fwd_extra = tens((g.tr_fwd_row + pad_big)[:, None], f32)
        self._self_extra = tens((g.tr_self_row + pad_big)[:, None], f32)
        self._end_row = tens(np.maximum(g.end_row, 0), i64)
        self._end_is_row = tens(g.end_row >= 0, torch.bool)
        self._pdf_end = tens(g.pdf_end, i64)
        self._tr_end = tens(g.tr_end[:, None], f32)
        self._pdf_root_self = tens(g.pdf_root_self, i64)
        self._tr_root_self = tens(g.tr_root_self[:, None], f32)
        self._eos_slot = tens(g.eos_of_slot()[:, None], f32)
        self._nosil = float(np.float32(g.nosil_cost if g.use_sil else 0.0))
        # made once: a host tensor copied in the frame loop would wait for
        # the card
        self._bit_weights = tens(1 << np.arange(8), torch.uint8).view(1, 8, 1)

    # ------------------------------------------------------------------
    def _fold_slots(self, rmin: torch.Tensor, pick_sil: torch.Tensor):
        """Slots (roots and shadows, (U+1, B)) -> LM-state values and
        encoded slots (slot * 2 + from_sil), (S, B).  Among equal
        values the larger encoded slot wins (the reference's scatter
        max)."""
        g = self.g
        S, U = g.S, g.U
        B = rmin.shape[1]
        if self._hist_inv is not None:
            inv = self._hist_inv
            sval = rmin.index_select(0, inv)
            sarg = inv[:, None].to(torch.int32) * 2 + \
                pick_sil.index_select(0, inv).to(torch.int32)
            return sval, sarg
        idx = self._hist_ext[:, None].expand(U + 1, B)
        sval = torch.full((S, B), float(INF), device=rmin.device)
        sval.scatter_reduce_(0, idx, rmin, "amin")
        slot = torch.arange(U + 1, dtype=torch.int32,
                            device=rmin.device)[:, None]
        enc = slot * 2 + pick_sil.to(torch.int32)
        won = torch.where(rmin == sval.index_select(0, self._hist_ext),
                          enc, -1)
        sarg = torch.full((S, B), -1, dtype=torch.int32, device=rmin.device)
        sarg.scatter_reduce_(0, idx, won, "amax")
        return sval, sarg

    def _backoff(self, sval: torch.Tensor, sarg: torch.Tensor):
        """Per uni state the min of its direct value and of its pair
        states' values + bo2 (the fold tree; among equal values the
        smaller encoded slot wins) -> unival, uslot (V+1, B)."""
        SP = self.g.lm.SP
        uni_direct = sval[SP:]
        if not SP:
            return uni_direct, sarg[SP:]
        B = sval.shape[1]
        dev = sval.device
        pv, ps = sval[:SP], sarg[:SP]
        if self._fold_perm is not None:
            pv = pv.index_select(0, self._fold_perm)
            ps = ps.index_select(0, self._fold_perm)
        inf_row = torch.full((1, B), float(INF), device=dev)
        sent_row = torch.full((1, B), SLOT_SENTINEL, dtype=torch.int32,
                              device=dev)
        vplane = torch.cat([pv + self._bo2_sorted, inf_row], 0)
        splane = torch.cat([ps, sent_row], 0)
        for lv in self._fold_levels:
            R, D2 = lv.shape
            flat = lv.reshape(-1)
            v2 = vplane.index_select(0, flat).view(R, D2, B)
            s2 = splane.index_select(0, flat).view(R, D2, B)
            vmin = v2.amin(dim=1)
            smin = torch.where(v2 == vmin[:, None, :], s2,
                               SLOT_SENTINEL).amin(dim=1)
            vplane = torch.cat([vmin, inf_row], 0)
            splane = torch.cat([smin, sent_row], 0)
        pair_val_w = vplane.index_select(0, self._fold_fin)
        pair_slot_w = splane.index_select(0, self._fold_fin)
        take_pair = pair_val_w < uni_direct
        return (torch.where(take_pair, pair_val_w, uni_direct),
                torch.where(take_pair, pair_slot_w, sarg[SP:]))

    def _lm_fold(self, roots: torch.Tensor, sil: torch.Tensor):
        """Block 1, the LM fold: slots (roots and silence shadows,
        (U+1, B)) -> their min rmin and whether a shadow gave it
        (pick_sil), the LM states' values and encoded slots (S, B), the
        backoff tree's unival and uslot (V+1, B), and the null state's
        value and slot (B,)."""
        g = self.g
        radj = roots + self._nosil
        if g.use_sil:
            rmin = torch.minimum(radj, sil)
            pick_sil = sil < radj
        else:
            rmin = radj
            pick_sil = torch.zeros_like(radj, dtype=torch.bool)
        sval, sarg = self._fold_slots(rmin, pick_sil)
        unival, uslot = self._backoff(sval, sarg)
        nv_cand = unival + self._bo1[:, None]
        nval = nv_cand.amin(dim=0)
        nslot = uslot.gather(0, nv_cand.argmin(dim=0)[None, :])[0]
        return rmin, pick_sil, sval, sarg, unival, uslot, nval, nslot

    def _expand(self, rmin, sval, sarg, unival, uslot, nval, K: int,
                beam: float):
        """Block 2, the pooled arc expansion: each lane's K best
        virtual-context rows within the beam, their arcs scatter-min'd
        into the entry plane (SP+V, B), and the entry cost of every unit
        (U, B).  -> (ent_unit, the pool's rows (B, K), values (B, K) and
        encoded source slots (B, K))."""
        g = self.g
        V, SP, S = g.V, g.lm.SP, g.S
        B = rmin.shape[1]
        dev = rmin.device
        lane = torch.arange(B, device=dev)
        sval_ext = torch.cat([sval[:SP], unival,
                              torch.full((1, B), float(INF), device=dev)], 0)
        vvals = sval_ext.index_select(0, self._vc_src)        # (VC, B)
        cutoff = rmin.amin(dim=0) + beam
        vm = torch.where(vvals <= cutoff[None, :], vvals, float(INF))
        ids, vals = self._select(vm, K)                        # (B, K)
        dsts = self._vc_dst[ids]                               # (B, K, D)
        cand = vals[:, :, None] + self._vc_cost[ids]
        ent_all = torch.full(((SP + V) * B,), float(INF), device=dev)
        ent_all.scatter_reduce_(0, (dsts * B + lane[:, None, None]
                                    ).reshape(-1), cand.reshape(-1), "amin")
        ent_all = ent_all.view(SP + V, B)
        psrc = self._vc_src[ids]                               # (B, K)
        pslot = torch.where(
            psrc < SP,
            sarg.view(-1)[psrc.clamp(0, S - 1) * B + lane[:, None]],
            uslot.reshape(-1)[(psrc - SP).clamp(0, V) * B + lane[:, None]])
        ent_uni_w = torch.minimum(nval[None, :] + self._uni[:, None],
                                  ent_all[SP:])                # (V, B)
        ent_unit = torch.where(
            self._unit_is_pair[:, None],
            ent_all.index_select(0, self._unit_pair),
            ent_uni_w.index_select(0, self._unit_uni_word)) \
            + self._unit_pron_cost
        return ent_unit, ids, vals, pslot

    def _rows(self, cost, am_t, ent_unit):
        """Block 3, the row relaxation.  -> (new cost (Nr, B), bit-packed
        decisions (Nr/8, B))."""
        new_cost, take_fwd = self._relax_rows(cost, am_t, ent_unit)
        return new_cost, self._pack_bits(take_fwd, self.g.Nr // 8)

    def _roots(self, cost, roots, sil, am_t, ent_unit):
        """Block 4, roots and silence shadows.  -> (roots (U+1, B),
        shadows (U+1, B), bit-packed root and shadow decisions)."""
        UB = _round_up(self.g.U + 1, 8) // 8
        roots_new, _, take_end = self._relax_roots(cost, roots, am_t,
                                                   ent_unit)
        end_bits = self._pack_bits(take_end, UB)
        if not self.g.use_sil:
            return roots_new, sil, end_bits, torch.zeros_like(end_bits)
        sil_new, sil_take = self._relax_sil(roots, sil, am_t)
        return roots_new, sil_new, end_bits, self._pack_bits(sil_take, UB)

    def _frame(self, cost, roots, sil, am_t, act, K: int, beam: float,
               outs: Dict[str, torch.Tensor], t: int):
        """One frame: cost (Nr, B), roots and sil (U+1, B), am_t (P, B)
        (costs, -scale x loglikes), act (B,) -> the new planes; the
        frame's decisions and pool are written into outs[...][t]."""
        rmin, _, sval, sarg, unival, uslot, nval, nslot = self._lm_fold(
            roots, sil)
        ent_unit, ids, vals, pslot = self._expand(rmin, sval, sarg, unival,
                                                  uslot, nval, K, beam)
        new_cost, row_bits = self._rows(cost, am_t, ent_unit)
        roots_new, sil_new, end_bits, sil_bits = self._roots(
            cost, roots, sil, am_t, ent_unit)
        for name, value in (("row_bits", row_bits), ("end_bits", end_bits),
                            ("sil_bits", sil_bits), ("ids", ids),
                            ("vals", vals), ("pslot", pslot), ("nval", nval),
                            ("nslot", nslot)):
            outs[name][t] = value
        keep = act[None, :]
        return (torch.where(keep, new_cost, cost),
                torch.where(keep, roots_new, roots),
                torch.where(keep, sil_new, sil))

    def _forward(self, am: torch.Tensor, active: torch.Tensor, K: int,
                 beam: float,
                 carry: Optional[Tuple[torch.Tensor, ...]] = None):
        """am (T, P, B) costs, active (T, B), carry: the (cost (Nr, B),
        roots (U+1, B), shadows (U+1, B)) to resume from, or None for a
        fresh start at the begin slot -> ((cost, roots, shadows) after
        the last frame, the per-frame dumps: row_bits (T, Nr/8, B),
        end_bits and sil_bits (T, UB, B) uint8; ids (T, B, K) int64,
        vals (T, B, K) f32, pslot (T, B, K) int32, nval (T, B) f32 and
        nslot (T, B) int32)."""
        g = self.g
        Nr, U = g.Nr, g.U
        T, _, B = am.shape
        dev = self.device
        UB = _round_up(U + 1, 8) // 8
        outs = {
            "row_bits": torch.empty((T, Nr // 8, B), dtype=torch.uint8,
                                    device=dev),
            "end_bits": torch.empty((T, UB, B), dtype=torch.uint8,
                                    device=dev),
            "sil_bits": torch.empty((T, UB, B), dtype=torch.uint8,
                                    device=dev),
            "ids": torch.empty((T, B, K), dtype=torch.int64, device=dev),
            "vals": torch.empty((T, B, K), dtype=torch.float32, device=dev),
            "pslot": torch.empty((T, B, K), dtype=torch.int32, device=dev),
            "nval": torch.empty((T, B), dtype=torch.float32, device=dev),
            "nslot": torch.empty((T, B), dtype=torch.int32, device=dev),
        }
        if carry is None:
            cost = torch.full((Nr, B), float(INF), device=dev)
            roots = torch.full((U + 1, B), float(INF), device=dev)
            roots[U] = 0.0
            sil = torch.full((U + 1, B), float(INF), device=dev)
        else:
            cost, roots, sil = carry
        for t in range(T):
            cost, roots, sil = self._frame(cost, roots, sil, am[t],
                                           active[t], K, beam, outs, t)
        return (cost, roots, sil), outs

    def _follow(self, outs: Dict[str, torch.Tensor], active: torch.Tensor,
                final_state: torch.Tensor):
        """Walk the dumps backward from each lane's final state -> (the
        state before frame 0 (B,), states (T, B): the state after each
        frame)."""
        g = self.g
        SP, U, Nr = g.lm.SP, g.U, g.Nr
        D = self.VC_D
        root0, begin, sil0 = Nr, Nr + U, Nr + U + 1
        T, B = outs["nval"].shape
        dev = self.device
        lane = torch.arange(B, device=dev)

        def unpack(bits, idx):
            byte = bits[idx >> 3, lane].to(torch.int64)
            return (byte >> (idx & 7)) & 1

        states = torch.empty((T, B), dtype=torch.int64, device=dev)
        cur = final_state
        for t in range(T - 1, -1, -1):
            states[t] = cur
            is_row = cur < Nr
            is_shadow = cur >= sil0
            is_begin = cur == begin
            n_c = cur.clamp(0, Nr - 1)
            u_c = (cur - root0).clamp(0, U - 1)
            # the entry source of the unit a row or a root state was
            # entered into: the pool candidate set is exactly what the
            # forward scatter-min reduced, so the values match bitwise
            u_i = torch.where(is_row, self._row_unit[n_c], u_c)
            w_i = self._unit_uni_word[u_i]
            pair_i = self._unit_is_pair[u_i]
            target = torch.where(pair_i, self._unit_pair[u_i], SP + w_i)
            ids = outs["ids"][t]
            cand = outs["vals"][t][:, :, None] + self._vc_cost[ids]
            candw = torch.where(self._vc_dst[ids] == target[:, None, None],
                                cand, float(INF)).reshape(B, -1)
            k_win = candw.argmin(dim=1) // D
            cmin = candw.amin(dim=1)
            enc_p = outs["pslot"][t][lane, k_win].to(torch.int64)
            # uni-history units: the null-state backoff route competes
            # with the folded explicit arcs
            use_pool = pair_i | (cmin < outs["nval"][t] + self._uni[w_i])
            enc = torch.where(use_pool, enc_p,
                              outs["nslot"][t].to(torch.int64))
            slot = enc >> 1
            entry = torch.where((enc & 1) == 1, sil0 + slot,
                                torch.where(slot == U, begin, root0 + slot))
            bit = unpack(outs["row_bits"][t], n_c)
            row_prev = torch.where(
                bit == 1, torch.where(self._row_first[n_c], entry, cur - 1),
                cur)
            te = unpack(outs["end_bits"][t], u_c)
            root_prev = torch.where(
                te == 1, torch.where(self._end_is_row[u_c],
                                     self._end_row[u_c], entry), cur)
            us = (cur - sil0).clamp(0, U)
            st = unpack(outs["sil_bits"][t], us)
            sh_prev = torch.where(
                st == 1, torch.where(us == U, begin, root0 + us), cur)
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
        Nr, U = g.Nr, g.U
        fin_root = roots + self._eos_slot
        fin_sil = sil + self._eos_slot if g.use_sil else \
            torch.full_like(fin_root, float(INF))
        allfin = torch.cat([fin_root, fin_sil], 0)
        best_i = allfin.argmin(dim=0)
        final_state = torch.where(
            best_i <= U, torch.where(best_i == U, Nr + U, Nr + best_i),
            Nr + U + 1 + (best_i - (U + 1)))
        return final_state, allfin.amin(dim=0)

    # ------------------------------------------------------------------
    def decode_batch(self, loglikes, acoustic_scale: float = 1.0,
                     lengths: Optional[Sequence[int]] = None,
                     prune_k: Optional[int] = None,
                     prune_beam: float = float(BIG),
                     exact_topk: bool = True,
                     stats: Optional[Dict[str, float]] = None
                     ) -> List[Hyp]:
        """loglikes (B, T, P): a tensor (moved to this decoder's device)
        or a numpy array; lengths (B,) valid frames; prune_k: pool rows
        a lane and frame (all by default: exact); prune_beam: only
        sources within this beam of the frame's best enter the pool.
        The selection is always exact (`exact_topk` is accepted for the
        reference's interface: its approximate selection is a TPU
        device).  stats, when given, receives fwd_s, fol_s and
        traceback_s.  -> per lane (word ids, tids, cost), or None when
        no path survives."""
        g = self.g
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, P = ll.shape
        if P < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {P} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        K = min(self.VC if prune_k is None else int(prune_k), self.VC)
        beam = float(prune_beam)
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            t0 = time.perf_counter()
            (_, roots, sil), outs = self._forward(am, active, K, beam)
            if stats is not None:
                self._sync()
                stats["fwd_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            final_state, best_cost = self._final_state(roots, sil)
            first_state, states = self._follow(outs, active, final_state)
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
        trajectory."""
        g = self.g
        Nr, U = g.Nr, g.U
        root0, begin, sil0 = Nr, Nr + U, Nr + U + 1
        T, B = states.shape
        if T == 0:
            return [None if best_cost[b] >= INF / 2 else ([], [],
                    float(best_cost[b])) for b in range(B)]
        prev = np.vstack([first_state[None, :], states[:-1]])
        cur = states
        self_loop = prev == cur
        is_row = cur < Nr
        is_shadow = cur >= sil0
        n_c = np.clip(cur, 0, Nr - 1)
        u_c = np.clip(cur - root0, 0, U - 1)
        tid_all = np.where(
            is_row,
            np.where(self_loop, g.tid_self_row[n_c], g.tid_fwd_row[n_c]),
            np.where(
                is_shadow,
                np.where(self_loop, g.sil_tid_self, g.sil_tid_fwd),
                np.where(self_loop, g.tid_root_self[u_c], g.tid_end[u_c])))
        word_all = np.where(
            is_row & ~self_loop & g.row_is_first[n_c] & (prev >= Nr),
            g.unit_word[np.maximum(g.row_unit[n_c], 0)] + 1,
            np.where(~is_row & ~is_shadow & ~self_loop
                     & (g.end_row[u_c] < 0) & (prev >= Nr),
                     g.unit_word[u_c] + 1, 0))
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
    # Lattice mode: device dumps of fixed capacity a frame (the top-K
    # entry-source pool and the top-L word-end events of each lane), a
    # device gather of each surviving event's top-J entry candidates, and
    # host assembly of each lane's word lattice (alpha and beta over the
    # captured event graph, pruning, FST emission).
    # ==================================================================
    @staticmethod
    def _raw_slot(enc: torch.Tensor) -> torch.Tensor:
        """Encoded slots (slot * 2 + from_sil, -1 for none, SLOT_SENTINEL
        for an empty fold entry) -> the lattice step's raw slots (-1,
        slot, IBIG).  The map is monotone, so the winners of the encoded
        fold are the winners of a fold over raw slots."""
        return torch.where(enc == SLOT_SENTINEL, IBIG, enc >> 1)

    def _frame_lattice(self, planes, am_t, act, t: int, K: int, L: int,
                       outs: Dict[str, torch.Tensor], force: torch.Tensor):
        """One lattice frame.  planes = (cost, ent (Nr, B), roots, sil,
        sil_t (U+1, B)): ent holds each row's entry frame, sil_t each
        shadow's start frame.  The entry values are the best-path step's
        (same blocks, same op sequence) with an infinite pool beam.
        force (B,) holds a unit whose word end, where the frame has it,
        enters the L events whatever its rank (-1: none).
        The frame's dumps are written into outs[...][t]; -> the new
        planes."""
        cost, ent, roots, sil, sil_t = planes
        g = self.g
        U = g.U
        B = cost.shape[1]
        lane = torch.arange(B, device=cost.device)
        tf = float(t)
        rmin, pick_sil, sval, sarg, unival, uslot, nval, nslot = \
            self._lm_fold(roots, sil)
        src_time = torch.where(pick_sil, sil_t, tf - 1.0)
        ent_unit, ids, vals, pslot = self._expand(
            rmin, sval, sarg, unival, uslot, nval, K, float(BIG))
        pslot = self._raw_slot(pslot)
        nslot = self._raw_slot(nslot)
        # the reference gathers these at the clipped raw slot (an empty
        # entry reads slot U's planes), so they are not the encoded bit
        pidx = pslot.clamp(0, U).to(torch.int64) * B + lane[:, None]
        nidx = nslot.clamp(0, U).to(torch.int64) * B + lane
        # --- rows, with the entry frame riding beside the cost ---------
        new_cost, take_fwd = self._relax_rows(cost, am_t, ent_unit)
        fwd_ent = torch.roll(ent, 1, 0)
        fwd_ent[self._first_rows] = tf
        new_ent = torch.where(take_fwd, fwd_ent, ent)
        # --- roots and the frame's top-L word-end events ---------------
        roots_new, end_cand, take_end = self._relax_roots(cost, roots, am_t,
                                                          ent_unit)
        arr_te = torch.where(self._end_is_row[:, None],
                             ent.index_select(0, self._end_row), tf)
        evq = torch.where(take_end & act[None, :], end_cand, float(INF))
        units = torch.arange(U, device=cost.device)[:, None]
        forced = (units == force[None, :]) & (evq < INF / 2)
        ev_ids, _ = self._select(torch.where(forced, float("-inf"), evq), L)
        ev_val = evq.reshape(-1)[ev_ids * B + lane[:, None]]       # (B, L)
        if g.use_sil:
            sil_new, sil_take = self._relax_sil(roots, sil, am_t)
            sil_t_new = torch.where(sil_take, tf - 1.0, sil_t)
        else:
            sil_new, sil_t_new = sil, sil_t
        for name, value in (
                ("ids", ids), ("vals", vals), ("pslot", pslot),
                ("p_fromsil", pick_sil.reshape(-1)[pidx]),
                ("p_srct", src_time.reshape(-1)[pidx]),
                ("nval", nval), ("nslot", nslot),
                ("n_fromsil", pick_sil.reshape(-1)[nidx]),
                ("n_srct", src_time.reshape(-1)[nidx]),
                ("n_srcval", rmin.reshape(-1)[nidx]),
                ("ev_ids", ev_ids), ("ev_val", ev_val),
                ("ev_te", arr_te.reshape(-1)[ev_ids * B + lane[:, None]])):
            outs[name][t] = value
        keep = act[None, :]
        return tuple(torch.where(keep, new, old) for new, old in (
            (new_cost, cost), (new_ent, ent), (roots_new, roots),
            (sil_new, sil), (sil_t_new, sil_t)))

    def _forward_lattice(self, am: torch.Tensor, active: torch.Tensor,
                         K: int, L: int, force: torch.Tensor):
        """am (T, P, B) costs, active (T, B), force (T, B) (see
        _frame_lattice) -> final roots, shadows and shadow start frames
        (U+1, B) and the per-frame dumps: the pool ids (T, B, K) int64,
        vals f32, pslot int32 (raw slots), p_fromsil bool and p_srct f32;
        the null state's nval, nslot, n_fromsil, n_srct and n_srcval
        (T, B); the word-end events ev_ids (T, B, L) int64, ev_val and
        ev_te (entry frame) f32."""
        g = self.g
        Nr, U = g.Nr, g.U
        T, _, B = am.shape
        dev = self.device
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        shapes = {"ids": ((B, K), i64), "vals": ((B, K), f32),
                  "pslot": ((B, K), i32), "p_fromsil": ((B, K), torch.bool),
                  "p_srct": ((B, K), f32), "nval": ((B,), f32),
                  "nslot": ((B,), i32), "n_fromsil": ((B,), torch.bool),
                  "n_srct": ((B,), f32), "n_srcval": ((B,), f32),
                  "ev_ids": ((B, L), i64), "ev_val": ((B, L), f32),
                  "ev_te": ((B, L), f32)}
        outs = {name: torch.empty((T,) + shape, dtype=dtype, device=dev)
                for name, (shape, dtype) in shapes.items()}
        roots = torch.full((U + 1, B), float(INF), device=dev)
        roots[U] = 0.0
        planes = (torch.full((Nr, B), float(INF), device=dev),
                  torch.zeros((Nr, B), device=dev), roots,
                  torch.full((U + 1, B), float(INF), device=dev),
                  torch.full((U + 1, B), -1.0, device=dev))
        for t in range(T):
            planes = self._frame_lattice(planes, am[t], active[t], t, K, L,
                                         outs, force[t])
        _, _, roots, sil, sil_t = planes
        return roots, sil, sil_t, outs

    def _viterbi_word_ends(self, am: torch.Tensor, active: torch.Tensor,
                           K: int) -> torch.Tensor:
        """The best-path pass over the lattice's pool (K rows, no beam:
        the lattice frame's entry values, bit for bit) -> (T, B) int64:
        the unit whose word end the lane's best path takes in each frame,
        or -1."""
        Nr, U = self.g.Nr, self.g.U
        (_, roots, sil), outs = self._forward(am, active, K, float(BIG))
        first, states = self._follow(outs, active,
                                     self._final_state(roots, sil)[0])
        prev = torch.cat([first[None], states[:-1]], 0)
        is_end = (states >= Nr) & (states < Nr + U) & (prev != states) \
            & active
        return torch.where(is_end, states - Nr, -1)

    def _finals(self, roots, sil, sil_t):
        """Each lane's Lf = min(32, 2(U+1)) smallest root and shadow
        finals, on the device.  -> (values (B, Lf), slots, is_shadow,
        start frames of the shadows (B, Lf), each lane's best (B,))."""
        g = self.g
        U = g.U
        B = roots.shape[1]
        fin_root = roots + self._eos_slot
        fin_sil = sil + self._eos_slot if g.use_sil else \
            torch.full_like(fin_root, float(INF))
        fi, fv = self._select(torch.cat([fin_root, fin_sil], 0),
                              min(32, 2 * (U + 1)))
        is_sil = fi >= U + 1
        slot = torch.where(is_sil, fi - (U + 1), fi)
        lane = torch.arange(B, device=roots.device)
        stime = sil_t.reshape(-1)[slot.clamp(0, U) * B + lane[:, None]]
        return fv, slot, is_sil, stime, fv.amin(dim=1)

    def _event_pools(self, outs, st, su, sb, J: int):
        """The top-J entry candidates of each survivor (t = its entry
        frame, unit, lane) over its frame's K*D pool arcs and the null
        state's backoff, in chunks of at most POOL_CHUNK_BYTES of
        candidate planes.  Ties go to the first column (argmin).  -> numpy
        (S, J) value (f32), slot (int32), start frame (f32), from-silence
        flag and LM cost (f32)."""
        K = outs["ids"].shape[2]
        per = max(1, self.POOL_CHUNK_BYTES
                  // ((K * self.VC_D + 1) * self.POOL_BYTES_A_CANDIDATE))
        parts = []
        for lo in range(0, len(st), per):
            idx = [torch.as_tensor(x[lo:lo + per], device=self.device)
                   for x in (st, su, sb)]
            parts.append([c.cpu().numpy()
                          for c in self._pool_chunk(outs, *idx, J)])
        return [np.concatenate(cols) for cols in zip(*parts)]

    def _pool_chunk(self, outs, st, su, sb, J: int):
        """_event_pools on one chunk of survivors (device tensors)."""
        SP = self.g.lm.SP
        D = self.VC_D
        ids_k = outs["ids"][st, sb]                       # (S, K)
        vals_k = outs["vals"][st, sb]
        n, K = ids_k.shape
        pair = self._unit_is_pair[su]
        word = self._unit_uni_word[su]
        target = torch.where(pair, self._unit_pair[su], SP + word)
        cand = vals_k[:, :, None] + self._vc_cost[ids_k]  # (S, K, D)
        cand = torch.where(self._vc_dst[ids_k] == target[:, None, None],
                           cand, float(INF)).reshape(n, K * D)
        nv = outs["nval"][st, sb]
        bo_val = torch.where(pair, float(INF), nv + self._uni[word])
        all_v = torch.cat([cand, bo_val[:, None]], 1) \
            + self._unit_pron_cost[su]
        # the LM cost of a candidate (pronunciation cost excluded): an
        # explicit arc's cost, or the null state's value less its source
        # root's value plus the unigram
        bo_lm = (nv - outs["n_srcval"][st, sb]) + self._uni[word]
        n_planes = [outs[k][st, sb] for k in ("nslot", "n_srct",
                                              "n_fromsil")]
        p_planes = [outs[k][st, sb] for k in ("pslot", "p_srct",
                                              "p_fromsil")]
        picks = []
        for _ in range(J):
            a = all_v.argmin(dim=1)
            col = a[:, None]
            is_bo = a == K * D
            k = (a // D).clamp(max=K - 1)[:, None]
            slot, stime, fromsil = (
                torch.where(is_bo, nq, pq.gather(1, k)[:, 0])
                for nq, pq in zip(n_planes, p_planes))
            lm = torch.where(
                is_bo, bo_lm,
                cand.gather(1, col.clamp(max=K * D - 1))[:, 0]
                - vals_k.gather(1, k)[:, 0])
            picks.append((all_v.gather(1, col)[:, 0], slot, stime, fromsil,
                          lm))
            all_v.scatter_(1, col, float(INF))
        return [torch.stack(p, 1) for p in zip(*picks)]

    def decode_batch_lattice(self, loglikes, acoustic_scale: float = 1.0,
                             lengths: Optional[Sequence[int]] = None,
                             lattice_beam: float = 8.0, J: int = 4,
                             prune_k: Optional[int] = 128,
                             event_cap: int = 64,
                             stats: Optional[Dict[str, float]] = None):
        """Word-lattice decode: per lane a Lattice (ilabel = tid, olabel =
        word id, weights (graph, acoustic)) pruned to `lattice_beam`, or
        None.  Per frame at most `event_cap` word-end events and `prune_k`
        entry sources (within an infinite beam) are captured, so the
        dumps are of fixed capacity; alpha + beta pruning of the captured
        event graph is exact.  The events are each frame's cheapest word
        ends, and the word ends of the lane's best path (found by a
        best-path pass over the same pool first) whatever their rank, so
        the lattice holds the path decode_batch gives with that pool.
        stats, when given, receives fwd_s (both passes), n_events, pool_s
        and assemble_s."""
        g = self.g
        U = g.U
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, P = ll.shape
        if P < g.num_pdfs:
            raise ValueError(f"loglikes pdf dim {P} < {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None else [T] * B,
                             np.int64)
        K = min(self.VC if prune_k is None else int(prune_k), self.VC)
        L = int(min(event_cap, U))
        with torch.inference_mode():
            am = (ll * (-acoustic_scale)).permute(1, 2, 0).contiguous()
            active = torch.as_tensor(
                np.arange(T)[:, None] < lengths[None, :], device=self.device)
            t0 = time.perf_counter()
            force = self._viterbi_word_ends(am, active, K)
            roots, sil, sil_t, outs = self._forward_lattice(am, active, K, L,
                                                            force)
            fin = [x.cpu().numpy() for x in self._finals(roots, sil, sil_t)]
            ev_ids, ev_val, ev_te = (outs[k].cpu().numpy()
                                     for k in ("ev_ids", "ev_val", "ev_te"))
        fv, fslot, fsil, fst, best = fin
        fst = np.rint(fst).astype(np.int64)
        ev_te = np.rint(ev_te).astype(np.int64)
        if stats is not None:
            stats["fwd_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        # ---- survivors: every captured event of an active frame ------
        # The reference keeps only events within the beam of the lane's
        # final best.  That drops every event whose path still has a
        # negative cost to go, and with a chain model's outputs costs
        # fall frame by frame: its lattices come out empty.  The
        # assembly's alpha + beta pruning of the captured event graph is
        # exact, so it alone decides what stays.
        okev = (ev_val < INF / 2) \
            & (np.arange(T)[:, None, None] < lengths[None, :, None])
        st_, sb_, sl_ = np.nonzero(okev)
        su_ = ev_ids[st_, sb_, sl_].astype(np.int64)
        sv_ = ev_val[st_, sb_, sl_].astype(np.float64)
        ste_ = ev_te[st_, sb_, sl_]
        # one survivor a (t, unit, lane), in key order as the reference
        # orders them (an exact selection repeats none)
        ukey = (sb_ * T + st_) * (U + 1) + su_
        _, first = np.unique(ukey, return_index=True)
        st_, sb_, su_, sv_, ste_ = (x[first] for x in
                                    (st_, sb_, su_, sv_, ste_))
        if stats is not None:
            stats["n_events"] = len(st_)
        if len(st_) == 0:
            return [None] * B
        # ---- top-J entry pools at the survivors -----------------------
        with torch.inference_mode():
            ecv, esl, est, efs, elm = self._event_pools(outs, ste_, su_,
                                                        sb_, J)
        del outs
        ecv = ecv.astype(np.float64)
        esl = esl.astype(np.int64)
        est = np.rint(est).astype(np.int64)
        efs = efs.astype(bool)
        elm = elm.astype(np.float64)
        if stats is not None:
            stats["pool_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        # ---- per-lane node graphs (phase 1: structure only) -----------
        plans = []
        lane_off = np.searchsorted(sb_, np.arange(B + 1))   # lane-major
        for b in range(B):
            sel = slice(lane_off[b], lane_off[b + 1])
            fin_b = [(float(fv[b, i]), int(fslot[b, i]), bool(fsil[b, i]),
                      int(fst[b, i]))
                     for i in range(fv.shape[1]) if fv[b, i] < INF / 2]
            plans.append(self._plan_lane(
                b, int(lengths[b]), st_[sel], su_[sel], sv_[sel],
                ste_[sel], ecv[sel], esl[sel], est[sel], efs[sel],
                elm[sel], fin_b, float(best[b]), lattice_beam))
        # ---- one batched device gather of self-span acoustics ---------
        # differences of two float64 prefix sums (the reference's are
        # float32, whose rounding at |sum| ~ 1e3-1e4 reaches 1e-3: enough
        # to flip a pruning decision between two devices)
        req = [p["span_req"] for p in plans if p is not None]
        if sum(len(r[0]) for r in req):
            t0s, t1s, pdfs, bs = (torch.as_tensor(
                np.concatenate([r[i] for r in req]), device=self.device)
                for i in range(4))
            with torch.inference_mode():
                am_cs = torch.cumsum(am.to(torch.float64), dim=0)
                vals_sp = (am_cs[t1s, pdfs, bs]
                           - am_cs[t0s, pdfs, bs]).cpu().numpy()
            del am_cs
        else:
            vals_sp = np.zeros(0)
        off = 0
        lats = []
        for p in plans:
            if p is None:
                lats.append(None)
                continue
            n = len(p["span_req"][0])
            # an arc from a node that no captured path reaches has
            # alpha - alpha = INF - INF: NaN, which fails every <= test,
            # so the arc is pruned
            with np.errstate(invalid="ignore"):
                lats.append(self._assemble_lane(p, vals_sp[off:off + n]))
            off += n
        if stats is not None:
            stats["assemble_s"] = time.perf_counter() - t0
        return lats

    def _plan_lane(self, b, Tb, st, su, sv, ste, ecv, esl, est, efs,
                   elm, fin_b, best, beam):
        """Phase-1 host planning for one lane: node set (events +
        referenced entry sources + final anchors), entry/self/final
        arc lists, and the (t0, t1, pdf) span-acoustic gather request.
        Returns None for an unreachable lane."""
        g = self.g
        U = g.U
        if Tb == 0 or len(st) == 0 or not np.isfinite(best) \
                or best >= INF / 2:
            return None
        cutoff = best + beam + 1e-4
        J = ecv.shape[1]
        # ---- candidate arcs (flattened over events x J; the exact
        # alpha+beta filter runs in phase 2 — no value pre-filter here
        # because beta can be negative with positive loglikes) ---------
        n_ev = len(st)
        ev_i = np.repeat(np.arange(n_ev), J)
        cand_v = ecv.reshape(-1)
        keep = cand_v < INF / 2
        # a_cost: alpha at dst via candidate j
        a_cost = sv[ev_i] - ecv[ev_i, 0] + cand_v
        ev_i = ev_i[keep]
        a_cost = a_cost[keep]
        c_slot = esl.reshape(-1)[keep]
        c_st = est.reshape(-1)[keep]
        c_fs = efs.reshape(-1)[keep]
        c_lm = elm.reshape(-1)[keep]
        src_is_start = (c_slot >= U) | (c_st < 0)
        # ---- node set -------------------------------------------------
        ev_key = su * (Tb + 1) + st
        src_key = np.where(src_is_start, -1, c_slot * (Tb + 1) + c_st)
        fin_keys = []
        for (val, slot, is_sil, stime) in fin_b:
            if val > cutoff or slot > U:
                continue
            if is_sil:
                if stime >= 0 and slot < U:
                    fin_keys.append(slot * (Tb + 1) + stime)
            elif slot < U:
                fin_keys.append(slot * (Tb + 1) + (Tb - 1))
        node_keys = np.unique(np.concatenate(
            [ev_key, src_key[src_key >= 0],
             np.asarray(fin_keys, np.int64)]))
        node_u = node_keys // (Tb + 1)
        node_t = node_keys % (Tb + 1)
        n = len(node_keys)
        # node alpha: arrival value at event nodes, else INF (filled
        # exactly along self-chains in phase 2)
        node_arr = np.full(n, np.inf)
        pos = np.searchsorted(node_keys, ev_key)
        node_arr[pos] = sv
        node_te = np.full(n, -1, np.int64)
        node_te[pos] = ste
        src_i = np.where(src_is_start, -1,
                         np.searchsorted(node_keys, src_key))
        # drop arcs referencing a nonexistent source node (possible
        # only if the source key computation raced the unique() — it
        # cannot, but guard)
        ok = src_is_start | ((src_i < n)
                             & (node_keys[np.maximum(src_i, 0)]
                                == src_key))
        ev_i, a_cost, c_slot, c_st, c_fs, c_lm, src_is_start, src_i = (
            x[ok] for x in (ev_i, a_cost, c_slot, c_st, c_fs, c_lm,
                            src_is_start, src_i))
        dst_i = np.searchsorted(node_keys, ev_key[ev_i])
        # ---- self-extension spans (consecutive same-unit nodes) ------
        same = node_u[1:] == node_u[:-1]
        ss = np.nonzero(same)[0]
        sd = ss + 1
        pdfs = g.pdf_root_self[node_u[ss]]
        span_req = (node_t[ss].astype(np.int64),
                    node_t[sd].astype(np.int64),
                    pdfs.astype(np.int64),
                    np.full(len(ss), b, np.int64))
        return dict(b=b, Tb=Tb, cutoff=cutoff, best=best,
                    node_keys=node_keys, node_u=node_u, node_t=node_t,
                    node_arr=node_arr, node_te=node_te,
                    ev_i=ev_i, a_cost=a_cost, c_slot=c_slot,
                    c_st=c_st, c_fs=c_fs, c_lm=c_lm,
                    src_is_start=src_is_start, src_i=src_i,
                    dst_i=dst_i, ss=ss, sd=sd, fin_b=fin_b,
                    span_req=span_req)

    def _assemble_lane(self, p, span_ac):
        """Phase-2 host assembly: exact alpha along self-chains, beta
        over the captured node graph, alpha+beta pruning, FST emission
        (ilabel=tid, olabel=word, weights (graph, acoustic))."""
        g = self.g
        U = g.U
        Tb, cutoff = p["Tb"], p["cutoff"]
        node_u, node_t = p["node_u"], p["node_t"]
        node_arr, node_te = p["node_arr"], p["node_te"]
        ss, sd = p["ss"], p["sd"]
        n = len(node_u)
        eos = g.eos_of_slot()                      # (U+1,)
        tr_self = np.asarray(g.tr_root_self, np.float64)
        s_cost = (node_t[sd] - node_t[ss]) * tr_self[node_u[ss]] \
            + span_ac
        # ---- alpha along chains (nodes sorted by (u, t)): Jacobi
        # relaxation over consecutive-node edges, one hop per pass
        # (vectorized; passes bounded by the longest per-unit chain)
        alpha = node_arr.copy()
        for _ in range(n):
            new = alpha[ss] + s_cost
            upd = new < alpha[sd] - 1e-12
            if not upd.any():
                break
            np.minimum.at(alpha, sd[upd], new[upd])
        # ---- beta ------------------------------------------------------
        beta = np.full(n, np.inf)
        last = node_t == Tb - 1
        beta[last] = eos[node_u[last]]
        fin_sil_arcs = []
        for (val, slot, is_sil, stime) in p["fin_b"]:
            if val > cutoff:
                continue
            if is_sil and slot < U and stime >= 0:
                i = np.searchsorted(p["node_keys"],
                                    slot * (Tb + 1) + stime)
                if i < n and p["node_keys"][i] == \
                        slot * (Tb + 1) + stime:
                    beta[i] = min(beta[i], val - alpha[i])
                    fin_sil_arcs.append((int(i), int(slot),
                                         int(stime), float(val)))
            elif is_sil and slot >= U:
                fin_sil_arcs.append((-1, int(slot), int(stime),
                                     float(val)))
        ev_i, a_cost = p["ev_i"], p["a_cost"]
        src_is_start, src_i, dst_i = (p["src_is_start"], p["src_i"],
                                      p["dst_i"])
        src_alpha = np.where(src_is_start, 0.0,
                             alpha[np.maximum(src_i, 0)])
        arc_delta = a_cost - src_alpha
        arc_src_t = np.where(src_is_start, -1,
                             node_t[np.maximum(src_i, 0)])
        # frame by frame from the last, over the self spans and the arcs
        # (start arcs excluded) whose source is in the frame: each edge
        # reads a node of a later frame, so a frame's edges are one
        # order-free min, grouped by one stable sort of their frames
        inner = ~src_is_start
        e_src = np.concatenate([ss, src_i[inner]])
        e_dst = np.concatenate([sd, dst_i[inner]])
        e_cost = np.concatenate([s_cost, arc_delta[inner]])
        e_t = np.concatenate([node_t[ss], arc_src_t[inner]])
        by_t = np.argsort(-e_t, kind="stable")
        e_src, e_dst, e_cost = e_src[by_t], e_dst[by_t], e_cost[by_t]
        _, starts = np.unique(-e_t[by_t], return_index=True)
        for lo, hi in zip(starts, np.append(starts[1:], len(by_t))):
            np.minimum.at(beta, e_src[lo:hi],
                          e_cost[lo:hi] + beta[e_dst[lo:hi]])
        keep_node = alpha + beta <= cutoff
        # ---- emit ------------------------------------------------------
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

        def emit_chain(cur, dst_state, u, te, t, olabel, graph, acous):
            e = int(g.end_row[u])
            k = len(g.prons[int(g.unit_var[u])])
            dur = t - te + 1
            tids = []
            if e >= 0:
                first_row = e - (k - 2)
                tids = [int(g.tid_fwd_row[r])
                        for r in range(first_row, e + 1)]
                tids += [int(g.tid_self_row[e])] * (dur - k)
            tids.append(int(g.tid_end[u]))
            for q, tid in enumerate(tids):
                lastq = q == len(tids) - 1
                nxt = dst_state if lastq else lat.add_state()
                wgt = (graph, acous) if q == 0 else (0.0, 0.0)
                lat.add_arc(cur, Arc(tid, olabel if q == 0 else 0,
                                     wgt, nxt))
                cur = nxt

        def emit_sil(cur, n_frames):
            for q in range(n_frames):
                nxt = lat.add_state()
                lat.add_arc(cur, Arc(
                    int(g.sil_tid_fwd if q == 0 else g.sil_tid_self),
                    0, (0.0, 0.0), nxt))
                cur = nxt
            return cur

        keep_arc = keep_node[dst_i] & \
            (src_is_start | keep_node[np.maximum(src_i, 0)]) & \
            (src_alpha + arc_delta + beta[dst_i] <= cutoff)
        for i in np.nonzero(keep_arc)[0]:
            u = int(node_u[dst_i[i]])
            t = int(node_t[dst_i[i]])
            te = int(node_te[dst_i[i]])
            src_t = int(p["c_st"][i])
            lm_cost = float(p["c_lm"][i])
            is_start = bool(src_is_start[i])
            cur = start if is_start else node_state(int(src_i[i]))
            dst = node_state(int(dst_i[i]))
            n_sil = (te - 1) - src_t
            var = int(g.unit_var[u])
            k = len(g.prons[var])
            dur = t - te + 1
            e = int(g.end_row[u])
            gcost = lm_cost + float(g.pron_cost[var]) \
                + float(g.tr_end[u])
            if e >= 0:
                first_row = e - (k - 2)
                gcost += float(np.sum(g.tr_fwd_row[first_row:e + 1]))
                gcost += (dur - k) * float(g.tr_self_row[e])
            if n_sil > 0:
                gcost += g.sil_cost + g.sil_tr_fwd + \
                    (n_sil - 1) * g.sil_tr_self
            elif g.use_sil:
                gcost += g.nosil_cost
            acous = float(arc_delta[i]) - gcost
            if n_sil > 0:
                cur = emit_sil(cur, n_sil)
            emit_chain(cur, dst, u, te, t,
                       int(g.unit_word[u]) + 1, gcost, acous)
        # self-extension arcs
        keep_span = keep_node[ss] & keep_node[sd] \
            & ~(alpha[ss] + s_cost + beta[sd] > cutoff)
        for k2 in np.nonzero(keep_span)[0]:
            i0, i1 = int(ss[k2]), int(sd[k2])
            cur = nodes.get(i0)
            if cur is None:
                continue
            u = int(node_u[i0])
            t0, t1 = int(node_t[i0]), int(node_t[i1])
            dstn = node_state(i1)
            gc = (t1 - t0) * float(tr_self[u])
            ac = float(span_ac[k2])
            for q in range(t0 + 1, t1 + 1):
                lastq = q == t1
                nxt = dstn if lastq else lat.add_state()
                wgt = (gc, ac) if q == t0 + 1 else (0.0, 0.0)
                lat.add_arc(cur, Arc(int(g.tid_root_self[u]), 0, wgt,
                                     nxt))
                cur = nxt
        # finals at last-frame nodes
        for i, s in list(nodes.items()):
            if int(node_t[i]) == Tb - 1:
                lat.set_final(s, (float(eos[int(node_u[i])]), 0.0))
        # final-silence arcs (trailing silence then eos)
        for (i, slot, stime, val) in fin_sil_arcs:
            if i >= 0 and i not in nodes:
                continue
            cur = start if i < 0 else nodes[i]
            src_alpha_f = 0.0 if i < 0 else float(alpha[i])
            n_frames = (Tb - 1) - stime
            if n_frames <= 0:
                continue
            gcost = g.sil_cost + g.sil_tr_fwd + \
                (n_frames - 1) * g.sil_tr_self
            eos_f = float(eos[min(slot, U)])
            acous = (val - eos_f - src_alpha_f) - gcost
            nxt = lat.add_state()
            lat.add_arc(cur, Arc(int(g.sil_tid_fwd), 0,
                                 (gcost, acous), nxt))
            for q in range(1, n_frames):
                nn = lat.add_state()
                lat.add_arc(nxt, Arc(int(g.sil_tid_self), 0,
                                     (0.0, 0.0), nn))
                nxt = nn
            lat.set_final(nxt, (eos_f, 0.0))
        connect(lat)
        if lat.num_states == 0 or lat.start is None:
            return None
        return lat
