"""Beam-sparse batched device decoder for large decoding graphs (port
of `kaldi_tpu/decoder/beam_sparse.py`; the reference's stand-in for
upstream's cudadecoder load-balanced beam search, cuda-decoder.h
ExpandArcs / PruneAndPreprocess / non-emitting iterations).

The frontier is a fixed-capacity set of K tokens per lane, and each
frame is a fixed sequence of dense steps:

  1. expand     -- gather the (K, D) padded out-arc rows of the active
                   states; add arc weight and scaled acoustics
  2. dedup      -- keep, per state, the cheapest candidate, then the K
                   cheapest states (`_dedup_min`)
  3. eps passes -- the same over the epsilon arc table, `eps_depth`
                   times (the longest eps path, found at build time)
  4. prune      -- the beam around the lane's minimum; costs are kept
                   relative to it

States with more than D out-arcs are split into eps-linked chains at
build time (`cap_out_degree`, language preserving).  Each frame's
(state, cost) frontier comes back to the host, which reconstructs the
best path by cost consistency against the degree-capped graph; where
that fails it warns and returns the words found so far, as the
reference does, and `stats["traceback_failures"]` counts it.

The port's layout: lanes are a batch axis, (B, K), in place of the
reference's vmap; one frame step serves all lanes, and every sort is a
stable sort along the lane's row (torch.sort(..., stable=True) over
(B, n)).  The reference's tie rules ride on XLA's sorts -- top_k (ties
to the lower index), lexsort by (state, cost) and a stable argsort --
and stable sorts give the same orders: by cost, then stably by state.
The arc tables stay float32 and int64 side by side (the reference
bitcasts the weights into one int32 table for its TPU gather).  The
decoder runs on the card unless built with device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base.logging import KaldiTpuError, log, warn
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst

INF = np.float32(1e30)


def cap_out_degree(fst: VectorFst, max_degree: int) -> VectorFst:
    """Split states with out-degree > max_degree into epsilon-linked
    chains so every state has at most max_degree out-arcs (the chain
    link consumes one slot). Language-preserving."""
    out = VectorFst(fst.semiring)
    for _ in range(fst.num_states):
        out.add_state()
    out.set_start(fst.start)
    for s in range(fst.num_states):
        out.finals[s] = fst.finals[s]
        arcs = list(fst.arcs[s])
        cur = s
        while len(arcs) > max_degree:
            head, arcs = arcs[:max_degree - 1], arcs[max_degree - 1:]
            for a in head:
                out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight,
                                     a.nextstate))
            nxt = out.add_state()
            out.add_arc(cur, Arc(EPS, EPS, 0.0, nxt))
            cur = nxt
        for a in arcs:
            out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight,
                                 a.nextstate))
    return out


@dataclass
class SparseDeviceGraph:
    """Padded per-state arc tables: emitting and epsilon separated
    (host arrays; the decoder copies them to its device)."""
    e_dst: np.ndarray      # (S, De) int32, self-pointing padding
    e_pdf: np.ndarray      # (S, De) int32 pdf-id, -1 padding
    e_olabel: np.ndarray   # (S, De) int32
    e_w: np.ndarray        # (S, De) float32, INF padding
    n_dst: np.ndarray      # (S, Dn)
    n_olabel: np.ndarray
    n_w: np.ndarray
    finals: np.ndarray     # (S,)
    start: int
    eps_depth: int
    fst: VectorFst         # degree-capped graph (host, for traceback)
    tid2pdf: np.ndarray

    @property
    def num_states(self) -> int:
        return self.e_dst.shape[0]

    @classmethod
    def build(cls, fst: VectorFst, tid2pdf: np.ndarray,
              max_degree: int = 16) -> "SparseDeviceGraph":
        g = cap_out_degree(fst, max_degree)
        S = g.num_states
        De = Dn = 1
        for s in range(S):
            De = max(De, sum(1 for a in g.arcs[s] if a.ilabel != EPS))
            Dn = max(Dn, sum(1 for a in g.arcs[s] if a.ilabel == EPS))
        e_dst = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, De))
        e_pdf = np.full((S, De), -1, np.int32)
        e_olabel = np.zeros((S, De), np.int32)
        e_w = np.full((S, De), INF, np.float32)
        n_dst = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, Dn))
        n_olabel = np.zeros((S, Dn), np.int32)
        n_w = np.full((S, Dn), INF, np.float32)
        tid2pdf = np.asarray(tid2pdf, np.int32)
        for s in range(S):
            ei = ni = 0
            for a in g.arcs[s]:
                if a.ilabel != EPS:
                    e_dst[s, ei] = a.nextstate
                    e_pdf[s, ei] = tid2pdf[a.ilabel]
                    e_olabel[s, ei] = a.olabel
                    e_w[s, ei] = a.weight
                    ei += 1
                else:
                    n_dst[s, ni] = a.nextstate
                    n_olabel[s, ni] = a.olabel
                    n_w[s, ni] = a.weight
                    ni += 1
        finals = np.array([float(w) if w != TropicalWeight.zero else INF
                           for w in g.finals], np.float32)
        # epsilon depth: longest path in the eps subgraph (must be a DAG)
        eps_depth = _eps_depth(g)
        log(f"SparseDeviceGraph: {S} states, De={De}, Dn={Dn}, "
            f"eps_depth={eps_depth}")
        return cls(e_dst, e_pdf, e_olabel, e_w, n_dst, n_olabel, n_w,
                   finals, g.start, eps_depth, g, tid2pdf)


def _eps_depth(fst: VectorFst) -> int:
    S = fst.num_states
    adj = [[] for _ in range(S)]
    indeg = np.zeros(S, np.int64)
    for s in range(S):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                adj[s].append(a.nextstate)
                indeg[a.nextstate] += 1
    from collections import deque
    depth = np.zeros(S, np.int64)
    dq = deque(np.nonzero(indeg == 0)[0].tolist())
    seen = 0
    while dq:
        s = dq.popleft()
        seen += 1
        for d in adj[s]:
            depth[d] = max(depth[d], depth[s] + 1)
            indeg[d] -= 1
            if indeg[d] == 0:
                dq.append(d)
    if seen < S:
        raise KaldiTpuError("beam_sparse: epsilon cycle in graph")
    return int(depth.max())


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def _dedup_min(states: torch.Tensor, costs: torch.Tensor,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per lane (row): keep, per unique state, the minimum-cost
    candidate; then the `capacity` cheapest into fixed slots.
    states (B, n) int64, costs (B, n) float32 -> (B, capacity) each.

    The reference's orders, by stable sorts: its top_k pre-filter to the
    2 * capacity cheapest (ties to the lower index) is the head of a
    stable sort by cost; its lexsort by (state, cost) is a stable sort
    by cost followed by a stable sort by state; its argsort of the
    deduplicated costs is stable."""
    n = costs.shape[1]
    if n > 2 * capacity:
        order = torch.sort(costs, dim=1, stable=True).indices[:,
                                                                :2 * capacity]
        costs, states = _take(costs, order), _take(states, order)
    order = torch.sort(costs, dim=1, stable=True).indices
    states, costs = _take(states, order), _take(costs, order)
    order = torch.sort(states, dim=1, stable=True).indices
    s_sorted, c_sorted = _take(states, order), _take(costs, order)
    first = torch.ones_like(s_sorted, dtype=torch.bool)
    first[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
    c_unique = torch.where(first, c_sorted,
                           torch.full_like(c_sorted, float(INF)))
    keep = torch.sort(c_unique, dim=1, stable=True).indices[:, :capacity]
    return _take(s_sorted, keep), _take(c_unique, keep)


class BeamSparseDecoder:
    """Batched fixed-capacity beam decoder over a SparseDeviceGraph.
    `stats` after a call: the lanes and frames decoded, the host
    traceback's failures."""

    def __init__(self, graph: SparseDeviceGraph, beam: float = 16.0,
                 capacity: int = 2048, device: DeviceLike = None):
        self.g = graph
        self.beam = float(beam)
        self.capacity = int(capacity)
        self.device = dev = resolve_device(device)
        real = graph.e_w[graph.e_w < INF / 2]
        real_n = graph.n_w[graph.n_w < INF / 2]
        self._min_arc_w = min(
            0.0,
            float(real.min()) if real.size else 0.0,
            float(real_n.min()) if real_n.size else 0.0)
        def t(a, dtype):
            return torch.from_numpy(np.asarray(a)).to(dev, dtype)
        self._e_dst = t(graph.e_dst, torch.int64)
        self._e_pdf = t(graph.e_pdf, torch.int64)
        self._e_w = t(graph.e_w, torch.float32)
        self._n_dst = t(graph.n_dst, torch.int64)
        self._n_w = t(graph.n_w, torch.float32)
        self.stats: Dict[str, int] = {}

    # -- device steps ---------------------------------------------------------

    def _eps_pass(self, states, costs):
        B, K = states.shape
        dsts = self._n_dst[states].view(B, -1)
        cand = (costs[:, :, None] + self._n_w[states]).view(B, -1)
        return _dedup_min(torch.cat([states, dsts], 1),
                          torch.cat([costs, cand], 1), self.capacity)

    def _frame_step(self, states, costs, am_t):
        """One frame over all lanes: am_t (B, P) scaled acoustic costs."""
        B, K = states.shape
        pdfs = self._e_pdf[states]                        # (B, K, De)
        ac = torch.gather(am_t, 1, pdfs.clamp(min=0).view(B, -1)) \
            .view(pdfs.shape)
        cand = (costs[:, :, None] + self._e_w[states]) \
            + torch.where(pdfs >= 0, ac, torch.full_like(ac, float(INF)))
        s1, c1 = _dedup_min(self._e_dst[states].view(B, -1),
                            cand.view(B, -1), K)
        for _ in range(self.g.eps_depth):
            s1, c1 = self._eps_pass(s1, c1)
        mn = c1.min(dim=1).values
        c1 = torch.where(c1 <= (mn + self.beam)[:, None], c1,
                         torch.full_like(c1, float(INF)))
        shift = torch.where(torch.isfinite(mn) & (mn < INF / 2), mn,
                            torch.zeros_like(mn))
        return s1, c1 - shift[:, None], mn

    def _decode_device(self, ac: torch.Tensor):
        """ac: (B, T, P) scaled acoustic costs on the device -> the
        per-frame frontiers (T, B, K) states and costs, each frame's
        minima (T, B), and the initial frontier (B, K)."""
        g, K = self.g, self.capacity
        B, T, _ = ac.shape
        dev = ac.device
        states = torch.full((B, K), g.num_states - 1, dtype=torch.int64,
                            device=dev)
        costs = torch.full((B, K), float(INF), dtype=torch.float32,
                           device=dev)
        states[:, 0] = g.start
        costs[:, 0] = 0.0
        for _ in range(g.eps_depth):
            states, costs = self._eps_pass(states, costs)
        s0, c0 = states, costs
        fr_s = torch.empty((T, B, K), dtype=torch.int32, device=dev)
        fr_c = torch.empty((T, B, K), dtype=torch.float32, device=dev)
        shifts = torch.empty((T, B), dtype=torch.float32, device=dev)
        for t in range(T):
            states, costs, mn = self._frame_step(states, costs, ac[:, t])
            fr_s[t], fr_c[t], shifts[t] = states, costs, mn
        return fr_s, fr_c, shifts, s0, c0

    # -- public API -----------------------------------------------------------

    def decode(self, loglikes: np.ndarray, acoustic_scale: float = 0.1
               ) -> Optional[Tuple[List[int], List[int], float]]:
        """Returns (olabel sequence (words), state sequence, total cost)
        for the best path, or None if no final state is reachable."""
        out = self.decode_batch(np.asarray(loglikes)[None], acoustic_scale)
        if out[0] is None:
            warn("beam_sparse: no reachable final state")
        return out[0]

    def decode_batch(self, loglikes: np.ndarray,
                     acoustic_scale: float = 0.1) -> List[Optional[Tuple]]:
        """Lane-parallel batch decode (cudadecoder lanes): loglikes
        (B, T, P), every lane T frames; the frame steps run over all
        lanes on the device, tracebacks on the host per lane."""
        g = self.g
        ll = np.asarray(loglikes)
        ac_np = -ll * acoustic_scale
        with torch.inference_mode():
            ac = torch.from_numpy(np.ascontiguousarray(ac_np, np.float32)) \
                .to(self.device)
            fr_s, fr_c, shifts, s0, c0 = (
                x.cpu().numpy() for x in self._decode_device(ac))
        fr_s = fr_s.astype(np.int64).transpose(1, 0, 2)
        fr_c = fr_c.transpose(1, 0, 2)
        shifts = shifts.T
        self.stats = dict(lanes=int(ll.shape[0]), frames=int(ll.shape[1]),
                          traceback_failures=0)
        out: List[Optional[Tuple]] = []
        am_np = ll * acoustic_scale
        for b in range(fr_s.shape[0]):
            abs_c = fr_c[b] + np.cumsum(
                np.where(np.isfinite(shifts[b]) & (shifts[b] < INF / 2),
                         shifts[b], 0.0))[:, None]
            total = abs_c[-1] + g.finals[fr_s[b, -1]]
            best = int(np.argmin(total))
            if total[best] >= INF / 2:
                out.append(None)
                continue
            words, states = self._traceback(fr_s[b], abs_c, s0[b], c0[b],
                                            am_np[b], best)
            out.append((words, states, float(total[best])))
        return out

    # -- host traceback ------------------------------------------------------

    def _eps_paths_to(self, src: int, max_depth: int):
        """Yield (dst, cost, olabels) for eps paths from src (incl.
        empty path)."""
        out = [(src, 0.0, [])]
        frontier = [(src, 0.0, [])]
        for _ in range(max_depth):
            nxt = []
            for s, c, labs in frontier:
                for a in self.g.fst.arcs[s]:
                    if a.ilabel == EPS:
                        item = (a.nextstate, c + a.weight,
                                labs + ([a.olabel] if a.olabel else []))
                        nxt.append(item)
                        out.append(item)
            frontier = nxt
            if not frontier:
                break
        return out

    def _pairs(self):
        """The (emitting arc, eps path after it) pairs of every state of
        the degree-capped graph, in the order the reference's traceback
        tries them (a state's arcs in order, each arc's eps paths in
        `_eps_paths_to`'s order), as flat arrays with CSR rows by state:
        the arc's weight and pdf, the path's last state and cost, and
        the words of the pair (the arc's olabel, then the path's)."""
        if getattr(self, "_pair_cache", None) is not None:
            return self._pair_cache
        g = self.g
        paths: Dict[int, list] = {}
        w, pdf, dst, ec, words, cnt = [], [], [], [], [], []
        for s in range(g.fst.num_states):
            n = 0
            for a in g.fst.arcs[s]:
                if a.ilabel == EPS:
                    continue
                if a.nextstate not in paths:
                    paths[a.nextstate] = self._eps_paths_to(a.nextstate,
                                                            g.eps_depth)
                head = [a.olabel] if a.olabel else []
                for d, c, labs in paths[a.nextstate]:
                    w.append(a.weight)
                    pdf.append(int(g.tid2pdf[a.ilabel]))
                    dst.append(d)
                    ec.append(c)
                    words.append(head + labs)
                    n += 1
            cnt.append(n)
        cnt = np.asarray(cnt, np.int64)
        self._pair_cache = (np.concatenate([[0], np.cumsum(cnt)[:-1]])
                            .astype(np.int64), cnt,
                            np.asarray(w, np.float64),
                            np.asarray(pdf, np.int64),
                            np.asarray(dst, np.int64),
                            np.asarray(ec, np.float64), words)
        return self._pair_cache

    def _traceback(self, fr_s, abs_c, s0, c0, am, best):
        """The reference's host traceback by cost consistency: back from
        the best final token, a frame at a time, the first (predecessor
        token, emitting arc, eps path) that explains the current cost
        within `tol`, the predecessors tried cheapest first (np.argsort)
        and only while their cost can still explain it.  The tries of a
        frame run as arrays (`_pairs`); the first hit is the reference's
        loop's."""
        T = fr_s.shape[0]
        tol = 1e-2 + 1e-6 * T
        # early-termination bound: a predecessor can only explain the
        # current cost if pc + min_step_t <= cur_cost; steps can be
        # NEGATIVE when acoustic scores are positive log-likes, so the
        # bound must use the frame's minimum possible step
        min_arc_w = self._min_arc_w
        beg, cnt, pw, ppdf, pdst, pec, pwords = self._pairs()
        cur_state = int(fr_s[-1, best])
        cur_cost = float(abs_c[-1, best])
        rev_words: List[int] = []
        rev_states: List[int] = [cur_state]
        for t in range(T - 1, -1, -1):
            prev_s = fr_s[t - 1] if t > 0 else s0
            prev_c = abs_c[t - 1] if t > 0 else c0
            ac = -am[t]
            min_step = min_arc_w + float(np.min(ac))
            order = np.argsort(prev_c)
            pcs = prev_c[order].astype(np.float64)
            stop = (pcs >= INF / 2) | (pcs + min_step > cur_cost + tol)
            m = int(np.argmax(stop)) if stop.any() else len(order)
            ps = np.asarray(prev_s)[order[:m]].astype(np.int64)
            n = cnt[ps]
            run = np.repeat(np.cumsum(n) - n, n)
            idx = np.repeat(beg[ps], n) + np.arange(int(n.sum())) - run
            base = np.repeat(pcs[:m], n) + pw[idx] \
                + ac[ppdf[idx]].astype(np.float64)
            hit = (base <= cur_cost + tol) & (pdst[idx] == cur_state) \
                & (np.abs(base + pec[idx] - cur_cost) <= tol)
            if not hit.any():
                warn(f"beam_sparse traceback: consistency failure at "
                     f"frame {t}")
                self.stats["traceback_failures"] += 1
                break
            j = int(np.argmax(hit))
            k = int(np.searchsorted(np.cumsum(n), j, side="right"))
            rev_words.extend(reversed(pwords[idx[j]]))
            cur_state, cur_cost = int(ps[k]), float(pcs[k])
            rev_states.append(cur_state)
        return list(reversed(rev_words)), list(reversed(rev_states))
