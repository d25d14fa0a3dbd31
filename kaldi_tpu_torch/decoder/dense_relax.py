"""Dense-relaxation batched device decoder: exact Viterbi over a whole
decoding graph as fixed-shape gather/min steps (port of
`kaldi_tpu/decoder/dense_relax.py`; the reference's stand-in for
upstream's cudadecoder, src/cudadecoder/cuda-decoder.h:171).

The whole cost vector stays dense and every state's in-arcs are relaxed
each frame:

    next_cost[s] = min_d  cost[src[s,d]] + w[s,d] + am_t[pdf[s,d]]

with no sorts, hashing or beams, so the search is exact.  Build-time
transformations (host, numpy, the reference's code):

  * epsilon removal: eps arcs are composed into emitting arcs by
    closure (the eps subgraph must be a DAG); the olabel strings of the
    closure paths stay on the host per arc.  `_eps_closure` keeps the 64
    cheapest targets of a state, with a warning, as the reference does;
    `DenseDeviceGraph.eps_truncated` counts the states it cut.
  * in-degree tiering: states are renumbered by in-degree bucket
    (`_TIER_CAPS`), each tier a (S_t, D_t) padded table.

The device side is PyTorch ops (no hand kernel: the reference computes
this in XLA, not Pallas).  Each frame is one gather of all tiers' slots
from the concatenated [cost; am_t] table, one add, one min per tier and
one select for the lanes' lengths; the frame loop is a Python loop.
Costs are (S, B), lanes fastest.  Traceback is two-pass: the forward
keeps the cost vector every `chunk` frames; then, chunk by chunk in
reverse, the chunk is recomputed keeping the int16 argmin slot of each
(frame, state, lane) (the first minimum, as `jnp.argmin`), and the
pointers are followed back on the device.  Only the (T, B) chosen arc
ids come to the host, which maps them to words.

The decoder runs on the card unless built with device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base.logging import KaldiTpuError, log, warn
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.fstext.fst import EPS, TropicalWeight, VectorFst

INF = np.float32(1e30)

# in-degree bucket capacities (last bucket is extended to the true max);
# fine-grained low buckets keep the padded-slot count (= gather size,
# the per-frame cost driver) close to the true arc count
_TIER_CAPS = (2, 4, 8, 16, 32, 64, 128, 512, 4096)


def _eps_closure(fst: VectorFst, max_expansion: int = 64,
                 stats: Optional[Dict[str, int]] = None
                 ) -> List[List[Tuple[int, float, Tuple[int, ...]]]]:
    """Per state: list of (dst, cost, olabels) for all eps paths from
    the state, including the empty path. Eps subgraph must be a DAG.
    A state whose closure reaches more than `max_expansion` targets keeps
    the cheapest, with a warning, as the reference does; each such state
    adds one to `stats["eps_truncated"]`."""
    S = fst.num_states
    eps_arcs: List[List] = [[] for _ in range(S)]
    order_ready = True
    for s in range(S):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                eps_arcs[s].append(a)
    # topological order of the eps subgraph
    indeg = np.zeros(S, np.int64)
    for s in range(S):
        for a in eps_arcs[s]:
            indeg[a.nextstate] += 1
    from collections import deque
    dq = deque(np.nonzero(indeg == 0)[0].tolist())
    topo: List[int] = []
    while dq:
        s = dq.popleft()
        topo.append(s)
        for a in eps_arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                dq.append(a.nextstate)
    if len(topo) < S and any(eps_arcs[s] for s in range(S)):
        raise KaldiTpuError("dense_relax: epsilon cycle in graph")
    closure: List[List[Tuple[int, float, Tuple[int, ...]]]] = \
        [[] for _ in range(S)]
    for s in reversed(topo):
        # keep per-destination minimum cost only
        best: Dict[int, Tuple[float, Tuple[int, ...]]] = {s: (0.0, ())}
        for a in eps_arcs[s]:
            lab = (a.olabel,) if a.olabel else ()
            for (d2, c2, o2) in closure[a.nextstate]:
                c = float(a.weight) + c2
                if d2 not in best or c < best[d2][0]:
                    best[d2] = (c, lab + o2)
        if len(best) > max_expansion:
            # keep the cheapest targets; drop the tail with a warning
            items = sorted(best.items(), key=lambda kv: kv[1][0])
            best = dict(items[:max_expansion])
            warn(f"dense_relax: eps closure of state {s} truncated to "
                 f"{max_expansion} targets")
            if stats is not None:
                stats["eps_truncated"] = stats.get("eps_truncated", 0) + 1
        closure[s] = [(d, c, o) for d, (c, o) in best.items()]
    return closure


@dataclass
class DenseDeviceGraph:
    """Tiered in-arc tables over renumbered states (device side) plus
    host-side label/metadata for traceback assembly."""
    # per tier: (src (S_t, D_t) int32, pdf (S_t, D_t) int32,
    #            w (S_t, D_t) f32) in renumbered ids; padded entries
    # have src=0, pdf=0, w=INF
    tiers: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    # flat per-state arc records, concatenated in renumbered-state
    # order: offsets (S+1,), src_flat, ilabel_flat, and olabel tuples
    row_offset: np.ndarray       # (S+1,) int64 into flat arc arrays
    src_flat: np.ndarray         # (A,) int32 renumbered src
    ilabel_flat: np.ndarray      # (A,) int32 original ilabel (tid)
    olabels_flat: List[Tuple[int, ...]]  # per arc olabel string
    init_cost: np.ndarray        # (S,) f32 closure costs from start
    init_olabels: List[Tuple[int, ...]]  # per state
    final_cost: np.ndarray       # (S,) f32 effective final costs
    final_olabels: List[Tuple[int, ...]]
    perm: np.ndarray             # old id -> new id
    inv_perm: np.ndarray         # new id -> old id
    num_pdfs: int
    eps_truncated: int = 0       # states whose eps closure was cut

    @property
    def num_states(self) -> int:
        return len(self.init_cost)

    @classmethod
    def build(cls, fst: VectorFst, tid2pdf: Sequence[int],
              num_pdfs: Optional[int] = None) -> "DenseDeviceGraph":
        tid2pdf = np.asarray(tid2pdf, np.int32)
        S = fst.num_states
        trunc: Dict[str, int] = {}
        closure = _eps_closure(fst, stats=trunc)
        # eps-removed emitting in-arc lists per ORIGINAL destination:
        # (src, pdf, weight, ilabel, olabels)
        in_arcs: List[List[Tuple[int, int, float, int, Tuple[int, ...]]]] = \
            [[] for _ in range(S)]
        for s in range(S):
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    continue
                pdf = int(tid2pdf[a.ilabel])
                lab = (a.olabel,) if a.olabel else ()
                for (d2, c2, o2) in closure[a.nextstate]:
                    in_arcs[d2].append((s, pdf, float(a.weight) + c2,
                                        a.ilabel, lab + o2))
        # initial closure from start; effective finals through closure
        init_cost = np.full(S, INF, np.float32)
        init_olabels: List[Tuple[int, ...]] = [() for _ in range(S)]
        for (d, c, o) in closure[fst.start]:
            if c < init_cost[d]:
                init_cost[d] = c
                init_olabels[d] = o
        final_cost = np.full(S, INF, np.float32)
        final_olabels: List[Tuple[int, ...]] = [() for _ in range(S)]
        raw_final = np.array(
            [float(w) if w != TropicalWeight.zero else INF
             for w in fst.finals], np.float32)
        for s in range(S):
            for (d, c, o) in closure[s]:
                tot = c + raw_final[d]
                if tot < final_cost[s]:
                    final_cost[s] = tot
                    final_olabels[s] = o

        # tier assignment by in-degree; renumber contiguously per tier
        indeg = np.array([len(a) for a in in_arcs], np.int64)
        max_indeg = int(indeg.max()) if S else 0
        if max_indeg > 32767:
            raise KaldiTpuError(
                f"dense_relax: state in-degree {max_indeg} exceeds the "
                "int16 traceback-slot limit")
        caps = [c for c in _TIER_CAPS if c < max_indeg] + [max(max_indeg, 1)]
        tier_of = np.searchsorted(np.asarray(caps), indeg, side="left")
        order = np.argsort(tier_of, kind="stable")
        perm = np.empty(S, np.int64)
        perm[order] = np.arange(S)
        inv_perm = order

        tiers: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        row_offset = np.zeros(S + 1, np.int64)
        src_flat: List[int] = []
        ilabel_flat: List[int] = []
        olabels_flat: List[Tuple[int, ...]] = []
        new_id = 0
        for ti, cap in enumerate(caps):
            members = order[tier_of[order] == ti]
            St = len(members)
            if St == 0:
                tiers.append((np.zeros((0, cap), np.int32),
                              np.zeros((0, cap), np.int32),
                              np.full((0, cap), INF, np.float32)))
                continue
            src = np.zeros((St, cap), np.int32)
            pdf = np.zeros((St, cap), np.int32)
            w = np.full((St, cap), INF, np.float32)
            for r, old in enumerate(members):
                arcs = in_arcs[old]
                for d, (a_src, a_pdf, a_w, a_il, a_ol) in enumerate(arcs):
                    src[r, d] = perm[a_src]
                    pdf[r, d] = a_pdf
                    w[r, d] = a_w
                    src_flat.append(perm[a_src])
                    ilabel_flat.append(a_il)
                    olabels_flat.append(a_ol)
            tiers.append((src, pdf, w))
            new_id += St
        # per-state flat-arc offsets in new-id order (arcs were appended
        # in exactly this order above)
        counts = np.array([len(in_arcs[inv_perm[n]]) for n in range(S)],
                          np.int64)
        row_offset = np.concatenate([[0], np.cumsum(counts)])

        P = int(num_pdfs if num_pdfs is not None
                else (tid2pdf.max() + 1 if len(tid2pdf) else 1))
        tot_padded = sum(t[0].shape[0] * t[0].shape[1] for t in tiers)
        log(f"DenseDeviceGraph: {S} states, {len(src_flat)} eps-removed "
            f"arcs ({tot_padded} padded slots), tiers "
            f"{[(t[0].shape) for t in tiers]}, max in-degree {max_indeg}")
        return cls(tiers,
                   row_offset,
                   np.asarray(src_flat, np.int32),
                   np.asarray(ilabel_flat, np.int32),
                   olabels_flat,
                   init_cost[inv_perm].astype(np.float32),
                   [init_olabels[o] for o in inv_perm],
                   final_cost[inv_perm].astype(np.float32),
                   [final_olabels[o] for o in inv_perm],
                   perm.astype(np.int64), inv_perm.astype(np.int64), P,
                   trunc.get("eps_truncated", 0))

    @classmethod
    def from_arrays(cls, src: np.ndarray, dst: np.ndarray,
                    pdf: np.ndarray, olabel: np.ndarray,
                    weight: np.ndarray, finals: np.ndarray, start: int,
                    ilabel: Optional[np.ndarray] = None,
                    num_pdfs: Optional[int] = None) -> "DenseDeviceGraph":
        """Vectorized constructor for large eps-free graphs given flat
        arc arrays (the CSR-pack path, reference cuda-fst.h:62 CudaFst).
        finals: (S,) costs with INF for non-final states."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        pdf = np.asarray(pdf, np.int32)
        olabel = np.asarray(olabel, np.int32)
        weight = np.asarray(weight, np.float32)
        finals = np.asarray(finals, np.float32)
        if ilabel is None:
            ilabel = pdf
        ilabel = np.asarray(ilabel, np.int32)
        S = len(finals)
        A = len(src)
        indeg = np.bincount(dst, minlength=S).astype(np.int64)
        max_indeg = int(indeg.max()) if S else 0
        if max_indeg > 32767:
            raise KaldiTpuError(
                f"dense_relax: state in-degree {max_indeg} exceeds the "
                "int16 traceback-slot limit")
        caps = ([c for c in _TIER_CAPS if c < max_indeg]
                + [max(max_indeg, 1)])
        tier_of = np.searchsorted(np.asarray(caps), indeg, side="left")
        order = np.argsort(tier_of, kind="stable")      # new-id order
        perm = np.empty(S, np.int64)
        perm[order] = np.arange(S)

        # sort arcs by (new dst id, stable) and compute slot ranks
        new_dst = perm[dst]
        arc_order = np.argsort(new_dst, kind="stable")
        nd_sorted = new_dst[arc_order]
        # slot index within each state's run
        first_of_run = np.concatenate([[0], np.cumsum(
            np.bincount(nd_sorted, minlength=S))[:-1]])
        slot = np.arange(A) - first_of_run[nd_sorted]

        tiers: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        tier_row0 = {}
        row = 0
        for ti, cap in enumerate(caps):
            members = np.nonzero(tier_of[order] == ti)[0]  # new ids
            St = len(members)
            tier_row0[ti] = (row, cap)
            tsrc = np.zeros((St, cap), np.int32)
            tpdf = np.zeros((St, cap), np.int32)
            tw = np.full((St, cap), INF, np.float32)
            tiers.append((tsrc, tpdf, tw))
            row += St
        # fill tiers vectorized: each arc's (tier, local row, slot)
        arc_tier = tier_of[order][nd_sorted]
        for ti, cap in enumerate(caps):
            m = arc_tier == ti
            if not m.any():
                continue
            r0, _cap = tier_row0[ti]
            rows_local = nd_sorted[m] - r0
            sl = slot[m]
            ids = arc_order[m]
            tsrc, tpdf, tw = tiers[ti]
            tsrc[rows_local, sl] = perm[src[ids]]
            tpdf[rows_local, sl] = pdf[ids]
            tw[rows_local, sl] = weight[ids]

        row_offset = np.concatenate(
            [[0], np.cumsum(indeg[order])]).astype(np.int64)
        src_flat = perm[src[arc_order]].astype(np.int32)
        ilabel_flat = ilabel[arc_order]
        ol_sorted = olabel[arc_order]
        olabels_flat = [(int(o),) if o else () for o in ol_sorted]

        init_cost = np.full(S, INF, np.float32)
        init_cost[perm[start]] = 0.0
        P = int(num_pdfs if num_pdfs is not None else pdf.max() + 1)
        log(f"DenseDeviceGraph.from_arrays: {S} states, {A} arcs, tiers "
            f"{[t[0].shape for t in tiers]}, max in-degree {max_indeg}")
        empty: List[Tuple[int, ...]] = [()] * S
        return cls(tiers, row_offset, src_flat, ilabel_flat, olabels_flat,
                   init_cost, list(empty), finals[order].astype(np.float32),
                   list(empty), perm, order.astype(np.int64), P)


class DenseViterbiDecoder:
    """Batched exact Viterbi over a DenseDeviceGraph.

    decode_batch(loglikes (B, T, P)) -> per-lane (words, ilabels,
    total_cost) -- the words are olabels along the best path, ilabels
    the per-frame input labels (transition-ids for HCLG graphs).
    `stats` after a call: the padded slots and eps-removed arcs of the
    tables, the states whose eps closure was cut, the arcs chosen by
    the traceback and the frames relaxed."""

    def __init__(self, graph: DenseDeviceGraph, chunk: int = 32,
                 device: DeviceLike = None):
        self.g = graph
        self.chunk = int(chunk)
        self.device = dev = resolve_device(device)
        S = graph.num_states
        # fused gather index: all tiers' src slots, then their pdf slots
        # offset by S into the concatenated [cost; am_t] table
        idx = [t[0].reshape(-1) for t in graph.tiers] \
            + [t[1].reshape(-1) + S for t in graph.tiers]
        self._idx = torch.from_numpy(
            np.concatenate(idx).astype(np.int64)).to(dev)
        self._w = torch.from_numpy(np.concatenate(
            [t[2].reshape(-1) for t in graph.tiers]).astype(np.float32)
        ).to(dev)[:, None]
        self._shapes = [t[0].shape for t in graph.tiers
                        if t[0].shape[0] > 0]
        self._n_slots = sum(a * b for a, b in self._shapes)
        self._init_cost = torch.from_numpy(graph.init_cost).to(dev)
        self._final_cost = torch.from_numpy(graph.final_cost).to(dev)
        self._row_offset = torch.from_numpy(
            graph.row_offset.astype(np.int64)).to(dev)
        self._src_flat = torch.from_numpy(
            graph.src_flat.astype(np.int64)).to(dev)
        self.stats: Dict[str, int] = {}

    # -- device steps ---------------------------------------------------------

    def _relax(self, cost: torch.Tensor, am_t: torch.Tensor,
               with_argmin: bool):
        """cost (S, B), am_t (P, B) -> new cost (S, B) [+ int16 argmin
        slots (S, B)]."""
        n = self._n_slots
        rows = torch.cat([cost, am_t], 0).index_select(0, self._idx)
        cand = (rows[:n] + self._w) + rows[n:]
        B = cost.shape[1]
        parts, amins = [], []
        off = 0
        for St, Dt in self._shapes:
            c = cand[off:off + St * Dt].view(St, Dt, B)
            if with_argmin:
                v, i = c.min(dim=1)
                parts.append(v)
                amins.append(i.to(torch.int16))
            else:
                parts.append(c.amin(dim=1))
            off += St * Dt
        new = torch.cat(parts, 0)
        if with_argmin:
            return new, torch.cat(amins, 0)
        return new

    def _forward(self, am: torch.Tensor, active: torch.Tensor, C: int,
                 n_chunks: int):
        """-> (last cost (S, B), the cost at each chunk's start)."""
        B = am.shape[2]
        cost = self._init_cost[:, None].expand(-1, B).contiguous()
        ckpts = []
        for t in range(n_chunks * C):
            if t % C == 0:
                ckpts.append(cost)
            new = self._relax(cost, am[t], False)
            cost = torch.where(active[t][None, :], new, cost)
        return cost, ckpts

    def _backward(self, ckpts, am: torch.Tensor, active: torch.Tensor,
                  C: int, cur: torch.Tensor):
        """Recompute each chunk in reverse keeping the argmin slots, and
        follow them from `cur` (B,) -> (first states (B,), chosen arc ids
        (T_pad, B), -1 where a lane was inactive)."""
        S, B = ckpts[0].shape
        n_arcs = int(self._src_flat.shape[0])
        lane = torch.arange(B, device=cur.device)
        amins = torch.empty((C, S, B), dtype=torch.int16, device=cur.device)
        arcs = torch.empty((len(ckpts) * C, B), dtype=torch.int64,
                           device=cur.device)
        for k in range(len(ckpts) - 1, -1, -1):
            c = ckpts[k]
            for i in range(C):
                t = k * C + i
                new, amins[i] = self._relax(c, am[t], True)
                c = torch.where(active[t][None, :], new, c)
            for i in range(C - 1, -1, -1):
                t = k * C + i
                act = active[t]
                slot = amins[i][cur, lane].to(torch.int64)
                arc = self._row_offset[cur] + slot
                # padded-slot argmins (unreachable lanes) must not index
                # out of the flat arc array
                src = self._src_flat[arc.clamp(0, max(n_arcs - 1, 0))]
                arcs[t] = torch.where(act, arc, torch.full_like(arc, -1))
                cur = torch.where(act, src, cur)
        return cur, arcs

    # -- public API -----------------------------------------------------------

    def decode_batch(self, loglikes, acoustic_scale: float = 0.1,
                     lengths: Optional[Sequence[int]] = None
                     ) -> List[Optional[Tuple[List[int], List[int], float]]]:
        """loglikes: (B, T, P) log-likelihood scores (host array or
        tensor). Returns per lane (olabels, ilabels, total_cost) of the
        exact Viterbi path, or None if no final state is reachable."""
        g = self.g
        dev = self.device
        B, T, P = loglikes.shape
        if P < g.num_pdfs:
            raise KaldiTpuError(
                f"dense_relax: loglikes pdf dim {P} < graph {g.num_pdfs}")
        lengths = np.asarray(lengths if lengths is not None
                             else [T] * B, np.int64)
        # pad T to a multiple of the chunk (padding frames inactive)
        C = min(self.chunk, T) if T else 1
        n_chunks = max(1, -(-T // C))
        T_pad = n_chunks * C
        x = (loglikes if isinstance(loglikes, torch.Tensor)
             else torch.from_numpy(np.asarray(loglikes, np.float32)))
        with torch.inference_mode():
            # (T_pad, P, B) acoustic costs
            am = (x.to(dev, torch.float32) * (-acoustic_scale)) \
                .permute(1, 2, 0)
            if T_pad > T:
                am = torch.cat([am, am.new_zeros((T_pad - T, P, B))], 0)
            am = am.contiguous()
            active = torch.from_numpy(
                np.arange(T_pad)[:, None] < lengths[None, :]).to(dev)
            cost, ckpts = self._forward(am, active, C, n_chunks)
            total = cost + self._final_cost[:, None]
            best_cost, best_state = total.min(dim=0)
            first_state, arcs_dev = self._backward(ckpts, am, active, C,
                                                   best_state)
            best_state_np = best_state.cpu().numpy()
            best_cost_np = best_cost.cpu().numpy()
            arcs_all = arcs_dev.cpu().numpy()
            first_state = first_state.cpu().numpy()
        out: List[Optional[Tuple[List[int], List[int], float]]] = []
        chosen = 0
        for b in range(B):
            if best_cost_np[b] >= INF / 2:
                out.append(None)
                continue
            words: List[int] = list(g.init_olabels[int(first_state[b])])
            ilabels: List[int] = []
            for t in range(int(lengths[b])):
                a = int(arcs_all[t, b])
                if a < 0:
                    continue
                chosen += 1
                ilabels.append(int(g.ilabel_flat[a]))
                words.extend(g.olabels_flat[a])
            words.extend(g.final_olabels[int(best_state_np[b])])
            out.append((words, ilabels, float(best_cost_np[b])))
        self.stats = dict(padded_slots=self._n_slots,
                          arcs=int(g.src_flat.shape[0]),
                          eps_truncated=int(g.eps_truncated),
                          frames=int(T_pad), chosen_arcs=chosen)
        self.last_arcs = arcs_all
        return out

    def decode(self, loglikes: np.ndarray, acoustic_scale: float = 0.1
               ) -> Optional[Tuple[List[int], List[int], float]]:
        """Single-utterance decode: loglikes (T, P)."""
        return self.decode_batch(loglikes[None], acoustic_scale)[0]
