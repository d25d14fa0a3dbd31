"""Batched device Viterbi over packed graphs (port of
`kaldi_tpu/decoder/batched_viterbi.py`).

Utterances are lanes in a dense (batch x states) cost tensor; each frame
is one emitting relaxation followed by a fixed number of epsilon
relaxations (the graph's epsilon depth, computed at pack time, replaces
the data-dependent non-emitting iteration loop).  Every relaxation is one
launch of `ops.viterbi_relax` (a CUDA kernel on the card) over the padded
incoming-arc tables, prepared once a run (`PreparedRelax`); the
reference's `lax.scan` over frames is a Python loop of launches here.
Where the epsilon table provably changes no cost row (a graph without
epsilon arcs), the closure launches are left out.  The per-frame cost
tables stay on the device in one preallocated tensor, come to the host
once, and the traceback is recovered there by cost-consistency (no
backpointer storage on device).

Exact (no beam): correct for per-utterance training/alignment graphs and
small-to-medium decoding graphs where S x K fits the arithmetic budget.

Where the port departs from the reference's storage, not its results:
  * a graph shared by all lanes has its tables built once, (S, K), and
    the kernel reads them with a lane stride of 0; the reference stacks B
    copies.  One graph a lane gives (B, S, K) as there.
  * the device keeps cost rows lanes-fastest, (T+1, S+1, B), so that a
    warp of the kernel reads neighbouring lanes; `_viterbi_device`
    returns the reference's (B, T+1, S+1) as a view of it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.fstext.fst import EPS, TropicalWeight, VectorFst
from kaldi_tpu_torch.ops.viterbi_relax import (DEAD_SLACK, INF,
                                               PreparedRelax,
                                               build_incoming_table,
                                               check_tables,
                                               closure_is_identity,
                                               live_counts)

_log = logging.getLogger(__name__)

# (in_src, in_w, in_pdf, acoustic_scale, in_deg) -> the relaxation over
# these tables: f(cost, loglikes_t, out=...), or f(cost, out=...) for an
# epsilon table (in_pdf None)
RelaxFactory = Callable[..., Callable[..., torch.Tensor]]
Hyp = Optional[Tuple[List[int], List[int], float]]


@dataclass
class DeviceGraph:
    """Arc-parallel packing of one decoding/alignment graph."""
    e_src: np.ndarray
    e_dst: np.ndarray
    e_ilabel: np.ndarray   # transition-ids
    e_olabel: np.ndarray
    e_weight: np.ndarray
    ne_src: np.ndarray
    ne_dst: np.ndarray
    ne_olabel: np.ndarray
    ne_weight: np.ndarray
    start: int
    final: np.ndarray      # (S,) final costs (INF if none)
    num_states: int
    eps_depth: int

    def padded(self, S: int, EA: int, NA: int) -> "DeviceGraph":
        def pad_i(a, n, fill):
            return np.concatenate([a, np.full(n - len(a), fill, a.dtype)])
        dead = S - 1
        return DeviceGraph(
            pad_i(self.e_src, EA, dead), pad_i(self.e_dst, EA, dead),
            pad_i(self.e_ilabel, EA, 0), pad_i(self.e_olabel, EA, 0),
            pad_i(self.e_weight, EA, INF),
            pad_i(self.ne_src, NA, dead), pad_i(self.ne_dst, NA, dead),
            pad_i(self.ne_olabel, NA, 0), pad_i(self.ne_weight, NA, INF),
            self.start, pad_i(self.final, S, INF), S, self.eps_depth)


def pack_graph(fst: VectorFst) -> DeviceGraph:
    e = [[], [], [], [], []]
    ne = [[], [], [], []]
    for s in range(fst.num_states):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                ne[0].append(s)
                ne[1].append(a.nextstate)
                ne[2].append(a.olabel)
                ne[3].append(a.weight)
            else:
                e[0].append(s)
                e[1].append(a.nextstate)
                e[2].append(a.ilabel)
                e[3].append(a.olabel)
                e[4].append(a.weight)
    final = np.array([w if w != TropicalWeight.zero else INF
                      for w in fst.finals], np.float32)
    # epsilon depth: longest chain of eps arcs (assumed acyclic in
    # weight-bearing direction; cycles get capped)
    depth = _eps_depth(fst)
    return DeviceGraph(
        np.array(e[0], np.int32), np.array(e[1], np.int32),
        np.array(e[2], np.int32), np.array(e[3], np.int32),
        np.array(e[4], np.float32),
        np.array(ne[0], np.int32), np.array(ne[1], np.int32),
        np.array(ne[2], np.int32), np.array(ne[3], np.float32),
        fst.start, final, fst.num_states, depth)


def _eps_depth(fst: VectorFst, cap: int = 10) -> int:
    n = fst.num_states
    depth = [0] * n
    changed = True
    iters = 0
    while changed and iters < cap:
        changed = False
        iters += 1
        for s in range(n):
            for a in fst.arcs[s]:
                if a.ilabel == EPS and depth[a.nextstate] < depth[s] + 1:
                    depth[a.nextstate] = depth[s] + 1
                    changed = True
    return min(max(depth, default=0) + 1, cap)


def _scaled_min(loglikes: torch.Tensor, scale: float) -> float:
    """min of scale * loglikes (NaN if any is), 0 for no loglikes."""
    if loglikes.numel() == 0:
        return 0.0
    lo, hi = (float(x) for x in torch.aminmax(loglikes))
    return min(scale * lo, scale * hi)


def _viterbi_device(loglikes: torch.Tensor, acoustic_scale: float,
                    e_in_src, e_in_w, e_in_pdf, ne_in_src, ne_in_w,
                    init_cost: torch.Tensor, num_states: int, eps_iters: int,
                    relax: RelaxFactory = PreparedRelax, e_in_deg=None,
                    ne_in_deg=None,
                    closure_identity: bool = False) -> torch.Tensor:
    """loglikes: (B, T, P); padded incoming-arc tables are (S, K), shared,
    or (B, S, K) (see ops/viterbi_relax), `e_in_deg` and `ne_in_deg` their
    live counts (optional); all tensors on one device.  `relax` makes the
    relaxation of one table set (see RelaxFactory).  Cost rows carry a
    dead state at index S kept at INF.  Returns (B, T+1, S+1) post-closure
    cost tables, a view of a lanes-fastest tensor.

    Launches: T emitting relaxations and (T + 1) * eps_iters closure
    relaxations.  closure_identity: the tables passed
    `ops.viterbi_relax.closure_is_identity`; when this run's loglikes meet
    its condition too, a closure step would copy its row, so none is
    launched and each emitting step writes its table row itself: T
    launches, the same tables bit for bit."""
    B, S1 = init_cost.shape
    if S1 != num_states + 1:
        raise ValueError(f"init_cost has {S1} columns, expected "
                         f"{num_states + 1}")
    if eps_iters < 1:
        raise ValueError(f"eps_iters={eps_iters}: pack_graph gives >= 1")
    T = loglikes.shape[1]
    dev = init_cost.device

    emit = relax(e_in_src, e_in_w, e_in_pdf, acoustic_scale, e_in_deg)
    ll = loglikes.permute(1, 2, 0).contiguous()              # (T, P, B)
    table = torch.empty((T + 1, S1, B), dtype=torch.float32, device=dev)
    lls = [x.T for x in ll.unbind(0)]                        # (B, P) views
    rows = [x.T for x in table.unbind(0)]                    # (B, S+1) views
    if closure_identity and _scaled_min(loglikes, acoustic_scale) \
            >= -DEAD_SLACK:
        rows[0].copy_(init_cost)
        for t in range(T):
            emit(rows[t], lls[t], out=rows[t + 1])
        return table.permute(2, 0, 1)

    close = relax(ne_in_src, ne_in_w, None, acoustic_scale, ne_in_deg)
    scratch = torch.empty((2, S1, B), dtype=torch.float32, device=dev)
    pads = [x.T for x in scratch.unbind(0)]

    def eps_close(cur: torch.Tensor, dst: torch.Tensor) -> None:
        """eps_iters closure steps from `cur` (B, S+1); the last one
        writes `dst`.  `cur` is pads[0] or a tensor of its own."""
        for i in range(eps_iters):
            nxt = dst if i == eps_iters - 1 else pads[(i + 1) % 2]
            close(cur, out=nxt)
            cur = nxt

    eps_close(init_cost.T.contiguous().T, rows[0])
    for t in range(T):
        emit(rows[t], lls[t], out=pads[0])
        eps_close(pads[0], rows[t + 1])
    return table.permute(2, 0, 1)


class BatchedViterbi:
    """Batched exact Viterbi for a SHARED graph over many utterances
    (decode) or per-utterance graphs (alignment).

    relax: what makes the relaxation of a table set, `PreparedRelax` by
    default (the CUDA kernel for CUDA tensors, tables checked once a run);
    `each_call(relax_padded)` (both of `ops.viterbi_relax`) runs the plain
    version on the card, for comparison, and `each_call` fits any function
    of `viterbi_relax`'s arguments."""

    def __init__(self, graphs, tid_to_pdf: np.ndarray,
                 acoustic_scale: float = 1.0, device: DeviceLike = None,
                 relax: RelaxFactory = PreparedRelax):
        if isinstance(graphs, VectorFst):
            graphs = [graphs]
        self.device = resolve_device(device)
        self.relax = relax
        self.shared = len(graphs) == 1
        self.packed = [pack_graph(g) for g in graphs]
        self.tid_to_pdf = np.asarray(tid_to_pdf, np.int64)
        self.acoustic_scale = acoustic_scale

    def _prepare(self, B: int):
        """-> (per-lane padded graphs, numpy arrays for the device, S with
        the dead state, eps_iters).  Tables are (S, K) for a shared graph
        (every lane's entry of `padded` is then one object), (B, S, K)
        for one graph a lane."""
        if not self.shared and B > len(self.packed):
            raise ValueError(f"{B} lanes but {len(self.packed)} graphs")
        gs = self.packed[:1] if self.shared else self.packed[:B]
        S = max(g.num_states for g in gs) + 1  # +1 dead state
        padded = [g.padded(S, max(1, max(len(g.e_src) for g in gs)),
                           max(1, max(len(g.ne_src) for g in gs)))
                  for g in gs]
        # padded incoming-arc tables per graph (common K across lanes)
        tables = []
        for g in padded:
            e_pdf = self.tid_to_pdf[np.clip(g.e_ilabel, 0,
                                            len(self.tid_to_pdf) - 1)]
            e_tab = build_incoming_table(S, g.e_src, g.e_dst, g.e_weight,
                                         e_pdf.astype(np.int32))
            ne_tab = build_incoming_table(S, g.ne_src, g.ne_dst,
                                          g.ne_weight,
                                          np.zeros_like(g.ne_src))
            tables.append((e_tab, ne_tab))
        KE = max(t[0][3] for t in tables)
        KN = max(t[1][3] for t in tables)

        def pad_k(arr, K, fill):
            S_, k = arr.shape
            if k == K:
                return arr
            out = np.full((S_, K), fill, arr.dtype)
            out[:, :k] = arr
            return out

        def stack(which, i, K, fill):
            arrs = [pad_k(t[which][i], K, fill) for t in tables]
            return arrs[0] if self.shared else np.stack(arrs)

        arrays = dict(e_in_src=stack(0, 0, KE, S), e_in_w=stack(0, 1, KE, INF),
                      e_in_pdf=stack(0, 2, KE, 0),
                      ne_in_src=stack(1, 0, KN, S),
                      ne_in_w=stack(1, 1, KN, INF))
        if self.shared:
            padded = padded * B
        init = np.full((B, S + 1), INF, np.float32)
        for b, g in enumerate(padded):
            init[b, g.start] = 0.0
        arrays["init_cost"] = init
        eps_iters = max(g.eps_depth for g in padded)
        return padded, arrays, S, eps_iters

    def _forward(self, loglikes: torch.Tensor, arrays: Dict[str, np.ndarray],
                 S: int, eps_iters: int) -> torch.Tensor:
        """Tables to the device and the frame loop -> (B, T+1, S+1) cost
        tables on the device."""
        check_tables(arrays["e_in_src"], arrays["e_in_pdf"],
                     loglikes.shape[2])
        check_tables(arrays["ne_in_src"], None, None)
        e_deg = live_counts(arrays["e_in_src"], arrays["e_in_w"],
                            arrays["e_in_pdf"])
        ne_deg = live_counts(arrays["ne_in_src"], arrays["ne_in_w"])
        identity = closure_is_identity(
            arrays["ne_in_src"], arrays["ne_in_w"], ne_deg,
            arrays["e_in_src"], arrays["e_in_w"], e_deg)
        arrays = dict(arrays, e_in_deg=e_deg, ne_in_deg=ne_deg)
        with torch.inference_mode():
            return _viterbi_device(
                loglikes, self.acoustic_scale,
                **{k: torch.as_tensor(v, device=self.device)
                   for k, v in arrays.items()},
                num_states=S, eps_iters=eps_iters, relax=self.relax,
                closure_identity=identity)

    @staticmethod
    def _to_host(costs: torch.Tensor) -> np.ndarray:
        """(B, T+1, S+1) device view -> the same on the host, copied in
        the device's lanes-fastest memory order (one contiguous
        transfer)."""
        return costs.permute(1, 2, 0).cpu().numpy().transpose(2, 0, 1)

    def run(self, loglikes, lengths: Optional[Sequence[int]] = None
            ) -> List[Hyp]:
        """loglikes: (B, T, P) (padded), a tensor or a numpy array; returns
        per-utterance (alignment, words, cost)."""
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=self.device)
        B, T, P = ll.shape
        if lengths is None:
            lengths = [T] * B
        padded, arrays, S, eps_iters = self._prepare(B)
        costs = self._to_host(self._forward(ll, arrays, S, eps_iters))
        costs = costs[:, :, :S]
        ll_host = ll.cpu().numpy()
        return [self._traceback(padded[b], costs[b], ll_host[b],
                                int(lengths[b])) for b in range(B)]

    def _traceback(self, g: DeviceGraph, costs: np.ndarray,
                   loglikes: np.ndarray, T: int) -> Hyp:
        """Recover the best path from per-frame post-closure cost tables
        by cost-consistency."""
        final_tot = costs[T] + g.final
        s = int(np.argmin(final_tot))
        best_cost = float(final_tot[s])
        if best_cost >= INF / 2:
            _log.warning("batched viterbi: no final state reachable")
            return None
        tol = 1e-3
        rev: List[Tuple[int, int]] = []  # (ilabel, olabel)

        def relax_ne_into(cost_vec, state, budget):
            """Follow eps arcs backwards within a frame while consistent."""
            steps = 0
            cur = state
            while steps < budget:
                cands = np.nonzero(g.ne_dst == cur)[0]
                if cands.size == 0:
                    return cur
                pre = cost_vec[g.ne_src[cands]] + g.ne_weight[cands]
                k = int(np.argmin(np.abs(pre - cost_vec[cur])))
                if abs(pre[k] - cost_vec[cur]) > tol:
                    return cur
                a = cands[k]
                if g.ne_olabel[a] != 0:
                    rev.append((0, int(g.ne_olabel[a])))
                cur = int(g.ne_src[a])
                steps += 1
            return cur

        for t in range(T, 0, -1):
            s = relax_ne_into(costs[t], s, g.eps_depth)
            # find the emitting arc into s consistent with costs[t-1]
            cands = np.nonzero(g.e_dst == s)[0]
            if cands.size == 0:
                _log.warning("batched viterbi traceback failed (no emitting "
                             "arc)")
                return None
            pdfs = self.tid_to_pdf[np.clip(g.e_ilabel[cands], 0,
                                           len(self.tid_to_pdf) - 1)]
            ac = -self.acoustic_scale * loglikes[t - 1, pdfs]
            pre = costs[t - 1][g.e_src[cands]] + g.e_weight[cands] + ac
            k = int(np.argmin(np.abs(pre - costs[t][s])))
            a = cands[k]
            rev.append((int(g.e_ilabel[a]), int(g.e_olabel[a])))
            s = int(g.e_src[a])
        relax_ne_into(costs[0], s, g.eps_depth)
        rev.reverse()
        ali = [il for il, ol in rev if il != 0]
        words = [ol for il, ol in rev if ol != 0]
        return ali, words, best_cost
