"""Lattice algorithms (the part of `kaldi_tpu/lat/functions.py` that the
lattice decoders and their tests need; parity: lat/lattice-functions.h,
latbin tools).

lattice_best_path      — lattice-best-path
lattice_best_path_lattice — lattice-1best (the best path as a lattice)
lattice_scale          — lattice-scale (lm/acoustic scale)
add_word_ins_penalty   — lattice-add-penalty
lattice_prune          — lattice-prune (forward-backward cost pruning)
lattice_state_times    — the frame index of each state
lattice_forward_backward_post — arc posteriors (lattice-functions.h:84)
lattice_nbest          — lattice-to-nbest (exact k-best, acyclic)
determinize_lattice    — word-level determinization, unpruned, as the
                         reference's nnet3-latgen-faster and
                         lattice-determinize run it
determinize_lattice_pruned — word-level determinization with beam
                         pruning and the max-states back-off
                         (lat/determinize-lattice-pruned.h)
determinize_lattice_phone_pruned — the two-pass form with phone labels
                         spliced in at phone starts
                         (lattice-determinize-phone-pruned)
lattice_forward_backward_mpe_variants — the MPFE / sMBR forward-backward
                         of discriminative training
                         (lattice-functions.cc:798)
"""

from __future__ import annotations

import heapq
import logging
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError, warn
from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        VectorFst)
from kaldi_tpu_torch.fstext.ops import connect, determinize_star, invert
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice

_log = logging.getLogger(__name__)


def _total(w: Tuple[float, float]) -> float:
    return w[0] + w[1]


def _best_chain(lat: Lattice) -> Tuple[List[Arc], int, float]:
    """The cheapest path to a final state (shortest-path relaxation over
    total costs; the first path found stays on equal totals) -> (its
    arcs, the final state or -1 when none is reachable, its cost)."""
    n = lat.num_states
    dist = [INF] * n
    back: List[Optional[Tuple[int, Arc]]] = [None] * n
    dist[lat.start] = 0.0
    inq = [False] * n
    q = deque([lat.start])
    inq[lat.start] = True
    while q:
        s = q.popleft()
        inq[s] = False
        for a in lat.arcs[s]:
            nd = dist[s] + _total(a.weight)
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
                if not inq[a.nextstate]:
                    q.append(a.nextstate)
                    inq[a.nextstate] = True
    best_s, best_c = -1, INF
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            c = dist[s] + _total(lat.finals[s])
            if c < best_c:
                best_c, best_s = c, s
    chain: List[Arc] = []
    s = best_s
    while best_s >= 0 and s != lat.start and back[s] is not None:
        p, a = back[s]
        chain.append(a)
        s = p
    chain.reverse()
    return chain, best_s, best_c


def lattice_best_path(lat: Lattice) -> Tuple[List[int], List[int], float]:
    """Returns (alignment tids, words, total cost)."""
    chain, best_s, best_c = _best_chain(lat)
    if best_s < 0:
        return [], [], INF
    return ([a.ilabel for a in chain if a.ilabel != EPS],
            [a.olabel for a in chain if a.olabel != EPS], best_c)


def lattice_best_path_lattice(lat: Lattice) -> Optional[Lattice]:
    """The best path as a linear lattice, keeping each arc's weight and
    the final weight (latbin/lattice-1best.cc: ShortestPath on the
    lattice semiring); None when no final state is reachable."""
    chain, best_s, _ = _best_chain(lat)
    if best_s < 0:
        return None
    out = VectorFst(LatticeWeight)
    cur = out.add_state()
    out.set_start(cur)
    for a in chain:
        ns = out.add_state()
        out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight, ns))
        cur = ns
    out.finals[cur] = lat.finals[best_s]
    return out


def lattice_scale(lat: Lattice, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0) -> Lattice:
    """Each arc and final weight (graph, acoustic) scaled by (lm_scale,
    acoustic_scale)."""
    out = lat.copy()
    for arcs in out.arcs:
        for a in arcs:
            a.weight = (a.weight[0] * lm_scale, a.weight[1] * acoustic_scale)
    for s in range(out.num_states):
        w = out.finals[s]
        if w != LatticeWeight.zero:
            out.finals[s] = (w[0] * lm_scale, w[1] * acoustic_scale)
    return out


def add_word_ins_penalty(lat: Lattice, penalty: float) -> Lattice:
    """`penalty` added to the graph cost of every arc with a word."""
    out = lat.copy()
    for arcs in out.arcs:
        for a in arcs:
            if a.olabel != EPS:
                a.weight = (a.weight[0] + penalty, a.weight[1])
    return out


def _forward_backward_costs(lat: Lattice) -> Tuple[List[float], List[float]]:
    """Viterbi forward and backward total costs per state."""
    n = lat.num_states
    fwd = [INF] * n
    fwd[lat.start] = 0.0
    inq = [False] * n
    q = deque([lat.start])
    while q:
        s = q.popleft()
        inq[s] = False
        for a in lat.arcs[s]:
            nd = fwd[s] + _total(a.weight)
            if nd < fwd[a.nextstate] - 1e-12:
                fwd[a.nextstate] = nd
                if not inq[a.nextstate]:
                    q.append(a.nextstate)
                    inq[a.nextstate] = True
    bwd = [INF] * n
    preds: List[List[Tuple[int, Arc]]] = [[] for _ in range(n)]
    for s in range(n):
        for a in lat.arcs[s]:
            preds[a.nextstate].append((s, a))
    q = deque()
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            bwd[s] = _total(lat.finals[s])
            q.append(s)
    inq = [False] * n
    while q:
        s = q.popleft()
        inq[s] = False
        for p, a in preds[s]:
            nd = bwd[s] + _total(a.weight)
            if nd < bwd[p] - 1e-12:
                bwd[p] = nd
                if not inq[p]:
                    q.append(p)
                    inq[p] = True
    return fwd, bwd


def lattice_prune(lat: Lattice, beam: float) -> Lattice:
    fwd, bwd = _forward_backward_costs(lat)
    best = min((f + b for f, b in zip(fwd, bwd)), default=INF)
    out = VectorFst(LatticeWeight)
    out.add_states(lat.num_states)
    out.start = lat.start
    for s in range(lat.num_states):
        out.finals[s] = lat.finals[s]
        if fwd[s] + bwd[s] > best + beam:
            out.finals[s] = LatticeWeight.zero
            continue
        for a in lat.arcs[s]:
            arc_cost = fwd[s] + _total(a.weight) + bwd[a.nextstate]
            if arc_cost <= best + beam:
                out.add_arc(s, Arc(a.ilabel, a.olabel, a.weight, a.nextstate))
    return connect(out)


def lattice_state_times(lat: Lattice) -> List[int]:
    """Frame index of each state (requires a topologically-sane lattice
    where emitting arcs advance time; lattice-functions.cc
    LatticeStateTimes)."""
    n = lat.num_states
    times = [-1] * n
    times[lat.start] = 0
    order = _topsort(lat)
    for s in order:
        if times[s] < 0:
            # unreachable state: must not propagate its bogus (-1)
            # time into reachable successors
            continue
        for a in lat.arcs[s]:
            t = times[s] + (1 if a.ilabel != EPS else 0)
            if times[a.nextstate] < 0:
                times[a.nextstate] = t
    return times


def _topsort(lat: VectorFst) -> List[int]:
    n = lat.num_states
    indeg = [0] * n
    for s in range(n):
        for a in lat.arcs[s]:
            indeg[a.nextstate] += 1
    q = deque([s for s in range(n) if indeg[s] == 0])
    order = []
    while q:
        s = q.popleft()
        order.append(s)
        for a in lat.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                q.append(a.nextstate)
    if len(order) != n:
        raise ValueError("lattice has cycles")
    return order


def lattice_forward_backward_post(lat: Lattice, acoustic_scale: float = 1.0
                                  ) -> List[List[Tuple[int, float]]]:
    """Per-frame (transition-id, posterior) lists
    (LatticeForwardBackward, lattice-functions.h:84), in the log
    semiring over graph + acoustic_scale x acoustic costs."""
    n = lat.num_states
    order = _topsort(lat)

    def arc_ll(a):
        return -(a.weight[0] + acoustic_scale * a.weight[1])

    alpha = [-INF] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            v = alpha[s] + arc_ll(a)
            alpha[a.nextstate] = np.logaddexp(alpha[a.nextstate], v)
    beta = [-INF] * n
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            beta[s] = -(lat.finals[s][0] + acoustic_scale * lat.finals[s][1])
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = np.logaddexp(beta[s], arc_ll(a) + beta[a.nextstate])
    total = beta[lat.start]
    times = lattice_state_times(lat)
    T = max((times[s] for s in range(n) if times[s] >= 0), default=0)
    post: List[Dict[int, float]] = [dict() for _ in range(T)]
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == EPS:
                continue
            p = math.exp(alpha[s] + arc_ll(a) + beta[a.nextstate] - total)
            t = times[s]
            if 0 <= t < T:
                post[t][a.ilabel] = post[t].get(a.ilabel, 0.0) + p
    return [sorted(d.items()) for d in post]


def boost_lattice_phone_errors(lat, tm, ref_phones, b: float,
                               silence_phones=frozenset(),
                               max_silence_error: float = 0.0):
    """A copy of `lat` with each emitting arc's graph cost lowered by
    b x its frame's phone error against `ref_phones`: 0 where the arc's
    phone is the reference's at that frame, else `max_silence_error` on
    a silence phone and 1 on any other (Kaldi's LatticeBoost, the
    boosting of lattice-boost-ali for boosted MMI)."""
    times = lattice_state_times(lat)
    out = VectorFst(LatticeWeight)
    for _ in range(lat.num_states):
        out.add_state()
    out.set_start(lat.start)
    for s in range(lat.num_states):
        out.finals[s] = lat.finals[s]
        for a in lat.arcs[s]:
            g, ac = a.weight
            if a.ilabel != 0 and times[s] < len(ref_phones):
                phone = tm.transition_id_to_phone(a.ilabel)
                if phone == ref_phones[times[s]]:
                    err = 0.0
                elif phone in silence_phones:
                    err = max_silence_error
                else:
                    err = 1.0
                g = g - b * err
            out.add_arc(s, Arc(a.ilabel, a.olabel, (g, ac), a.nextstate))
    return out


def lattice_nbest(lat: Lattice, n: int) -> List[Tuple[List[int], List[int], float]]:
    """Exact n-best paths for an acyclic lattice: DP keeping n best
    (cost, path) per state."""
    order = _topsort(lat)
    # best lists propagate forward
    paths: List[List[Tuple[float, List[Arc]]]] = \
        [[] for _ in range(lat.num_states)]
    paths[lat.start] = [(0.0, [])]
    results = []
    for s in order:
        if not paths[s]:
            continue
        if lat.finals[s] != LatticeWeight.zero:
            for c, arcs in paths[s]:
                results.append((c + _total(lat.finals[s]), arcs))
        for a in lat.arcs[s]:
            cand = [(c + _total(a.weight), arcs + [a]) for c, arcs in paths[s]]
            merged = sorted(paths[a.nextstate] + cand, key=lambda x: x[0])[:n]
            paths[a.nextstate] = merged
    results.sort(key=lambda x: x[0])
    out = []
    for c, arcs in results[:n]:
        ali = [a.ilabel for a in arcs if a.ilabel != EPS]
        words = [a.olabel for a in arcs if a.olabel != EPS]
        out.append((ali, words, c))
    return out


def determinize_lattice(lat: Lattice) -> Lattice:
    """Word-level determinization: for each word sequence, the best path
    (the capability of DeterminizeLatticePhonePrunedWrapper; the
    algorithm is the reference's, inversion + determinize_star over the
    lattice semiring + inversion back).  Unpruned: when determinize_star
    exceeds 100,000 states, or its output strings blow up, it warns and
    returns its input, the raw lattice itself, as the reference does
    (so `determinize_lattice(lat) is lat` marks a fallback)."""
    work = invert(lat.copy())  # words on input, tids on output
    try:
        det = determinize_star(work, max_states=100000, functional=False)
    except RuntimeError as e:
        warn(f"lattice determinization fell back to raw lattice: {e}")
        return lat
    return invert(det)


class _DetOverflow(Exception):
    pass


def _det_pruned_once(lat: Lattice, beam: float, max_states: int,
                     max_elements: int) -> Lattice:
    """One pass of beam-interleaved lattice determinization.

    Weighted subset determinization over the lattice semiring with
    transition-id strings (the algorithm of
    lat/determinize-lattice-pruned.h:28-120,
    re-implemented best-first): det states are normalized subsets of
    (input state, residual (graph, acoustic) weight, residual tid
    string); word-eps arcs are closed into the subsets; every subset
    element is pruned against (forward cost + residual + input-lattice
    backward best cost) <= best + beam, so the output never grows
    blowup regions the beam would discard anyway.  Det states are
    expanded best-first (a priority queue on forward cost) so hitting
    max_states keeps the most promising part.  Raises _DetOverflow
    when max_states/max_elements is exceeded (the caller backs off,
    mirroring DeterminizeLatticePhonePrunedWrapper's retry)."""
    W = LatticeWeight
    n = lat.num_states
    _, beta = _forward_backward_costs(lat)
    best = beta[lat.start]
    if best >= INF:
        return Lattice(semiring=W)
    cutoff = best + beam

    def closure(elems):
        """Expand word-eps arcs; keep per-state min-cost element.
        elems: dict state -> (gcost, acost, string)."""
        stack = list(elems.keys())
        while stack:
            s = stack.pop()
            g, a, st = elems[s]
            for arc in lat.arcs[s]:
                if arc.olabel != EPS:
                    continue
                ng = g + arc.weight[0]
                na = a + arc.weight[1]
                nst = st + ((arc.ilabel,) if arc.ilabel else ())
                old = elems.get(arc.nextstate)
                if old is None or ng + na < old[0] + old[1] - 1e-12:
                    elems[arc.nextstate] = (ng, na, nst)
                    stack.append(arc.nextstate)
        return elems

    def normalize(elems, fwd_cost):
        """Prune vs beam, subtract the min weight and common string
        prefix.  Returns (divisor (g, a), prefix, key, kept-elems)."""
        kept = {s: v for s, v in elems.items()
                if fwd_cost + v[0] + v[1] + beta[s] <= cutoff + 1e-9}
        if not kept:
            return None
        div = None
        for s, (g, a, st) in kept.items():
            if div is None or (g + a, g) < (div[0] + div[1], div[0]):
                div = (g, a)
        strings = [v[2] for v in kept.values()]
        prefix = strings[0]
        for st in strings[1:]:
            k = 0
            while k < len(prefix) and k < len(st) and prefix[k] == st[k]:
                k += 1
            prefix = prefix[:k]
        p = len(prefix)
        norm = {s: (g - div[0], a - div[1], st[p:])
                for s, (g, a, st) in kept.items()}
        key = tuple(sorted(
            (s, round(g, 6), round(a, 6), st)
            for s, (g, a, st) in norm.items()))
        return div, prefix, key, norm

    out = Lattice(semiring=W)
    subsets: Dict[tuple, int] = {}      # key -> det id
    det_elems: List[dict] = []
    det_fwd: List[float] = []
    det_out: List[int] = []             # det id -> output state
    heap: List[Tuple[float, int]] = []
    done = set()
    n_elements = 0

    def get_state(elems, fwd_cost):
        """Returns (det id or None, divisor, prefix)."""
        nonlocal n_elements
        res = normalize(closure(elems), fwd_cost)
        if res is None:
            return None, None, None
        div, prefix, key, norm = res
        did = subsets.get(key)
        if did is None:
            did = len(det_elems)
            subsets[key] = did
            det_elems.append(norm)
            det_fwd.append(fwd_cost + div[0] + div[1])
            det_out.append(out.add_state())
            heapq.heappush(heap, (det_fwd[did], did))
            n_elements += len(norm)
            if len(det_elems) > max_states or n_elements > max_elements:
                raise _DetOverflow()
        else:
            # reached again via a cheaper prefix: children were pruned
            # against the old (higher) forward cost — lower it and
            # re-expand (Dijkstra decrease-key with re-expansion)
            nf = fwd_cost + div[0] + div[1]
            if nf < det_fwd[did] - 1e-9:
                det_fwd[did] = nf
                done.discard(did)
                heapq.heappush(heap, (nf, did))
        return did, div, prefix

    def emit_chain(src, word, weight, string, dest):
        """Arc chain carrying the word + tid string + weight."""
        cur = src
        if not string:
            out.add_arc(cur, Arc(0, word, weight, dest))
            return
        for i, tid in enumerate(string):
            last = i == len(string) - 1
            nxt = dest if last else out.add_state()
            out.add_arc(cur, Arc(tid, word if i == 0 else 0,
                                 weight if i == 0 else W.one, nxt))
            cur = nxt

    start_elems = {lat.start: (0.0, 0.0, ())}
    did, div, prefix = get_state(start_elems, 0.0)
    if did is None:
        return Lattice(semiring=W)
    # initial divisor/prefix folded into a dedicated start chain
    if div != (0.0, 0.0) or prefix:
        real_start = out.add_state()
        out.start = real_start
        emit_chain(real_start, 0, div, prefix, det_out[did])
    else:
        out.start = det_out[did]

    while heap:
        fwd_cost, d = heapq.heappop(heap)
        if d in done or fwd_cost > det_fwd[d] + 1e-12:
            continue
        done.add(d)
        elems = det_elems[d]
        d_state = det_out[d]
        # re-expansion after decrease-key: drop previously emitted arcs
        # (orphaned chain states are swept by the final connect())
        out.arcs[d_state] = []
        out.finals[d_state] = W.zero
        # final weight: min over final elements (emit trailing string)
        best_fin = None
        for s, (g, a, st) in elems.items():
            fw = lat.finals[s]
            if fw == W.zero:
                continue
            cand = (g + fw[0], a + fw[1], st)
            if fwd_cost + cand[0] + cand[1] > cutoff + 1e-9:
                continue                    # final exceeds the beam
            if best_fin is None or (cand[0] + cand[1]
                                    < best_fin[0] + best_fin[1]):
                best_fin = cand
        if best_fin is not None:
            if best_fin[2]:
                fs = out.add_state()
                out.set_final(fs, W.one)
                emit_chain(d_state, 0, (best_fin[0], best_fin[1]),
                           best_fin[2], fs)
            else:
                out.set_final(d_state, (best_fin[0], best_fin[1]))
        # group outgoing non-eps word arcs by word
        by_word: Dict[int, dict] = {}
        for s, (g, a, st) in elems.items():
            for arc in lat.arcs[s]:
                if arc.olabel == EPS:
                    continue
                ng = g + arc.weight[0]
                na = a + arc.weight[1]
                nst = st + ((arc.ilabel,) if arc.ilabel else ())
                tgt = by_word.setdefault(arc.olabel, {})
                old = tgt.get(arc.nextstate)
                if old is None or ng + na < old[0] + old[1] - 1e-12:
                    tgt[arc.nextstate] = (ng, na, nst)
        for word, nelems in sorted(by_word.items()):
            ndid, ndiv, nprefix = get_state(nelems, fwd_cost)
            if ndid is None:
                continue
            emit_chain(d_state, word, ndiv, nprefix, det_out[ndid])
    connect(out)
    return out


def determinize_lattice_pruned(lat: Lattice, beam: float = 10.0,
                               max_states: int = 50000,
                               max_elements: int = 2_000_000,
                               num_retries: int = 4) -> Lattice:
    """Beam-interleaved word-level lattice determinization with bounded
    memory (parity: lat/determinize-lattice-pruned.h incl. the
    max_mem/beam backoff of DeterminizeLatticePhonePrunedWrapper:
    on overflow, the beam shrinks and the input is pre-pruned, then
    determinization reruns).  Output: word-deterministic lattice
    (expanded form — arc chains carry the tid strings) containing
    exactly the word sequences within `beam` of the best path, each
    with its best-path weight and alignment."""
    b = beam
    work = lat
    for attempt in range(num_retries):
        try:
            return _det_pruned_once(work, b, max_states, max_elements)
        except _DetOverflow:
            b *= 0.6
            work = lattice_prune(work, b)
            _log.warning("determinize_lattice_pruned: overflow, retrying "
                         "with beam %.2f", b)
    _log.warning("determinize_lattice_pruned: giving up, returning "
                 "tight-pruned non-deterministic lattice")
    return lattice_prune(lat, b)


def _insert_phone_labels(lat: Lattice, tm) -> Tuple[Lattice, int]:
    """Insert phone symbols on the word side at phone starts
    (determinize-lattice-pruned.cc:1292 DeterminizeLatticeInsertPhones;
    our convention: ilabel = transition-id, olabel = word).  Returns
    (new lattice, first_phone_label)."""
    out = VectorFst(lat.semiring)
    out.add_states(lat.num_states)
    out.start = lat.start
    for s in range(lat.num_states):
        out.finals[s] = lat.finals[s]
    first_phone = max((a.olabel for arcs in lat.arcs for a in arcs),
                      default=0) + 1
    one = lat.semiring.one
    for s in range(lat.num_states):
        for arc in lat.arcs[s]:
            if (s != lat.start and arc.ilabel != 0
                    and tm.transition_id_to_hmm_state(arc.ilabel) == 0
                    and not tm.is_self_loop(arc.ilabel)):
                phone = tm.transition_id_to_phone(arc.ilabel)
                if arc.olabel == 0:
                    out.add_arc(s, Arc(arc.ilabel,
                                       first_phone + phone,
                                       arc.weight, arc.nextstate))
                else:
                    extra = out.add_state()
                    out.add_arc(s, Arc(arc.ilabel, arc.olabel,
                                       arc.weight, extra))
                    out.add_arc(extra, Arc(0, first_phone + phone,
                                           one, arc.nextstate))
            else:
                out.add_arc(s, Arc(arc.ilabel, arc.olabel,
                                   arc.weight, arc.nextstate))
    return out, first_phone


def _delete_phone_labels(lat: Lattice, first_phone: int) -> Lattice:
    """Map inserted phone word-labels back to epsilon
    (determinize-lattice-pruned.cc:1348)."""
    for arcs in lat.arcs:
        for i, arc in enumerate(arcs):
            if arc.olabel >= first_phone:
                arcs[i] = Arc(arc.ilabel, 0, arc.weight, arc.nextstate)
    return lat


def determinize_lattice_phone_pruned(
        lat: Lattice, tm, beam: float = 10.0,
        phone_determinize: bool = True, word_determinize: bool = True,
        max_states: int = 50000) -> Lattice:
    """Two-pass pruned determinization
    (determinize-lattice-pruned.cc:1412
    DeterminizeLatticePhonePruned): first determinize with phone
    symbols spliced in at phone starts — phone boundaries make the
    intermediate determinization much less blow-up-prone on long
    lattices — then remove them and determinize at the word level."""
    if not (phone_determinize or word_determinize):
        _log.warning("determinize_lattice_phone_pruned: both passes "
                     "disabled, copying lattice")
        return lat
    work = lat
    if phone_determinize:
        work, first_phone = _insert_phone_labels(work, tm)
        work = determinize_lattice_pruned(work, beam,
                                          max_states=max_states)
        work = _delete_phone_labels(work, first_phone)
        if not word_determinize:
            return work
    return determinize_lattice_pruned(work, beam,
                                      max_states=max_states)


_LOG_ZERO = -1e30


def _logadd(a: float, b: float) -> float:
    """log(exp(a) + exp(b)), a term at or below half of -1e30 dropped
    (the JAX package's `lat/sausages.py` helper)."""
    if a < b:
        a, b = b, a
    if b <= _LOG_ZERO / 2:
        return a
    return a + math.log1p(math.exp(b - a))


def lattice_forward_backward_mpe_variants(
        tm, silence_phones, lat: Lattice, num_ali,
        criterion: str = "smbr", one_silence_class: bool = True):
    """MPE/sMBR-style forward-backward: per-frame posteriors over
    transition-ids weighted by (expected accuracy difference), the
    objective gradients of MPFE / sMBR discriminative training
    (lat/lattice-functions.cc:798 LatticeForwardBackwardMpeVariants).

    Returns (tot_objf, post) where post[t] = [(tid, weight), ...]
    (weights may be negative) and tot_objf is the expected frame
    accuracy of the lattice under its own posterior."""
    if criterion not in ("mpfe", "smbr"):
        raise KaldiTpuError(f"bad criterion {criterion!r}")
    is_mpfe = criterion == "mpfe"
    sil = set(int(p) for p in silence_phones)
    order = _topsort(lat)
    times = lattice_state_times(lat)
    max_time = len(num_ali)
    n = lat.num_states
    NEG = -1e100
    alpha = [NEG] * n
    beta = [NEG] * n
    alpha_s = [0.0] * n
    beta_s = [0.0] * n
    alpha[lat.start] = 0.0
    zero = lat.semiring.zero

    def frame_acc_of(arc, t):
        if arc.ilabel == 0:
            return 0.0
        phone = tm.transition_id_to_phone(arc.ilabel)
        ref_phone = tm.transition_id_to_phone(int(num_ali[t]))
        p_sil, r_sil = phone in sil, ref_phone in sil
        both_sil = p_sil and r_sil
        if not is_mpfe:
            pdf = tm.transition_id_to_pdf(arc.ilabel)
            ref_pdf = tm.transition_id_to_pdf(int(num_ali[t]))
            if not one_silence_class:
                return 1.0 if (pdf == ref_pdf and not p_sil) else 0.0
            return 1.0 if (pdf == ref_pdf or both_sil) else 0.0
        if not one_silence_class:
            return 1.0 if (phone == ref_phone and not p_sil) else 0.0
        return 1.0 if (phone == ref_phone or both_sil) else 0.0

    # first pass: alpha/beta over log-likelihood (-total cost)
    tot_fwd = NEG
    for s in order:
        a = alpha[s]
        if a <= NEG:
            continue
        for arc in lat.arcs[s]:
            like = -(arc.weight[0] + arc.weight[1])
            alpha[arc.nextstate] = _logadd(alpha[arc.nextstate], a + like)
        f = lat.finals[s]
        if f != zero:
            if times[s] != max_time:
                raise KaldiTpuError("final-prob not at max_time")
            tot_fwd = _logadd(tot_fwd, a - (f[0] + f[1]))
    for s in reversed(order):
        f = lat.finals[s]
        b = -(f[0] + f[1]) if f != zero else NEG
        for arc in lat.arcs[s]:
            like = -(arc.weight[0] + arc.weight[1])
            b = _logadd(b, beta[arc.nextstate] + like)
        beta[s] = b
    if not math.isfinite(tot_fwd):
        raise KaldiTpuError("no successful path in lattice")
    if abs(tot_fwd - beta[lat.start]) > 1e-4 * max(1.0, abs(tot_fwd)):
        raise KaldiTpuError(
            f"forward {tot_fwd} != backward {beta[lat.start]}")
    # second pass: accuracy expectations
    tot_score = 0.0
    for s in order:
        for arc in lat.arcs[s]:
            like = -(arc.weight[0] + arc.weight[1])
            acc = frame_acc_of(arc, times[s]) if times[s] < max_time \
                else 0.0
            scale = math.exp(alpha[s] + like - alpha[arc.nextstate]) \
                if alpha[arc.nextstate] > NEG / 2 else 0.0
            alpha_s[arc.nextstate] += scale * (alpha_s[s] + acc)
        f = lat.finals[s]
        if f != zero:
            scale = math.exp(alpha[s] - (f[0] + f[1]) - tot_fwd)
            tot_score += scale * alpha_s[s]
    post: List[List] = [[] for _ in range(max_time)]
    for s in reversed(order):
        for arc in lat.arcs[s]:
            like = -(arc.weight[0] + arc.weight[1])
            arc_beta = beta[arc.nextstate] + like
            acc = frame_acc_of(arc, times[s]) if times[s] < max_time \
                else 0.0
            scale = math.exp(arc_beta - beta[s]) \
                if beta[s] > NEG / 2 else 0.0
            if math.isnan(scale):
                scale = 0.0
            beta_s[s] += scale * (beta_s[arc.nextstate] + acc)
            if arc.ilabel != 0:
                posterior = math.exp(alpha[s] + arc_beta - tot_fwd)
                acc_diff = (alpha_s[s] + acc + beta_s[arc.nextstate]
                            - tot_score)
                post[times[s]].append((arc.ilabel, posterior * acc_diff))
    if abs(tot_score - beta_s[lat.start]) > 1e-3 * max(1.0, abs(tot_score)):
        raise KaldiTpuError(
            f"forward score {tot_score} != backward {beta_s[lat.start]}")
    # merge duplicate tids per frame (summing)
    merged: List[List] = []
    for row in post:
        acc_d: Dict[int, float] = {}
        for tid, w in row:
            acc_d[tid] = acc_d.get(tid, 0.0) + w
        merged.append(sorted(acc_d.items()))
    return tot_score, merged
