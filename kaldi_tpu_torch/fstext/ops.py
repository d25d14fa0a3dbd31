"""WFST algorithms on the VectorFst core (port of
`kaldi_tpu/fstext/ops.py`, whole).  Host-side.

Parity: the OpenFst operations of the reference's graph builds
(fstarcsort, fsttablecompose, fstrmepslocal, fstdeterminizestar,
fstminimizeencoded, fstpushspecial, fstshortestpath, fstreplace).
`minimize_encoded` serves the decoding-graph build of
`decoder/graph.py` `make_decoding_graph`; the graph tools of
`cli/fst_tools.py` run the rest as mkgraph.sh does.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        VectorFst)


def arcsort(fst: VectorFst, sort_type: str = "ilabel") -> VectorFst:
    key = ((lambda a: (a.ilabel, a.olabel)) if sort_type == "ilabel"
           else (lambda a: (a.olabel, a.ilabel)))
    for arcs in fst.arcs:
        arcs.sort(key=key)
    return fst


def connect(fst: VectorFst) -> VectorFst:
    """Trim states not both accessible and co-accessible (in place)."""
    n = fst.num_states
    if fst.start < 0:
        return fst
    # forward reachability
    acc = [False] * n
    stack = [fst.start]
    acc[fst.start] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs[s]:
            if not acc[a.nextstate]:
                acc[a.nextstate] = True
                stack.append(a.nextstate)
    # backward from finals
    preds: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            preds[a.nextstate].append(s)
    coacc = [False] * n
    stack = [s for s in range(n) if fst.is_final(s)]
    for s in stack:
        coacc[s] = True
    while stack:
        s = stack.pop()
        for p in preds[s]:
            if not coacc[p]:
                coacc[p] = True
                stack.append(p)
    keep = [s for s in range(n) if acc[s] and coacc[s]]
    remap = {s: i for i, s in enumerate(keep)}
    new_arcs = []
    new_finals = []
    for s in keep:
        new_arcs.append([Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate])
                         for a in fst.arcs[s] if a.nextstate in remap])
        new_finals.append(fst.finals[s])
    fst.arcs = new_arcs
    fst.finals = new_finals
    fst.start = remap.get(fst.start, -1)
    return fst


def project(fst: VectorFst, project_output: bool = False) -> VectorFst:
    for arcs in fst.arcs:
        for a in arcs:
            if project_output:
                a.ilabel = a.olabel
            else:
                a.olabel = a.ilabel
    return fst


def invert(fst: VectorFst) -> VectorFst:
    """Swap every arc's input and output label (in place; fstinvert)."""
    for arcs in fst.arcs:
        for a in arcs:
            a.ilabel, a.olabel = a.olabel, a.ilabel
    return fst


def relabel(fst: VectorFst, ilabel_map: Optional[Dict[int, int]] = None,
            olabel_map: Optional[Dict[int, int]] = None) -> VectorFst:
    for arcs in fst.arcs:
        for a in arcs:
            if ilabel_map is not None:
                a.ilabel = ilabel_map.get(a.ilabel, a.ilabel)
            if olabel_map is not None:
                a.olabel = olabel_map.get(a.olabel, a.olabel)
    return fst


def compose(fst1: VectorFst, fst2: VectorFst,
            connect_result: bool = True) -> VectorFst:
    """Compose fst1 ∘ fst2. Uses the 3-state epsilon filter to avoid
    duplicate epsilon paths."""
    sr = fst1.semiring
    assert fst2.semiring is sr
    out = VectorFst(sr)
    if fst1.start < 0 or fst2.start < 0:
        return out
    # sort fst2 by ilabel for binary search matching
    fst2_sorted: List[Tuple[List[int], List[Arc]]] = []
    for arcs in fst2.arcs:
        sa = sorted(arcs, key=lambda a: a.ilabel)
        fst2_sorted.append(([a.ilabel for a in sa], sa))

    state_map: Dict[Tuple[int, int, int], int] = {}
    queue: deque = deque()

    def get_state(t: Tuple[int, int, int]) -> int:
        if t not in state_map:
            state_map[t] = out.add_state()
            queue.append(t)
        return state_map[t]

    start = (fst1.start, fst2.start, 0)
    out.set_start(get_state(start))
    while queue:
        s1, s2, f = queue.popleft()
        cur = state_map[(s1, s2, f)]
        w_final = sr.times(fst1.finals[s1], fst2.finals[s2])
        out.finals[cur] = w_final
        labels2, arcs2 = fst2_sorted[s2]
        lo0 = bisect.bisect_left(labels2, EPS)
        hi0 = bisect.bisect_right(labels2, EPS)
        eps2_arcs = arcs2[lo0:hi0]
        for a1 in fst1.arcs[s1]:
            if a1.olabel == EPS:
                # ε₂ move: fst1 advances alone (filter 0 or 2 → 2)
                if f != 1:
                    ns = get_state((a1.nextstate, s2, 2))
                    out.add_arc(cur, Arc(a1.ilabel, EPS, a1.weight, ns))
                # combined (ε₂,ε₁) move from filter 0: both advance
                if f == 0:
                    for a2 in eps2_arcs:
                        ns = get_state((a1.nextstate, a2.nextstate, 0))
                        out.add_arc(cur, Arc(a1.ilabel, a2.olabel,
                                             sr.times(a1.weight, a2.weight),
                                             ns))
            else:
                lo = bisect.bisect_left(labels2, a1.olabel)
                hi = bisect.bisect_right(labels2, a1.olabel)
                for a2 in arcs2[lo:hi]:
                    ns = get_state((a1.nextstate, a2.nextstate, 0))
                    out.add_arc(cur, Arc(a1.ilabel, a2.olabel,
                                         sr.times(a1.weight, a2.weight), ns))
        # ε₁ move: fst2 advances alone (filter 0 or 1 → 1)
        if f != 2:
            for a2 in eps2_arcs:
                ns = get_state((s1, a2.nextstate, 1))
                out.add_arc(cur, Arc(EPS, a2.olabel, a2.weight, ns))
    if connect_result:
        connect(out)
    return out


def _eps_closure(fst: VectorFst, s: int) -> List[Tuple[int, object]]:
    """All (state, weight) reachable from s via epsilon (ilabel==olabel==0)
    paths, including (s, one). Assumes no negative-weight eps cycles."""
    sr = fst.semiring
    dist: Dict[int, object] = {s: sr.one}
    queue = deque([s])
    while queue:
        u = queue.popleft()
        for a in fst.arcs[u]:
            if a.ilabel == EPS and a.olabel == EPS:
                w = sr.times(dist[u], a.weight)
                old = dist.get(a.nextstate, sr.zero)
                new = sr.plus(old, w)
                if new != old:
                    dist[a.nextstate] = new
                    queue.append(a.nextstate)
    return list(dist.items())


def rm_epsilon(fst: VectorFst) -> VectorFst:
    """Remove all (eps,eps) arcs, preserving weighted equivalence."""
    sr = fst.semiring
    out = VectorFst(sr)
    out.add_states(fst.num_states)
    out.start = fst.start
    for s in range(fst.num_states):
        final = sr.zero
        seen_arcs: List[Arc] = []
        for t, w in _eps_closure(fst, s):
            final = sr.plus(final, sr.times(w, fst.finals[t]))
            for a in fst.arcs[t]:
                if not (a.ilabel == EPS and a.olabel == EPS):
                    seen_arcs.append(Arc(a.ilabel, a.olabel,
                                         sr.times(w, a.weight), a.nextstate))
        out.finals[s] = final
        out.arcs[s] = seen_arcs
    return connect(out)


def remove_eps_local(fst: VectorFst) -> VectorFst:
    """Equivalent of fstrmepslocal: removes epsilons where possible
    without increasing the FST size. This implementation performs full
    epsilon removal (always correct; size growth is not a concern at
    decoding-graph scale after determinization)."""
    return rm_epsilon(fst)


def determinize_star(fst: VectorFst, delta: float = 1e-4,
                     max_states: int = 10_000_000,
                     functional: bool = True) -> VectorFst:
    """functional=True: the classic DeterminizeStar contract (errors on
    non-functional input). functional=False: lattice-determinization
    semantics — when two paths with the same input sequence carry
    different output strings, keep the better-weight one (the
    CompactLatticeWeight Plus of lattice-weight.h:424)."""
    sr = fst.semiring
    out = VectorFst(sr)
    if fst.start < 0:
        return out

    def better(w1, w2) -> bool:
        """True if w1 strictly preferred over w2 by the semiring plus."""
        return sr.plus(w1, w2) == w1 and w1 != w2

    def quant(w):
        if hasattr(sr, "quantize"):
            return sr.quantize(w, delta)
        if sr is LatticeWeight:
            return (round(w[0] / delta), round(w[1] / delta))
        return round(w / delta) if w != INF else INF

    # subset: frozenset of (state, quantized-residual-weight, out-string)
    # real values kept in dict alongside
    def canon(subset: Dict[Tuple[int, Tuple], object]):
        items = tuple(sorted((s, strg, quant(w))
                             for (s, strg), w in subset.items()))
        return items

    def eps_expand(pairs: List[Tuple[int, Tuple[int, ...], object]]):
        """Expand epsilon-input arcs: returns dict
        {(state, out_string): weight}."""
        if functional:
            dist: Dict[Tuple[int, Tuple[int, ...]], object] = {}
            queue = deque()
            for s, strg, w in pairs:
                k = (s, strg)
                old = dist.get(k, sr.zero)
                dist[k] = sr.plus(old, w)
                queue.append(k)
            while queue:
                s, strg = queue.popleft()
                w = dist[(s, strg)]
                for a in fst.arcs[s]:
                    if a.ilabel == EPS:
                        nstr = strg if a.olabel == EPS else strg + (a.olabel,)
                        if len(nstr) > 5000:
                            raise RuntimeError(
                                "determinize_star: output-string blowup "
                                "(epsilon cycle with output?)")
                        k = (a.nextstate, nstr)
                        nw = sr.times(w, a.weight)
                        old = dist.get(k, sr.zero)
                        new = sr.plus(old, nw)
                        if new != old:
                            dist[k] = new
                            queue.append(k)
            return dist
        # non-functional: key by state; keep (weight, string) with the
        # preferred weight
        best: Dict[int, Tuple[object, Tuple[int, ...]]] = {}
        queue = deque()
        for s, strg, w in pairs:
            cur = best.get(s)
            if cur is None or better(w, cur[0]):
                best[s] = (w, strg)
                queue.append(s)
        while queue:
            s = queue.popleft()
            w, strg = best[s]
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    nstr = strg if a.olabel == EPS else strg + (a.olabel,)
                    if len(nstr) > 5000:
                        raise RuntimeError(
                            "determinize_star: output-string blowup")
                    nw = sr.times(w, a.weight)
                    cur = best.get(a.nextstate)
                    if cur is None or better(nw, cur[0]):
                        best[a.nextstate] = (nw, nstr)
                        queue.append(a.nextstate)
        return {(s, strg): w for s, (w, strg) in best.items()}

    subset_map: Dict[Tuple, int] = {}
    work: deque = deque()

    def common_divisor(weights):
        """For tropical/lattice: min; used to normalize subsets."""
        it = iter(weights)
        acc = next(it)
        for w in it:
            acc = sr.plus(acc, w)
        return acc

    def get_out_state(subset_dict) -> Tuple[int, object, Tuple[int, ...]]:
        """Normalize subset: factor out common weight and common output
        prefix; return (out_state_id, common_weight, common_string)."""
        common_w = common_divisor(subset_dict.values())
        # common prefix of all strings
        strings = [strg for (s, strg) in subset_dict.keys()]
        prefix = strings[0]
        for st in strings[1:]:
            i = 0
            while i < len(prefix) and i < len(st) and prefix[i] == st[i]:
                i += 1
            prefix = prefix[:i]
        plen = len(prefix)
        norm = {(s, strg[plen:]): sr.divide(w, common_w)
                for (s, strg), w in subset_dict.items()}
        key = canon(norm)
        if key not in subset_map:
            if len(subset_map) >= max_states:
                raise RuntimeError("determinize_star: state blowup")
            subset_map[key] = out.add_state()
            work.append((key, norm))
        return subset_map[key], common_w, prefix

    def emit(src: int, ilabel: int, weight, out_string: Tuple[int, ...],
             dest: int):
        """Add arc src --ilabel:out_string/weight--> dest, spreading
        strings > 1 over chain states."""
        if len(out_string) == 0:
            out.add_arc(src, Arc(ilabel, EPS, weight, dest))
            return
        cur = src
        for i, ol in enumerate(out_string):
            il = ilabel if i == 0 else EPS
            w = weight if i == 0 else sr.one
            if i == len(out_string) - 1:
                nxt = dest
            else:
                nxt = out.add_state()
            out.add_arc(cur, Arc(il, ol, w, nxt))
            cur = nxt

    # initialize
    init = eps_expand([(fst.start, (), sr.one)])
    s0, w0, p0 = get_out_state(init)
    if w0 != sr.one or p0:
        # need a super-start carrying the common weight/string
        real_start = out.add_state()
        out.set_start(real_start)
        emit(real_start, EPS, w0, p0, s0)
    else:
        out.set_start(s0)

    while work:
        key, subset = work.popleft()
        cur = subset_map[key]
        # final weight: sum over final states; final strings must agree
        final_w = sr.zero
        final_strings = set()
        best_final: Optional[Tuple[object, Tuple[int, ...]]] = None
        for (s, strg), w in subset.items():
            if fst.is_final(s):
                final_strings.add(strg)
                fw = sr.times(w, fst.finals[s])
                final_w = sr.plus(final_w, fw)
                if best_final is None or better(fw, best_final[0]):
                    best_final = (fw, strg)
        if len(final_strings) > 1:
            if functional:
                raise RuntimeError(
                    "determinize_star: FST is not functional (conflicting "
                    "output strings at final states)")
            # lattice semantics: keep the best final (weight, string)
            final_w, only = best_final
            final_strings = {only}
        if final_strings and next(iter(final_strings)):
            # residual output string at final state: append via eps arcs
            fstate = out.add_state()
            out.finals[fstate] = sr.one
            emit(cur, EPS, final_w, next(iter(final_strings)), fstate)
        else:
            out.finals[cur] = final_w
        # group non-eps transitions by ilabel
        by_label: Dict[int, List[Tuple[int, Tuple[int, ...], object]]] = \
            defaultdict(list)
        for (s, strg), w in subset.items():
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    nstr = strg if a.olabel == EPS else strg + (a.olabel,)
                    by_label[a.ilabel].append(
                        (a.nextstate, nstr, sr.times(w, a.weight)))
        for ilabel, pairs in sorted(by_label.items()):
            expanded = eps_expand(pairs)
            dest, w, prefix = get_out_state(expanded)
            emit(cur, ilabel, w, prefix, dest)
    return out


# fstminimizeencoded: encode (ilabel, olabel, weight) -> label, Moore
# partition refinement, decode

def minimize_encoded(fst: VectorFst, delta: float = 1e-4) -> VectorFst:
    n = fst.num_states
    if n == 0:
        return fst
    sr = fst.semiring

    def qw(w):
        if sr is LatticeWeight:
            return (round(w[0] / delta) if w[0] != INF else INF,
                    round(w[1] / delta) if w[1] != INF else INF)
        return round(w / delta) if w != INF else INF

    # encode arcs
    enc: Dict[Tuple, int] = {}

    def code(a: Arc) -> int:
        k = (a.ilabel, a.olabel, qw(a.weight))
        if k not in enc:
            enc[k] = len(enc)
        return k and enc[k]

    coded: List[List[Tuple[int, int]]] = []
    for s in range(n):
        coded.append([(code(a), a.nextstate) for a in fst.arcs[s]])

    # initial partition: by final weight
    part = {}
    blocks: Dict[Tuple, int] = {}
    for s in range(n):
        k = qw(fst.finals[s])
        if k not in blocks:
            blocks[k] = len(blocks)
        part[s] = blocks[k]
    # Moore refinement to fixpoint
    while True:
        sig: Dict[Tuple, int] = {}
        new_part = {}
        for s in range(n):
            signature = (part[s],
                         tuple(sorted((c, part[ns]) for c, ns in coded[s])))
            if signature not in sig:
                sig[signature] = len(sig)
            new_part[s] = sig[signature]
        if len(sig) == len(set(part.values())):
            part = new_part
            break
        part = new_part

    nblocks = len(set(part.values()))
    if nblocks == n:
        return fst
    out = VectorFst(sr)
    out.add_states(nblocks)
    rep: Dict[int, int] = {}
    for s in range(n):
        rep.setdefault(part[s], s)
    for b, s in rep.items():
        out.finals[b] = fst.finals[s]
        seen = set()
        for a in fst.arcs[s]:
            k = (a.ilabel, a.olabel, qw(a.weight), part[a.nextstate])
            if k in seen:
                continue
            seen.add(k)
            out.add_arc(b, Arc(a.ilabel, a.olabel, a.weight, part[a.nextstate]))
    out.start = part[fst.start]
    connect(out)
    return out


# ---------------------------------------------------------------------------
# Shortest distance / path (tropical)

def shortest_distance(fst: VectorFst, reverse: bool = False) -> List[float]:
    """Single-source shortest distances over the tropical semiring
    (label-correcting; handles negative arcs, assumes no negative cycles)."""
    n = fst.num_states
    dist = [INF] * n
    if n == 0:
        return dist
    if not reverse:
        adj = fst.arcs
        init = {fst.start: 0.0}
    else:
        adj_r: List[List[Arc]] = [[] for _ in range(n)]
        for s in range(n):
            for a in fst.arcs[s]:
                adj_r[a.nextstate].append(Arc(a.ilabel, a.olabel, a.weight, s))
        adj = adj_r
        init = {s: fst.finals[s] for s in range(n) if fst.is_final(s)}
    inq = [False] * n
    queue = deque()
    for s, w in init.items():
        dist[s] = min(dist[s], w)
        queue.append(s)
        inq[s] = True
    while queue:
        s = queue.popleft()
        inq[s] = False
        for a in adj[s]:
            nd = dist[s] + a.weight
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                if not inq[a.nextstate]:
                    queue.append(a.nextstate)
                    inq[a.nextstate] = True
    return dist


def shortest_path(fst: VectorFst) -> VectorFst:
    """Single best path (tropical), returned as a linear FST."""
    sr = fst.semiring
    n = fst.num_states
    out = VectorFst(sr)
    if n == 0 or fst.start < 0:
        return out
    if sr is LatticeWeight:
        tot = lambda w: w[0] + w[1]
    else:
        tot = lambda w: w
    dist = [INF] * n
    back: List[Optional[Tuple[int, Arc]]] = [None] * n
    dist[fst.start] = 0.0
    inq = [False] * n
    queue = deque([fst.start])
    inq[fst.start] = True
    while queue:
        s = queue.popleft()
        inq[s] = False
        for a in fst.arcs[s]:
            nd = dist[s] + tot(a.weight)
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
                if not inq[a.nextstate]:
                    queue.append(a.nextstate)
                    inq[a.nextstate] = True
    best_state, best_cost = -1, INF
    for s in range(n):
        if fst.is_final(s):
            c = dist[s] + tot(fst.finals[s])
            if c < best_cost:
                best_cost, best_state = c, s
    if best_state < 0:
        return out
    # trace back
    path = []
    s = best_state
    while s != fst.start:
        p, a = back[s]
        path.append(a)
        s = p
    path.reverse()
    cur = out.add_state()
    out.set_start(cur)
    for a in path:
        ns = out.add_state()
        out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight, ns))
        cur = ns
    out.finals[cur] = fst.finals[best_state]
    return out


# ---------------------------------------------------------------------------
# Path-language comparison for tests (replaces OpenFst Equivalent for
# the small random FSTs used in unit tests)

def _all_paths(fst: VectorFst, max_len: int = 8, max_paths: int = 20000):
    """Enumerate (ilabels, olabels) -> total weight for paths up to
    max_len arcs (tropical aggregation)."""
    sr = fst.semiring
    results: Dict[Tuple[Tuple, Tuple], object] = {}
    if fst.start < 0:
        return results
    stack = [(fst.start, (), (), sr.one, 0)]
    count = 0
    while stack:
        s, ils, ols, w, depth = stack.pop()
        count += 1
        if count > max_paths:
            raise RuntimeError("too many paths")
        if fst.is_final(s):
            k = (ils, ols)
            tw = sr.times(w, fst.finals[s])
            results[k] = sr.plus(results.get(k, sr.zero), tw)
        if depth < max_len:
            for a in fst.arcs[s]:
                nil = ils if a.ilabel == EPS else ils + (a.ilabel,)
                nol = ols if a.olabel == EPS else ols + (a.olabel,)
                stack.append((a.nextstate, nil, nol,
                              sr.times(w, a.weight), depth + 1))
    return results


def equal_paths(fst1: VectorFst, fst2: VectorFst, max_len: int = 8,
                delta: float = 1e-3) -> bool:
    """True if the two FSTs assign the same weights to all transduction
    pairs with paths up to max_len arcs (test helper)."""
    sr = fst1.semiring
    p1 = _all_paths(fst1, max_len)
    p2 = _all_paths(fst2, max_len)
    # compare only pairs fully represented on both sides (truncation-safe):
    keys = set(p1) | set(p2)
    for k in keys:
        a = p1.get(k, sr.zero)
        b = p2.get(k, sr.zero)
        if a == sr.zero or b == sr.zero:
            if a != b:
                # might be truncation; only fail if path short
                if len(k[0]) < max_len - 1:
                    return False
            continue
        if not sr.approx_equal(a, b, delta):
            return False
    return True


def replace_fst(root: VectorFst, replacements: Dict[int, VectorFst]
                ) -> VectorFst:
    """FST replacement (the GrammarFst capability, decoder/grammar-fst.h:101,
    realized eagerly like fstreplace): arcs whose ilabel is a
    nonterminal key in `replacements` are spliced with a copy of the
    corresponding sub-FST (entering at its start, exiting to the arc's
    destination from its final states). The reference defers this to
    decode time; graphs at our scale can be expanded up front, and the
    on-demand variant remains an optimization."""
    sr = root.semiring
    out = VectorFst(sr)
    out.add_states(root.num_states)
    out.start = root.start
    for s in range(root.num_states):
        out.finals[s] = root.finals[s]
    for s in range(root.num_states):
        for a in root.arcs[s]:
            if a.ilabel not in replacements:
                out.add_arc(s, Arc(a.ilabel, a.olabel, a.weight, a.nextstate))
                continue
            sub = replacements[a.ilabel]
            if sub.start < 0:
                continue
            offset = out.num_states
            out.add_states(sub.num_states)
            # enter the sub-FST, carrying the arc's weight and olabel
            out.add_arc(s, Arc(EPS, a.olabel, a.weight, offset + sub.start))
            for t in range(sub.num_states):
                for b in sub.arcs[t]:
                    out.add_arc(offset + t, Arc(b.ilabel, b.olabel, b.weight,
                                                offset + b.nextstate))
                if sub.finals[t] != sr.zero:
                    out.add_arc(offset + t, Arc(EPS, EPS, sub.finals[t],
                                                a.nextstate))
    return connect(out)


def push_special(fst: VectorFst, delta: float = 1e-4,
                 max_iters: int = 200) -> VectorFst:
    """Special weight pushing (fstext/push-special.cc PushSpecial):
    reweights so every state's total outgoing probability mass —
    counting the final-prob as an arc back to the start state — equals
    one, WITHOUT requiring the whole FST to sum to one (regular pushing
    diverges on such graphs, e.g. HCLG).

    Solve M v = lam v by power iteration, where
    M[i]·v = sum_{arcs i->j} w(a) v[j] + f(i) v[start] (prob domain),
    then set  cost'(a) = cost(a) + log v[i] - log v[j] + log lam  and
    final'(i) = final(i) + log v[i] - log v[start] + log lam.  Each
    path's weight changes by lam^(arcs+1) — a per-frame constant, which
    is why this is safe on decoding graphs."""
    n = fst.num_states
    if n == 0 or fst.start < 0:
        return fst
    src, dst, w = [], [], []
    for s in range(n):
        for a in fst.arcs[s]:
            src.append(s)
            dst.append(a.nextstate)
            w.append(math.exp(-min(float(a.weight), 700.0)))
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float64)
    finals = np.array([math.exp(-min(float(fw), 700.0))
                       if fw != fst.semiring.zero else 0.0
                       for fw in fst.finals], np.float64)
    v = np.ones(n, np.float64)
    lam = 1.0
    # power iteration on (M + I): periodic graphs (e.g. a simple
    # start->final->start cycle) make pure power iteration oscillate
    # between eigenvectors of +/-lambda; the +I shift breaks the
    # periodicity without changing eigenvectors (lambda_M =
    # lambda_{M+I} - 1)
    for _ in range(max_iters):
        nv = np.zeros(n, np.float64)
        np.add.at(nv, src, w * v[dst])
        nv += finals * v[fst.start]
        nv += v
        lam_new = float(np.max(nv))
        if lam_new <= 1.0 + 1e-12:
            raise ValueError("push_special: FST has a dead state")
        nv = nv / lam_new
        if (abs(lam_new - lam) < delta * lam_new
                and float(np.max(np.abs(nv - v))) < delta):
            v, lam = nv, lam_new
            break
        v, lam = nv, lam_new
    lam = lam - 1.0
    log_v = np.log(np.maximum(v, 1e-290))
    log_lam = math.log(lam)
    out = VectorFst(fst.semiring)
    for _ in range(n):
        out.add_state()
    out.set_start(fst.start)
    for s in range(n):
        for a in fst.arcs[s]:
            out.add_arc(s, Arc(a.ilabel, a.olabel,
                               float(a.weight) + log_v[s] - log_v[a.nextstate]
                               + log_lam, a.nextstate))
        if fst.finals[s] != fst.semiring.zero:
            out.finals[s] = (float(fst.finals[s]) + log_v[s]
                             - log_v[fst.start] + log_lam)
    return out
