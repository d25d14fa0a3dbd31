"""Lattice-generating beam decoder on the host (port of
`kaldi_tpu/decoder/lattice_decoder.py`; parity:
decoder/lattice-faster-decoder.h:243 LatticeFasterDecoderTpl): per-frame
tokens with links, beam and max-active pruning, periodic link pruning
within the lattice beam, and the raw (state-level) lattice.  The
acoustic scores arrive as a (frames x pdfs) matrix.

The rules are the reference's, step for step: a frame's emitting arcs
leave the tokens within the beam (and the max-active cutoff) in the
order the tokens were made, a token keeps the first of its best costs,
the next frame keeps what is within the beam of its best, the epsilon
closure runs last-in first-out with a 1e-9 tolerance, every
prune_interval frames the links out of reach of the lattice beam go
(one reverse sweep over the links, as the reference makes it), and the
raw lattice holds the tokens within lattice_beam of the best final
path, its states numbered as the reference numbers them.

One rule is upstream's, not the reference's (a reference fault,
repaired): the periodic pruning measures a link against the frontier
token it leads to, not against the frontier's best token
(`_prune_links`).  Where the reference's pruning loses nothing that the
final lattice holds, the lattices are the same.

The layout is not the reference's dicts of tuples: a frame's emitting
arcs are expanded as arrays (the graph's non-epsilon arcs in CSR rows,
`GraphRows`), the links are kept as arrays a frame at a time, and a
token is an int64 key, (frame << 32) | state.  Only the epsilon closure,
the epsilon links' part of the sweeps and the lattice's assembly run a
link at a time, as the reference runs everything.

The graph is a VectorFst, whose rows are built whole up front, or any
object with `start`, `arcs[s]` and `finals[s]` (decoder/biglm.py's lazy
compositions, fstext/grammar_fst.py's GrammarFst): its states get local
ids as the search meets them, and a state's row is asked of it when the
search first reaches the state, so a lazy FST expands only those.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from kaldi_tpu_torch.base.logging import warn
from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        TropicalWeight, VectorFst)
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice


@dataclass
class LatticeFasterDecoderOptions:
    beam: float = field(default=16.0, metadata={"doc": "Decoding beam"})
    lattice_beam: float = field(default=10.0, metadata={"doc": "Lattice generation beam"})
    max_active: int = field(default=7000, metadata={"doc": "Max active states"})
    min_active: int = 200
    prune_interval: int = 25
    determinize_lattice: bool = True


class _Links:
    """A run of links made in one step: emitting (frame t to t + 1,
    `emit`) or epsilon (inside one frame), as parallel arrays."""
    __slots__ = ("emit", "src", "dst", "il", "ol", "g", "ac")

    def __init__(self, emit, src, dst, il, ol, g, ac):
        self.emit = emit
        self.src, self.dst, self.il, self.ol = src, dst, il, ol
        self.g, self.ac = g, ac

    def __len__(self):
        return len(self.src)

    def take(self, keep: np.ndarray) -> "_Links":
        return _Links(self.emit, self.src[keep], self.dst[keep],
                      self.il[keep], self.ol[keep], self.g[keep],
                      self.ac[keep])


class _Tokens:
    """Token costs by key: a frame's keys sorted, concatenated in frame
    order, so that the whole table is sorted and `index` is a binary
    search.  Removing tokens (the link pruning's dead ones) keeps it
    sorted."""

    def __init__(self):
        self.keys = np.zeros(0, np.int64)
        self.cost = np.zeros(0, np.float64)

    def add_frame(self, keys: np.ndarray, cost: np.ndarray) -> None:
        order = np.argsort(keys, kind="stable")
        self.keys = np.concatenate([self.keys, keys[order]])
        self.cost = np.concatenate([self.cost, cost[order]])

    def index(self, keys: np.ndarray) -> np.ndarray:
        """Positions of `keys` in the table, -1 where absent."""
        if not len(self.keys):
            return np.full(len(keys), -1, np.int64)
        pos = np.searchsorted(self.keys, keys)
        pos = np.minimum(pos, len(self.keys) - 1)
        return np.where(self.keys[pos] == keys, pos, -1)

    def keep(self, mask: np.ndarray) -> None:
        self.keys, self.cost = self.keys[mask], self.cost[mask]


def _grown(a: np.ndarray, n: int) -> np.ndarray:
    """`a` with room for at least n entries (capacity doubles)."""
    if n <= len(a):
        return a
    out = np.zeros(max(n, 2 * len(a), 16), a.dtype)
    out[:len(a)] = a
    return out


class GraphRows:
    """A decoding graph's emitting arcs as CSR rows over local state ids
    (`beg`, `cnt`; the arcs' `il`, `ol`, `w`, `dst`) and its epsilon arcs
    by state (`eps`: local id -> [(olabel, weight, next local id)], the
    states that have any).

    A VectorFst's rows are built whole and its local ids are its states.
    Any other FST is read on demand: `local` gives a state its id when a
    row first names it, and `need` asks the FST for the rows of the ids
    not read yet, so only the states the search reaches are expanded."""

    def __init__(self, fst):
        self.fst = fst
        self.lazy = not isinstance(fst, VectorFst)
        if self.lazy:
            self._ids: Dict[int, int] = {}
            self._ext: List[int] = []
            self._done = np.zeros(0, bool)
            self.beg = np.zeros(0, np.int64)
            self.cnt = np.zeros(0, np.int64)
            self.il = np.zeros(0, np.int64)
            self.ol = np.zeros(0, np.int64)
            self.w = np.zeros(0, np.float64)
            self.dst = np.zeros(0, np.int64)
            self.num_arcs = 0
            self.eps: Dict[int, list] = {}
            self.start = self.local(fst.start)
            return
        n = fst.num_states
        emit = [[a for a in arcs if a.ilabel != EPS] for arcs in fst.arcs]
        counts = np.array([len(a) for a in emit], np.int64)
        self.beg = np.concatenate([[0], np.cumsum(counts)[:-1]]) \
            .astype(np.int64) if n else np.zeros(0, np.int64)
        self.cnt = counts
        flat = [a for arcs in emit for a in arcs]
        self.il = np.array([a.ilabel for a in flat], np.int64)
        self.ol = np.array([a.olabel for a in flat], np.int64)
        self.w = np.array([a.weight for a in flat], np.float64)
        self.dst = np.array([a.nextstate for a in flat], np.int64)
        # the epsilon arcs of the states that have any, in arc order
        self.eps = {s: [(a.olabel, a.weight, a.nextstate) for a in arcs
                        if a.ilabel == EPS]
                    for s, arcs in enumerate(fst.arcs)
                    if any(a.ilabel == EPS for a in arcs)}
        self.start = fst.start

    @property
    def num_expanded(self) -> int:
        """States whose rows were read (all of a VectorFst's)."""
        return int(self._done.sum()) if self.lazy else len(self.cnt)

    def local(self, state: int) -> int:
        if not self.lazy:
            return state
        i = self._ids.get(state)
        if i is None:
            i = self._ids[state] = len(self._ext)
            self._ext.append(state)
        return i

    def external(self, local: int) -> int:
        return self._ext[local] if self.lazy else local

    def final(self, local: int):
        return self.fst.finals[self.external(local)]

    def _room(self) -> None:
        """Row arrays as long as the local ids given so far."""
        n = len(self._ext)
        if len(self._done) < n:
            self._done = _grown(self._done, n)
            self.beg = _grown(self.beg, n)
            self.cnt = _grown(self.cnt, n)

    def need(self, states) -> None:
        """Read the rows of the local ids in `states` not read yet."""
        if not self.lazy:
            return
        self._room()
        states = np.asarray(states, np.int64)
        todo = states[~self._done[states]]
        if not len(todo):
            return
        # the unread ids once each, in the order they come
        _, first = np.unique(todo, return_index=True)
        for s in todo[np.sort(first)].tolist():
            arcs = self.fst.arcs[self._ext[s]]
            emit = [a for a in arcs if a.ilabel != EPS]
            k, m = self.num_arcs, len(emit)
            if m:
                for name in ("il", "ol", "w", "dst"):
                    setattr(self, name, _grown(getattr(self, name), k + m))
                self.il[k:k + m] = [a.ilabel for a in emit]
                self.ol[k:k + m] = [a.olabel for a in emit]
                self.w[k:k + m] = [a.weight for a in emit]
                self.dst[k:k + m] = [self.local(a.nextstate) for a in emit]
            eps = [(a.olabel, a.weight, self.local(a.nextstate))
                   for a in arcs if a.ilabel == EPS]
            if eps:
                self.eps[s] = eps
            self._room()
            self.beg[s], self.cnt[s] = k, m
            self.num_arcs = k + m
            self._done[s] = True


class LatticeFasterDecoder:
    def __init__(self, fst,
                 opts: Optional[LatticeFasterDecoderOptions] = None):
        self.fst = fst
        self.opts = opts or LatticeFasterDecoderOptions()
        self.stats: Dict[str, int] = {}
        self.rows = GraphRows(fst)

    # -- the frame loop ------------------------------------------------------

    def decode(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray,
               acoustic_scale: float = 1.0) -> Optional[Lattice]:
        """The raw (state-level) lattice: ilabels transition ids, olabels
        words, weights (graph_cost, acoustic_cost); None when no token
        survives a frame or no final path exists."""
        opts, rows = self.opts, self.rows
        T = loglikes.shape[0]
        self.stats = {"max_live_links": 0}
        tid = np.asarray(tid_to_pdf, np.int64)
        pdf = None if rows.lazy else tid[rows.il]
        tokens = _Tokens()
        links: List[_Links] = []
        # `cur`: the frame's tokens, in the order they were made
        cur = self._closure({rows.start: 0.0}, 0, links)
        cur_s = np.fromiter(cur.keys(), np.int64, len(cur))
        cur_c = np.fromiter(cur.values(), np.float64, len(cur))
        tokens.add_frame(cur_s, cur_c)
        for t in range(T):
            frame = np.asarray(loglikes[t], np.float64)
            cutoff = cur_c.min() + opts.beam
            if len(cur_c) > opts.max_active:
                cutoff = min(cutoff, np.partition(
                    cur_c, opts.max_active - 1)[opts.max_active - 1])
            act = cur_c <= cutoff
            src_s, src_c = cur_s[act], cur_c[act]
            rows.need(src_s)
            cnt = rows.cnt[src_s]
            total = int(cnt.sum())
            run = np.repeat(np.cumsum(cnt) - cnt, cnt)
            arc = np.repeat(rows.beg[src_s], cnt) \
                + np.arange(total, dtype=np.int64) - run
            il = rows.il[arc]
            ac = -acoustic_scale * frame[tid[il] if pdf is None
                                         else pdf[arc]]
            nc = np.repeat(src_c, cnt) + rows.w[arc] + ac
            dst = rows.dst[arc]
            links.append(_Links(True, np.repeat(src_s, cnt) | (t << 32),
                                dst | ((t + 1) << 32), il,
                                rows.ol[arc], rows.w[arc], ac))
            finite = nc < INF
            if not finite.any():
                warn(f"lattice decode: no tokens at frame {t}")
                return None
            # each next state's best cost, the states in the order of
            # their first finite arc
            d_f, c_f = dst[finite], nc[finite]
            uniq, first, inv = np.unique(d_f, return_index=True,
                                         return_inverse=True)
            best = np.full(len(uniq), INF)
            np.minimum.at(best, inv, c_f)
            order = np.argsort(first, kind="stable")
            nxt_s, nxt_c = uniq[order], best[order]
            keep = nxt_c <= nxt_c.min() + opts.beam
            nxt_s, nxt_c = nxt_s[keep], nxt_c[keep]
            rows.need(nxt_s)
            if rows.eps and any(int(s) in rows.eps for s in nxt_s):
                nxt = self._closure(dict(zip(nxt_s.tolist(),
                                             nxt_c.tolist())), t + 1, links)
                nxt_s = np.fromiter(nxt.keys(), np.int64, len(nxt))
                nxt_c = np.fromiter(nxt.values(), np.float64, len(nxt))
            tokens.add_frame(nxt_s | ((t + 1) << 32), nxt_c)
            cur_s, cur_c = nxt_s, nxt_c
            if opts.prune_interval > 0 and (t + 1) % opts.prune_interval \
                    == 0:
                links = self._prune_links(links, tokens, cur_s, cur_c, t + 1)
                self.stats["max_live_links"] = max(
                    self.stats["max_live_links"], sum(map(len, links)))
        self.stats["states_expanded"] = rows.num_expanded
        return self._raw_lattice(links, tokens, cur_s, T)

    def _closure(self, tokens: Dict[int, float], t: int,
                 links: List[_Links]) -> Dict[int, float]:
        """The reference's epsilon closure, last in first out; appends the
        epsilon links it walks to `links` as one run."""
        rows = self.rows
        eps = rows.eps
        rows.need(list(tokens))
        queue = [s for s in tokens if s in eps]
        limit = min(tokens.values(), default=0.0) + self.opts.beam
        rec = []
        while queue:
            s = queue.pop()
            c = tokens[s]
            if c > limit:
                continue
            for ol, w, d in eps[s]:
                nc = c + w
                rec.append((s, d, ol, w))
                if nc < tokens.get(d, INF) - 1e-9:
                    tokens[d] = nc
                    rows.need((d,))
                    if d in eps:
                        queue.append(d)
        if rec:
            s, d, ol, w = (np.array(x) for x in zip(*rec))
            links.append(_Links(False, s.astype(np.int64) | (t << 32),
                                d.astype(np.int64) | (t << 32),
                                np.zeros(len(rec), np.int64),
                                ol.astype(np.int64), w.astype(np.float64),
                                np.zeros(len(rec))))
        return tokens

    # -- link pruning ----------------------------------------------------------

    @staticmethod
    def _sweep(links: List[_Links], tokens: _Tokens,
               back: np.ndarray) -> List[np.ndarray]:
        """One reverse sweep over the links, as the reference makes it:
        back[src] = min(back[src], back[dst] + g + ac), the runs in reverse
        order, an epsilon run a link at a time in reverse.  `back` is
        aligned with the token table (inf: unset) and updated in place;
        -> each run's destination positions."""
        dpos = [tokens.index(r.dst) for r in links]
        for r, dp in zip(reversed(links), reversed(dpos)):
            sp = tokens.index(r.src)
            b = np.where(dp >= 0, back[np.maximum(dp, 0)], INF)
            nb = b + r.g + r.ac
            if r.emit:
                ok = (nb < INF) & (sp >= 0)
                np.minimum.at(back, sp[ok], nb[ok])
                continue
            g = r.g + r.ac
            for i in range(len(r) - 1, -1, -1):
                if dp[i] < 0 or sp[i] < 0 or back[dp[i]] == INF:
                    continue
                v = back[dp[i]] + g[i]
                if v < back[sp[i]]:
                    back[sp[i]] = v
        return dpos

    def _prune_links(self, links: List[_Links], tokens: _Tokens,
                     front_s: np.ndarray, front_c: np.ndarray,
                     t: int) -> List[_Links]:
        """Drop the links not on a path within lattice_beam of the best
        path into some token of the frontier (frame t), and the token costs
        no kept link touches.  Each frontier token is an end as good as the
        best (upstream's PruneForwardLinks gives it extra cost 0): its
        backward cost starts at best - cost, so that a link's extra cost is
        measured against the frontier token it leads to.  The reference
        starts every frontier token at 0 instead, which measures the links
        into a token beyond lattice_beam of the best against the best, and
        drops them all: when that token's path wins later, its lattice has
        lost its start (the lattice then begins at the frame of the
        pruning)."""
        best = front_c.min()
        cutoff = best + self.opts.lattice_beam
        back = np.full(len(tokens.keys), INF)
        back[tokens.index(front_s | (t << 32))] = best - front_c
        dpos = self._sweep(links, tokens, back)
        kept, live = [], np.zeros(len(tokens.keys), bool)
        for r, dp in zip(links, dpos):
            sp = tokens.index(r.src)
            c = np.where(sp >= 0, tokens.cost[np.maximum(sp, 0)], INF)
            b = np.where(dp >= 0, back[np.maximum(dp, 0)], INF)
            ok = (sp >= 0) & (dp >= 0) & (b < INF) & (c < INF)
            ok &= ((c + r.g) + r.ac) + b <= cutoff
            if ok.any():
                rr = r.take(ok)
                kept.append(rr)
                live[sp[ok]] = True
                live[dp[ok]] = True
        live[tokens.index(front_s | (t << 32))] = True
        tokens.keep(live)
        return kept

    # -- the raw lattice -------------------------------------------------------

    def _raw_lattice(self, links: List[_Links], tokens: _Tokens,
                     last_s: np.ndarray, T: int) -> Optional[Lattice]:
        rows = self.rows
        finals = {int(s): rows.final(s) for s in last_s
                  if rows.final(s) != TropicalWeight.zero}
        if not finals:
            warn("lattice decode: no final tokens; using all last-frame "
                 "tokens as final")
            finals = {int(s): 0.0 for s in last_s}
        # backward costs: the fixed point the reference's queue reaches,
        # a frame at a time from the last: the emitting runs out of frame
        # f (slot 2f + 1), then the epsilon runs inside it (slot 2f)
        back = np.full(len(tokens.keys), INF)
        fpos = tokens.index(np.array(list(finals), np.int64) | (T << 32))
        back[fpos[fpos >= 0]] = [fw for p, fw in zip(fpos, finals.values())
                                 if p >= 0]
        by_frame: Dict[int, List[_Links]] = {}
        for r in links:
            if len(r):
                f = int(r.src[0] >> 32)
                by_frame.setdefault(2 * f + (1 if r.emit else 0),
                                    []).append(r)
        for slot in range(2 * T + 1, -1, -1):
            for r in by_frame.get(slot, ()):
                sp, dp = tokens.index(r.src), tokens.index(r.dst)
                g = r.g + r.ac
                if r.emit:
                    b = np.where(dp >= 0, back[np.maximum(dp, 0)], INF)
                    ok = (sp >= 0) & (b < INF)
                    np.minimum.at(back, sp[ok], b[ok] + g[ok])
            eps = [r for r in by_frame.get(slot, ()) if not r.emit]
            changed = bool(eps)
            while changed:
                changed = False
                for r in eps:
                    sp, dp = tokens.index(r.src), tokens.index(r.dst)
                    g = r.g + r.ac
                    for i in range(len(r)):
                        if sp[i] < 0 or dp[i] < 0 or back[dp[i]] == INF:
                            continue
                        v = back[dp[i]] + g[i]
                        if v < back[sp[i]] - 1e-9:
                            back[sp[i]] = v
                            changed = True
        best_total = min((float(tokens.cost[p]) + fw
                          for p, fw in zip(fpos, finals.values()) if p >= 0),
                         default=INF)
        if best_total == INF:
            return None
        keep = (back < INF) & (tokens.cost + back
                               <= best_total + self.opts.lattice_beam)
        lat = VectorFst(LatticeWeight)
        state_of: Dict[int, int] = {}

        def get(k: int) -> int:
            if k not in state_of:
                state_of[k] = lat.add_state()
            return state_of[k]

        start = tokens.index(np.array([rows.start], np.int64))[0]
        if start < 0 or not keep[start]:
            cand = np.flatnonzero(keep)
            frames = tokens.keys[cand] >> 32
            first = cand[frames == frames.min()]
            start = first[np.argmin(tokens.cost[first])]
        lat.set_start(get(int(tokens.keys[start])))
        seen = set()
        for r in links:
            sp, dp = tokens.index(r.src), tokens.index(r.dst)
            ok = (sp >= 0) & (dp >= 0)
            ok[ok] = keep[sp[ok]] & keep[dp[ok]]
            for i in np.flatnonzero(ok):
                src, dst = int(r.src[i]), int(r.dst[i])
                il, ol = int(r.il[i]), int(r.ol[i])
                g, a = float(r.g[i]), float(r.ac[i])
                sig = (src, dst, il, ol, round(g, 6), round(a, 6))
                if sig in seen:
                    continue
                seen.add(sig)
                lat.add_arc(get(src), Arc(il, ol, (g, a), get(dst)))
        for p, (s, fw) in zip(fpos, finals.items()):
            if p >= 0 and keep[p]:
                lat.finals[get(s | (T << 32))] = (fw, 0.0)
        connect(lat)
        return lat
