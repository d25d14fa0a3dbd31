"""CPU Viterbi decoding over decoding graphs: the host token-passing
decoder that every device decoder is held against (port of
`FasterDecoderOptions` and `FasterDecoder` of
`kaldi_tpu/decoder/viterbi.py`).

Parity: decoder/faster-decoder.h (beam token passing with
ProcessEmitting/ProcessNonemitting).  The acoustic scores arrive as a
precomputed (frames x pdfs) matrix, so this host loop only does the
data-dependent search.

`align_equal` (bin/align-equal-compiled) gives the flat-start alignment
of monophone training: a seeded random feasible path through the
training graph, the spare frames spread evenly as self-loops.
`best_path_through` is the exact search (no beam), the reference's
SimpleDecoder.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst

INF = float("inf")
_log = logging.getLogger(__name__)


@dataclass
class FasterDecoderOptions:
    beam: float = field(default=16.0, metadata={"doc": "Decoding beam. Larger->slower, more accurate"})
    max_active: int = field(default=2147483647, metadata={"doc": "Decoder max active states. Larger->slower; more accurate"})
    min_active: int = field(default=20, metadata={"doc": "Decoder min active states"})
    beam_delta: float = 0.5
    hash_ratio: float = 2.0


class _Token:
    __slots__ = ("cost", "prev", "arc_ilabel", "arc_olabel")

    def __init__(self, cost, prev, ilabel, olabel):
        self.cost = cost
        self.prev = prev
        self.arc_ilabel = ilabel
        self.arc_olabel = olabel


class FasterDecoder:
    """Beam Viterbi producing the best path (alignment + words)."""

    def __init__(self, fst: VectorFst, opts: Optional[FasterDecoderOptions] = None):
        self.fst = fst
        self.opts = opts or FasterDecoderOptions()

    def decode(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray,
               acoustic_scale: float = 1.0,
               word_ins_penalty: float = 0.0
               ) -> Optional[Tuple[List[int], List[int], float]]:
        """loglikes: (T, num_pdfs). Returns (alignment transition-ids,
        word ids, total cost) for the best path reaching a final state,
        or None if decoding failed."""
        fst = self.fst
        beam = self.opts.beam
        emitting = self.emitting_arcs(tid_to_pdf)
        # active tokens: state -> _Token
        cur: Dict[int, _Token] = {fst.start: _Token(0.0, None, 0, 0)}
        cur = self._process_nonemitting(cur, beam, word_ins_penalty)
        for t in range(loglikes.shape[0]):
            nxt = self._process_emitting(cur, emitting, loglikes[t],
                                         acoustic_scale, word_ins_penalty)
            if not nxt:
                _log.warning("no tokens survived at frame %d", t)
                return None
            cur = self._process_nonemitting(nxt, beam, word_ins_penalty)
        # final
        best_tok: Optional[_Token] = None
        best_cost = INF
        for state, tok in cur.items():
            fw = fst.finals[state]
            if fw == TropicalWeight.zero:
                continue
            c = tok.cost + fw
            if c < best_cost:
                best_cost = c
                best_tok = tok
        if best_tok is None:
            _log.warning("no final state reached")
            return None
        alignment: List[int] = []
        words: List[int] = []
        tok = best_tok
        while tok is not None:
            if tok.arc_ilabel != EPS:
                alignment.append(tok.arc_ilabel)
            if tok.arc_olabel != EPS:
                words.append(tok.arc_olabel)
            tok = tok.prev
        alignment.reverse()
        words.reverse()
        return alignment, words, best_cost

    def emitting_arcs(self, tid_to_pdf: np.ndarray) -> list:
        """Each state's emitting arcs as (ilabel, olabel, weight,
        nextstate, pdf) tuples, the pdfs looked up once."""
        return [[(a.ilabel, a.olabel, a.weight, a.nextstate,
                  int(tid_to_pdf[a.ilabel]))
                 for a in arcs if a.ilabel != EPS] for arcs in self.fst.arcs]

    def _process_emitting(self, cur: Dict[int, _Token], emitting: list,
                          frame: np.ndarray, acoustic_scale: float,
                          word_ins_penalty: float) -> Dict[int, _Token]:
        """ProcessEmitting for one frame: the tokens of `cur` within the
        adaptive cutoff through their emitting arcs (`emitting_arcs`) ->
        the new tokens within the beam of the best (empty if none)."""
        beam = self.opts.beam
        # the frame's acoustic costs, each -acoustic_scale * float(x)
        ac = (-acoustic_scale * np.asarray(frame, np.float64)).tolist()
        nxt: Dict[int, _Token] = {}
        # adaptive pruning cutoff
        cutoff = min(tok.cost for tok in cur.values()) + beam
        if len(cur) > self.opts.max_active:
            costs = sorted(tok.cost for tok in cur.values())
            cutoff = min(cutoff, costs[self.opts.max_active - 1])
        next_best = INF
        for state, tok in cur.items():
            cost = tok.cost
            if cost > cutoff:
                continue
            for ilabel, olabel, weight, nextstate, pdf in emitting[state]:
                c = cost + weight + ac[pdf]
                if word_ins_penalty and olabel != EPS:
                    c += word_ins_penalty
                if c >= next_best + beam:
                    continue
                old = nxt.get(nextstate)
                if old is None or c < old.cost:
                    nxt[nextstate] = _Token(c, tok, ilabel, olabel)
                    if c < next_best:
                        next_best = c
        # prune against the updated best
        cutoff = next_best + beam
        return {s: tok for s, tok in nxt.items() if tok.cost <= cutoff}

    def _process_nonemitting(self, tokens: Dict[int, _Token],
                             beam: float,
                             word_ins_penalty: float = 0.0
                             ) -> Dict[int, _Token]:
        """Epsilon-closure of the token set (ProcessNonemitting)."""
        fst = self.fst
        queue = list(tokens.keys())
        best = min((t.cost for t in tokens.values()), default=0.0)
        cutoff = best + beam
        while queue:
            state = queue.pop()
            tok = tokens[state]
            if tok.cost > cutoff:
                continue
            for a in fst.arcs[state]:
                if a.ilabel != EPS:
                    continue
                c = tok.cost + a.weight
                if word_ins_penalty and a.olabel != EPS:
                    c += word_ins_penalty
                old = tokens.get(a.nextstate)
                if old is None or c < old.cost - 1e-9:
                    tokens[a.nextstate] = _Token(c, tok, EPS, a.olabel)
                    queue.append(a.nextstate)
        return tokens


def best_path_through(fst: VectorFst, loglikes: np.ndarray,
                      tid_to_pdf: np.ndarray, acoustic_scale: float = 1.0
                      ) -> Optional[Tuple[List[int], List[int], float]]:
    """Exact Viterbi (no beam): the reference's SimpleDecoder."""
    dec = FasterDecoder(fst, FasterDecoderOptions(beam=1e9))
    return dec.decode(loglikes, tid_to_pdf, acoustic_scale)


def _random_feasible_path(graph: VectorFst, num_frames: int,
                          seed: int = 0) -> Optional[List[Arc]]:
    """Random forward path (self-loops excluded) from start to a final
    state whose emitting-arc count fits in num_frames.

    Feasibility: mn[s] = min #emitting arcs from s to any final state
    (multi-source BFS on the reversed graph, 0/1 weights); an arc is
    admissible iff used + cost + mn[next] <= num_frames.  Among
    admissible arcs we choose uniformly at random, seeded per
    utterance by the caller — a CORPUS-level constant seed would give
    every same-length utterance the same junction decisions and bias
    the flat-start stats systematically.  Random choice at the
    optional-silence junctions is what seeds the silence GMM with
    flat-start stats — a shortest path would skip every silence branch
    and EM could never latch onto SIL."""
    start = graph.start
    if start < 0:
        return None
    n_states = graph.num_states
    INF = 1 << 30
    # reversed adjacency (non-self-loop arcs only)
    radj: List[List[Tuple[int, int]]] = [[] for _ in range(n_states)]
    for s in range(n_states):
        for a in graph.arcs[s]:
            if a.nextstate != s:
                radj[a.nextstate].append(
                    (s, 0 if a.ilabel == EPS else 1))
    mn = [INF] * n_states
    dq = deque()
    for s in range(n_states):
        if graph.finals[s] != TropicalWeight.zero:
            mn[s] = 0
            dq.append(s)
    while dq:  # 0/1-BFS (deque Dijkstra)
        s = dq.popleft()
        for p, c in radj[s]:
            if mn[s] + c < mn[p]:
                mn[p] = mn[s] + c
                if c == 0:
                    dq.appendleft(p)
                else:
                    dq.append(p)
    if mn[start] > num_frames:
        _log.warning(f"align_equal: graph needs >= {mn[start]} frames but the "
             f"utterance has only {num_frames}")
        return None
    rng = np.random.default_rng((0x5EED ^ (num_frames * 2654435761
                                           % (1 << 31)) ^ n_states)
                                + 1000003 * (seed & 0xFFFFFFFF))
    path: List[Arc] = []
    s, used = start, 0
    max_steps = 10 * (num_frames + n_states) + 100
    for _ in range(max_steps):
        cands = []
        for a in graph.arcs[s]:
            if a.nextstate == s or mn[a.nextstate] >= INF:
                continue
            c = 0 if a.ilabel == EPS else 1
            if used + c + mn[a.nextstate] <= num_frames:
                cands.append(a)
        is_final = graph.finals[s] != TropicalWeight.zero
        if is_final and (not cands or rng.random() < 0.5):
            return path
        if not cands:
            return None
        a = cands[rng.integers(len(cands))]
        path.append(a)
        used += 0 if a.ilabel == EPS else 1
        s = a.nextstate
    _log.warning("align_equal: random walk did not terminate (eps cycle?)")
    return None


def align_equal(graph: VectorFst, num_frames: int, tm,
                seed: int = 0) -> Optional[List[int]]:
    """Equal alignment (align-equal-compiled / EqualAlign,
    hmm-utils.cc): pick a forward path through the training graph, then
    distribute the remaining frames *evenly* as self-loops across the
    path's states — the unbiased flat-start initialization EM needs
    (a zero-acoustics Viterbi would instead dump all slack into the
    single cheapest self-loop, typically silence).

    The forward path is chosen RANDOMLY among feasible ones (like the
    reference's EqualAlign): random choice at the optional-silence
    junctions is what gives the silence model flat-start stats — a
    shortest path would skip every silence branch and EM could never
    latch onto SIL."""
    path = _random_feasible_path(graph, num_frames, seed)
    if path is None:
        return None
    emitting = [a for a in path if a.ilabel != EPS]
    n = len(emitting)
    if n > num_frames:
        _log.warning(f"align_equal: path needs {n} frames but only "
             f"{num_frames} available")
        return None
    # states (arc destinations) that can absorb self-loops
    def self_loop_arc(state: int) -> Optional[Arc]:
        for a in graph.arcs[state]:
            if a.nextstate == state and a.ilabel != EPS:
                return a
        return None

    # key by POSITION in the path, not arc identity: repeated words
    # can reuse the same Arc objects (the compiler shares per-word
    # sub-FSTs), and an id()-keyed share table would then double-count
    loopable = [i for i, a in enumerate(path) if a.ilabel != EPS
                and self_loop_arc(a.nextstate) is not None]
    extra = num_frames - n
    if extra > 0 and not loopable:
        _log.warning("align_equal: no self-loops available to fill frames")
        return None
    shares: Dict[int, int] = {}
    if loopable:
        base, rem = divmod(extra, len(loopable))
        for rank, pos in enumerate(loopable):
            shares[pos] = base + (1 if rank < rem else 0)
    alignment: List[int] = []
    for i, a in enumerate(path):
        if a.ilabel == EPS:
            continue
        alignment.append(a.ilabel)
        k = shares.get(i, 0)
        if k:
            sl = self_loop_arc(a.nextstate)
            alignment.extend([sl.ilabel] * k)
    assert len(alignment) == num_frames
    return alignment
