"""CPU Viterbi decoding over decoding graphs: the host token-passing
decoder that every device decoder is held against (port of
`FasterDecoderOptions` and `FasterDecoder` of
`kaldi_tpu/decoder/viterbi.py`).

Parity: decoder/faster-decoder.h (beam token passing with
ProcessEmitting/ProcessNonemitting).  The acoustic scores arrive as a
precomputed (frames x pdfs) matrix, so this host loop only does the
data-dependent search.

Not carried over yet: `best_path_through`, `_random_feasible_path` and
`align_equal` (they wait for the transition model).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import EPS, TropicalWeight, VectorFst

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
        T = loglikes.shape[0]
        beam = self.opts.beam
        # active tokens: state -> _Token
        cur: Dict[int, _Token] = {fst.start: _Token(0.0, None, 0, 0)}
        cur = self._process_nonemitting(cur, beam, word_ins_penalty)
        for t in range(T):
            frame = loglikes[t]
            nxt: Dict[int, _Token] = {}
            # adaptive pruning cutoff
            best = min(tok.cost for tok in cur.values())
            cutoff = best + beam
            if len(cur) > self.opts.max_active:
                costs = sorted(tok.cost for tok in cur.values())
                cutoff = min(cutoff, costs[self.opts.max_active - 1])
            next_best = INF
            for state, tok in cur.items():
                if tok.cost > cutoff:
                    continue
                for a in fst.arcs[state]:
                    if a.ilabel == EPS:
                        continue
                    ac = -acoustic_scale * float(frame[tid_to_pdf[a.ilabel]])
                    c = tok.cost + a.weight + ac
                    if word_ins_penalty and a.olabel != EPS:
                        c += word_ins_penalty
                    if c >= next_best + beam:
                        continue
                    old = nxt.get(a.nextstate)
                    if old is None or c < old.cost:
                        nxt[a.nextstate] = _Token(c, tok, a.ilabel, a.olabel)
                        next_best = min(next_best, c)
            if not nxt:
                _log.warning("no tokens survived at frame %d", t)
                return None
            # prune against updated best
            cutoff2 = next_best + beam
            nxt = {s: tok for s, tok in nxt.items() if tok.cost <= cutoff2}
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
