"""Sparse backoff bigram LM in flat arrays, the LexChain decoder's LM
(numpy copy of `BigramBackoffLm` of `kaldi_tpu/lm/bigram.py`: the
fields, `dense_cost`, `cost` and `from_counts`).

The decoder keeps the lexicon and the LM factored at decode time
(decoder/lexchain.py): the LM it needs is an ARPA bigram in backoff
form, unigram costs, per-context backoff costs and a SPARSE list of
explicit bigrams, estimated here from raw text with absolute
discounting.

Semantics: cost(w|u) = min(explicit(u, w), bo(u) + uni(w)), the
epsilon-backoff composition of the compiled G (lm/arpa-lm-compiler.h:32
compiles backoff as epsilon arcs, so the tropical-semiring G also takes
the min path).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BIG = 1e10          # cost of an impossible event (finite: stays exact
#                     under +, unlike inf, and never wins a min)
_log = logging.getLogger(__name__)


@dataclass
class BigramBackoffLm:
    """Backoff bigram over V words; context index V = <s>.

    All costs are -ln(p).  Explicit arcs are sorted by (dst, src)."""
    words: List[str]                 # V entries (no <s>/</s>/<eps>)
    uni: np.ndarray                  # (V,)  -ln P(w)
    bo: np.ndarray                   # (V+1,) -ln backoff(u)
    expl_src: np.ndarray             # (E,) int32, context in [0, V]
    expl_dst: np.ndarray             # (E,) int32, word in [0, V)
    expl_cost: np.ndarray            # (E,) float32 -ln P(w|u)
    eos: np.ndarray                  # (V+1,) -ln P(</s>|u), backoff folded
    eos_uni: float = BIG             # -ln P_uni(</s>)

    @property
    def V(self) -> int:
        return len(self.words)

    @property
    def num_explicit(self) -> int:
        return len(self.expl_src)

    def dense_cost(self) -> np.ndarray:
        """(V+1, V) densified cost table: min(explicit, bo + uni)."""
        dense = self.bo[:, None] + self.uni[None, :]
        dense[self.expl_src, self.expl_dst] = np.minimum(
            dense[self.expl_src, self.expl_dst], self.expl_cost)
        return dense.astype(np.float32)

    def cost(self, u: int, w: int) -> float:
        """-ln P(w | u) with backoff (host scoring, tests)."""
        m = (self.expl_src == u) & (self.expl_dst == w)
        e = float(self.expl_cost[m].min()) if m.any() else np.inf
        return float(min(e, self.bo[u] + self.uni[w]))

    @classmethod
    def from_counts(cls, sentences: Sequence[Sequence[str]],
                    vocab: Optional[Sequence[str]] = None,
                    discount: float = 0.5,
                    prune_count: int = 1) -> "BigramBackoffLm":
        """Absolute-discounting backoff estimate from text.

        P(w|u) = max(c(u,w) - D, 0)/c(u) + bo(u) * P_uni(w) with
        bo(u) = D * N1+(u) / c(u); unigram = ML with add-discount
        smoothing over the vocabulary.  Bigrams seen fewer than
        `prune_count` times are dropped to the backoff path."""
        if vocab is None:
            vocab = sorted({w for s in sentences for w in s})
        words = list(vocab)
        V = len(words)
        wid = {w: i for i, w in enumerate(words)}
        BOS = V
        uni_c = np.zeros(V + 1)
        eos_c = np.zeros(V + 1)
        big_c: Dict[Tuple[int, int], float] = {}
        ctx_c = np.zeros(V + 1)
        for s in sentences:
            prev = BOS
            for w in s:
                i = wid[w]
                uni_c[i] += 1
                big_c[(prev, i)] = big_c.get((prev, i), 0.0) + 1
                ctx_c[prev] += 1
                prev = i
            eos_c[prev] += 1
            ctx_c[prev] += 1
        # unigram: ML with floor (</s> handled through eos)
        tot = uni_c[:V].sum() + eos_c.sum()
        uni_p = (uni_c[:V] + discount) / (tot + discount * (V + 1))
        eos_uni_p = (eos_c.sum() + discount) / (tot + discount * (V + 1))
        expl: List[Tuple[int, int, float]] = []
        bo = np.ones(V + 1)
        eos_cost = np.zeros(V + 1)
        n1plus = np.zeros(V + 1)
        for (u, w), c in big_c.items():
            if c >= prune_count:
                n1plus[u] += 1
        eos_kept = eos_c >= prune_count
        n1plus += eos_kept
        for u in range(V + 1):
            cu = ctx_c[u]
            if cu == 0:
                bo[u] = 1.0           # unseen context: pure backoff
                continue
            bo[u] = max(discount * n1plus[u] / cu, 1e-10)
        for (u, w), c in big_c.items():
            if c < prune_count:
                continue
            p = max(c - discount, 0.0) / ctx_c[u] + bo[u] * uni_p[w]
            expl.append((u, w, -math.log(p)))
        for u in range(V + 1):
            if eos_kept[u] and ctx_c[u] > 0:
                p = max(eos_c[u] - discount, 0.0) / ctx_c[u] \
                    + bo[u] * eos_uni_p
                eos_cost[u] = -math.log(p)
            else:
                eos_cost[u] = -math.log(bo[u] * eos_uni_p)
        expl.sort(key=lambda t: (t[1], t[0]))
        lm = cls(words=words,
                 uni=(-np.log(uni_p)).astype(np.float32),
                 bo=(-np.log(bo)).astype(np.float32),
                 expl_src=np.asarray([e[0] for e in expl], np.int32),
                 expl_dst=np.asarray([e[1] for e in expl], np.int32),
                 expl_cost=np.asarray([e[2] for e in expl], np.float32),
                 eos=eos_cost.astype(np.float32),
                 eos_uni=float(-math.log(eos_uni_p)))
        _log.info("BigramBackoffLm.from_counts: V=%d, %d explicit bigrams",
                  V, len(expl))
        return lm
