"""Sparse backoff bigram LM in flat arrays, the LexChain decoder's LM
(numpy copy of `BigramBackoffLm` of `kaldi_tpu/lm/bigram.py`: the
fields, `dense_cost`, `cost`, `from_counts`, `from_arpa` and
`to_arpa`).

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

M_LN10 = math.log(10.0)


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

    @classmethod
    def from_arpa(cls, lm, vocab: Optional[Sequence[str]] = None,
                  bos: str = "<s>", eos: str = "</s>"
                  ) -> "BigramBackoffLm":
        """From a parsed ArpaLm (lm/arpa.py).  Orders > 2 are cut to
        their bigram level (the device decoder's LM; rescore lattices
        with the full-order LM afterwards, lm/rescore.py —
        the tgsmall-decode/fglarge-rescore split of
        egs/librispeech/s5/local/chain/tuning/run_tdnn_1d.sh)."""
        uni_tab = lm.ngrams[0]
        if vocab is None:
            vocab = sorted(w for (w,) in uni_tab
                           if w not in (bos, eos, "<unk>", "<UNK>"))
        words = list(vocab)
        V = len(words)
        wid = {w: i for i, w in enumerate(words)}
        uni = np.full(V, 99.0 * M_LN10, np.float32)
        bo = np.zeros(V + 1, np.float32)
        eos_cost = np.full(V + 1, 99.0 * M_LN10, np.float32)
        eos_uni = 99.0 * M_LN10
        if (eos,) in uni_tab:
            eos_uni = -uni_tab[(eos,)][0] * M_LN10
        for (w,), (lp, b) in uni_tab.items():
            if w == eos:
                continue
            i = wid.get(w)
            if i is None:
                if w != bos:
                    continue
                bo[V] = -b * M_LN10
                continue
            uni[i] = -lp * M_LN10
            bo[i] = -b * M_LN10
        expl: List[Tuple[int, int, float]] = []
        if lm.order >= 2:
            for (u, w), (lp, _b) in lm.ngrams[1].items():
                ui = V if u == bos else wid.get(u)
                if ui is None:
                    continue
                c = -lp * M_LN10
                if w == eos:
                    eos_cost[ui] = c
                    continue
                i = wid.get(w)
                if i is None:
                    continue
                expl.append((ui, i, c))
        eos_cost = np.minimum(eos_cost, bo + eos_uni)
        expl.sort(key=lambda t: (t[1], t[0]))
        return cls(words=words, uni=uni, bo=bo,
                   expl_src=np.asarray([e[0] for e in expl], np.int32),
                   expl_dst=np.asarray([e[1] for e in expl], np.int32),
                   expl_cost=np.asarray([e[2] for e in expl],
                                        np.float32),
                   eos=eos_cost.astype(np.float32),
                   eos_uni=float(eos_uni))

    # ------------------------------------------------------------------
    def to_arpa(self) -> str:
        """ARPA text (round-trip tests; feeding the lang-dir G build).
        Explicit-bigram probabilities are written as the TOTAL
        (already-interpolated) probability this object assigns."""
        V = len(self.words)
        # explicit </s> bigrams only where cheaper than the backoff path
        eos_expl = [u for u in range(V + 1)
                    if self.eos[u] < self.bo[u] + self.eos_uni - 1e-6]
        lines = ["\\data\\", f"ngram 1={V + 2}",
                 f"ngram 2={self.num_explicit + len(eos_expl)}",
                 "", "\\1-grams:"]
        lines.append(f"-99\t<s>\t{-self.bo[V] / M_LN10:.6f}")
        lines.append(f"{-self.eos_uni / M_LN10:.6f}\t</s>")
        for i, w in enumerate(self.words):
            lines.append(f"{-self.uni[i] / M_LN10:.6f}\t{w}\t"
                         f"{-self.bo[i] / M_LN10:.6f}")
        lines += ["", "\\2-grams:"]
        name = lambda u: "<s>" if u == V else self.words[u]
        for s, d, c in zip(self.expl_src, self.expl_dst, self.expl_cost):
            lines.append(f"{-c / M_LN10:.6f}\t{name(int(s))} "
                         f"{self.words[int(d)]}")
        for u in eos_expl:
            lines.append(f"{-self.eos[u] / M_LN10:.6f}\t{name(u)} </s>")
        lines += ["", "\\end\\", ""]
        return "\n".join(lines)
