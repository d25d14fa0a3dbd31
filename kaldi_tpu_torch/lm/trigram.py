"""Sparse backoff trigram LM in flat arrays, the n-gram decoder's
first-pass LM (numpy copy of `TrigramBackoffLm` of
`kaldi_tpu/lm/trigram.py`: the fields, `from_counts` and
`eos_state_cost`).

The LM is the ARPA state machine, minimized as ArpaLmCompiler builds it
(lm/arpa-lm-compiler.h:32): a state exists only for contexts that
distinguish the future.

  states   : null, unigram states u in [0, V] (V = <s>),
             pair states (u, v) ONLY where explicit trigram
             continuations (or an explicit trigram </s>) exist
  moves    : from uni(u) on w:
               explicit bigram (u,w) -> pair(u,w)  [if (u,w) is a state]
               explicit bigram (u,w) FOLDED -> uni(w) with cost
                 bi(u,w) + bo2(u,w)                [otherwise]
               backoff bo1(u) -> null -> unigram w -> uni(w)
             from pair(u,v) on w:
               explicit trigram -> pair(v,w) or FOLDED -> uni(w)
               backoff bo2(u,v) -> uni(v), continue as above
  final    : explicit </s> at each level, with backoff

Costs are -ln p.  Backoff weights are mass-exact: pruned n-grams return
their probability to the backoff path.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

BIG = 1e10
_log = logging.getLogger(__name__)


@dataclass
class TrigramBackoffLm:
    """Backoff trigram over V words; unigram context index V = <s>.

    Pair states [0, SP) exist only for trigram contexts.  Explicit arcs
    by destination kind:
      - `ent_bi_cost[sp]`: the bigram arc INTO pair state sp from
        uni(pair_u[sp]) (BIG if that bigram is not explicit)
      - fold_src/fold_dst/fold_cost: explicit bigrams whose destination
        state was folded away -> uni(fold_dst); the cost includes the
        folded state's backoff weight
      - tri_src (pair index) / tri_dst (ENCODED: < SP pair index, >= SP
        folded to uni(tri_dst - SP)) / tri_cost."""
    words: List[str]                     # V entries
    uni: np.ndarray                      # (V,)   -ln P(w)
    bo1: np.ndarray                      # (V+1,) -ln backoff(u)
    fold_src: np.ndarray                 # (E2f,) uni context in [0, V]
    fold_dst: np.ndarray                 # (E2f,) word
    fold_cost: np.ndarray                # (E2f,)
    pair_u: np.ndarray                   # (SP,)
    pair_v: np.ndarray                   # (SP,)
    bo2: np.ndarray                      # (SP,)
    ent_bi_cost: np.ndarray              # (SP,) or BIG
    tri_src: np.ndarray                  # (E3,) pair index
    tri_dst: np.ndarray                  # (E3,) encoded destination
    tri_cost: np.ndarray                 # (E3,)
    eos_uni: float
    eos_bi: np.ndarray                   # (V+1,) explicit or BIG
    eos_tri: np.ndarray                  # (SP,)  explicit or BIG

    @property
    def V(self) -> int:
        return len(self.words)

    @property
    def SP(self) -> int:
        return len(self.pair_u)

    @property
    def num_explicit_bi(self) -> int:
        return len(self.fold_src) + int((self.ent_bi_cost < BIG / 2).sum())

    @property
    def num_explicit_tri(self) -> int:
        return len(self.tri_src)

    def eos_state_cost(self) -> Tuple[np.ndarray, np.ndarray]:
        """Folded final costs: (uni-level (V+1,), pair-level (SP,))."""
        eos_u = np.minimum(self.eos_bi, self.bo1 + self.eos_uni)
        eos_p = np.minimum(self.eos_tri,
                           self.bo2 + eos_u[self.pair_v]) \
            if self.SP else np.zeros(0, np.float32)
        return eos_u.astype(np.float32), np.asarray(eos_p, np.float32)

    @classmethod
    def _assemble(cls, words, uni, bo1, bi_map, bo2_map, tri_map,
                  eos_uni, eos_bi_map, eos_tri_map):
        """The flat arrays from dict tables: bi_map (u,w) -> cost,
        bo2_map (u,v) -> backoff cost of the pair context (0.0 when
        unlisted), tri_map (u,v,w) -> cost, eos_bi_map u -> cost,
        eos_tri_map (u,v) -> cost."""
        V = len(words)
        # pair states sorted by (v, u): the states of one word v are
        # contiguous, so the decoder's per-word backoff fold runs over
        # monotone index ranges
        pair_set = sorted({(u, v) for (u, v, w) in tri_map}
                          | set(eos_tri_map),
                          key=lambda p: (p[1], p[0]))
        pid = {p: i for i, p in enumerate(pair_set)}
        SP = len(pair_set)
        pair_u = np.asarray([p[0] for p in pair_set], np.int32)
        pair_v = np.asarray([p[1] for p in pair_set], np.int32)
        bo2 = np.asarray([bo2_map.get(p, 0.0) for p in pair_set],
                         np.float32)
        ent_bi = np.full(SP, BIG, np.float32)
        f_src, f_dst, f_cost = [], [], []
        for (u, w), c in sorted(bi_map.items()):
            sp = pid.get((u, w))
            if sp is not None:
                ent_bi[sp] = c
            else:
                f_src.append(u)
                f_dst.append(w)
                f_cost.append(c + bo2_map.get((u, w), 0.0))
        t_src, t_dst, t_cost = [], [], []
        eos_tri = np.full(SP, BIG, np.float32)
        for (u, v, w), c in sorted(tri_map.items()):
            s = pid[(u, v)]
            d = pid.get((v, w))
            if d is None:
                t_dst.append(SP + w)
                t_cost.append(c + bo2_map.get((v, w), 0.0))
            else:
                t_dst.append(d)
                t_cost.append(c)
            t_src.append(s)
        for (u, v), c in eos_tri_map.items():
            eos_tri[pid[(u, v)]] = c
        eos_bi = np.full(V + 1, BIG, np.float32)
        for u, c in eos_bi_map.items():
            eos_bi[u] = c
        lm = cls(words=list(words),
                 uni=np.asarray(uni, np.float32),
                 bo1=np.asarray(bo1, np.float32),
                 fold_src=np.asarray(f_src, np.int32),
                 fold_dst=np.asarray(f_dst, np.int32),
                 fold_cost=np.asarray(f_cost, np.float32),
                 pair_u=pair_u, pair_v=pair_v, bo2=bo2,
                 ent_bi_cost=ent_bi,
                 tri_src=np.asarray(t_src, np.int32),
                 tri_dst=np.asarray(t_dst, np.int32),
                 tri_cost=np.asarray(t_cost, np.float32),
                 eos_uni=float(eos_uni), eos_bi=eos_bi,
                 eos_tri=eos_tri)
        _log.info("TrigramBackoffLm: V=%d, %d pair states, %d bigrams "
                  "(%d folded), %d trigrams", V, SP, lm.num_explicit_bi,
                  len(f_src), lm.num_explicit_tri)
        return lm

    @classmethod
    def from_counts(cls, sentences: Sequence[Sequence[str]],
                    vocab: Optional[Sequence[str]] = None,
                    discount: float = 0.5,
                    prune_bi: int = 1, prune_tri: int = 2
                    ) -> "TrigramBackoffLm":
        """Interpolated absolute-discounting backoff estimate from text
        (Chen & Goodman's interpolated form).  Backoff weights return
        the discounted and the pruned mass, so every context
        distribution sums to one."""
        if vocab is None:
            vocab = sorted({w for s in sentences for w in s})
        words = list(vocab)
        V = len(words)
        wid = {w: i for i, w in enumerate(words)}
        # vectorized counting; internal EOS code E = V+1, BOS = V
        E = V + 1
        lens = np.asarray([len(s) + 1 for s in sentences], np.int64)
        total = int(lens.sum())
        ids = np.full(total, E, np.int64)
        flat = [wid[w] for s in sentences for w in s]
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        body = np.ones(total, bool)
        body[np.cumsum(lens) - 1] = False          # EOS positions
        ids[body] = np.asarray(flat, np.int64)
        prev1 = np.empty(total, np.int64)
        prev1[1:] = ids[:-1]
        prev1[starts] = V                           # BOS
        prev2 = np.full(total, -1, np.int64)
        prev2[1:] = prev1[:-1]
        prev2[starts] = -1                          # no trigram at t=0
        uni_c = np.bincount(ids[ids < V], minlength=V).astype(float)
        eos_total = int((ids == E).sum())
        ctx1_c = np.bincount(prev1, minlength=V + 1).astype(float)
        K = V + 2
        bk, bc = np.unique(prev1 * K + ids, return_counts=True)
        m3 = prev2 >= 0
        tk, tc = np.unique((prev2[m3] * K + prev1[m3]) * K + ids[m3],
                           return_counts=True)
        ck, cc = np.unique(prev2[m3] * K + prev1[m3], return_counts=True)
        tot = uni_c.sum() + eos_total
        uni_p = (uni_c + discount) / (tot + discount * (V + 1))
        eos_uni_p = (eos_total + discount) / (tot + discount * (V + 1))
        # bigram level: mass-exact backoff weights
        b_u, b_w = bk // K, bk % K
        b_kept = bc >= prune_bi
        disc_mass1 = np.bincount(
            b_u, weights=np.where(b_kept, discount, bc), minlength=V + 1)
        has_kept1 = np.zeros(V + 1, bool)
        has_kept1[b_u[b_kept]] = True
        bo1 = np.ones(V + 1)
        m = (ctx1_c > 0) & has_kept1
        bo1[m] = np.maximum(disc_mass1[m] / ctx1_c[m], 1e-10)
        base_all = np.concatenate([uni_p, [0.0, eos_uni_p]])

        def p_bi_vec(u, w):
            """P(w|u) with the kept-bigram lookup by searchsorted into
            the unique bigram keys."""
            u = np.asarray(u, np.int64)
            w = np.asarray(w, np.int64)
            key = u * K + w
            pos = np.searchsorted(bk, key)
            pos_c = np.minimum(pos, len(bk) - 1) if len(bk) else pos * 0
            hit = (len(bk) > 0) & (bk[pos_c] == key) & b_kept[pos_c] \
                & (ctx1_c[u] > 0)
            expl = np.where(
                hit,
                np.maximum(bc[pos_c] - discount, 0.0)
                / np.maximum(ctx1_c[u], 1.0), 0.0)
            return expl + bo1[u] * base_all[w]

        # trigram level
        t_uv, t_w = tk // K, tk % K
        t_u, t_v = t_uv // K, t_uv % K
        t_kept = tc >= prune_tri
        cpos = np.searchsorted(ck, t_uv)
        disc_mass2 = np.zeros(len(ck))
        np.add.at(disc_mass2, cpos, np.where(t_kept, discount, tc))
        has_kept2 = np.zeros(len(ck), bool)
        has_kept2[cpos[t_kept]] = True
        bo2_arr = np.ones(len(ck))
        m = (cc > 0) & has_kept2
        bo2_arr[m] = np.maximum(disc_mass2[m] / cc[m], 1e-10)
        bo2_map = {(int(k // K), int(k % K)): float(-np.log(b))
                   for k, b, hm in zip(ck, bo2_arr, m) if hm}
        # dict tables
        kb_u, kb_w, kb_p = b_u[b_kept], b_w[b_kept], \
            p_bi_vec(b_u[b_kept], b_w[b_kept])
        bi_map = {(int(u), int(w)): float(-np.log(p))
                  for u, w, p in zip(kb_u, kb_w, kb_p) if w != E}
        eos_bi_map = {int(u): float(-np.log(p))
                      for u, w, p in zip(kb_u, kb_w, kb_p) if w == E}
        kt = t_kept
        kt_u, kt_v, kt_w = t_u[kt], t_v[kt], t_w[kt]
        kt_c2 = cc[cpos[kt]]
        kt_bo = bo2_arr[cpos[kt]] * has_kept2[cpos[kt]] \
            + 1.0 * ~has_kept2[cpos[kt]]
        kt_p = np.maximum(tc[kt] - discount, 0.0) \
            / np.maximum(kt_c2, 1.0) * (kt_c2 > 0) \
            + kt_bo * p_bi_vec(kt_v, kt_w)
        tri_map = {}
        eos_tri_map = {}
        for u, v, w, p in zip(kt_u, kt_v, kt_w, kt_p):
            if v == E:
                continue
            if w == E:
                eos_tri_map[(int(u), int(v))] = float(-np.log(p))
            else:
                tri_map[(int(u), int(v), int(w))] = float(-np.log(p))
        return cls._assemble(
            words, -np.log(uni_p), -np.log(bo1), bi_map, bo2_map,
            tri_map, -math.log(eos_uni_p), eos_bi_map, eos_tri_map)
