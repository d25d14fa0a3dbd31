"""Decision-tree building (port of `cluster_phones`, `BuildTreeOptions`
and `build_tree` of `kaldi_tpu/tree/build_tree.py`; parity:
tree/build-tree.h BuildTree, bin/cluster-phones + compile-questions).

  cluster_phones  automatic question generation by bottom-up
                  agglomerative clustering of per-phone stats
  build_tree      greedy likelihood-gain splitting over (key, question)
                  pairs, per roots spec

The reference scores every (key, question) of a leaf one at a time in
Python.  Here one leaf's candidates are scored together: a pass over
the leaf's events (in their order) adds each event's stats to the
yes-side or the no-side sum of every candidate, so each side's sum is
the same sequence of float64 additions the reference makes, and the
objective is its formula row by row.  The gains are bit-equal and the
first best candidate wins as in the reference, so the same statistics
give the same tree.

`accumulate_tree_stats` (acc-tree-stats) is the reference's, event for
event.  Leaf post-clustering: the reference's `BuildTreeOptions` has
`cluster_thresh` but its `build_tree` never reads it, so a tree built
with any value is the unclustered one; the port raises for a value >= 0
rather than accept an option that does nothing.
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.tree.clusterable import M_LOG_2PI, GaussClusterable
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.tree.event_map import (PDF_CLASS_KEY, ConstantEventMap,
                                            EventMap, SplitEventMap,
                                            TableEventMap)

_log = logging.getLogger(__name__)

Event = Tuple[Tuple[int, int], ...]  # sorted ((key, value), ...)
_MISSING = -(2 ** 31)                # an event's value for a key it lacks


def accumulate_tree_stats(tm, topo, feats: np.ndarray,
                          alignment: Sequence[int], N: int, P: int,
                          stats: Optional[Dict[Event, GaussClusterable]] = None,
                          ci_phones: Sequence[int] = (),
                          var_floor: float = 0.01
                          ) -> Dict[Event, GaussClusterable]:
    """acc-tree-stats: per frame, event = context window + pdf-class.
    ci_phones (e.g. silence) get context-independent events."""
    if stats is None:
        stats = {}
    ci = set(ci_phones)
    phone_bounds = []  # (start, end, phone)
    cur_start = 0
    cur_phone = None
    infos = []
    for i, tid in enumerate(alignment):
        phone = tm.transition_id_to_phone(tid)
        hmm_state = tm.transition_id_to_hmm_state(tid)
        pdf_class = topo.topology_for_phone(phone)[hmm_state].forward_pdf_class
        is_start = (hmm_state == 0 and not tm.is_self_loop(tid))
        if is_start and cur_phone is not None:
            phone_bounds.append((cur_start, i, cur_phone))
            cur_start = i
        if is_start or cur_phone is None:
            cur_phone = phone
            if i == 0:
                cur_start = 0
        infos.append((phone, pdf_class))
    if cur_phone is not None:
        phone_bounds.append((cur_start, len(alignment), cur_phone))
    phone_seq = [p for _, _, p in phone_bounds]
    dim = feats.shape[1]
    for seg_idx, (start, end, phone) in enumerate(phone_bounds):
        window = []
        for offset in range(-P, N - P):
            j = seg_idx + offset
            if phone in ci and offset != 0:
                window.append(0)
            elif 0 <= j < len(phone_seq):
                window.append(phone_seq[j])
            else:
                window.append(0)
        for i in range(start, min(end, feats.shape[0])):
            _, pdf_class = infos[i]
            event_list = [(PDF_CLASS_KEY, pdf_class)]
            event_list += [(k, window[k]) for k in range(N)]
            event = tuple(sorted(event_list))
            if event not in stats:
                stats[event] = GaussClusterable(dim, var_floor)
            stats[event].add_stats(feats[i].astype(np.float64))
    return stats


def cluster_phones(stats: Dict[Event, GaussClusterable], phones: List[int],
                   P: int, max_questions: int = 40) -> List[List[int]]:
    """Question generation: agglomerative clustering of phones by their
    pooled stats (cluster-phones); every intermediate cluster becomes a
    question set, plus singletons (deduplicated, in creation order)."""
    per_phone: Dict[int, GaussClusterable] = {}
    for event, stat in stats.items():
        phone = dict(event).get(P)
        if phone in (None, 0):
            continue
        if phone not in per_phone:
            per_phone[phone] = stat
        else:
            per_phone[phone] = per_phone[phone].add(stat)
    active = {p: ([p], per_phone[p]) for p in phones if p in per_phone}
    questions: List[List[int]] = [sorted(v[0]) for v in active.values()]
    while len(active) > 1:
        best = None
        keys = list(active.keys())
        for i in range(len(keys)):
            for j in range(i + 1, len(keys)):
                d = active[keys[i]][1].distance(active[keys[j]][1])
                if best is None or d < best[0]:
                    best = (d, keys[i], keys[j])
        _, ka, kb = best
        merged = (sorted(active[ka][0] + active[kb][0]),
                  active[ka][1].add(active[kb][1]))
        del active[ka], active[kb]
        active[merged[0][0]] = merged
        questions.append(merged[0])
    seen = set()
    out = []
    for q in questions:
        t = tuple(q)
        if t not in seen:
            seen.add(t)
            out.append(q)
    return out


@dataclass
class BuildTreeOptions:
    max_leaves: int = 1000
    min_gain: float = 200.0         # thresh in build-tree
    cluster_thresh: float = -1.0    # <0: no post-clustering
    var_floor: float = 0.01


def _objf_rows(x: np.ndarray, dim: int, var_floor: float) -> np.ndarray:
    """GaussClusterable.objf of each row of x = [count, sum (dim), sumsq
    (dim)], the same float64 operations in the same order."""
    count = x[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = x[:, 1:1 + dim] / count[:, None]
        var = x[:, 1 + dim:] / count[:, None] - mean * mean
        var = np.maximum(var, var_floor)
        out = -0.5 * count * (dim * M_LOG_2PI + np.log(var).sum(axis=1)
                              + dim)
    return np.where(count <= 0, 0.0, out)


class _Leaf:
    __slots__ = ("idx", "total", "best_split", "split_into")

    def __init__(self, idx: np.ndarray, total: np.ndarray):
        self.idx = idx            # the leaf's events, in stats order
        self.total = total        # their stats added in that order
        self.best_split = None
        self.split_into = None


def build_tree(stats: Dict[Event, GaussClusterable],
               questions: Dict[int, List[List[int]]],
               roots: List[Tuple[List[int], bool, bool]],
               N: int, P: int,
               opts: Optional[BuildTreeOptions] = None,
               topo=None) -> ContextDependency:
    """roots: list of (phone_set, shared, split) like the roots file:
    'shared' = one root for all pdf-classes of these phones, 'split' =
    allow decision-tree splitting below the root."""
    if opts is None:
        opts = BuildTreeOptions()
    if opts.cluster_thresh >= 0:
        raise NotImplementedError(
            "cluster_thresh >= 0: the reference's build_tree does no leaf "
            "post-clustering (kaldi_tpu/tree/build_tree.py never reads "
            "the option), so there is nothing to hold a port to")
    phone_to_root: Dict[int, int] = {}
    for ri, (phone_set, _shared, _split) in enumerate(roots):
        for p in phone_set:
            phone_to_root[p] = ri

    # every event's stats as a row [count, sum, sumsq], and its value for
    # every key, in the order of `stats`
    items = list(stats.items())
    dim = len(items[0][1].stats_sum) if items else 0
    var_floor = items[0][1].var_floor if items else opts.var_floor
    X = np.zeros((len(items), 1 + 2 * dim), np.float64)
    keys = sorted({k for e, _ in items for k, _ in e})
    vals = {k: np.full(len(items), _MISSING, np.int64) for k in keys}
    for i, (e, s) in enumerate(items):
        X[i, 0] = s.count
        X[i, 1:1 + dim] = s.stats_sum
        X[i, 1 + dim:] = s.stats_sumsq
        for k, v in e:
            vals[k][i] = v

    pdf_class = vals[PDF_CLASS_KEY].copy() if PDF_CLASS_KEY in vals \
        else np.full(len(items), _MISSING)
    central = vals[P].copy() if P in vals else np.full(len(items), _MISSING)

    def total_of(idx: np.ndarray) -> np.ndarray:
        acc = X[idx[0]].copy()
        for i in idx[1:]:
            acc += X[i]
        return acc

    # every (key, question) candidate in the reference's order, and for
    # each key a table: [candidate, value] -> value in the question
    cands, tables = [], {}
    for key in keys:
        qs = questions.get(key, [])
        width = max([0] + [int(v) for q in qs for v in q]
                    + vals[key][vals[key] != _MISSING].tolist()) + 2
        tab = np.zeros((len(qs), width), bool)
        for c, q in enumerate(qs):
            tab[c, [int(v) for v in q]] = True
            cands.append((key, sorted(set(q))))
        vals[key] = np.where(vals[key] == _MISSING, width - 1, vals[key])
        tables[key] = tab

    def find_best_split(leaf: _Leaf):
        """Best (gain, key, yes_set, yes leaf, no leaf) or None."""
        idx = leaf.idx
        rows, offset, first = [], 0, []
        for key in keys:
            tab = tables[key]
            v = vals[key][idx]
            if (v != tab.shape[1] - 1).any():   # some event has the key
                rows.append(tab[:, v])
                first.extend(range(offset, offset + tab.shape[0]))
            offset += tab.shape[0]
        if not first:
            return None
        member = np.concatenate(rows)           # (C, E)
        n_yes = member.sum(axis=1)
        valid = (n_yes > 0) & (n_yes < idx.size)
        if not valid.any():
            return None
        yes = np.zeros((member.shape[0], X.shape[1]))
        no = np.zeros_like(yes)
        for j, e in enumerate(idx):
            m = member[:, j]
            yes[m] += X[e]
            no[~m] += X[e]
        gain = (_objf_rows(yes, dim, var_floor)
                + _objf_rows(no, dim, var_floor)) \
            - _objf_rows(leaf.total[None], dim, var_floor)[0]
        c = int(np.argmax(np.where(valid, gain, -np.inf)))
        if not valid[c]:
            c = int(np.flatnonzero(valid)[0])
        key, qset = cands[first[c]]
        return (float(gain[c]), key, qset,
                _Leaf(idx[member[c]], yes[c]), _Leaf(idx[~member[c]], no[c]))

    next_pdf = 0
    split_count = 0
    heap = []                   # (-gain, counter, leaf)
    counter = 0
    live = set()                # ids of the leaves not split yet
    root_groups: List[List[_Leaf]] = []
    for ri, (phone_set, shared, split) in enumerate(roots):
        evs = np.flatnonzero(np.isin(central, list(phone_set)))
        if evs.size == 0:
            _log.warning("no tree stats for root %s", phone_set)
            root_groups.append([])
            continue
        if shared:
            groups = [evs]
        else:
            pcs = pdf_class[evs]
            groups = [evs[pcs == pc] for pc in sorted(set(pcs.tolist()))]
        leaves = [_Leaf(g, total_of(g)) for g in groups]
        root_groups.append(leaves)
        for leaf in leaves:
            if split:
                b = find_best_split(leaf)
                leaf.best_split = b
                if b is not None:
                    heapq.heappush(heap, (-b[0], counter, leaf))
                    counter += 1
            live.add(id(leaf))

    num_leaves = len(live)
    while heap and num_leaves < opts.max_leaves:
        neg_gain, _, leaf = heapq.heappop(heap)
        if id(leaf) not in live:                # stale entry
            continue
        if -neg_gain < opts.min_gain:
            break
        b = leaf.best_split
        if b is None:
            continue
        _, key, yes_set, l_yes, l_no = b
        live.discard(id(leaf))
        leaf.split_into = (key, yes_set, l_yes, l_no)
        for child in (l_yes, l_no):
            live.add(id(child))
            bb = find_best_split(child)
            child.best_split = bb
            if bb is not None:
                heapq.heappush(heap, (-bb[0], counter, child))
                counter += 1
        num_leaves += 1
        split_count += 1

    def leaf_to_map(leaf: _Leaf) -> EventMap:
        nonlocal next_pdf
        if leaf.split_into is not None:
            key, yes_set, l_yes, l_no = leaf.split_into
            return SplitEventMap(key, yes_set, leaf_to_map(l_yes),
                                 leaf_to_map(l_no))
        pdf = next_pdf
        next_pdf += 1
        return ConstantEventMap(pdf)

    table: List[Optional[EventMap]] = [None] * (max(phone_to_root) + 1)
    for ri, (phone_set, _shared, _split) in enumerate(roots):
        leaves = root_groups[ri]
        if not leaves:
            # one pdf per pdf-class of the topology
            if topo is None:
                continue
            npc = max(topo.num_pdf_classes(p) for p in phone_set)
            sub = []
            for _ in range(npc):
                sub.append(ConstantEventMap(next_pdf))
                next_pdf += 1
            em = TableEventMap(PDF_CLASS_KEY, sub)
        elif len(leaves) == 1:
            em = leaf_to_map(leaves[0])
        else:
            em = TableEventMap(PDF_CLASS_KEY,
                               [leaf_to_map(l) for l in leaves])
        for p in phone_set:
            table[p] = em
    _log.info("build_tree: %d leaves after %d splits", next_pdf, split_count)
    return ContextDependency(N, P, TableEventMap(P, table))
