"""Word alignment of lattices and CTM output (port of
`kaldi_tpu/lat/word_align.py`; host-side; parity:
lat/word-align-lattice.h, latbin/lattice-align-words + nbest-to-ctm,
lattice-to-ctm-conf).

Word time boundaries are recovered from the transition-id alignment:
a word token on an arc claims the frames from its emission point to
the start of the next word (word-start phones delimit segments using
the transition model, like the word-boundary-info method)."""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, Arc, LatticeWeight
from kaldi_tpu_torch.lat.kaldi_lattice import CompactLattice, Lattice
from kaldi_tpu_torch.lat.sausages import (MinimumBayesRisk,
                                          MinimumBayesRiskOptions)


@dataclass
class CtmEntry:
    utt: str
    channel: int
    start: float       # seconds
    duration: float
    word: int          # word id (map to text at the edge)
    confidence: float = 1.0


def best_path_word_times(lat: Lattice, tm,
                         frame_shift: float = 0.01
                         ) -> List[Tuple[int, int, int]]:
    """Returns [(word, start_frame, end_frame)] along the best path by
    walking arcs in order and attributing frames to the most recent
    word token."""
    # Walk the best path collecting per-arc (ilabel, olabel)
    n = lat.num_states
    INF = float("inf")
    dist = [INF] * n
    back: List[Optional[Tuple[int, object]]] = [None] * n
    dist[lat.start] = 0.0
    q = deque([lat.start])
    inq = [False] * n
    while q:
        s = q.popleft()
        inq[s] = False
        for a in lat.arcs[s]:
            nd = dist[s] + a.weight[0] + a.weight[1]
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
                if not inq[a.nextstate]:
                    q.append(a.nextstate)
                    inq[a.nextstate] = True
    best_s, best_c = -1, INF
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            c = dist[s] + lat.finals[s][0] + lat.finals[s][1]
            if c < best_c:
                best_c, best_s = c, s
    if best_s < 0:
        return []
    arcs = []
    s = best_s
    while s != lat.start and back[s] is not None:
        p, a = back[s]
        arcs.append(a)
        s = p
    arcs.reverse()
    # attribute frames
    out: List[Tuple[int, int, int]] = []
    t = 0
    cur_word: Optional[int] = None
    cur_start = 0
    for a in arcs:
        if a.olabel != EPS:
            if cur_word is not None:
                out.append((cur_word, cur_start, t))
            cur_word = a.olabel
            cur_start = t
        if a.ilabel != EPS:
            t += 1
    if cur_word is not None:
        out.append((cur_word, cur_start, t))
    return out


def lattice_to_ctm(lat: Lattice, tm, utt: str,
                   frame_shift: float = 0.01,
                   use_confidences: bool = True,
                   decode_mbr: bool = True) -> List[CtmEntry]:
    """lattice-to-ctm-conf: word times from the (MBR or MAP) hypothesis
    with MBR confidences."""
    times = best_path_word_times(lat, tm, frame_shift)
    confs: Dict[int, float] = {}
    if use_confidences:
        mbr = MinimumBayesRisk(lat, MinimumBayesRiskOptions(
            decode_mbr=decode_mbr))
        hyp = mbr.get_one_best()
        # align confidences to best-path words by order of occurrence
        conf_list = mbr.confidences
        # map i-th occurrence of each word
        idx = 0
        order: List[float] = []
        for w, _, _ in times:
            c = 1.0
            if idx < len(hyp) and hyp[idx] == w:
                c = conf_list[idx]
                idx += 1
            order.append(c)
    else:
        order = [1.0] * len(times)
    out = []
    for (w, s, e), c in zip(times, order):
        out.append(CtmEntry(utt, 1, s * frame_shift,
                            max(e - s, 1) * frame_shift, w, c))
    return out


def format_ctm(entries: Sequence[CtmEntry],
               word_names: Optional[Dict[int, str]] = None) -> str:
    lines = []
    for e in entries:
        w = word_names.get(e.word, str(e.word)) if word_names else str(e.word)
        lines.append(f"{e.utt} {e.channel} {e.start:.2f} {e.duration:.2f} "
                     f"{w} {e.confidence:.2f}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Word/phone alignment proper (lat/word-align-lattice.h WordBoundaryInfo;
# lat/word-align-lattice-lexicon.h; lat/phone-align-lattice.h) — exact for
# LINEAR (single-path) lattices, the form the nbest/ctm pipelines use.

class WordBoundaryInfo:
    """Per-phone word-position types from a word_boundary.int file:
    lines `<phone-id> begin|end|internal|singleton|nonword`
    (word-align-lattice.h:136)."""
    BEGIN, END, INTERNAL, SINGLETON, NONWORD = range(5)
    _NAMES = {"begin": BEGIN, "end": END, "internal": INTERNAL,
              "singleton": SINGLETON, "nonword": NONWORD,
              # some lang dirs mark silence explicitly
              "silence": NONWORD}

    def __init__(self, phone_to_type: Dict[int, int],
                 silence_label: int = 0,
                 partial_word_label: int = 0):
        self.phone_to_type = phone_to_type
        self.silence_label = silence_label
        self.partial_word_label = partial_word_label

    @classmethod
    def from_file(cls, path: str, silence_label: int = 0,
                  partial_word_label: int = 0) -> "WordBoundaryInfo":
        mapping: Dict[int, int] = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) != 2 or parts[1] not in cls._NAMES:
                    raise ValueError(
                        f"bad word-boundary line: {line!r}")
                mapping[int(parts[0])] = cls._NAMES[parts[1]]
        return cls(mapping, silence_label, partial_word_label)

    def type_of(self, phone: int) -> int:
        return self.phone_to_type[phone]


def linear_lattice_arcs(lat: Lattice):
    """Arc list of a linear lattice, or None if the lattice branches."""
    arcs = []
    s = lat.start
    seen = set()
    final = None
    while True:
        if s in seen:
            return None, None
        seen.add(s)
        out = lat.arcs[s]
        is_final = lat.finals[s] != LatticeWeight.zero
        if not out:
            if not is_final:
                return None, None
            final = lat.finals[s]
            break
        if len(out) != 1 or is_final:
            return None, None
        arcs.append(out[0])
        s = out[0].nextstate
    return arcs, final


def split_linear_to_phones(tm, arcs):
    """Group a linear lattice's arcs into phone segments: each segment
    = [(tid, weight), ...] with the word labels queued in order.
    Epsilon-input arcs fold their weight into the neighbouring
    segment."""
    segments: List[List] = []
    words: List[int] = []
    pending_weight = [0.0, 0.0]
    for a in arcs:
        if a.olabel != 0:
            words.append(a.olabel)
        if a.ilabel == 0:
            pending_weight[0] += a.weight[0]
            pending_weight[1] += a.weight[1]
            continue
        t = a.ilabel
        if (tm.transition_id_to_hmm_state(t) == 0
                and not tm.is_self_loop(t)) or not segments:
            segments.append([])
        segments[-1].append((t, (a.weight[0] + pending_weight[0],
                                 a.weight[1] + pending_weight[1])))
        pending_weight = [0.0, 0.0]
    return segments, words, tuple(pending_weight)


def _emit_compact_linear(groups, final_extra):
    """Build a linear CompactLattice from
    [(word, [(tid, weight), ...]), ...]."""
    out = CompactLattice()
    cur = out.add_state()
    out.set_start(cur)
    for word, seg in groups:
        g = sum(w[0] for _t, w in seg)
        a = sum(w[1] for _t, w in seg)
        tids = tuple(t for t, _w in seg)
        ns = out.add_state()
        out.add_arc(cur, Arc(word, word, ((g, a), tids), ns))
        cur = ns
    out.finals[cur] = ((final_extra[0], final_extra[1]), ())
    return out


def word_align_lattice(lat: Lattice, tm, info: WordBoundaryInfo):
    """Word-align a LINEAR lattice: one CompactLattice arc per word,
    each arc's string carrying exactly that word's transition-ids;
    nonword (silence) segments get info.silence_label
    (word-align-lattice.cc semantics; linear inputs only — run
    lattice-1best / lattice-to-nbest first)."""
    arcs, final = linear_lattice_arcs(lat)
    if arcs is None:
        return None
    segments, words, extra = split_linear_to_phones(tm, arcs)
    fg = (final[0] + extra[0], final[1] + extra[1])
    groups = []
    wq = list(words)
    i = 0
    ok = True
    while i < len(segments):
        seg = segments[i]
        phone = tm.transition_id_to_phone(seg[0][0])
        ptype = info.type_of(phone)
        if ptype == WordBoundaryInfo.NONWORD:
            groups.append((info.silence_label, seg))
            i += 1
        elif ptype == WordBoundaryInfo.SINGLETON:
            groups.append((wq.pop(0) if wq else
                           info.partial_word_label, seg))
            i += 1
        elif ptype == WordBoundaryInfo.BEGIN:
            j = i + 1
            merged = list(seg)
            closed = False
            while j < len(segments):
                p2 = tm.transition_id_to_phone(segments[j][0][0])
                t2 = info.type_of(p2)
                merged.extend(segments[j])
                j += 1
                if t2 == WordBoundaryInfo.END:
                    closed = True
                    break
                if t2 != WordBoundaryInfo.INTERNAL:
                    ok = False
                    break
            if not closed:
                ok = False
            groups.append((wq.pop(0) if wq and closed else
                           info.partial_word_label, merged))
            i = j
        else:  # END or INTERNAL without a begin: broken alignment
            groups.append((info.partial_word_label, seg))
            ok = False
            i += 1
    if wq:
        ok = False
    return _emit_compact_linear(groups, fg), ok


def word_align_lattice_lexicon(lat: Lattice, tm, lexicon):
    """Lexicon-based word alignment of a LINEAR lattice
    (word-align-lattice-lexicon.cc): `lexicon` is a list of
    (word_in, word_out, (phones...)) entries; entries with
    word_in == 0 may be inserted freely (optional silence).  A DP
    over (segment index, word index) finds the segmentation."""
    arcs, final = linear_lattice_arcs(lat)
    if arcs is None:
        return None
    segments, words, extra = split_linear_to_phones(tm, arcs)
    fg = (final[0] + extra[0], final[1] + extra[1])
    seg_phones = [tm.transition_id_to_phone(s[0][0]) for s in segments]
    by_word: Dict[int, List] = {}
    for win, wout, phones in lexicon:
        by_word.setdefault(win, []).append((tuple(phones), wout))
    N, K = len(segments), len(words)

    @functools.lru_cache(maxsize=None)
    def solve(i: int, k: int):
        """Returns list of (word_out, start, end) or None."""
        if i == N:
            return [] if k == K else None
        # optional nonword entries
        for phones, wout in by_word.get(0, []):
            n = len(phones)
            if tuple(seg_phones[i:i + n]) == phones:
                rest = solve(i + n, k)
                if rest is not None:
                    return [(wout, i, i + n)] + rest
        if k < K:
            for phones, wout in by_word.get(words[k], []):
                n = len(phones)
                if n and tuple(seg_phones[i:i + n]) == phones:
                    rest = solve(i + n, k + 1)
                    if rest is not None:
                        return [(wout, i, i + n)] + rest
        return None

    sol = solve(0, 0)
    if sol is None:
        return None
    groups = []
    for wout, i, j in sol:
        merged = []
        for s in segments[i:j]:
            merged.extend(s)
        groups.append((wout, merged))
    return _emit_compact_linear(groups, fg)


def phone_align_lattice(lat: Lattice, tm,
                        replace_output_symbols: bool = False):
    """Phone-align a LINEAR lattice: one CompactLattice arc per phone
    (phone-align-lattice.cc).  With replace_output_symbols the arc
    labels become phone ids; otherwise the original word labels ride
    on the phone arc where they appeared (first phone of the word)."""
    arcs, final = linear_lattice_arcs(lat)
    if arcs is None:
        return None
    segments, words, extra = split_linear_to_phones(tm, arcs)
    # re-walk to place words on the segment where they occurred
    word_at: Dict[int, int] = {}
    seg_i = -1
    pending_word = 0
    for a in arcs:
        if a.olabel != 0:
            pending_word = a.olabel
        if a.ilabel != 0:
            t = a.ilabel
            if (tm.transition_id_to_hmm_state(t) == 0
                    and not tm.is_self_loop(t)) or seg_i < 0:
                seg_i += 1
                if pending_word:
                    word_at[seg_i] = pending_word
                    pending_word = 0
    fg = (final[0] + extra[0], final[1] + extra[1])
    groups = []
    for i, seg in enumerate(segments):
        if replace_output_symbols:
            label = tm.transition_id_to_phone(seg[0][0])
        else:
            label = word_at.get(i, 0)
        groups.append((label, seg))
    return _emit_compact_linear(groups, fg)
