"""ARPA n-gram LM parsing and G-FST compilation (port of
`kaldi_tpu/lm/arpa.py`; host-side).

Parity: lm/arpa-file-parser.h:81 (parser) and lm/arpa-lm-compiler.h:32
(ARPA -> FST with backoff as epsilon arcs; here the backoff label is
configurable so it can carry #0 for determinizability, as
prepare_lang/format_lm arrange).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.base.logging import KaldiTpuError, warn
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst

M_LN10 = math.log(10.0)


@dataclass
class ArpaLm:
    order: int
    # ngrams[n] = dict mapping tuple(words) -> (logprob_log10, backoff_log10)
    ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = field(
        default_factory=list)

    def score_sentence_log10(self, words: Sequence[str],
                             bos: str = "<s>", eos: str = "</s>") -> float:
        """Sum of conditional log10 probs with backoff (for tests)."""
        seq = [bos] + list(words) + [eos]
        total = 0.0
        for i in range(1, len(seq)):
            total += self._cond_log10(tuple(seq[max(0, i - self.order + 1):i]),
                                      seq[i])
        return total

    def _cond_log10(self, hist: Tuple[str, ...], word: str) -> float:
        while True:
            ng = hist + (word,)
            n = len(ng)
            if n <= self.order and ng in self.ngrams[n - 1]:
                return self.ngrams[n - 1][ng][0]
            if not hist:
                warn(f"OOV word {word}; using -99")
                return -99.0
            bo = self.ngrams[len(hist) - 1].get(hist, (0.0, 0.0))[1]
            hist = hist[1:]
            # add backoff and recurse
            return bo + self._cond_log10(hist, word)


def parse_arpa(text: str) -> ArpaLm:
    lines = iter(text.splitlines())
    for line in lines:
        if line.strip() == "\\data\\":
            break
    else:
        raise KaldiTpuError("no \\data\\ section in ARPA input")
    counts = []
    for line in lines:
        line = line.strip()
        m = re.match(r"ngram (\d+)\s*=\s*(\d+)", line)
        if m:
            counts.append(int(m.group(2)))
        elif line.startswith("\\"):
            first_section = line
            break
        elif not line:
            continue
    order = len(counts)
    lm = ArpaLm(order, [dict() for _ in range(order)])
    cur_n = int(re.match(r"\\(\d+)-grams:", first_section).group(1))
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line == "\\end\\":
            break
        m = re.match(r"\\(\d+)-grams:", line)
        if m:
            cur_n = int(m.group(1))
            continue
        parts = line.split()
        logp = float(parts[0])
        if len(parts) >= cur_n + 2:
            words = tuple(parts[1:cur_n + 1])
            backoff = float(parts[cur_n + 1])
        else:
            words = tuple(parts[1:cur_n + 1])
            backoff = 0.0
        lm.ngrams[cur_n - 1][words] = (logp, backoff)
    return lm


def arpa_to_fst(lm: ArpaLm, word_to_id: Dict[str, int],
                bos: str = "<s>", eos: str = "</s>",
                backoff_label: int = EPS,
                oov_handling: str = "skip") -> VectorFst:
    """Compile to a word acceptor in the tropical semiring. States are
    n-gram histories; backoff arcs carry `backoff_label` (pass the #0
    symbol id for a determinizable LG pipeline). Weights are -ln(p)."""
    fst = VectorFst(TropicalWeight)
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        while len(hist) >= lm.order:
            hist = hist[1:]
        # histories must exist as (n<order)-grams with backoff entries;
        # back off to shorter if unseen
        while hist and (len(hist) > lm.order - 1
                        or hist not in lm.ngrams[len(hist) - 1]):
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = fst.add_state()
        return state_of[hist]

    start = fst.add_state()
    fst.set_start(start)
    state_of[("<START>",)] = start  # private key; never backed-off to

    # start state behaves like history (<s>,)
    def hist_after(hist: Tuple[str, ...], word: str) -> Tuple[str, ...]:
        return tuple(list(hist) + [word])

    # emit arcs for every n-gram
    for n in range(1, lm.order + 1):
        for ng, (logp, backoff) in lm.ngrams[n - 1].items():
            hist, word = ng[:-1], ng[-1]
            if word == bos:
                # <s> defines the start history; no arc
                continue
            if any(w not in word_to_id and w not in (bos, eos) for w in ng):
                if oov_handling == "skip":
                    continue
                raise KaldiTpuError(f"ngram {ng} has OOV word")
            src = start if hist == (bos,) else (
                get_state(hist) if hist else get_state(()))
            w = -logp * M_LN10
            if word == eos:
                fst.finals[src] = TropicalWeight.plus(fst.finals[src], w)
            else:
                dest = get_state(hist_after(hist, word))
                fst.add_arc(src, Arc(word_to_id[word], word_to_id[word],
                                     w, dest))

    # backoff arcs
    for n in range(1, lm.order):
        for ng, (logp, backoff) in lm.ngrams[n - 1].items():
            if ng not in state_of:
                continue
            if ng == (bos,):
                src = start
            else:
                src = state_of[ng]
            lower = get_state(ng[1:])
            if src == lower:
                continue
            fst.add_arc(src, Arc(backoff_label, EPS,
                                 -backoff * M_LN10, lower))
    # <s> backoff
    if (bos,) in lm.ngrams[0]:
        bo = lm.ngrams[0][(bos,)][1]
        lower = get_state(())
        if lower != start:
            fst.add_arc(start, Arc(backoff_label, EPS, -bo * M_LN10, lower))

    from kaldi_tpu_torch.fstext.ops import connect
    return connect(fst)
