"""Edit distance for WER (port of `WerStats` and `edit_distance_counts`
of `kaldi_tpu/util/edit_distance.py`; parity: bin/compute-wer.cc)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass
class WerStats:
    errors: int = 0
    ref_words: int = 0
    ins: int = 0
    dels: int = 0
    subs: int = 0
    sentences: int = 0
    wrong_sentences: int = 0

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_words, 1)

    def add(self, ref: Sequence[str], hyp: Sequence[str]) -> None:
        i, d, s = edit_distance_counts(ref, hyp)
        self.ins += i
        self.dels += d
        self.subs += s
        self.errors += i + d + s
        self.ref_words += len(ref)
        self.sentences += 1
        if i + d + s:
            self.wrong_sentences += 1

    def report(self) -> str:
        return (f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_words}, "
                f"{self.ins} ins, {self.dels} del, {self.subs} sub ]")


def edit_distance_counts(ref: Sequence, hyp: Sequence
                         ) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) of the best alignment,
    each edit costing 1, as compute-wer counts them."""
    R, H = len(ref), len(hyp)
    # prev[j] = (total, ins, del, sub)
    prev = [(j, j, 0, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, i, 0)]
        for j in range(1, H + 1):
            t, ii, dd, ss = prev[j - 1]
            if ref[i - 1] != hyp[j - 1]:
                cand = (t + 1, ii, dd, ss + 1)
            else:
                cand = (t, ii, dd, ss)
            t, ii, dd, ss = prev[j]                 # deletion
            if t + 1 < cand[0]:
                cand = (t + 1, ii, dd + 1, ss)
            t, ii, dd, ss = cur[j - 1]              # insertion
            if t + 1 < cand[0]:
                cand = (t + 1, ii + 1, dd, ss)
            cur.append(cand)
        prev = cur
    _, i, d, s = prev[H]
    return i, d, s
