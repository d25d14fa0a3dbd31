"""Synthetic lexicon and bigram for the direct decoding graph (numpy
copy of `DirectGraphSpec`, `synth_lexicon` and `synth_bigram` of
`kaldi_tpu/decoder/graph_direct.py`).  Same seeds, same draws, so the
port builds the same graph as the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class DirectGraphSpec:
    """Knobs for the synthetic-lexicon benchmark graph."""
    vocab: int = 700
    num_phones: int = 40
    min_pron: int = 3
    max_pron: int = 8
    num_pdfs: int = 3456
    eos_cost: float = 2.0          # -log P(</s> | u), flat
    bigram_range: Tuple[float, float] = (1.5, 12.0)
    seed: int = 0


def synth_lexicon(spec: DirectGraphSpec) -> List[np.ndarray]:
    """Random pronunciations (unique per word), phone ids 1-based."""
    rng = np.random.default_rng(spec.seed)
    prons: List[np.ndarray] = []
    seen = set()
    while len(prons) < spec.vocab:
        k = int(rng.integers(spec.min_pron, spec.max_pron + 1))
        p = rng.integers(1, spec.num_phones + 1, size=k).astype(np.int32)
        key = tuple(p.tolist())
        if key in seen:
            continue
        seen.add(key)
        prons.append(p)
    return prons


def synth_bigram(spec: DirectGraphSpec) -> np.ndarray:
    """(V+1, V) costs -log P(w | u); row V is the sentence-begin
    context.  A densified backoff bigram: every transition exists."""
    rng = np.random.default_rng(spec.seed + 1)
    lo, hi = spec.bigram_range
    V = spec.vocab
    w = rng.uniform(lo, hi, size=(V + 1, V)).astype(np.float32)
    # make a few transitions per context clearly cheap (zipf-ish mass)
    hot = rng.integers(0, V, size=(V + 1, 8))
    rows = np.arange(V + 1)[:, None]
    w[rows, hot] = rng.uniform(lo, lo + 1.5, size=hot.shape)
    return w
