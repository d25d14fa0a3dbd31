"""A fabricated corpus in the standard Kaldi data layout, for the generic
corpus recipe (`recipes/template_run.py`): three words made of tones,
a lexicon and an ARPA bigram, made from a seed (no download).

A copy of `make_standard_corpus` of the reference's
tests/test_template_recipe.py with the utterance counts as parameters:
at (14, 4) it writes the same wav.scp, text, utt2spk, lexicon.txt,
lm.arpa and wave files byte for byte.  Each utterance is 0.3 s of
silence, then four words of 0.25 s, each followed by 0.25 s of silence
(2.3 s at 8 kHz)."""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu_torch.feat.wave import WaveData

FS = 8000.0
TONES = {"YES": (350.0, 900.0), "NO": (1600.0, 2600.0),
         "HEY": (700.0, 1800.0)}
WORDS = ["YES", "NO", "HEY"]
LEXICON = "YES Y\nNO N\nHEY H EY\n"
ARPA = """\\data\\
ngram 1=5
ngram 2=4

\\1-grams:
-0.60206 YES -0.30103
-0.60206 NO -0.30103
-1.0 HEY -0.30103
-99 <s> -0.30103
-0.60206 </s>

\\2-grams:
-0.47712 YES NO
-0.47712 NO YES
-0.60206 <s> YES
-0.60206 <s> NO

\\end\\
"""


def synth(words: List[str], seed: int) -> np.ndarray:
    """One utterance's samples (float32, int16 range)."""
    rng = np.random.default_rng(seed)

    def sil(n: int) -> np.ndarray:
        return 60.0 * rng.normal(size=n)

    parts = [sil(int(0.3 * FS))]
    for w in words:
        n = int(0.25 * FS)
        t = np.arange(n) / FS
        f1, f2 = TONES[w]
        seg = (2500 * np.sin(2 * np.pi * f1 * t)
               + 1500 * np.sin(2 * np.pi * f2 * t)
               + 60 * rng.normal(size=n))
        env = np.minimum(1.0, np.minimum(np.arange(n),
                                         n - np.arange(n)) / (0.02 * FS))
        parts.append(seg * env)
        parts.append(sil(int(0.25 * FS)))
    return np.concatenate(parts).astype(np.float32)


def make_standard_corpus(root: str, n_train: int = 14, n_test: int = 4,
                         seed: int = 7
                         ) -> Tuple[Dict[str, List[str]],
                                    Dict[str, List[str]]]:
    """Writes root/{train,test}/{wav.scp,text,utt2spk,*.wav},
    root/lexicon.txt and root/lm.arpa; returns (train, test)
    transcripts by utterance."""
    rng = np.random.default_rng(seed)
    train: Dict[str, List[str]] = {}
    test: Dict[str, List[str]] = {}
    for i in range(n_train):
        train[f"tr{i:02d}"] = [WORDS[int(rng.integers(3))]
                               for _ in range(4)]
    for i in range(n_test):
        test[f"te{i:02d}"] = [WORDS[int(rng.integers(3))]
                              for _ in range(4)]
    for split, utts in (("train", train), ("test", test)):
        sd = os.path.join(root, split)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, "wav.scp"), "w") as scp, \
                open(os.path.join(sd, "text"), "w") as text, \
                open(os.path.join(sd, "utt2spk"), "w") as u2s:
            for i, (utt, ws) in enumerate(sorted(utts.items())):
                wav = synth(ws, seed=zlib.crc32(utt.encode()) % 100000)
                p = os.path.join(sd, f"{utt}.wav")
                with open(p, "wb") as f:
                    WaveData(FS, wav[None, :]).write(f)
                scp.write(f"{utt} {p}\n")
                text.write(f"{utt} {' '.join(ws)}\n")
                u2s.write(f"{utt} spk{i % 3}\n")
    with open(os.path.join(root, "lexicon.txt"), "w") as f:
        f.write(LEXICON)
    with open(os.path.join(root, "lm.arpa"), "w") as f:
        f.write(ARPA)
    return train, test
