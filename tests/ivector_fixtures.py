"""Seeded feature archives for the i-vector parity tests: a few speakers,
each utterance frames of a Gaussian mixture shifted by its speaker's
offset, column 0 an energy-like track with silent stretches (for VAD)."""

import numpy as np

from kaldi_tpu_torch.util.table import TableWriter

SPEAKERS = 4


def synth_feats(n_utts: int, dim: int = 6, seed: int = 0,
                min_len: int = 60, max_len: int = 160) -> dict:
    """{utt: (T, dim) float32} for utterances u000.. of speakers
    round-robin."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(5, dim))
    offsets = rng.normal(scale=0.7, size=(SPEAKERS, dim))
    out = {}
    for i in range(n_utts):
        T = int(rng.integers(min_len, max_len))
        k = rng.integers(0, len(centers), size=T)
        x = (centers[k] + offsets[i % SPEAKERS]
             + rng.normal(scale=0.6, size=(T, dim)))
        energy = np.where(rng.random(T) < 0.3, 2.0, 12.0)
        x[:, 0] = energy + rng.normal(scale=0.5, size=T)
        out[f"u{i:03d}"] = x.astype(np.float32)
    return out


def speaker_of(utt: str) -> str:
    return f"spk{int(utt[1:]) % SPEAKERS}"


def write_set(root, feats: dict) -> None:
    """root/feats.ark (sorted keys), root/spk2utt, root/utt2spk."""
    root.mkdir(parents=True, exist_ok=True)
    with TableWriter("matrix", f"ark:{root}/feats.ark") as w:
        for u in sorted(feats):
            w.write(u, feats[u])
    spk2utt = {}
    for u in sorted(feats):
        spk2utt.setdefault(speaker_of(u), []).append(u)
    (root / "spk2utt").write_text("".join(
        f"{s} {' '.join(us)}\n" for s, us in sorted(spk2utt.items())))
    (root / "utt2spk").write_text("".join(
        f"{u} {speaker_of(u)}\n" for u in sorted(feats)))


def read_table(kind: str, rspecifier: str) -> dict:
    from kaldi_tpu_torch.util.table import SequentialTableReader
    return {k: (np.asarray(v) if kind in ("matrix", "vector") else v)
            for k, v in SequentialTableReader(kind, rspecifier)}


def rel_err(got, want) -> float:
    """Largest difference against the largest element of `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))
