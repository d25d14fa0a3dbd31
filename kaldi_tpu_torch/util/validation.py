"""Data/lang directory validation (port of `kaldi_tpu/util/validation.py`;
parity: utils/validate_data_dir.sh,
utils/validate_lang.pl, utils/fix_data_dir.sh).

Validators return a list of problem strings (empty = valid) so library
callers can decide severity; the CLI wrappers print them and exit
nonzero. fix_data_dir removes inconsistent utterances the way the
reference's fix_data_dir.sh does (keep the intersection, rewrite
files sorted)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from kaldi_tpu_torch.base.logging import log, warn


def _read_map(path: str, allow_empty_value: bool = False
              ) -> Tuple[Dict[str, str], List[str]]:
    """First-token -> rest map; returns (map, problems)."""
    problems: List[str] = []
    out: Dict[str, str] = {}
    prev_key = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.rstrip("\n").split(None, 1)
            if not parts:
                problems.append(f"{path}:{lineno}: empty line")
                continue
            key = parts[0]
            val = parts[1] if len(parts) > 1 else ""
            if not val and not allow_empty_value:
                problems.append(f"{path}:{lineno}: no value for {key}")
            if key in out:
                problems.append(f"{path}:{lineno}: duplicate key {key}")
            if prev_key is not None and key < prev_key:
                problems.append(
                    f"{path}:{lineno}: not sorted ({key} after"
                    f" {prev_key}); run fix_data_dir")
            prev_key = key
            out[key] = val
    return out, problems


def validate_data_dir(d: str, require_text: bool = True,
                      require_feats: bool = False) -> List[str]:
    """Check wav.scp/text/utt2spk/spk2utt/feats.scp/segments
    consistency (validate_data_dir.sh)."""
    problems: List[str] = []
    wav_scp = os.path.join(d, "wav.scp")
    segments = os.path.join(d, "segments")
    utt2spk_p = os.path.join(d, "utt2spk")
    if not os.path.exists(utt2spk_p):
        return [f"{d}: no utt2spk file"]
    utt2spk, p = _read_map(utt2spk_p)
    problems += p
    utts = set(utt2spk)

    if os.path.exists(segments):
        segs, p = _read_map(segments)
        problems += p
        if set(segs) != utts:
            problems.append(f"{d}: segments/utt2spk utterance mismatch")
        recs = {v.split()[0] for v in segs.values() if v}
        if os.path.exists(wav_scp):
            wavs, p = _read_map(wav_scp, allow_empty_value=False)
            problems += p
            missing = recs - set(wavs)
            if missing:
                problems.append(
                    f"{d}: segments references recordings not in "
                    f"wav.scp: {sorted(missing)[:5]}")
        for u, v in segs.items():
            parts = v.split()
            if len(parts) != 3:
                problems.append(f"{d}: bad segments line for {u}")
                continue
            try:
                start, end = float(parts[1]), float(parts[2])
                if not (0 <= start < end):
                    problems.append(
                        f"{d}: segment {u} has bad times {start}/{end}")
            except ValueError:
                problems.append(f"{d}: segment {u} non-numeric times")
    elif os.path.exists(wav_scp):
        wavs, p = _read_map(wav_scp)
        problems += p
        if set(wavs) != utts:
            only_w = sorted(set(wavs) - utts)[:5]
            only_u = sorted(utts - set(wavs))[:5]
            problems.append(f"{d}: wav.scp/utt2spk mismatch "
                            f"(wav-only {only_w}, utt-only {only_u})")
    if require_text:
        text_p = os.path.join(d, "text")
        if not os.path.exists(text_p):
            problems.append(f"{d}: no text file")
        else:
            text, p = _read_map(text_p, allow_empty_value=True)
            problems += p
            if set(text) != utts:
                problems.append(f"{d}: text/utt2spk utterance mismatch")
    if require_feats:
        feats_p = os.path.join(d, "feats.scp")
        if not os.path.exists(feats_p):
            problems.append(f"{d}: no feats.scp")
        else:
            feats, p = _read_map(feats_p)
            problems += p
            if set(feats) != utts:
                problems.append(f"{d}: feats.scp/utt2spk mismatch")
    spk2utt_p = os.path.join(d, "spk2utt")
    if os.path.exists(spk2utt_p):
        spk2utt, p = _read_map(spk2utt_p)
        problems += p
        mapped = {(u, s) for s, us in spk2utt.items() for u in us.split()}
        direct = set((u, s) for u, s in utt2spk.items())
        if mapped != direct:
            problems.append(f"{d}: spk2utt is not the inverse of utt2spk")
    return problems


def validate_lang_dir(d: str) -> List[str]:
    """Check phones.txt/words.txt/topo/L.fst consistency
    (validate_lang.pl core checks)."""
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from kaldi_tpu_torch.fstext.fst import EPS
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.util import kaldi_io

    problems: List[str] = []
    for req in ("phones.txt", "words.txt", "topo"):
        if not os.path.exists(os.path.join(d, req)):
            problems.append(f"{d}: missing {req}")
    if problems:
        return problems
    phones = read_symbol_table(os.path.join(d, "phones.txt"))
    words = read_symbol_table(os.path.join(d, "words.txt"))
    for name, table in (("phones.txt", phones), ("words.txt", words)):
        ids = list(table.values())
        if len(set(ids)) != len(ids):
            problems.append(f"{d}/{name}: duplicate ids")
        if table.get("<eps>", 0) != 0:
            problems.append(f"{d}/{name}: <eps> must map to 0")
    try:
        topo = kaldi_io.read_kaldi_object(HmmTopology.read,
                                          os.path.join(d, "topo"))
        real_phones = [i for nm, i in phones.items()
                       if i != 0 and not nm.startswith("#")]
        covered = set(topo.phones)
        missing = [p for p in real_phones if p not in covered]
        if missing:
            problems.append(f"{d}: topo does not cover phones {missing}")
    except Exception as e:  # noqa: BLE001
        problems.append(f"{d}/topo: unreadable ({e})")
    lpath = os.path.join(d, "L.fst")
    if os.path.exists(lpath):
        try:
            L = read_fst_file(lpath)
            if L.start < 0:
                problems.append(f"{d}/L.fst: no start state")
            max_p = max(phones.values())
            max_w = max(words.values())
            for s in range(L.num_states):
                for a in L.arcs[s]:
                    if a.ilabel != EPS and a.ilabel > max_p:
                        problems.append(
                            f"{d}/L.fst: ilabel {a.ilabel} out of range")
                        break
                    if a.olabel != EPS and a.olabel > max_w:
                        problems.append(
                            f"{d}/L.fst: olabel {a.olabel} out of range")
                        break
        except Exception as e:  # noqa: BLE001
            problems.append(f"{d}/L.fst: unreadable ({e})")
    else:
        problems.append(f"{d}: missing L.fst")
    return problems


def fix_data_dir(d: str) -> int:
    """Keep only utterances present in ALL per-utterance files, rewrite
    everything key-sorted (fix_data_dir.sh). Returns #utts removed."""
    per_utt = [f for f in ("wav.scp", "text", "utt2spk", "feats.scp")
               if os.path.exists(os.path.join(d, f))]
    maps = {}
    for f in per_utt:
        m, _ = _read_map(os.path.join(d, f), allow_empty_value=True)
        maps[f] = m
    keep = None
    for f in per_utt:
        keep = set(maps[f]) if keep is None else keep & set(maps[f])
    keep = keep or set()
    removed = max(len(maps[f]) for f in per_utt) - len(keep) \
        if per_utt else 0
    for f in per_utt:
        with open(os.path.join(d, f), "w") as out:
            for k in sorted(keep):
                out.write(f"{k} {maps[f][k]}".rstrip() + "\n")
    # regenerate spk2utt
    if "utt2spk" in maps:
        spk2utt: Dict[str, List[str]] = {}
        for u in sorted(keep):
            spk2utt.setdefault(maps["utt2spk"][u], []).append(u)
        with open(os.path.join(d, "spk2utt"), "w") as out:
            for s in sorted(spk2utt):
                out.write(f"{s} {' '.join(spk2utt[s])}\n")
    log(f"fix_data_dir: kept {len(keep)} utterances, removed {removed}")
    return removed
