"""Lang-directory interop (port of `kaldi_tpu/decoder/lang_dir.py`;
parity: the utils/prepare_lang.sh data contract: phones.txt, words.txt,
L.fst, L_disambig.fst, topo, phones/*).  Host-side; the files equal the
reference's byte for byte, but for the disambiguation symbols that
phones.txt and phones/disambig.int list (`write_lang_dir`).

write_lang_dir produces a directory the reference tools can consume
(symbol tables as text, L.fst in raw OpenFst binary, topo in text
format); read_lang_dir loads one produced by either implementation.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from kaldi_tpu_torch.base.logging import KaldiTpuError, log
from kaldi_tpu_torch.decoder.graph import Lang, make_lexicon_fst
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.util import kaldi_io


def write_symbol_table(path: str, names: Dict[int, str],
                       eps: str = "<eps>") -> None:
    with open(path, "w") as f:
        f.write(f"{eps} 0\n")
        for i in sorted(names):
            f.write(f"{names[i]} {i}\n")


def read_symbol_table(path: str) -> Dict[str, int]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def write_lang_dir(lang: Lang, dirname: str) -> None:
    """Every disambiguation symbol that L_disambig.fst uses is listed,
    as #0 to #k in phones.txt and phones/disambig.int, k being the count
    `make_lexicon_fst(with_disambig=True)` sets, optional silence's
    symbol included (upstream prepare_lang.sh's contract).  The
    reference names them from the count before L_disambig is built and
    after L.fst has reset it, and so lists #0 alone (ROADMAP.md
    section 3); the other files are the reference's byte for byte."""
    os.makedirs(dirname, exist_ok=True)
    os.makedirs(os.path.join(dirname, "phones"), exist_ok=True)
    L = make_lexicon_fst(lang, with_disambig=True)
    disambig = [lang.first_disambig + k
                for k in range(lang.num_disambig + 1)]
    phone_names = dict(lang.phone_names)
    for k, sym in enumerate(disambig):
        phone_names[sym] = f"#{k}"
    write_symbol_table(os.path.join(dirname, "phones.txt"), phone_names)
    write_symbol_table(os.path.join(dirname, "words.txt"), lang.word_names)
    topo = lang.topo or lang.make_topology()
    kaldi_io.write_kaldi_object(topo.write, os.path.join(dirname, "topo"),
                                binary=False)
    with open(os.path.join(dirname, "L_disambig.fst"), "wb") as f:
        write_fst(f, L)
    L_plain = make_lexicon_fst(lang, with_disambig=False)
    with open(os.path.join(dirname, "L.fst"), "wb") as f:
        write_fst(f, L_plain)
    # phones/ lists
    sil_id = lang.phones[lang.sil_phone]
    with open(os.path.join(dirname, "phones", "silence.csl"), "w") as f:
        f.write(f"{sil_id}\n")
    nonsil = sorted(i for p, i in lang.phones.items()
                    if p != lang.sil_phone)
    with open(os.path.join(dirname, "phones", "nonsilence.csl"), "w") as f:
        f.write(":".join(str(i) for i in nonsil) + "\n")
    with open(os.path.join(dirname, "phones", "disambig.int"), "w") as f:
        for sym in disambig:
            f.write(f"{sym}\n")
    log(f"wrote lang directory {dirname}")


def read_lang_dir(dirname: str):
    """Returns (phones {name: id}, words {name: id}, topo, L_disambig,
    disambig ids)."""
    phones = read_symbol_table(os.path.join(dirname, "phones.txt"))
    words = read_symbol_table(os.path.join(dirname, "words.txt"))
    topo = kaldi_io.read_kaldi_object(HmmTopology.read,
                                      os.path.join(dirname, "topo"))
    lpath = os.path.join(dirname, "L_disambig.fst")
    if not os.path.exists(lpath):
        lpath = os.path.join(dirname, "L.fst")
    L = read_fst_file(lpath)
    disambig: List[int] = []
    dpath = os.path.join(dirname, "phones", "disambig.int")
    if os.path.exists(dpath):
        disambig = [int(line) for line in open(dpath) if line.strip()]
    else:
        disambig = [i for name, i in phones.items()
                    if name.startswith("#")]
    return phones, words, topo, L, disambig


def prepare_lang(lexicon_path: str, out_dir: str, sil_phone: str = "SIL",
                 sil_prob: float = 0.5,
                 oov_word: Optional[str] = None) -> Lang:
    """prepare_lang.sh front door: lexicon text file
    ('WORD phone1 phone2 ...' per line, alternative prons on separate
    lines) -> lang directory."""
    lexicon: Dict[str, List[List[str]]] = {}
    with open(lexicon_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            lexicon.setdefault(parts[0], []).append(parts[1:])
    lang = Lang(lexicon, sil_phone=sil_phone, sil_prob=sil_prob,
                oov_word=oov_word)
    lang.make_topology()
    write_lang_dir(lang, out_dir)
    return lang
