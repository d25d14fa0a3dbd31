"""compute-wer (port of the tool of `kaldi_tpu/cli/ali_tools.py`;
bin/compute-wer.cc): the WER and sentence error rate of hypotheses
against references, both text tables of words.

Not carried over yet: the module's other tools (align-equal-compiled,
ali-to-phones, ali-to-pdf, copy-int-vector, align-text, ali-to-post,
weight-silence-post).
"""

from __future__ import annotations

import sys
from typing import List

from kaldi_tpu_torch.util.edit_distance import WerStats
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader


def compute_wer(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute WER by comparing different transcriptions\n"
        "Usage: compute-wer [options] <ref-rspecifier> <hyp-rspecifier>\n"
        "E.g.: compute-wer --text --mode=present ark:data/train/text ark:hyp_text")
    mode = po.register_value("mode", "strict", "Scoring mode: strict|present|all")
    po.register_value("text", True, "Deprecated option! Keeping for compatibility")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    refs = dict(SequentialTableReader("token-vector", po.get_arg(1)))
    hyps = dict(SequentialTableReader("token-vector", po.get_arg(2)))
    stats = WerStats()
    absent = 0
    for key, ref in refs.items():
        if key not in hyps:
            absent += 1
            if mode[0] == "present":
                continue
            if mode[0] == "strict":
                print(f"compute-wer: no hypothesis for key {key}",
                      file=sys.stderr)
                return 1
            stats.add(ref, [])
            continue
        stats.add(ref, hyps[key])
    print(stats.report())
    print(f"%SER {100.0 * stats.wrong_sentences / max(stats.sentences, 1):.2f} "
          f"[ {stats.wrong_sentences} / {stats.sentences} ]")
    if absent:
        print(f"{absent} absent sentences.", file=sys.stderr)
    return 0
