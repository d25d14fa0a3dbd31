"""compute-wer, ali-to-pdf and ali-to-post (ports of the tools of
`kaldi_tpu/cli/ali_tools.py`; bin/compute-wer.cc, bin/ali-to-pdf.cc,
bin/ali-to-post.cc): the WER and sentence error rate of hypotheses
against references, both text tables of words; alignments to pdf-ids
and to posteriors.  ali-to-pdf reads the model's TransitionModel only, as
Kaldi's does, so it takes a GMM .mdl and a chain 0.trans_mdl alike (the
JAX package's tool reads a whole GMM model).

Not carried over yet: the module's other tools (align-equal-compiled,
ali-to-phones, copy-int-vector, align-text, weight-silence-post).
"""

from __future__ import annotations

import sys
from typing import List

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.util.edit_distance import WerStats
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


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


def ali_to_pdf(argv: List[str]) -> int:
    po = ParseOptions(
        "Converts alignments (containing transition-ids) to pdf-ids, "
        "zero-based.\n"
        "Usage: ali-to-pdf [options] <model> <alignments-rspecifier> "
        "<pdfs-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(1))
    writer = TableWriter("int-vector", po.get_arg(3))
    for key, ali in SequentialTableReader("int-vector", po.get_arg(2)):
        writer.write(key, [int(p) for p in tm.transition_ids_to_pdfs(ali)])
    writer.close()
    return 0


def ali_to_post(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert alignments to posteriors (weight 1.0 per frame)\n"
        "Usage: ali-to-post [options] <alignments-rspecifier> "
        "<posteriors-wspecifier>")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("posterior", po.get_arg(2))
    n = 0
    for key, ali in SequentialTableReader("int-vector", po.get_arg(1)):
        writer.write(key, [[(int(t), 1.0)] for t in ali])
        n += 1
    writer.close()
    log(f"converted {n} alignments to posteriors")
    return 0 if n else 1
