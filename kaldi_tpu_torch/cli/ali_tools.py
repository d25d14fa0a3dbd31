"""compute-wer, align-equal-compiled, ali-to-pdf, ali-to-phones,
ali-to-post and copy-int-vector (ports of the tools of
`kaldi_tpu/cli/ali_tools.py`; bin/compute-wer.cc, bin/ali-to-pdf.cc,
bin/ali-to-phones.cc, ...): the WER and sentence error rate of
hypotheses against references, both text tables of words; equally
spaced alignments of compiled training graphs; alignments to pdf-ids,
phones and posteriors.  ali-to-pdf and ali-to-phones read the model's
TransitionModel only, as Kaldi's do, so they take a GMM .mdl and a chain
0.trans_mdl alike (the JAX package's tools read a whole GMM model).

Not carried over yet: the module's other tools (align-text,
weight-silence-post, post-to-weights, show-alignments).
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


def align_equal_compiled(argv: List[str]) -> int:
    po = ParseOptions("Write an equally spaced alignment (for getting training started)\n"
                      "Usage: align-equal-compiled <graphs-rspecifier> <features-rspecifier> <alignments-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.base.logging import warn
    from kaldi_tpu_torch.decoder.viterbi import align_equal
    from kaldi_tpu_torch.fstext.fst import VectorFst
    from kaldi_tpu_torch.util.table import RandomAccessTableReader
    graphs = RandomAccessTableReader(VectorFst, po.get_arg(1))
    writer = TableWriter("int-vector", po.get_arg(3))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in graphs:
            warn(f"no graph for {key}")
            err += 1
            continue
        ali = align_equal(graphs[key], feats.shape[0], None, seed=n + err)
        if ali is None:
            err += 1
            continue
        writer.write(key, ali)
        n += 1
    writer.close()
    log(f"equal-aligned {n} utterances ({err} failed)")
    return 0 if n else 1


def ali_to_phones(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert model-level alignments to phone-sequences (in integer, "
        "not symbolic, form)\n"
        "Usage: ali-to-phones [options] <model> <alignments-rspecifier> <phone-transcript-wspecifier>")
    per_frame = po.register_value("per-frame", False, "If true, write out the frame-level phone alignment")
    write_lengths = po.register_value("write-lengths", False, "If true, write the #frames for each phone (different format)")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(1))
    holder = "int-pair-vector" if write_lengths[0] else "int-vector"
    writer = TableWriter(holder, po.get_arg(3))
    for key, ali in SequentialTableReader("int-vector", po.get_arg(2)):
        if per_frame[0]:
            writer.write(key, [tm.transition_id_to_phone(t) for t in ali])
            continue
        segs = []  # [phone, length]
        for t in ali:
            phone = tm.transition_id_to_phone(t)
            is_start = (tm.transition_id_to_hmm_state(t) == 0
                        and not tm.is_self_loop(t))
            if is_start or not segs:
                segs.append([phone, 1])
            else:
                segs[-1][1] += 1
        if write_lengths[0]:
            writer.write(key, [(p, length) for p, length in segs])
        else:
            writer.write(key, [p for p, _ in segs])
    writer.close()
    return 0


def copy_int_vector(argv: List[str]) -> int:
    po = ParseOptions("Copy archives of vectors of integers, or archives of single integers\n"
                      "Usage: copy-int-vector [options] <vector-rspecifier> <vector-wspecifier>")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("int-vector", po.get_arg(2))
    n = 0
    for key, vec in SequentialTableReader("int-vector", po.get_arg(1)):
        writer.write(key, vec)
        n += 1
    writer.close()
    log(f"copied {n} vectors of int32.")
    return 0
