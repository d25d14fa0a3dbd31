"""Tree tools and alignment conversion (ports of acc-tree-stats,
sum-tree-stats, cluster-phones and build-tree, which the reference
registers under `kaldi_tpu/cli/nnet3_tools.py`, and of convert-ali of
`kaldi_tpu/cli/tail6_tools.py`).  Host numpy, as in the reference.

The tree statistics are the reference's BuildTreeStats wire format
(build-tree-utils.cc:29: "BTS", then each event and its GaussClusterable),
binary with the \\0B marker, byte for byte as the JAX tools write them.
The model arguments are read for their TransitionModel only, as Kaldi's
tools read them.
"""

from __future__ import annotations

import io
from typing import List

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def _write_tree_stats(wxfilename: str, stats) -> None:
    from kaldi_tpu_torch.tree.clusterable import write_build_tree_stats
    with kaldi_io.output_stream(wxfilename) as f:
        iof.init_output_stream(f, True)
        write_build_tree_stats(f, True, stats)


def _read_tree_stats(rxfilename: str):
    from kaldi_tpu_torch.tree.clusterable import read_build_tree_stats
    with kaldi_io.input_stream(rxfilename) as f:
        if not hasattr(f, "peek"):
            f = io.BufferedReader(f)
        binary = iof.init_input_stream(f)
        return read_build_tree_stats(f, binary)


def acc_tree_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate statistics for phonetic-context tree building.\n"
        "Usage: acc-tree-stats [options] <model-in> <features-rspecifier> "
        "<alignments-rspecifier> <tree-accs-out>")
    context_width = po.register_value("context-width", 3, "Context window size [must match context-width]")
    central_position = po.register_value("central-position", 1, "Central position in context window [must match central-position]")
    ci_phones = po.register_value("ci-phones", "", "Colon-separated list of integer indices of context-independent phones")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.tree.build_tree import accumulate_tree_stats
    tm = kaldi_io.read_kaldi_object(TransitionModel.read,
                                    po.get_arg(1))
    ci = [int(p) for p in ci_phones[0].split(":") if p]
    ali_reader = RandomAccessTableReader("int-vector", po.get_arg(3))
    stats = {}
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in ali_reader:
            continue
        accumulate_tree_stats(tm, tm.topo, feats, ali_reader[key],
                              context_width[0], central_position[0],
                              stats, ci_phones=ci)
        n += 1
    _write_tree_stats(po.get_arg(4), stats)
    log(f"accumulated tree stats from {n} utterances ({len(stats)} events)")
    return 0


def sum_tree_stats(argv: List[str]) -> int:
    po = ParseOptions("Sum statistics for phonetic-context tree building.\n"
                      "Usage: sum-tree-stats [options] <tree-accs-out> <tree-accs-in1> <tree-accs-in2> ...")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    total = None
    for i in range(2, po.num_args() + 1):
        stats = _read_tree_stats(po.get_arg(i))
        if total is None:
            total = stats
        else:
            for k, v in stats.items():
                total[k] = total[k].add(v) if k in total else v
    _write_tree_stats(po.get_arg(1), total or {})
    return 0


def cluster_phones_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Cluster phones (or sets of phones) into sets for various purposes\n"
        "Usage: cluster-phones [options] <tree-stats-in> <phone-sets-in> <clustered-phones-out>")
    central_position = po.register_value("central-position", 1, "Central position in context window")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.tree.build_tree import cluster_phones
    stats = _read_tree_stats(po.get_arg(1))
    phones = []
    with open(po.get_arg(2)) as f:
        for line in f:
            phones.extend(int(t) for t in line.split())
    questions = cluster_phones(stats, phones, central_position[0])
    with open(po.get_arg(3), "w") as f:
        for q in questions:
            f.write(" ".join(str(p) for p in q) + "\n")
    log(f"wrote {len(questions)} questions")
    return 0


def build_tree_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Train decision tree\n"
        "Usage: build-tree [options] <tree-stats-in> <roots-file> "
        "<questions-file> <topo-file> <tree-out>")
    max_leaves = po.register_value("max-leaves", 1000, "Maximum number of leaves to be used in tree-building")
    context_width = po.register_value("context-width", 3, "Context window size")
    central_position = po.register_value("central-position", 1, "Central position in context window")
    thresh = po.register_value("thresh", 300.0, "Log-likelihood change threshold for tree-building")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.tree.build_tree import BuildTreeOptions, build_tree
    from kaldi_tpu_torch.tree.event_map import PDF_CLASS_KEY
    stats = _read_tree_stats(po.get_arg(1))
    roots = []
    with open(po.get_arg(2)) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            roots.append(([int(t) for t in parts[2:]],
                          parts[0] == "shared", parts[1] == "split"))
    phone_qs = []
    with open(po.get_arg(3)) as f:
        for line in f:
            if line.strip():
                phone_qs.append([int(t) for t in line.split()])
    topo = kaldi_io.read_kaldi_object(HmmTopology.read, po.get_arg(4))
    max_pc = max(topo.num_pdf_classes(p) for r in roots for p in r[0])
    questions = {k: phone_qs for k in range(context_width[0])}
    questions[PDF_CLASS_KEY] = [list(range(k + 1)) for k in range(max_pc)]
    tree = build_tree(stats, questions, roots, context_width[0],
                      central_position[0],
                      BuildTreeOptions(max_leaves=max_leaves[0],
                                       min_gain=thresh[0]), topo=topo)
    kaldi_io.write_kaldi_object(tree.write, po.get_arg(5))
    log(f"built tree with {tree.num_pdfs} leaves")
    return 0


def convert_ali(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert alignments between systems (e.g. mono -> triphone): "
        "phone segment durations are preserved; pdfs come from the "
        "new tree over the utterance's phone context.\n"
        "Usage: convert-ali [options] <old-model> <new-model> "
        "<new-tree> <old-ali-rspecifier> <new-ali-wspecifier>")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.topology import NO_PDF
    from kaldi_tpu_torch.tree.context_dep import ContextDependency
    tm_old = kaldi_io.read_kaldi_object(TransitionModel.read, po.get_arg(1))
    tm_new = kaldi_io.read_kaldi_object(TransitionModel.read, po.get_arg(2))
    tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                      po.get_arg(3))
    N, P = tree.context_width(), tree.central_position()
    writer = TableWriter("int-vector", po.get_arg(5))
    n = err = 0
    for key, ali in SequentialTableReader("int-vector", po.get_arg(4)):
        phones = [tm_old.transition_id_to_phone(int(t)) for t in ali]
        # phone segments [phone, start, dur]: a segment starts at a phone
        # change or at a non-self-loop transition into hmm-state 0
        segs = []
        for t, p in enumerate(phones):
            tid = int(ali[t])
            starts = (t == 0 or phones[t - 1] != p
                      or (tm_old.transition_id_to_hmm_state(tid) == 0
                          and not tm_old.is_self_loop(tid)
                          and tm_old.transition_id_to_hmm_state(
                              int(ali[t - 1])) != 0))
            if starts:
                segs.append([p, t, 0])
            segs[-1][2] += 1
        seq = [s[0] for s in segs]
        out: List[int] = []
        ok = True
        for i, (p, start, dur) in enumerate(segs):
            window = [seq[j] if 0 <= j < len(seq) else 0
                      for j in range(i - P, i - P + N)]
            entry = tm_new.topo.topology_for_phone(p)
            try:
                for t in range(start, start + dur):
                    tid_old = int(ali[t])
                    hs = tm_old.transition_id_to_hmm_state(tid_old)
                    if hs >= len(entry) or \
                            entry[hs].forward_pdf_class == NO_PDF:
                        raise ValueError(
                            f"topology mismatch for phone {p} state {hs}")
                    pdf = tree.compute(window, entry[hs].forward_pdf_class)
                    spdf = tree.compute(window,
                                        entry[hs].self_loop_pdf_class)
                    ts = tm_new.tuple_to_transition_state(p, hs, pdf, spdf)
                    if tm_old.is_self_loop(tid_old):
                        out.append(tm_new.self_loop_of(ts))
                    else:
                        # the first non-self-loop transition out of ts
                        tid = None
                        for ti in range(tm_new.num_transition_indices(ts)):
                            cand = tm_new.pair_to_transition_id(ts, ti)
                            if not tm_new.is_self_loop(cand):
                                tid = cand
                                break
                        if tid is None:
                            raise ValueError("no forward transition")
                        out.append(tid)
            except (ValueError, KeyError) as e:
                warn(f"convert-ali: {key}: {e}")
                ok = False
                break
        if not ok or len(out) != len(ali):
            err += 1
            continue
        writer.write(key, np.asarray(out, np.int32))
        n += 1
    writer.close()
    log(f"converted {n} alignments ({err} errors)")
    return 0 if n else 1
