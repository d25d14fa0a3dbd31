"""Lattice rescoring, MBR, word alignment and CTM tools (ports of the
reference's latbin tools: lattice-lmrescore, lattice-mbr-decode and
lattice-to-ctm-conf of `kaldi_tpu/cli/misc_tools.py`; lattice-to-nbest,
nbest-to-linear, lattice-align-words, arpa-to-const-arpa,
lattice-lmrescore-const-arpa and lattice-lmrescore-pruned of
`kaldi_tpu/cli/lat_tools.py`; nbest-to-ctm and lattice-compose of
`kaldi_tpu/cli/lat_tools2.py`; lattice-align-words-lexicon of
`kaldi_tpu/cli/latalign_tools.py`; lattice-determinize-phone-pruned of
`kaldi_tpu/cli/parbin_tools.py`).  Host-side, over Lattice tables, as in
the reference: the archives they write are the JAX tools' byte for byte.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Dict, List, Tuple

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.gmm_tools import _read_tm
from kaldi_tpu_torch.cli.lat_tools import _each
from kaldi_tpu_torch.fstext.fst import (EPS, Arc, LatticeWeight,
                                        TropicalWeight, VectorFst)
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.lat.compose_pruned import compose_lattice_pruned
from kaldi_tpu_torch.lat.functions import (determinize_lattice_phone_pruned,
                                           lattice_best_path, lattice_nbest,
                                           lattice_scale)
from kaldi_tpu_torch.lat.kaldi_lattice import (CompactLatticeHolder, Lattice,
                                               LatticeHolder)
from kaldi_tpu_torch.lat.sausages import MinimumBayesRisk
from kaldi_tpu_torch.lat.word_align import (WordBoundaryInfo, format_ctm,
                                            lattice_to_ctm,
                                            word_align_lattice,
                                            word_align_lattice_lexicon)
from kaldi_tpu_torch.lm.arpa import parse_arpa
from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
from kaldi_tpu_torch.lm.rescore import DeterministicLm, lattice_lmrescore
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def lattice_lmrescore_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Add lm_scale * [cost of best path through LM FST] to graph "
        "costs of the lattice.\n"
        "Usage: lattice-lmrescore [options] <lattice-rspecifier> "
        "<arpa-lm-rxfilename> <words-txt> <lattice-wspecifier>")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for language model costs; frequently 1.0 or -1.0")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    with kaldi_io.input_stream(po.get_arg(2)) as f:
        lm = parse_arpa(f.read().decode("utf-8"))
    word_names = {}
    with open(po.get_arg(3)) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                word_names[int(parts[1])] = parts[0]
    det = DeterministicLm(lm, word_names)
    writer = TableWriter(LatticeHolder(), po.get_arg(4))
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        writer.write(key, lattice_lmrescore(lat, det, lm_scale[0]))
        n += 1
    writer.close()
    log(f"rescored {n} lattices")
    return 0


def arpa_to_const_arpa(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert an ARPA format language model into ConstArpaLm format.\n"
        "Usage: arpa-to-const-arpa [opts] <arpa-rxfilename> "
        "<const-arpa-wxfilename>")
    bos = po.register_value("bos-symbol", -1,
                            "Symbol id for <s> (integer-word ARPA)")
    eos = po.register_value("eos-symbol", -1,
                            "Symbol id for </s> (integer-word ARPA)")
    unk = po.register_value("unk-symbol", -1, "Symbol id for <unk>")
    symtab = po.register_value("read-symbol-table", "",
                               "words.txt mapping word strings to ids "
                               "(for string-word ARPA)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    symbols = None
    if symtab[0]:
        symbols = {}
        with open(symtab[0]) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    symbols[parts[0]] = int(parts[1])
    lm = ConstArpaLm.build_from_arpa(po.get_arg(1), symbols=symbols)
    if int(bos[0]) >= 0:
        lm.bos_id = int(bos[0])
    if int(eos[0]) >= 0:
        lm.eos_id = int(eos[0])
    if int(unk[0]) >= 0:
        lm.unk_id = int(unk[0])
    if lm.bos_id < 0 or lm.eos_id < 0:
        warn("bos/eos ids unresolved; pass --bos-symbol/--eos-symbol "
             "or --read-symbol-table")
    lm.write(po.get_arg(2))
    log(f"wrote ConstArpaLm order {lm.order}, ngrams {lm.num_ngrams}")
    return 0


def lattice_lmrescore_const_arpa(argv: List[str]) -> int:
    po = ParseOptions(
        "Adds lm_scale * [cost of best path through ConstArpaLm] to "
        "graph costs.\n"
        "Usage: lattice-lmrescore-const-arpa [options] "
        "<lattice-rspecifier> <const-arpa-rxfilename> "
        "<lattice-wspecifier>")
    lm_scale = po.register_value("lm-scale", 1.0,
                                 "Scaling factor for LM costs")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    lm = ConstArpaLm.read(po.get_arg(2))
    return _each(po.get_arg(1), po.get_arg(3),
                 lambda k, lat: lattice_lmrescore(lat, lm, lm_scale[0]),
                 "lattice-lmrescore-const-arpa")


def lattice_lmrescore_pruned_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Replace LM scores with a big LM using pruned composition: "
        "subtract the old (small) ARPA G exactly, add the new "
        "ConstArpaLm within a compose beam.\n"
        "Usage: lattice-lmrescore-pruned [options] <lattice-rspecifier> "
        "<old-arpa-rxfilename> <words-txt> <const-arpa-rxfilename> "
        "<lattice-wspecifier>")
    lm_scale = po.register_value("lm-scale", 1.0,
                                 "Scale for the LM being added")
    beam = po.register_value("compose-beam", 6.0,
                             "Pruning beam of the composed output")
    max_arcs = po.register_value("max-arcs", 100000,
                                 "Arc budget per lattice")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    with kaldi_io.input_stream(po.get_arg(2)) as f:
        old = parse_arpa(f.read().decode("utf-8"))
    names = {}
    with open(po.get_arg(3)) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                names[int(parts[1])] = parts[0]
    old_det = DeterministicLm(old, names)
    new_lm = ConstArpaLm.read(po.get_arg(4))

    def fn(key, lat):
        sub = lattice_lmrescore(lat, old_det, -lm_scale[0])
        return compose_lattice_pruned(sub, new_lm, lm_scale[0],
                                      beam=beam[0],
                                      max_arcs=int(max_arcs[0]))

    return _each(po.get_arg(1), po.get_arg(5), fn,
                 "lattice-lmrescore-pruned")


def compose_lattice_fst_op(lat: Lattice, fst: VectorFst) -> Lattice:
    """Compose a lattice's word (output) side with a tropical FST,
    adding FST costs to graph costs (latbin/lattice-compose.cc with an
    fst as arg2). FST input-eps arcs advance the FST freely; lattice
    eps-word arcs advance the lattice freely."""
    out = VectorFst(LatticeWeight)
    # composed state = (lat state, fst state, filter); filter = 1 after
    # an FST eps-input move, which forbids a lattice eps-olabel move —
    # the 2-value epsilon-sequencing filter of OpenFst composition, so
    # adjacent eps sequences have exactly ONE interleaving (all lattice
    # eps first, then fst eps) and no path is duplicated.
    state_map: Dict[Tuple[int, int, int], int] = {}
    work = deque()

    def get(ls, fs, filt):
        key = (ls, fs, filt)
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            work.append(key)
        return s

    if lat.num_states == 0 or lat.start is None or \
            fst.num_states == 0 or fst.start is None:
        return out
    # sort fst arcs by ilabel for lookup
    by_label: List[Dict[int, List[Arc]]] = []
    for s in range(fst.num_states):
        d: Dict[int, List[Arc]] = {}
        for a in fst.arcs[s]:
            d.setdefault(a.ilabel, []).append(a)
        by_label.append(d)
    start = get(lat.start, fst.start, 0)
    out.set_start(start)
    while work:
        ls, fs, filt = work.popleft()
        cur = state_map[(ls, fs, filt)]
        if lat.finals[ls] != LatticeWeight.zero and \
                fst.finals[fs] != TropicalWeight.zero:
            g, ac = lat.finals[ls]
            out.finals[cur] = (g + float(fst.finals[fs]), ac)
        # fst eps-input arcs: free advance (sets the filter)
        for fa in by_label[fs].get(EPS, []):
            g = float(fa.weight)
            ns = get(ls, fa.nextstate, 1)
            out.add_arc(cur, Arc(EPS, fa.olabel, (g, 0.0), ns))
        for a in lat.arcs[ls]:
            if a.olabel == EPS:
                if filt == 1:
                    continue       # eps-lat after eps-fst forbidden
                ns = get(a.nextstate, fs, 0)
                out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight, ns))
                continue
            for fa in by_label[fs].get(a.olabel, []):
                g, ac = a.weight
                ns = get(a.nextstate, fa.nextstate, 0)
                out.add_arc(cur, Arc(a.ilabel, fa.olabel,
                                     (g + float(fa.weight), ac), ns))
    connect(out)
    return out


def lattice_compose(argv: List[str]) -> int:
    po = ParseOptions(
        "Composes lattices (on the word level) with a tropical FST "
        "(e.g. a grammar or LM fst read once).\n"
        "Usage: lattice-compose [options] <lattice-rspecifier1> "
        "<fst-rxfilename> <lattice-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    fst = read_fst_file(po.get_arg(2))
    return _each(po.get_arg(1), po.get_arg(3),
                 lambda k, lat: compose_lattice_fst_op(lat, fst),
                 "lattice-compose")


def lattice_mbr_decode(argv: List[str]) -> int:
    po = ParseOptions(
        "Do Minimum Bayes Risk decoding (decoding that aims to minimize the "
        "expected word error rate).\n"
        "Usage: lattice-mbr-decode [options] <lattice-rspecifier> "
        "<transcriptions-wspecifier> [<bayes-risk-wspecifier> [<sausage-stats-wspecifier>]]")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for graph/lm costs")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    writer = TableWriter("int-vector", po.get_arg(2))
    risk_writer = (TableWriter("float", po.get_arg(3))
                   if po.num_args() >= 3 else None)
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        scaled = lattice_scale(lat, lm_scale[0], acoustic_scale[0])
        mbr = MinimumBayesRisk(scaled)
        writer.write(key, mbr.get_one_best())
        if risk_writer:
            risk_writer.write(key, mbr.get_bayes_risk())
    writer.close()
    if risk_writer:
        risk_writer.close()
    return 0


def lattice_to_ctm_conf(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate 1-best path through lattices; output as CTM with "
        "confidences.\n"
        "Usage: lattice-to-ctm-conf [options] <lattice-rspecifier> <ctm-wxfilename>")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for LM probabilities")
    frame_shift = po.register_value("frame-shift", 0.01, "Time in seconds between frames")
    decode_mbr = po.register_value("decode-mbr", True, "If true, do Minimum Bayes Risk decoding")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    entries = []
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        scaled = lattice_scale(lat, lm_scale[0], acoustic_scale[0])
        entries.extend(lattice_to_ctm(scaled, None, key, frame_shift[0],
                                      decode_mbr=decode_mbr[0]))
    with kaldi_io.output_stream(po.get_arg(2)) as f:
        f.write(format_ctm(entries).encode())
    return 0


def lattice_to_nbest(argv: List[str]) -> int:
    po = ParseOptions(
        "Work out N-best paths in lattices and write out as FSTs\n"
        "Usage: lattice-to-nbest [options] <lattice-rspecifier> <nbest-wspecifier>")
    n_opt = po.register_value("n", 1, "Number of distinct paths")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for graph/lm costs")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter(LatticeHolder(), po.get_arg(2))
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        scaled = lattice_scale(lat, lm_scale[0], acoustic_scale[0])
        for i, (ali, words, cost) in enumerate(
                lattice_nbest(scaled, n_opt[0]), 1):
            linear = VectorFst(LatticeWeight)
            cur = linear.add_state()
            linear.set_start(cur)
            L = max(len(ali), len(words))
            for j in range(L):
                ns = linear.add_state()
                il = ali[j] if j < len(ali) else EPS
                ol = words[j] if j < len(words) else EPS
                w = (cost, 0.0) if j == 0 else (0.0, 0.0)
                linear.add_arc(cur, Arc(il, ol, w, ns))
                cur = ns
            linear.set_final(cur, (0.0, 0.0))
            writer.write(f"{key}-{i}", linear)
    writer.close()
    return 0


def nbest_to_linear(argv: List[str]) -> int:
    po = ParseOptions(
        "Takes as input lattices/n-bests which must be linear (single path);\n"
        "convert from lattice to up to 4 archives containing transcriptions, alignments,\n"
        "and acoustic and LM costs\n"
        "Usage: nbest-to-linear [options] <nbest-rspecifier> <alignments-wspecifier> "
        "[<transcriptions-wspecifier> [<lm-cost-wspecifier> [<ac-cost-wspecifier>]]]")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    ali_writer = TableWriter("int-vector", po.get_arg(2))
    words_writer = (TableWriter("int-vector", po.get_arg(3))
                    if po.num_args() >= 3 else None)
    lm_writer = (TableWriter("float", po.get_arg(4))
                 if po.num_args() >= 4 else None)
    ac_writer = (TableWriter("float", po.get_arg(5))
                 if po.num_args() >= 5 else None)
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        ali, words, cost = lattice_best_path(lat)
        ali_writer.write(key, ali)
        if words_writer:
            words_writer.write(key, words)
        # total lm/ac costs along best path
        if lm_writer or ac_writer:
            g = a = 0.0
            # recompute by walking arcs of the linear fst
            s = lat.start
            while s >= 0:
                if lat.finals[s] != LatticeWeight.zero:
                    g += lat.finals[s][0]
                    a += lat.finals[s][1]
                    break
                if not lat.arcs[s]:
                    break
                arc = lat.arcs[s][0]
                g += arc.weight[0]
                a += arc.weight[1]
                s = arc.nextstate
            if lm_writer:
                lm_writer.write(key, g)
            if ac_writer:
                ac_writer.write(key, a)
    ali_writer.close()
    for w in (words_writer, lm_writer, ac_writer):
        if w:
            w.close()
    return 0


def nbest_to_ctm(argv: List[str]) -> int:
    po = ParseOptions(
        "Takes linear lattices (single path; e.g. output of "
        "lattice-1best or nbest-to-linear) and converts to ctm format.\n"
        "Usage: nbest-to-ctm [options] <nbest-rspecifier> "
        "<ctm-wxfilename>")
    frame_shift = po.register_value("frame-shift", 0.01,
                                    "Time in seconds between frames")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    lines: List[str] = []
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        entries = []
        s = lat.start
        t = 0
        cur_word = None
        cur_start = 0
        while s is not None:
            if lat.finals[s] != LatticeWeight.zero or not lat.arcs[s]:
                break
            a = lat.arcs[s][0]
            if a.olabel != 0:
                if cur_word is not None:
                    entries.append((cur_word, cur_start, t - cur_start))
                cur_word, cur_start = a.olabel, t
            if a.ilabel != 0:
                t += 1
            s = a.nextstate
        if cur_word is not None:
            entries.append((cur_word, cur_start, max(t - cur_start, 1)))
        for w, st, dur in entries:
            lines.append(f"{key} 1 {st * frame_shift[0]:.2f} "
                         f"{dur * frame_shift[0]:.2f} {w}\n")
    with kaldi_io.output_stream(po.get_arg(2)) as f:
        f.write("".join(lines).encode())
    log(f"nbest-to-ctm: wrote {len(lines)} entries")
    return 0


def lattice_align_words(argv: List[str]) -> int:
    po = ParseOptions(
        "Word-align lattices so each CompactLattice arc carries one "
        "word's transition-ids (lattice-align-words.cc; linear "
        "lattices — run lattice-1best/lattice-to-nbest first).\n"
        "Usage: lattice-align-words [options] <word-boundary-file> "
        "<model> <lattice-rspecifier> <lattice-wspecifier>\n"
        "   or (legacy 3-arg form): lattice-align-words [options] "
        "<model> <lattice-rspecifier> <ctm-wxfilename>  — best-path "
        "CTM output")
    frame_shift = po.register_value("frame-shift", 0.01, "Frame shift in seconds")
    silence_label = po.register_value(
        "silence-label", 0, "Word id to give to silence segments")
    partial_word_label = po.register_value(
        "partial-word-label", 0,
        "Word id for partial/broken word segments")
    po.read(argv)
    if po.num_args() == 4:
        info = WordBoundaryInfo.from_file(
            po.get_arg(1), silence_label=silence_label[0],
            partial_word_label=partial_word_label[0])
        tm4 = _read_tm(po.get_arg(2))
        writer = TableWriter(CompactLatticeHolder(), po.get_arg(4))
        n = err = 0
        for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(3)):
            res = word_align_lattice(lat, tm4, info)
            if res is None:
                warn(f"word alignment failed for {key} (lattice not "
                     "linear)")
                err += 1
                continue
            clat, ok = res
            if not ok:
                warn(f"{key}: partial/forced word alignment")
            writer.write(key, clat)
            n += 1
        writer.close()
        log(f"word-aligned {n} lattices ({err} failed)")
        return 0 if n else 1
    if po.num_args() != 3:
        po.print_usage()
        return 1
    tm = _read_tm(po.get_arg(1))
    out = (sys.stdout if po.get_arg(3) == "-"
           else open(po.get_arg(3), "w"))
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(2)):
        entries = lattice_to_ctm(lat, tm, key, frame_shift=frame_shift[0])
        out.write(format_ctm(entries))
        n += 1
    if out is not sys.stdout:
        out.close()
    log(f"aligned {n} lattices")
    return 0 if n else 1


def lattice_align_words_lexicon(argv: List[str]) -> int:
    po = ParseOptions(
        "Word-align lattices using an integer align-lexicon: each "
        "line `word-in word-out phone1 ... phoneN`; entries with "
        "word-in 0 are optional (silence) and may be inserted freely "
        "(lattice-align-words-lexicon.cc; linear lattices).\n"
        "Usage: lattice-align-words-lexicon [options] <lexicon-file> "
        "<model> <lattice-rspecifier> <lattice-wspecifier>")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    lexicon = []
    with kaldi_io.input_stream(po.get_arg(1)) as f:
        for raw in f.read().decode().splitlines():
            parts = [int(x) for x in raw.split()]
            if len(parts) >= 2:
                lexicon.append((parts[0], parts[1], tuple(parts[2:])))
    tm = _read_tm(po.get_arg(2))
    writer = TableWriter(CompactLatticeHolder(), po.get_arg(4))
    n = err = 0
    for key, lat in SequentialTableReader(LatticeHolder(),
                                          po.get_arg(3)):
        clat = word_align_lattice_lexicon(lat, tm, lexicon)
        if clat is None:
            warn(f"lexicon word alignment failed for {key}")
            err += 1
            continue
        writer.write(key, clat)
        n += 1
    writer.close()
    log(f"word-aligned {n} lattices via lexicon ({err} failed)")
    return 0 if n else 1


def lattice_determinize_phone_pruned(argv: List[str]) -> int:
    po = ParseOptions(
        "Determinize lattices in two passes: first over phone+word "
        "symbols (phones spliced in at phone starts), then over "
        "words (lattice-determinize-phone-pruned.cc).\n"
        "Usage: lattice-determinize-phone-pruned [options] "
        "<model-in> <lattice-rspecifier> <lattice-wspecifier>")
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    beam = po.register_value("beam", 10.0,
                             "Pruning beam [applied after scaling]")
    max_states = po.register_value(
        "max-states", 50000, "Maximum states per determinized lattice")
    phone_det = po.register_value(
        "phone-determinize", True,
        "Run the first pass with phone symbols inserted")
    word_det = po.register_value(
        "word-determinize", True, "Run the second, word-level pass")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    if acoustic_scale[0] == 0.0:
        print("lattice-determinize-phone-pruned: --acoustic-scale "
              "must be nonzero", file=sys.stderr)
        return 1
    tm = _read_tm(po.get_arg(1))
    writer = TableWriter(LatticeHolder(), po.get_arg(3))
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(),
                                          po.get_arg(2)):
        scaled = lattice_scale(lat, 1.0, acoustic_scale[0])
        det = determinize_lattice_phone_pruned(
            scaled, tm, beam=beam[0], phone_determinize=phone_det[0],
            word_determinize=word_det[0], max_states=max_states[0])
        writer.write(key, lattice_scale(det, 1.0,
                                        1.0 / acoustic_scale[0]))
        n += 1
    writer.close()
    log(f"determinized {n} lattices (phone-pruned)")
    return 0 if n else 1
