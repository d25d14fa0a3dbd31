"""Lattice archive tools (port of the first tools of
`kaldi_tpu/cli/lat_tools.py`; the reference's latbin): lattice-copy,
lattice-scale, lattice-add-penalty, lattice-prune, lattice-determinize,
lattice-determinize-pruned, lattice-best-path, lattice-1best and
lattice-to-post, and lattice-boost-ali (`kaldi_tpu/cli/lat_tools2.py`
:440), over Lattice tables (OpenFst compactlattice44 binary, or the
reference's text).  lattice-boost-ali scores a silence phone as Kaldi's
LatticeBoost does (no error where it matches the alignment, --max-silence
where not), where the reference counts every silence arc as an error
(ROADMAP.md §3).

Not carried over yet: the module's other tools (lattice-to-nbest,
nbest-to-linear and the rest).
"""

from __future__ import annotations

import sys
from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.lat.functions import (add_word_ins_penalty,
                                           boost_lattice_phone_errors,
                                           determinize_lattice,
                                           determinize_lattice_pruned,
                                           lattice_best_path,
                                           lattice_best_path_lattice,
                                           lattice_forward_backward_post,
                                           lattice_prune, lattice_scale)
from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def _each(rspec, wspec, fn, name):
    writer = TableWriter(LatticeHolder(), wspec)
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(), rspec):
        out = fn(key, lat)
        if out is not None:
            writer.write(key, out)
            n += 1
    writer.close()
    log(f"{name}: processed {n} lattices")
    return 0 if n else 1


def _two_args(po: ParseOptions, argv: List[str]) -> bool:
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return False
    return True


def lattice_copy(argv: List[str]) -> int:
    po = ParseOptions("Copy lattices (e.g. useful for changing to text mode)\n"
                      "Usage: lattice-copy [options] <lattice-rspecifier> <lattice-wspecifier>")
    if not _two_args(po, argv):
        return 1
    return _each(po.get_arg(1), po.get_arg(2), lambda k, l: l, "lattice-copy")


def lattice_scale_cli(argv: List[str]) -> int:
    po = ParseOptions("Apply scaling to lattice weights\n"
                      "Usage: lattice-scale [options] <lattice-rspecifier> <lattice-wspecifier>")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for graph/lm costs")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    inv_acoustic_scale = po.register_value("inv-acoustic-scale", 1.0, "An alternative way of setting the acoustic scale: you can set its inverse")
    if not _two_args(po, argv):
        return 1
    ac = acoustic_scale[0]
    if inv_acoustic_scale[0] != 1.0:
        ac = 1.0 / inv_acoustic_scale[0]
    return _each(po.get_arg(1), po.get_arg(2),
                 lambda k, l: lattice_scale(l, lm_scale[0], ac),
                 "lattice-scale")


def lattice_add_penalty(argv: List[str]) -> int:
    po = ParseOptions("Add word insertion penalty to the lattice.\n"
                      "Usage: lattice-add-penalty [options] <lattice-rspecifier> <lattice-wspecifier>")
    word_ins_penalty = po.register_value("word-ins-penalty", 0.0, "Word insertion penalty")
    if not _two_args(po, argv):
        return 1
    return _each(po.get_arg(1), po.get_arg(2),
                 lambda k, l: add_word_ins_penalty(l, word_ins_penalty[0]),
                 "lattice-add-penalty")


def _nonzero_scale(tool: str, acoustic_scale: float) -> bool:
    if acoustic_scale == 0.0:
        print(f"{tool}: --acoustic-scale must be nonzero (the inverse "
              "rescale is undefined)", file=sys.stderr)
        return False
    return True


def lattice_prune_cli(argv: List[str]) -> int:
    po = ParseOptions("Prune lattices, keeping only best paths within beam\n"
                      "Usage: lattice-prune [options] <lattice-rspecifier> <lattice-wspecifier>")
    beam = po.register_value("beam", 4.0, "Pruning beam [applied after acoustic scaling]")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    if not _two_args(po, argv) or \
            not _nonzero_scale("lattice-prune", acoustic_scale[0]):
        return 1

    def fn(k, lat):
        pruned = lattice_prune(lattice_scale(lat, 1.0, acoustic_scale[0]),
                               beam[0])
        return lattice_scale(pruned, 1.0, 1.0 / acoustic_scale[0])
    return _each(po.get_arg(1), po.get_arg(2), fn, "lattice-prune")


def lattice_determinize_cli(argv: List[str]) -> int:
    po = ParseOptions("Determinize lattices, keeping only the best path (sequence of acoustic states) for each input-symbol sequence.\n"
                      "Usage: lattice-determinize [options] <lattice-rspecifier> <lattice-wspecifier>")
    po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    if not _two_args(po, argv):
        return 1
    return _each(po.get_arg(1), po.get_arg(2),
                 lambda k, l: determinize_lattice(l), "lattice-determinize")


def lattice_determinize_pruned_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Determinize lattices, keeping only the best path for each word "
        "sequence, with interleaved beam pruning (bounded memory; "
        "parity: latbin/lattice-determinize-pruned.cc).\n"
        "Usage: lattice-determinize-pruned [options] "
        "<lattice-rspecifier> <lattice-wspecifier>")
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    beam = po.register_value("beam", 10.0,
                             "Pruning beam [applied after scaling]")
    max_states = po.register_value(
        "max-states", 50000,
        "Maximum states per determinized lattice (backoff shrinks the "
        "beam when exceeded, like --max-mem in the reference)")
    if not _two_args(po, argv) or \
            not _nonzero_scale("lattice-determinize-pruned",
                               acoustic_scale[0]):
        return 1

    def fn(k, lat):
        det = determinize_lattice_pruned(
            lattice_scale(lat, 1.0, acoustic_scale[0]), beam=beam[0],
            max_states=max_states[0])
        return lattice_scale(det, 1.0, 1.0 / acoustic_scale[0])
    return _each(po.get_arg(1), po.get_arg(2), fn,
                 "lattice-determinize-pruned")


def lattice_best_path_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate 1-best path through lattices; output as transcriptions and alignments\n"
        "Usage: lattice-best-path [options] <lattice-rspecifier> "
        "[<transcriptions-wspecifier> [<alignments-wspecifier>]]")
    lm_scale = po.register_value("lm-scale", 1.0, "Scaling factor for graph/lm costs")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    po.register_value("word-symbol-table", "", "Symbol table for words [for debug output]")
    po.read(argv)
    if po.num_args() < 1:
        po.print_usage()
        return 1
    words_writer = (TableWriter("int-vector", po.get_arg(2))
                    if po.num_args() >= 2 else None)
    ali_writer = (TableWriter("int-vector", po.get_arg(3))
                  if po.num_args() >= 3 else None)
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        ali, words, _cost = lattice_best_path(
            lattice_scale(lat, lm_scale[0], acoustic_scale[0]))
        if words_writer:
            words_writer.write(key, words)
        if ali_writer:
            ali_writer.write(key, ali)
        n += 1
    for w in (words_writer, ali_writer):
        if w:
            w.close()
    log(f"found best paths for {n} lattices")
    return 0 if n else 1


def lattice_1best(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute best path through lattices and write out AS lattices "
        "(one path per lattice; lattice-1best.cc — note this differs "
        "from lattice-best-path, which writes transcriptions).\n"
        "Usage: lattice-1best [options] <lattice-rspecifier> "
        "<lattice-wspecifier>")
    lm_scale = po.register_value("lm-scale", 1.0,
                                 "Scaling factor for graph/lm costs")
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    if not _two_args(po, argv):
        return 1
    writer = TableWriter(LatticeHolder(), po.get_arg(2))
    n = err = 0
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        best = lattice_best_path_lattice(
            lattice_scale(lat, lm_scale[0], acoustic_scale[0]))
        if best is None:
            warn(f"no best path for {key}")
            err += 1
            continue
        writer.write(key, lattice_scale(
            best, 1.0 / lm_scale[0] if lm_scale[0] else 1.0,
            1.0 / acoustic_scale[0] if acoustic_scale[0] else 1.0))
        n += 1
    writer.close()
    log(f"found best paths for {n} lattices ({err} failed)")
    return 0 if n else 1


def lattice_to_post(argv: List[str]) -> int:
    po = ParseOptions(
        "Do forward-backward and collect posteriors over lattices.\n"
        "Usage: lattice-to-post [options] lats-rspecifier posts-wspecifier")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("posterior", po.get_arg(2))
    n = 0
    for key, lat in SequentialTableReader(LatticeHolder(), po.get_arg(1)):
        writer.write(key, lattice_forward_backward_post(lat,
                                                        acoustic_scale[0]))
        n += 1
    writer.close()
    log(f"posteriors for {n} lattices")
    return 0


def lattice_boost_ali(argv: List[str]) -> int:
    po = ParseOptions(
        "Boost graph likelihoods (decrease graph costs) by b * "
        "frame-phone-accuracy relative to the alignment (for boosted "
        "MMI training).\n"
        "Usage: lattice-boost-ali [options] <model> "
        "<lattice-rspecifier> <ali-rspecifier> <lattice-wspecifier>")
    b = po.register_value("b", 0.05, "Boosting factor")
    max_silence = po.register_value(
        "max-silence", 0.0, "Maximum error assigned to silence phones "
        "[c.f. --silence-phones option]. 0.0 or 1.0 are the only "
        "sensible values")
    silence_phones = po.register_value(
        "silence-phones", "", "Colon-separated list of integer ids of "
        "silence phones. The error on silence phones is computed more "
        "leniently")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    if not 0.0 <= max_silence[0] <= 1.0:
        warn(f"lattice-boost-ali: --max-silence={max_silence[0]} is not "
             "in [0, 1]")
        return 1
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    from kaldi_tpu_torch.util.table import RandomAccessTableReader
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(1))
    ali_reader = RandomAccessTableReader("int-vector", po.get_arg(3))
    sil = frozenset(int(p) for p in silence_phones[0].split(":") if p)

    def fn(key, lat):
        if key not in ali_reader:
            warn(f"lattice-boost-ali: no alignment for {key}")
            return None
        ref = [tm.transition_id_to_phone(t) for t in ali_reader[key]]
        return boost_lattice_phone_errors(lat, tm, ref, b[0], sil,
                                          max_silence[0])

    return _each(po.get_arg(2), po.get_arg(4), fn, "lattice-boost-ali")
