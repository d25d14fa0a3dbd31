"""Decoder-variant tools (port of `kaldi_tpu/cli/decoders2_tools.py`;
parity: src/gmmbin gmm-decode-simple.cc, gmm-latgen-simple.cc,
gmm-decode-biglm-faster.cc, gmm-latgen-biglm-faster.cc, gmm-latgen-map.cc;
src/bin latgen-incremental-mapped.cc).  Same positional arguments,
options and table specifiers as the reference's.

The GMM log-likelihoods run on the card (`cli/gmm_tools.py`
`read_am_gmm`, `AmDiagGmm.log_likes_batch`) unless --use-gpu=no; the
searches run on the host: the exact search (`best_path_through`),
`LatticeFasterDecoder` and `FasterDecoder`, which read the biglm tools'
lazy product (`decoder/biglm.py` `LazyBiglmFst`) only at the states
they reach, and `decoder/incremental.py` `LatticeIncrementalDecoder`.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.nnet3_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def gmm_decode_simple(argv: List[str]) -> int:
    po = ParseOptions(
        "Exact (beamless) Viterbi decode with a GMM model; any "
        "lattice produced is the linear best path "
        "(gmm-decode-simple.cc SimpleDecoder).\n"
        "Usage: gmm-decode-simple [options] <model-in> <fst-in> "
        "<features-rspecifier> <words-wspecifier> "
        "[<alignments-wspecifier>] [<lattice-wspecifier>]")
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 6:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.decoder.viterbi import best_path_through
    from kaldi_tpu_torch.fstext.fst import Arc, LatticeWeight, VectorFst
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))
    hclg = read_fst_file(po.get_arg(2))
    word_writer = TableWriter("int-vector", po.get_arg(4))
    ali_writer = (TableWriter("int-vector", po.get_arg(5))
                  if po.num_args() >= 5 and po.get_arg(5) else None)
    lat_writer = (TableWriter(LatticeHolder(), po.get_arg(6))
                  if po.num_args() >= 6 else None)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
        ll = am.log_likes_batch(feats)
        res = best_path_through(hclg, np.asarray(ll), tm.id2pdf_id,
                                acoustic_scale[0])
        if res is None:
            warn(f"decode failed for {key}")
            err += 1
            continue
        ali, words, cost = res
        word_writer.write(key, words)
        if ali_writer:
            ali_writer.write(key, ali)
        if lat_writer:
            # linear lattice: tids on arcs, words greedily attached
            lat = VectorFst(LatticeWeight)
            cur = lat.add_state()
            lat.set_start(cur)
            wq = list(words)
            for i, tid in enumerate(ali):
                ns = lat.add_state()
                lat.add_arc(cur, Arc(tid, wq.pop(0) if wq else 0,
                                     (0.0, 0.0), ns))
                cur = ns
            lat.finals[cur] = (cost, 0.0)
            lat_writer.write(key, lat)
        n += 1
    for w in (word_writer, ali_writer, lat_writer):
        if w is not None:
            w.close()
    log(f"decoded {n} utterances ({err} failed)")
    return 0 if n else 1


def gmm_latgen_simple(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices with a GMM model using simple (wide-beam) "
        "decoding (gmm-latgen-simple.cc).\n"
        "Usage: gmm-latgen-simple [options] <model-in> <fst-in> "
        "<features-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier> [<alignments-wspecifier>]]")
    from kaldi_tpu_torch.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    dopts = LatticeFasterDecoderOptions()
    dopts.beam = 1e5
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 6:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.functions import (determinize_lattice,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))
    hclg = read_fst_file(po.get_arg(2))
    lat_writer = TableWriter(LatticeHolder(), po.get_arg(4))
    word_writer = (TableWriter("int-vector", po.get_arg(5))
                   if po.num_args() >= 5 and po.get_arg(5) else None)
    ali_writer = (TableWriter("int-vector", po.get_arg(6))
                  if po.num_args() >= 6 else None)
    dec = LatticeFasterDecoder(hclg, dopts)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
        ll = am.log_likes_batch(feats)
        lat = dec.decode(np.asarray(ll), tm.id2pdf_id,
                         acoustic_scale[0])
        if lat is None:
            warn(f"decode failed for {key}")
            err += 1
            continue
        out_lat = determinize_lattice(lat) \
            if dopts.determinize_lattice else lat
        lat_writer.write(key, out_lat)
        if word_writer or ali_writer:
            ali, words, _ = lattice_best_path(lat)
            if word_writer:
                word_writer.write(key, words)
            if ali_writer:
                ali_writer.write(key, ali)
        n += 1
    for w in (lat_writer, word_writer, ali_writer):
        if w is not None:
            w.close()
    log(f"decoded {n} utterances ({err} failed)")
    return 0 if n else 1


def _biglm(argv: List[str], latgen: bool) -> int:
    name = "gmm-latgen-biglm-faster" if latgen \
        else "gmm-decode-biglm-faster"
    out_desc = ("<lattice-wspecifier> [<words-wspecifier>]" if latgen
                else "<words-wspecifier> [<alignments-wspecifier>]")
    po = ParseOptions(
        f"Decode with on-the-fly big-LM composition: word emissions "
        "pay (new-LM cost - old-LM cost), with the old LM's scores "
        f"already inside HCLG ({name}.cc; lazy product over active "
        "states only).\n"
        f"Usage: {name} [options] <model-in> <fst-in> "
        f"<old-lm-fst-in> <new-lm-fst-in> <features-rspecifier> "
        f"{out_desc}")
    if latgen:
        from kaldi_tpu_torch.decoder.lattice_decoder import \
            LatticeFasterDecoderOptions
        dopts = LatticeFasterDecoderOptions()
    else:
        from kaldi_tpu_torch.decoder.viterbi import FasterDecoderOptions
        dopts = FasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 6 or po.num_args() > 7:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.decoder.biglm import BackoffWordFst, LazyBiglmFst
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))
    hclg = read_fst_file(po.get_arg(2))
    old_g = BackoffWordFst(read_fst_file(po.get_arg(3)))
    new_g = BackoffWordFst(read_fst_file(po.get_arg(4)))
    lazy = LazyBiglmFst(hclg, old_g, new_g)
    n = err = 0
    if latgen:
        from kaldi_tpu_torch.decoder.lattice_decoder import \
            LatticeFasterDecoder
        from kaldi_tpu_torch.lat.functions import (determinize_lattice,
                                                   lattice_best_path)
        from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
        lat_writer = TableWriter(LatticeHolder(), po.get_arg(6))
        word_writer = (TableWriter("int-vector", po.get_arg(7))
                       if po.num_args() >= 7 else None)
        dec = LatticeFasterDecoder(lazy, dopts)
        for key, feats in SequentialTableReader("matrix",
                                                po.get_arg(5)):
            ll = am.log_likes_batch(feats)
            lat = dec.decode(np.asarray(ll), tm.id2pdf_id,
                             acoustic_scale[0])
            if lat is None:
                warn(f"decode failed for {key}")
                err += 1
                continue
            lat_writer.write(key, determinize_lattice(lat)
                             if dopts.determinize_lattice else lat)
            if word_writer:
                _a, words, _c = lattice_best_path(lat)
                word_writer.write(key, words)
            n += 1
        lat_writer.close()
        if word_writer:
            word_writer.close()
    else:
        from kaldi_tpu_torch.decoder.viterbi import FasterDecoder
        word_writer = TableWriter("int-vector", po.get_arg(6))
        ali_writer = (TableWriter("int-vector", po.get_arg(7))
                      if po.num_args() >= 7 else None)
        dec = FasterDecoder(lazy, dopts)
        for key, feats in SequentialTableReader("matrix",
                                                po.get_arg(5)):
            ll = am.log_likes_batch(feats)
            res = dec.decode(np.asarray(ll), tm.id2pdf_id,
                             acoustic_scale[0])
            if res is None:
                warn(f"decode failed for {key}")
                err += 1
                continue
            ali, words, _c = res
            word_writer.write(key, words)
            if ali_writer:
                ali_writer.write(key, ali)
            n += 1
        word_writer.close()
        if ali_writer:
            ali_writer.close()
    log(f"{name}: decoded {n} utterances ({err} failed)")
    return 0 if n else 1


def gmm_decode_biglm_faster(argv: List[str]) -> int:
    return _biglm(argv, latgen=False)


def gmm_latgen_biglm_faster(argv: List[str]) -> int:
    return _biglm(argv, latgen=True)


def gmm_latgen_map(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices with per-speaker MAP-adapted GMMs read "
        "from a table (gmm-latgen-map.cc; <model-in> supplies the "
        "transition model).\n"
        "Usage: gmm-latgen-map [options] <model-in> "
        "<gmms-rspecifier> <fst-in> <features-rspecifier> "
        "<lattice-wspecifier> [<words-wspecifier>]")
    from kaldi_tpu_torch.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    utt2spk_rs = po.register_value(
        "utt2spk", "", "rspecifier mapping utterances to the table's "
        "model keys")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 5 or po.num_args() > 6:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
    from kaldi_tpu_torch.lat.functions import (determinize_lattice,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from types import SimpleNamespace

    from kaldi_tpu_torch.util.table import ObjectHolder
    tm, _am0 = read_am_gmm(po.get_arg(1), device="cpu")
    device = _device(use_gpu[0])
    gmm_reader = RandomAccessTableReader(ObjectHolder(SimpleNamespace(
        read=lambda f, binary: AmDiagGmm.read(f, binary, device=device))),
        po.get_arg(2))
    hclg = read_fst_file(po.get_arg(3))
    utt2spk = (RandomAccessTableReader("token-vector", utt2spk_rs[0])
               if utt2spk_rs[0] else None)
    lat_writer = TableWriter(LatticeHolder(), po.get_arg(5))
    word_writer = (TableWriter("int-vector", po.get_arg(6))
                   if po.num_args() >= 6 else None)
    dec = LatticeFasterDecoder(hclg, dopts)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(4)):
        mk = key
        if utt2spk is not None:
            if key not in utt2spk:
                warn(f"no speaker for {key}")
                err += 1
                continue
            mk = utt2spk[key][0]
        if mk not in gmm_reader:
            warn(f"no adapted model for {mk}")
            err += 1
            continue
        am = gmm_reader[mk]
        ll = am.log_likes_batch(feats)
        lat = dec.decode(np.asarray(ll), tm.id2pdf_id,
                         acoustic_scale[0])
        if lat is None:
            warn(f"decode failed for {key}")
            err += 1
            continue
        lat_writer.write(key, determinize_lattice(lat)
                         if dopts.determinize_lattice else lat)
        if word_writer:
            _a, words, _c = lattice_best_path(lat)
            word_writer.write(key, words)
        n += 1
    lat_writer.close()
    if word_writer:
        word_writer.close()
    log(f"decoded {n} utterances with adapted models ({err} failed)")
    return 0 if n else 1


def latgen_incremental_mapped(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices from pdf-indexed loglike matrices with the "
        "chunk-wise incremental-determinization decoder "
        "(latgen-incremental-mapped.cc).\n"
        "Usage: latgen-incremental-mapped [options] <trans-model-in> "
        "<fst-in> <loglikes-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier>]")
    from kaldi_tpu_torch.decoder.lattice_decoder import \
        LatticeFasterDecoderOptions
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    chunk = po.register_value(
        "determinize-period", 50,
        "Frames between incremental determinizations")
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 5:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.gmm_tools import _read_tm
    from kaldi_tpu_torch.decoder.incremental import LatticeIncrementalDecoder
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    tm = _read_tm(po.get_arg(1))
    hclg = read_fst_file(po.get_arg(2))
    lat_writer = TableWriter(LatticeHolder(), po.get_arg(4))
    word_writer = (TableWriter("int-vector", po.get_arg(5))
                   if po.num_args() >= 5 else None)
    dec = LatticeIncrementalDecoder(hclg, dopts,
                                    chunk_frames=chunk[0])
    n = err = max_links = 0
    for key, ll in SequentialTableReader("matrix", po.get_arg(3)):
        lat = dec.decode(np.asarray(ll), tm.id2pdf_id,
                         acoustic_scale[0])
        if lat is None:
            warn(f"decode failed for {key}")
            err += 1
            continue
        max_links = max(max_links, dec.stats["max_chunk_links"])
        lat_writer.write(key, lat)
        if word_writer:
            _a, words, _c = lattice_best_path(lat)
            word_writer.write(key, words)
        n += 1
    lat_writer.close()
    if word_writer:
        word_writer.close()
    log(f"decoded {n} utterances incrementally ({err} failed; "
        f"max_chunk_links {max_links})")
    return 0 if n else 1
