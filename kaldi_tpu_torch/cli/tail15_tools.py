"""Grammar-FST tools and the incremental online decoder (port of the
part of `kaldi_tpu/cli/tail15_tools.py` that is not a `*-cuda` tool;
parity: src/fstbin/make-grammar-fst.cc, src/nnet3bin/
nnet3-latgen-grammar.cc, src/online2bin/online2-wav-nnet3-latgen-grammar.cc
and online2-wav-nnet3-latgen-incremental.cc).

The grammar container (`<KtGrammarFst>`: the nonterminal phones
offset, the sub-FSTs with their nonterminals, then the top-level FST,
each as OpenFst bytes) is the reference's, byte for byte, so a grammar
file of either package reads in the other.  The grammar decoders expand
the grammar statically (`expand_grammar`, a walk over GrammarFst's lazy
splice) and decode the expansion, as the reference does; the networks
run on the card unless --use-gpu=no, the searches on the host.

Not carried over yet: the `*-cuda` tools of the reference module.
"""

from __future__ import annotations

import os
import tempfile
from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

GRAMMAR_MAGIC = "<KtGrammarFst>"


def _write_grammar(wxfilename: str, offset: int, top, ifsts) -> None:
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    with kaldi_io.output_stream(wxfilename) as f:
        iof.init_output_stream(f, True)
        iof.write_token(f, True, GRAMMAR_MAGIC)
        iof.write_int32(f, True, offset)
        iof.write_int32(f, True, len(ifsts))
        for nt, fst in ifsts:
            iof.write_int32(f, True, nt)
            write_fst(f, fst)
        write_fst(f, top)


def read_grammar_any(rxfilename: str):
    """-> a GrammarFst from the grammar container, or the VectorFst of
    a plain FST file."""
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.fstext.grammar_fst import GrammarFst
    from kaldi_tpu_torch.fstext.openfst_io import read_fst, read_fst_file
    with kaldi_io.input_stream(rxfilename) as f:
        head = iof.peek_bytes(f, 2 + len(GRAMMAR_MAGIC))
        if GRAMMAR_MAGIC.encode() in head:
            iof.init_input_stream(f)
            iof.expect_token(f, True, GRAMMAR_MAGIC)
            offset = iof.read_int32(f, True)
            n = iof.read_int32(f, True)
            ifsts = []
            for _ in range(n):
                nt = iof.read_int32(f, True)
                ifsts.append((nt, read_fst(f)))
            top = read_fst(f)
            return GrammarFst(offset, top, ifsts)
    return read_fst_file(rxfilename)


def expand_grammar(g):
    """GrammarFst -> the statically expanded VectorFst, by a walk over
    the grammar's own lazy splice (its arcs/finals views): exact by
    construction, eager where the reference's decoders splice at decode
    time (grammar-fst.h:101).  Any other FST is returned as it is."""
    from kaldi_tpu_torch.fstext.fst import Arc, TropicalWeight, VectorFst
    from kaldi_tpu_torch.fstext.grammar_fst import GrammarFst
    if not isinstance(g, GrammarFst):
        return g
    out = VectorFst(TropicalWeight)
    ids = {g.start: out.add_state()}
    out.set_start(ids[g.start])
    stack = [g.start]
    while stack:
        s = stack.pop()
        fin = g.finals[s]
        if fin is not None and fin != TropicalWeight.zero:
            out.set_final(ids[s], fin)
        for a in g.arcs[s]:
            if a.nextstate not in ids:
                ids[a.nextstate] = out.add_state()
                stack.append(a.nextstate)
            out.add_arc(ids[s], Arc(a.ilabel, a.olabel, a.weight,
                                    ids[a.nextstate]))
    return out


def _write_fst_file(wxfilename: str, fst) -> None:
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    with kaldi_io.output_stream(wxfilename) as f:
        write_fst(f, fst)


def make_grammar_fst(argv: List[str]) -> int:
    po = ParseOptions(
        "Make a grammar FST for decoding with dynamically spliced "
        "sub-graphs (fstbin/make-grammar-fst.cc).\n"
        "Usage (1): make-grammar-fst [options] <top-level-fst> "
        "<symbol1> <fst1> [<symbol2> <fst2> ...] <fst-out>\n"
        "Usage (2): make-grammar-fst <fst-in> <fst-out>  "
        "(prepare a single FST for grammar use)")
    offset = po.register_value(
        "nonterm-phones-offset", -1,
        "Integer id of the symbol #nonterm_bos in phones.txt")
    write_as_grammar = po.register_value(
        "write-as-grammar", True,
        "If true, write as a grammar container (lazy splicing at "
        "decode time); if false, expand statically and write a "
        "normal FST")
    po.read(argv)
    from kaldi_tpu_torch.fstext.grammar_fst import (GrammarFst,
                                                    prepare_for_grammar_fst)
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    if po.num_args() == 2:
        fst = read_fst_file(po.get_arg(1))
        prepare_for_grammar_fst(fst, offset[0])
        _write_fst_file(po.get_arg(2), fst)
        log("prepared 1 FST for grammar decoding")
        return 0
    if po.num_args() < 4 or po.num_args() % 2 != 0:
        po.print_usage()
        return 1
    top = read_fst_file(po.get_arg(1))
    ifsts = []
    for i in range(2, po.num_args() - 1, 2):
        nt = int(po.get_arg(i))
        ifsts.append((nt, read_fst_file(po.get_arg(i + 1))))
    if write_as_grammar[0]:
        _write_grammar(po.get_arg(po.num_args()), offset[0], top, ifsts)
    else:
        _write_fst_file(po.get_arg(po.num_args()),
                        expand_grammar(GrammarFst(offset[0], top, ifsts)))
    log(f"made grammar FST with {len(ifsts)} sub-FSTs")
    return 0


def nnet3_latgen_grammar(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices using neural net model, decoding a grammar FST "
        "(nnet3bin/nnet3-latgen-grammar.cc; the grammar is expanded "
        "statically, the same search space as the reference's "
        "decode-time splicing).\n"
        "Usage: nnet3-latgen-grammar [options] <trans-model> <nnet-dir> "
        "<grammar-fst> <features-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier>]")
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import (_decode_loop,
                                                         _load_tm_and_model,
                                                         parse_args,
                                                         register_latgen)
    dopts, acoustic_scale, use_gpu = register_latgen(po)
    if not parse_args(po, argv):
        return 1
    tm, forward = _load_tm_and_model(po.get_arg(1), po.get_arg(2),
                                     use_gpu[0])
    fst = expand_grammar(read_grammar_any(po.get_arg(3)))

    def items():
        for key, feats in SequentialTableReader("matrix", po.get_arg(4)):
            yield key, forward(feats[None])[0].cpu().numpy(), len(feats)

    return _decode_loop(items(), fst, tm, forward, acoustic_scale[0], dopts,
                        po.get_arg(5),
                        po.get_arg(6) if po.num_args() >= 6 else None,
                        "nnet3-latgen-grammar")


def online2_wav_nnet3_latgen_grammar(argv: List[str]) -> int:
    """online2bin/online2-wav-nnet3-latgen-grammar.cc: the online decoder
    over a grammar graph, expanded statically (see nnet3-latgen-grammar)
    into a file of a temporary directory that
    online2-wav-nnet3-latgen-faster reads."""
    from kaldi_tpu_torch.cli.online_tools import \
        online2_wav_nnet3_latgen_faster
    pos = [a for a in argv[1:] if not a.startswith("--")]
    if len(pos) < 4:
        warn("Usage: online2-wav-nnet3-latgen-grammar [options] "
             "<nnet3-in> <grammar-fst> <wav-rspecifier> "
             "<word-wspecifier>")
        return 1
    fst = expand_grammar(read_grammar_any(pos[1]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "expanded.fst")
        _write_fst_file(path, fst)
        argv2 = ["online2-wav-nnet3-latgen-faster"] + \
            [path if a == pos[1] else a for a in argv[1:]]
        return online2_wav_nnet3_latgen_faster(argv2)


def online2_wav_nnet3_latgen_incremental(argv: List[str]) -> int:
    po = ParseOptions(
        "Online decoding with INCREMENTAL lattice determinization "
        "(online2-wav-nnet3-latgen-incremental.cc; the lattice is "
        "determinized in chunks as decoding proceeds).\n"
        "Usage: online2-wav-nnet3-latgen-incremental [options] "
        "<nnet3-in> <fst-in> <wav-rspecifier> <lattice-wspecifier>")
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
    from kaldi_tpu_torch.feat.frontend import MfccOptions
    mfcc_opts = MfccOptions()
    po.register_struct(mfcc_opts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic "
        "likelihoods")
    beam = po.register_value("beam", 15.0, "Decoding beam")
    sub = po.register_value("frame-subsampling-factor", 3,
                            "Frame subsampling factor of the model")
    determinize_period = po.register_value(
        "determinize-period", 20,
        "Output frames between incremental determinizations")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    import torch

    from kaldi_tpu_torch.decoder.incremental import \
        LatticeIncrementalDecoder
    from kaldi_tpu_torch.decoder.lattice_decoder import \
        LatticeFasterDecoderOptions
    from kaldi_tpu_torch.feat.frontend import OfflineFeature
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    tm, graph, _ = read_nnet3_any(po.get_arg(1))
    if tm is None:
        warn("raw model given (no transition model)")
        return 1
    device = _device(use_gpu[0])
    net = compile_graph(graph, "output", device=device)
    fe = OfflineFeature(mfcc_opts, device=device)
    dec = LatticeIncrementalDecoder(
        read_fst_file(po.get_arg(2)),
        LatticeFasterDecoderOptions(beam=beam[0]),
        chunk_frames=determinize_period[0])
    writer = TableWriter(LatticeHolder(), po.get_arg(4))
    n = max_links = 0
    for key, wave_data in SequentialTableReader("wave", po.get_arg(3)):
        feats, nframes = fe.compute_batch_device([wave_data.channel(0)])
        with torch.inference_mode():
            out = net(feats[:, :int(nframes[0])])[0].cpu().numpy()
        ll = out[::sub[0]] if sub[0] > 1 else out
        res = dec.decode(ll, tm.id2pdf_id, acoustic_scale=acoustic_scale[0])
        if res is None:
            warn(f"decode failed for {key}")
            continue
        max_links = max(max_links, dec.stats["max_chunk_links"])
        writer.write(key, res)
        n += 1
    writer.close()
    log(f"decoded {n} utterances (incremental determinization; "
        f"max_chunk_links {max_links})")
    return 0 if n else 1
