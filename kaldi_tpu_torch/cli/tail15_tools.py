"""Grammar-FST tools, the incremental online decoder and the cudafeat
and cudadecoder tools (port of `kaldi_tpu/cli/tail15_tools.py`; parity:
src/fstbin/make-grammar-fst.cc, src/nnet3bin/nnet3-latgen-grammar.cc,
src/online2bin/online2-wav-nnet3-latgen-grammar.cc and
online2-wav-nnet3-latgen-incremental.cc, src/cudafeatbin/*.cc and
src/cudadecoderbin/batched-wav-nnet3-cuda{,2,-online}.cc).

The grammar container (`<KtGrammarFst>`: the nonterminal phones
offset, the sub-FSTs with their nonterminals, then the top-level FST,
each as OpenFst bytes) is the reference's, byte for byte, so a grammar
file of either package reads in the other.  The grammar decoders expand
the grammar statically (`expand_grammar`, a walk over GrammarFst's lazy
splice) and decode the expansion, as the reference does; the networks
run on the card unless --use-gpu=no, the searches on the host.

The `*-cuda` feature tools are the plain computers' runner
(`cli/feat_tools.py` `_run_feature_tool`, a batch of utterances at a
time on the card unless --use-gpu=no) with a batch of 64; the online
CMVN tools are apply-cmvn-online (the host `OnlineCmvn`); the online
feature tools carry `BatchedIvectorExtractor`'s state over
--ivector-period frames at a time.  batched-wav-nnet3-cuda2 (and its
alias -cuda) computes a batch's features and the compiled acoustic model
(`nnet3/torch_bridge.py`) on the card, decodes each utterance with the
host `LatticeFasterDecoder` over the HCLG and prints the reference's
`RealTimeX` line, then a `batched-wav-nnet3-cuda2 stats {...}` JSON line
(the feature, forward and search seconds).  The model's output is at the
input frame rate and the decoder takes every --frame-subsampling-factor'th
frame; the reference's tool takes the first 1/factor of the frames
instead, a fault that tools/features_jax_bar.py shows on JAX.  A model
that does not compile raises: the reference's host fallback is not
carried over.  batched-wav-nnet3-cuda-online runs
online2-wav-nnet3-latgen-faster, as the reference's does.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import List

import numpy as np

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


# -- cudafeat: the batched device frontend ---------------------------------

def _cuda_feats(argv: List[str], name: str, fbank: bool) -> int:
    from kaldi_tpu_torch.cli.feat_tools import _run_feature_tool
    from kaldi_tpu_torch.feat.frontend import FbankOptions, MfccOptions
    return _run_feature_tool(name, FbankOptions if fbank else MfccOptions,
                             argv, default_batch_size=64)


def compute_mfcc_feats_cuda(argv: List[str]) -> int:
    return _cuda_feats(argv, "compute-mfcc-feats-cuda", False)


def compute_fbank_feats_cuda(argv: List[str]) -> int:
    return _cuda_feats(argv, "compute-fbank-feats-cuda", True)


def compute_mfcc_online_batched_cuda(argv: List[str]) -> int:
    return _cuda_feats(argv, "compute-mfcc-online-batched-cuda", False)


def compute_fbank_online_batched_cuda(argv: List[str]) -> int:
    return _cuda_feats(argv, "compute-fbank-online-batched-cuda", True)


def apply_cmvn_online_cuda(argv: List[str]) -> int:
    """cudafeatbin/apply-{,batched-}cmvn-online-cuda.cc: the host online
    CMVN of apply-cmvn-online, a stream per utterance."""
    from kaldi_tpu_torch.cli.tail14_tools import apply_cmvn_online
    return apply_cmvn_online(["apply-cmvn-online"] + argv[1:])


apply_batched_cmvn_online_cuda = apply_cmvn_online_cuda


def _online_feats_pipeline(argv: List[str], name: str) -> int:
    import torch

    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
    from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor
    po = ParseOptions(
        "Compute features and online i-vectors, the whole online front "
        f"end (cudafeatbin/{name}.cc).\n"
        f"Usage: {name} [options] <ivector-extractor (.npz)> "
        "<wav-rspecifier> <feats-wspecifier> <ivectors-wspecifier>")
    opts = MfccOptions()
    po.register_struct(opts)
    ivector_period = po.register_value(
        "ivector-period", 10, "Frames between i-vector estimates")
    batch_size = po.register_value("batch-size", 64,
                                   "Utterances per device batch")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    device = _device(use_gpu[0])
    bex = BatchedIvectorExtractor(load_ivector_extractor(po.get_arg(1)),
                                  device=device)
    fe = OfflineFeature(opts, device=device)
    fwriter = TableWriter("matrix", po.get_arg(3))
    iwriter = TableWriter("matrix", po.get_arg(4))
    buf = []
    n = 0

    def flush():
        nonlocal n
        if not buf:
            return
        feats = fe.compute_batch([w for _k, w in buf])
        lens = np.array([f.shape[0] for f in feats])
        t_max = int(lens.max())
        batch = np.zeros((len(buf), t_max, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            batch[i, :f.shape[0]] = f
        # an i-vector a period from the carried device state
        state = bex.init_state(len(buf))
        period = max(ivector_period[0], 1)
        ivs = [[] for _ in buf]
        for c0 in range(0, t_max, period):
            chunk = torch.from_numpy(batch[:, c0:c0 + period]).to(
                bex.device)
            mask = torch.from_numpy(
                np.arange(c0, min(c0 + period, t_max))[None, :]
                < lens[:, None]).to(bex.device)
            state = bex.acc_chunk(state, chunk, mask)
            iv = bex.ivector(state).cpu().numpy()
            for i in range(len(buf)):
                if c0 < lens[i]:
                    ivs[i].append(iv[i])
        for i, (k, _w) in enumerate(buf):
            fwriter.write(k, feats[i])
            iwriter.write(k, np.stack(ivs[i]))
            n += 1
        buf.clear()

    for key, wave in SequentialTableReader("wave", po.get_arg(2)):
        buf.append((key, wave.channel(0)))
        if len(buf) >= batch_size[0]:
            flush()
    flush()
    fwriter.close()
    iwriter.close()
    log(f"computed features + online i-vectors for {n} utterances")
    return 0 if n else 1


def compute_online_feats_cuda(argv: List[str]) -> int:
    return _online_feats_pipeline(argv, "compute-online-feats-cuda")


def compute_online_feats_batched_cuda(argv: List[str]) -> int:
    return _online_feats_pipeline(argv, "compute-online-feats-batched-cuda")


# -- cudadecoder: the batched offline decode ------------------------------

def batched_wav_nnet3_cuda2(argv: List[str]) -> int:
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.cli.online_tools2 import (register_use_gpu,
                                                  stats_line)
    from kaldi_tpu_torch.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    po = ParseOptions(
        "Batched offline decode: wav -> batched device features -> "
        "batched device AM forward -> lattices, with the RealTimeX metric "
        "of record (cudadecoderbin/batched-wav-nnet3-cuda2.cc:246-249); "
        "the search over the HCLG runs on the host.\n"
        "Usage: batched-wav-nnet3-cuda2 [options] <nnet3-in> <fst-in> "
        "<wav-rspecifier> <lattice-wspecifier>")
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    mfcc_opts = MfccOptions()
    po.register_struct(mfcc_opts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    sub = po.register_value("frame-subsampling-factor", 3,
                            "Frame subsampling factor of the model")
    batch_size = po.register_value("max-batch-size", 64,
                                   "Utterances per device batch")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    tm, graph, _ = read_nnet3_any(po.get_arg(1))
    if tm is None:
        warn("need an .mdl with a transition model")
        return 1
    device = resolve_device(_device(use_gpu[0]))
    dec = LatticeFasterDecoder(read_fst_file(po.get_arg(2)), dopts)
    fe = OfflineFeature(mfcc_opts, device=device)
    net = compile_graph(graph, "output", device=device)
    writer = TableWriter(LatticeHolder(), po.get_arg(4))
    buf = []
    stats = dict(utterances=0, failed=0, frames=0, feat_s=0.0,
                 forward_s=0.0, search_s=0.0)
    total_audio = 0.0
    t_start = time.time()

    def flush():
        if not buf:
            return
        t0 = time.perf_counter()
        feats = fe.compute_batch([w for _k, w in buf])
        t1 = time.perf_counter()
        t_max = -(-max(f.shape[0] for f in feats) // 8) * 8
        batch = np.zeros((len(buf), t_max, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            batch[i, :f.shape[0]] = f
        out = net(batch, None).cpu().numpy()
        # the model's output is at the input frame rate: every sub'th
        # frame of the utterance's own (the reference's first 1/sub of
        # them is a fault)
        lls = [out[i, :f.shape[0]:sub[0]] for i, f in enumerate(feats)]
        t2 = time.perf_counter()
        stats["feat_s"] += t1 - t0
        stats["forward_s"] += t2 - t1
        for (k, _w), ll in zip(buf, lls):
            stats["frames"] += ll.shape[0]
            t0 = time.perf_counter()
            lat = dec.decode(ll, tm.id2pdf_id, acoustic_scale[0])
            stats["search_s"] += time.perf_counter() - t0
            if lat is None:
                stats["failed"] += 1
                continue
            writer.write(k, lat)
            stats["utterances"] += 1
        buf.clear()

    for key, wave in SequentialTableReader("wave", po.get_arg(3)):
        buf.append((key, wave.channel(0)))
        total_audio += wave.duration
        if len(buf) >= batch_size[0]:
            flush()
    flush()
    writer.close()
    wall = time.time() - t_start
    n = stats["utterances"]
    log(f"decoded {n} utterances; Overall: Aggregate Total Time: "
        f"{wall:.4f} Total Audio: {total_audio:.4f} "
        f"RealTimeX: {total_audio / max(wall, 1e-9):.4f}")
    stats.update(wall_s=wall, audio_s=total_audio,
                 realtimex=total_audio / max(wall, 1e-9))
    stats_line("batched-wav-nnet3-cuda2", stats, device)
    return 0 if n else 1


def batched_wav_nnet3_cuda(argv: List[str]) -> int:
    """cudadecoderbin/batched-wav-nnet3-cuda.cc, superseded by -cuda2 in
    the reference too: the same pipeline."""
    return batched_wav_nnet3_cuda2(["batched-wav-nnet3-cuda2"] + argv[1:])


def batched_wav_nnet3_cuda_online(argv: List[str]) -> int:
    """cudadecoderbin/batched-wav-nnet3-cuda-online.cc: the chunked online
    decode of online2-wav-nnet3-latgen-faster, as the reference's runs
    it (the batched device lanes are `online/batched_device_pipeline.py`
    over the port's own graphs)."""
    from kaldi_tpu_torch.cli.online_tools import \
        online2_wav_nnet3_latgen_faster
    return online2_wav_nnet3_latgen_faster(
        ["online2-wav-nnet3-latgen-faster"] + argv[1:])
