"""online2-tcp-nnet3-decode-faster, online2-wav-dump-features and
nnet3-align-compiled (ports of `kaldi_tpu/cli/online_tools2.py`; the
reference's online2bin and nnet3bin tools of those names).

The TCP server scores a `.mdl` through the compiled module
(nnet3/torch_bridge.py), on the card unless --use-gpu=no, a streaming
window a connection (nnet3/streaming.py's OnlineNnetScorer) with the
.mdl's left and right context, and searches the HCLG on the host.  The
JAX package's tool scores each chunk of features alone, so every chunk
boundary is an utterance boundary to the model and the subsampling
phase restarts at each chunk; the window gives the offline forward's
outputs instead, as upstream's looped decodable does.

nnet3-align-compiled scores each utterance with the `.mdl`'s compiled
module, on the card unless --use-gpu=no, takes every
--frame-subsampling-factor-th output frame (the alignment is at the
output rate), and searches each compiled training graph with the host
FasterDecoder.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def read_words(path: str) -> Dict[int, str]:
    """words.txt symbol table -> {id: word}."""
    names = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                names[int(parts[1])] = parts[0]
    return names


def register_use_gpu(po: ParseOptions):
    return po.register_value("use-gpu", "yes",
                             "yes: score on the CUDA card (fail without "
                             "one); no: on the CPU")


def use_gpu_device(use_gpu: str):
    """--use-gpu's value -> the torch device (yes: the card, raising
    without one; no: the CPU)."""
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.device import resolve_device
    return resolve_device(_device(use_gpu))


def load_streaming_model(path: str, use_gpu: str, sub: int):
    """-> (transition model, scorer factory, device) of a .mdl: each
    scorer an OnlineNnetScorer over the compiled module's subsampled
    output with the .mdl's contexts; None for a raw model."""
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    device = resolve_device(_device(use_gpu))
    tm, graph, info = read_nnet3_any(path)
    if tm is None:
        warn("raw model given (no transition model); an .mdl is needed")
        return None
    net = compile_graph(graph, "output", device=device)

    def forward(window: torch.Tensor) -> torch.Tensor:
        return net(window)[:, ::sub]

    def make_scorer() -> OnlineNnetScorer:
        return OnlineNnetScorer(forward, info["left_context"],
                                info["right_context"], sub, device=device)

    return tm, make_scorer, device


def stats_line(tool: str, stats: dict, device: torch.device) -> None:
    """Log the run's totals as one JSON object after `<tool> stats `."""
    from kaldi_tpu_torch.ops import kernel_launch_counts
    out = dict(stats, kernel_launches=kernel_launch_counts())
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"{tool} stats {json.dumps(out)}")


def online2_tcp_nnet3_decode_faster(argv: List[str]) -> int:
    po = ParseOptions(
        "TCP server for streaming nnet3 decoding: clients stream raw "
        "16-bit little-endian PCM; partial hypotheses come back "
        "'\\r'-terminated, finals '\\n'-terminated "
        "(online2-tcp-nnet3-decode-faster.cc protocol).\n"
        "Usage: online2-tcp-nnet3-decode-faster [options] <nnet3-in> "
        "<fst-in> <word-symbol-table>")
    from kaldi_tpu_torch.feat.frontend import MfccOptions
    mfcc_opts = MfccOptions()
    po.register_struct(mfcc_opts)
    port = po.register_value("port-num", 5050, "Port to listen on")
    samp_freq = po.register_value("samp-freq", 8000.0,
                                  "Sampling frequency of the audio")
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    sub = po.register_value("frame-subsampling-factor", 3,
                            "Frame subsampling factor of the model")
    chunk_ms = po.register_value("chunk-length-ms", 180,
                                 "Audio chunk size in milliseconds")
    max_conn = po.register_value(
        "num-connections", 0, "Exit after serving this many "
        "connections (0 = serve forever); used by tests")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.online.features import (OnlineFeature,
                                                 OnlineFeaturePipeline)
    from kaldi_tpu_torch.online.server import TcpDecodeServer
    loaded = load_streaming_model(po.get_arg(1), use_gpu[0], sub[0])
    if loaded is None:
        return 1
    tm, make_scorer, device = loaded
    hclg = read_fst_file(po.get_arg(2))
    names = read_words(po.get_arg(3))

    def make_pipeline():
        return OnlineFeaturePipeline(OnlineFeature(mfcc_opts, device=device))

    make_pipeline()           # options the frontend refuses fail here
    server = TcpDecodeServer(
        hclg, tm, None, word_names=names, make_pipeline=make_pipeline,
        samp_freq=samp_freq[0], acoustic_scale=acoustic_scale[0],
        chunk_ms=chunk_ms[0], port=port[0], make_scorer=make_scorer)
    server.start()
    print(f"# listening on {server.host}:{server.port}", flush=True)
    try:
        while not (max_conn[0] and server.num_served >= max_conn[0]):
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    stats_line("online2-tcp-nnet3-decode-faster",
               dict(server.stats, connections=server.num_served,
                    errors=len(server.errors)), device)
    return 1 if server.errors else 0


def online2_wav_dump_features(argv: List[str]) -> int:
    po = ParseOptions(
        "Simulate the online feature pipeline on wav input and dump "
        "the features it would feed the decoder "
        "(online2-wav-dump-features.cc).\n"
        "Usage: online2-wav-dump-features [options] <wav-rspecifier> "
        "<feats-wspecifier>")
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.feat.frontend import MfccOptions
    mfcc_opts = MfccOptions()
    po.register_struct(mfcc_opts)
    chunk_length = po.register_value(
        "chunk-length", 0.18, "Length of audio chunks fed to the "
        "online pipeline, in seconds")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.online.features import (OnlineFeature,
                                                 OnlineFeaturePipeline)
    device = resolve_device(_device(use_gpu[0]))
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    fs = mfcc_opts.frame_opts.samp_freq
    step = max(1, int(chunk_length[0] * fs))
    for key, wave_data in SequentialTableReader("wave", po.get_arg(1)):
        pipe = OnlineFeaturePipeline(OnlineFeature(mfcc_opts, device=device))
        wave = np.asarray(wave_data.channel(0))
        for i in range(0, len(wave), step):
            pipe.accept_waveform(fs, wave[i:i + step])
        pipe.input_finished()
        writer.write(key, pipe.get_frames(0, pipe.num_frames_ready()))
        n += 1
    writer.close()
    log(f"dumped online features for {n} utterances")
    return 0 if n else 1


def nnet3_align_compiled(argv: List[str]) -> int:
    po = ParseOptions(
        "Viterbi-align features to compiled training graphs using an "
        "nnet3 model (nnet3-align-compiled.cc).  Chain models: "
        "--frame-subsampling-factor=3 (the alignment is at the "
        "subsampled rate, like the reference).\n"
        "Usage: nnet3-align-compiled [options] <nnet3-in> "
        "<graphs-rspecifier> <feats-rspecifier> "
        "<alignments-wspecifier>")
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                 FasterDecoderOptions)
    from kaldi_tpu_torch.device import full_f32, resolve_device
    from kaldi_tpu_torch.fstext.fst import VectorFst
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    from kaldi_tpu_torch.util.table import RandomAccessTableReader
    beam = po.register_value("beam", 10.0, "Decoding beam")
    retry_beam = po.register_value("retry-beam", 40.0,
                                   "Beam for the second attempt")
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    sub = po.register_value("frame-subsampling-factor", 1,
                            "Frame subsampling factor of the model")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    device = resolve_device(_device(use_gpu[0]))
    tm, graph_model, _info = read_nnet3_any(po.get_arg(1))
    if tm is None:
        warn("raw model given (no transition model); an .mdl is needed")
        return 1
    net = compile_graph(graph_model, "output", device=device)
    graphs = RandomAccessTableReader(VectorFst, po.get_arg(2))
    writer = TableWriter("int-vector", po.get_arg(4))
    n = err = 0
    stats = {"forward_s": 0.0, "search_s": 0.0, "frames": 0}
    for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
        if key not in graphs:
            warn(f"no graph for {key}")
            err += 1
            continue
        t0 = time.perf_counter()
        x = torch.from_numpy(np.asarray(feats, np.float32)[None]).to(device)
        with torch.no_grad(), full_f32():
            ll = net(x)[0, ::sub[0]].cpu().numpy()
        t1 = time.perf_counter()
        res = FasterDecoder(graphs[key], FasterDecoderOptions(
            beam=beam[0])).decode(ll, tm.id2pdf_id, acoustic_scale[0])
        if res is None and retry_beam[0] > beam[0]:
            res = FasterDecoder(graphs[key], FasterDecoderOptions(
                beam=retry_beam[0])).decode(ll, tm.id2pdf_id,
                                            acoustic_scale[0])
        stats["forward_s"] += t1 - t0
        stats["search_s"] += time.perf_counter() - t1
        stats["frames"] += ll.shape[0]
        if res is None:
            warn(f"alignment failed for {key}")
            err += 1
            continue
        writer.write(key, res[0])
        n += 1
    writer.close()
    log(f"aligned {n} utterances ({err} failed)")
    stats_line("nnet3-align-compiled",
               dict(stats, utterances=n, failed=err), device)
    return 0 if n else 1
