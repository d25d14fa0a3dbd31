"""nnet3-latgen-faster's variants -batch (the forward minibatched across
utterances) and -looped (a streaming forward, a chunk of frames at a
time), and the loading and decode loop they share with
nnet3-latgen-faster (cli/nnet3_tools.py): port of
`kaldi_tpu/cli/nnet3_latgen_tools.py`; parity:
src/nnet3bin/nnet3-latgen-faster{,-batch,-looped}.cc.

The model is an xconfig checkpoint directory (parallel/checkpoint.py),
computed on the card unless --use-gpu=no, in float32 with TF32 off; the
search (decoder/lattice_decoder.py) and the determinization
(lat/functions.py determinize_lattice, the reference's unpruned one)
run on the host.  Each tool logs a `<tool> stats {...}` JSON line at
its end: utterances and frames, the forward's host seconds and its span
on the card (ms between CUDA events around each call, idle gaps
included), the search's and the determinization's seconds, `det_fallbacks`
(lattices written undeterminized because determinization gave up), the
wall and real-time factor (audio_s counts the input frames at the
features' 10-ms shift), the hand kernels' launches and, on the card,
the peak memory.

Not carried over yet: -lookahead (it needs decoder/biglm.py) and
-looped-parallel.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

FRAME_SHIFT_S = 0.01


def register_latgen(po: ParseOptions):
    from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
    from kaldi_tpu_torch.decoder.lattice_decoder import \
        LatticeFasterDecoderOptions
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods "
        "(chain models typically 1.0)")
    return dopts, acoustic_scale, register_use_gpu(po)


class _Forward:
    """The xconfig model's "output" head over (B, T, D) features, on its
    device in float32 with TF32 off; accumulates host seconds and (on the
    card) the ms between CUDA events around each call."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.host_s = 0.0
        self.span_ms = 0.0
        self.calls = 0

    def __call__(self, feats) -> torch.Tensor:
        from kaldi_tpu_torch.device import full_f32
        x = (feats if isinstance(feats, torch.Tensor)
             else torch.tensor(np.asarray(feats, np.float32)))
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with torch.no_grad(), full_f32():
            out = self._output(x)
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            self.span_ms += ev[0].elapsed_time(ev[1])
        self.host_s += time.perf_counter() - t0
        self.calls += 1
        return out

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        return self.model({"input": x})["output"]


def _load_tm_and_model(tm_arg: str, nnet_dir: str, use_gpu: str):
    """-> (transition model, _Forward over the checkpoint's model)."""
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.parallel.checkpoint import load_xconfig_checkpoint
    with kaldi_io.input_stream(tm_arg) as f:
        binary = iof.init_input_stream(f)
        tm = TransitionModel.read(f, binary)
    model, _text, _step = load_xconfig_checkpoint(nnet_dir,
                                                  device=_device(use_gpu))
    return tm, _Forward(model)


def _decode_loop(items: Iterable[Tuple[str, np.ndarray, int]],
                 hclg_arg: str, tm, forward: _Forward, acoustic_scale: float,
                 dopts, lat_wspec: str, words_wspec: Optional[str],
                 name: str, ali_wspec: Optional[str] = None) -> int:
    """Decode each (key, loglikes, input frames) of `items` into a
    lattice (determinized unless --determinize-lattice=false) and its
    best path's words and transition-ids; log the stats line."""
    from kaldi_tpu_torch.cli.online_tools2 import stats_line
    from kaldi_tpu_torch.decoder.lattice_decoder import LatticeFasterDecoder
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.functions import (determinize_lattice,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    t_start = time.perf_counter()
    dec = LatticeFasterDecoder(read_fst_file(hclg_arg), dopts)
    lat_writer = TableWriter(LatticeHolder(), lat_wspec)
    word_writer = (TableWriter("int-vector", words_wspec)
                   if words_wspec else None)
    ali_writer = TableWriter("int-vector", ali_wspec) if ali_wspec else None
    stats = dict(utterances=0, failed=0, input_frames=0, frames=0,
                 search_s=0.0, determinize_s=0.0, det_fallbacks=0,
                 lattice_states=0, lattice_arcs=0)
    for key, loglikes, n_in in items:
        stats["input_frames"] += n_in
        stats["frames"] += loglikes.shape[0]
        t0 = time.perf_counter()
        lat = dec.decode(loglikes, tm.id2pdf_id, acoustic_scale)
        stats["search_s"] += time.perf_counter() - t0
        if lat is None:
            stats["failed"] += 1
            continue
        out_lat = lat
        if dopts.determinize_lattice:
            t0 = time.perf_counter()
            out_lat = determinize_lattice(lat)
            stats["determinize_s"] += time.perf_counter() - t0
            stats["det_fallbacks"] += out_lat is lat
        lat_writer.write(key, out_lat)
        stats["lattice_states"] += out_lat.num_states
        stats["lattice_arcs"] += out_lat.num_arcs()
        if word_writer or ali_writer:
            ali, words, _ = lattice_best_path(lat)
            if word_writer:
                word_writer.write(key, words)
            if ali_writer:
                ali_writer.write(key, ali)
        stats["utterances"] += 1
    for writer in (lat_writer, word_writer, ali_writer):
        if writer:
            writer.close()
    n = stats["utterances"]
    log(f"{name}: decoded {n} utterances ({stats['failed']} failed)")
    wall = time.perf_counter() - t_start
    audio = stats["input_frames"] * FRAME_SHIFT_S
    stats.update(forward_s=forward.host_s, forward_calls=forward.calls,
                 forward_span_ms=(forward.span_ms
                                  if forward.device.type == "cuda"
                                  else None),
                 wall_s=wall, audio_s=audio, rtf=wall / max(audio, 1e-9))
    stats_line(name, stats, forward.device)
    return 0 if n else 1


def parse_args(po: ParseOptions, argv: List[str]) -> bool:
    po.read(argv)
    if po.num_args() < 5:
        po.print_usage()
        return False
    return True


def nnet3_latgen_faster_looped(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices with a LOOPED (streaming, constant-memory) "
        "nnet3 computation (decodable-online-looped.h:135 AdvanceChunk; "
        "here a rolling input window, nnet3/streaming.py).\n"
        "Usage: nnet3-latgen-faster-looped [options] <trans-model> "
        "<nnet-dir> <fst-in> <features-rspecifier> "
        "<lattice-wspecifier> [<words-wspecifier>]")
    dopts, acoustic_scale, use_gpu = register_latgen(po)
    chunk = po.register_value(
        "frames-per-chunk", 50, "Input frames per streaming chunk")
    extra_left = po.register_value(
        "extra-left-context", 20, "Left context frames kept per chunk")
    extra_right = po.register_value(
        "extra-right-context", 20, "Right lookahead frames per chunk")
    sub = po.register_value(
        "frame-subsampling-factor", 1,
        "Output frame subsampling of the nnet")
    if not parse_args(po, argv):
        return 1
    from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
    tm, forward = _load_tm_and_model(po.get_arg(1), po.get_arg(2),
                                     use_gpu[0])

    def items():
        for key, feats in SequentialTableReader("matrix", po.get_arg(4)):
            scorer = OnlineNnetScorer(forward, left_context=extra_left[0],
                                      right_context=extra_right[0],
                                      subsample=sub[0],
                                      device=forward.device)
            outs = [scorer.accept_features(feats[s:s + chunk[0]])
                    for s in range(0, feats.shape[0], chunk[0])]
            outs.append(scorer.finish())
            outs = [o for o in outs if o.shape[0]]
            ll = (torch.cat(outs).cpu().numpy() if outs
                  else np.zeros((0, 1), np.float32))
            yield key, ll, len(feats)

    return _decode_loop(items(), po.get_arg(3), tm, forward,
                        acoustic_scale[0], dopts, po.get_arg(5),
                        po.get_arg(6) if po.num_args() >= 6 else None,
                        "nnet3-latgen-faster-looped")


def batch_loglikes(forward: Callable, pend: List[Tuple[str, np.ndarray]]):
    """-batch's forward of a minibatch: the utterances zero-padded to the
    longest into one batch, each utterance's output frames taken as
    round(T * T_out / T_max) (nnet3_latgen_tools.py:184-187); the padded
    tail is context for the last frames of the shorter ones."""
    t_max = max(f.shape[0] for _, f in pend)
    batch = np.zeros((len(pend), t_max, pend[0][1].shape[1]), np.float32)
    for i, (_, f) in enumerate(pend):
        batch[i, :f.shape[0]] = f
    out = forward(batch).cpu().numpy()
    ratio = out.shape[1] / float(t_max)
    for i, (key, f) in enumerate(pend):
        yield key, out[i, :max(1, int(round(f.shape[0] * ratio)))], len(f)


def nnet3_latgen_faster_batch(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices with the nnet3 forward MINIBATCHED across "
        "utterances (nnet3-latgen-faster-batch.cc: one zero-padded "
        "batch per --minibatch-size utterances).\n"
        "Usage: nnet3-latgen-faster-batch [options] <trans-model> "
        "<nnet-dir> <fst-in> <features-rspecifier> "
        "<lattice-wspecifier> [<words-wspecifier>]")
    dopts, acoustic_scale, use_gpu = register_latgen(po)
    mb = po.register_value("minibatch-size", 8,
                           "Utterances per AM forward batch")
    if not parse_args(po, argv):
        return 1
    tm, forward = _load_tm_and_model(po.get_arg(1), po.get_arg(2),
                                     use_gpu[0])

    def items():
        pend: List = []
        for kv in SequentialTableReader("matrix", po.get_arg(4)):
            pend.append(kv)
            if len(pend) == mb[0]:
                yield from batch_loglikes(forward, pend)
                pend = []
        if pend:
            yield from batch_loglikes(forward, pend)

    return _decode_loop(items(), po.get_arg(3), tm, forward,
                        acoustic_scale[0], dopts, po.get_arg(5),
                        po.get_arg(6) if po.num_args() >= 6 else None,
                        "nnet3-latgen-faster-batch")
