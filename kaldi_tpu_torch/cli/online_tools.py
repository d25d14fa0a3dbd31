"""online2-wav-nnet3-latgen-faster (port of the nnet3 tool of
`kaldi_tpu/cli/online_tools.py`; the reference's online2bin tool of
that name): wav tables decoded as if streamed, a chunk of audio at a
time, with a `.mdl` scored through the compiled module on the card
(unless --use-gpu=no) in a streaming window with the .mdl's contexts,
and the HCLG searched on the host.  It writes the words of each
utterance and logs the real-time factor.

The JAX package's tool scores each chunk of features alone (edge frames
replicated at every chunk boundary); here the window gives the offline
forward's outputs.

Not carried over yet: online2-wav-gmm-latgen-faster, which waits for the
GMM online decoders.
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.online_tools2 import (load_streaming_model,
                                               register_use_gpu, stats_line)
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def online2_wav_nnet3_latgen_faster(argv: List[str]) -> int:
    po = ParseOptions(
        "Reads in wav file(s) and simulates online decoding with a "
        "neural net\n(nnet3 .mdl as produced by our exporter or the "
        "reference), decoding\nin chunks as audio arrives. Chain models: "
        "use --frame-subsampling-factor=3 --acoustic-scale=1.0.\n"
        "Usage: online2-wav-nnet3-latgen-faster [options] <nnet3-in> "
        "<fst-in> <wav-rspecifier> <word-wspecifier>")
    from kaldi_tpu_torch.decoder.viterbi import FasterDecoderOptions
    from kaldi_tpu_torch.feat.frontend import MfccOptions
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.online.decoding import SingleUtteranceDecoder
    from kaldi_tpu_torch.online.features import (OnlineFeature,
                                                 OnlineFeaturePipeline)
    from kaldi_tpu_torch.util.profile import OnlineTimer
    mfcc_opts = MfccOptions()
    po.register_struct(mfcc_opts)
    chunk_length = po.register_value("chunk-length", 0.18, "Length of chunk size in seconds, that we process")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    beam = po.register_value("beam", 15.0, "Decoding beam")
    word_ins_penalty = po.register_value("word-ins-penalty", 0.0, "Word insertion penalty")
    sub = po.register_value("frame-subsampling-factor", 3, "Frame subsampling factor of the model")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    loaded = load_streaming_model(po.get_arg(1), use_gpu[0], sub[0])
    if loaded is None:
        return 1
    tm, make_scorer, device = loaded
    hclg = read_fst_file(po.get_arg(2))
    writer = TableWriter("int-vector", po.get_arg(4))
    n = 0
    total_audio = total_wall = 0.0
    stats = dict(utterances=0, chunks=0, frames=0, scorer_s=0.0,
                 search_s=0.0)
    for key, wave_data in SequentialTableReader("wave", po.get_arg(3)):
        pipe = OnlineFeaturePipeline(OnlineFeature(mfcc_opts, device=device))
        dec = SingleUtteranceDecoder(
            hclg, tm, make_scorer(), pipe, acoustic_scale=acoustic_scale[0],
            opts=FasterDecoderOptions(beam=beam[0]),
            word_ins_penalty=word_ins_penalty[0])
        timer = OnlineTimer(key)
        wav = wave_data.channel(0)
        chunk = max(int(chunk_length[0] * wave_data.samp_freq), 1)
        for start in range(0, len(wav), chunk):
            pipe.accept_waveform(wave_data.samp_freq,
                                 wav[start:start + chunk])
            dec.advance_decoding()
        pipe.input_finished()
        dec.advance_decoding()
        res = dec.finalize_decoding()
        timer.compute_now(wave_data.duration)
        for k in ("chunks", "frames", "scorer_s", "search_s"):
            stats[k] += getattr(dec, k)
        if res is None:
            warn(f"decode failed for {key}")
            continue
        writer.write(key, res[1])
        total_audio += wave_data.duration
        total_wall += timer.real_time_factor() * wave_data.duration
        n += 1
    writer.close()
    if total_wall > 0:
        log(f"decoded {n} utterances; overall RTF "
            f"{total_wall / max(total_audio, 1e-9):.3f} "
            f"({total_audio / max(total_wall, 1e-9):.1f}x realtime)")
    stats.update(utterances=n, audio_s=total_audio, wall_s=total_wall)
    stats_line("online2-wav-nnet3-latgen-faster", stats, device)
    return 0 if n else 1
