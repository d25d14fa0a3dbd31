"""featbin tools (port of the tools of `kaldi_tpu/cli/feat_tools.py` that
a corpus recipe's feature stage runs): compute-mfcc-feats, copy-feats,
compute-cmvn-stats, apply-cmvn, apply-cmvn-sliding, add-deltas,
splice-feats, feat-to-dim, feat-to-len, wav-to-duration and
extract-segments.  Same positional
arguments, option names and table specifiers as the reference's.

compute-mfcc-feats computes a batch of utterances at a time on the card
(`feat/frontend.py` `OfflineFeature`) unless --use-gpu=no; the other
tools are host numpy, as in the reference.  Its VTLN options
(--vtln-warp, --vtln-map with --utt2spk, --vtln-low, --vtln-high) warp
the mel bins an utterance; a batch of mixed warps takes one mel matrix a
warp.  An option of the reference that the port does not carry
(--subtract-mean, dither other than 0, --compress) raises instead of
being ignored.

Not carried over yet: compute-fbank-feats, -spectrogram-feats and
-plp-feats, the pitch tools, paste-feats and the
other feature tools of the reference's module.
"""

from __future__ import annotations

import sys
from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.nnet3_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.feat import functions as ff
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        RandomAccessTableReaderMapped,
                                        SequentialTableReader, TableWriter)


def compute_mfcc_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Create MFCC feature files.\n"
        "Usage: compute-mfcc-feats [options...] <wav-rspecifier> "
        "<feats-wspecifier>")
    opts = MfccOptions()
    po.register_struct(opts)
    channel = po.register_value("channel", -1, "Channel to extract (-1 -> expect mono, 0 -> left, 1 -> right)")
    subtract_mean = po.register_value("subtract-mean", False, "Subtract mean of each feature file [CMS]; not recommended to do it this way")
    vtln_warp = po.register_value("vtln-warp", 1.0, "Vtln warp factor (only applicable if vtln-map not specified)")
    vtln_map = po.register_value("vtln-map", "", "Map from utterance or speaker-id to vtln warp factor (rspecifier)")
    utt2spk = po.register_value("utt2spk", "", "Utterance to speaker-id map rspecifier (if doing VTLN and you have warps per speaker)")
    min_duration = po.register_value("min-duration", 0.0, "Minimum duration of segments to process (in seconds)")
    write_utt2dur = po.register_value("write-utt2dur", "", "Wspecifier to write duration of each utterance in seconds")
    batch_size = po.register_value("batch-size", 32, "Number of utterances per device batch")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    if subtract_mean[0]:
        raise NotImplementedError(
            "--subtract-mean is not ported (the reference only warns); "
            "use apply-cmvn")
    computer = OfflineFeature(opts, device=_device(use_gpu[0]))
    vtln_reader = (RandomAccessTableReaderMapped("float", vtln_map[0],
                                                 utt2spk[0])
                   if vtln_map[0] else None)
    reader = SequentialTableReader("wave", po.get_arg(1))
    writer = TableWriter("matrix", po.get_arg(2))
    dur_writer = (TableWriter("float", write_utt2dur[0])
                  if write_utt2dur[0] else None)
    num_done = num_err = 0
    pending = []  # (key, wave, warp)

    def flush():
        nonlocal num_done
        if not pending:
            return
        feats, nframes = computer.compute_batch_device(
            [w for _, w, _ in pending],
            vtln_warp=[warp for _, _, warp in pending])
        feats = feats.cpu().numpy()
        for i, (key, _, _) in enumerate(pending):
            writer.write(key, feats[i, :nframes[i]])
            num_done += 1
        pending.clear()

    for key, wave_data in reader:
        if dur_writer is not None:
            dur_writer.write(key, wave_data.duration)
        if wave_data.duration < min_duration[0]:
            warn(f"utterance {key} too short ({wave_data.duration:.2f}s)")
            num_err += 1
            continue
        nch = wave_data.data.shape[0]
        ch = channel[0]
        if ch == -1:
            if nch != 1:
                warn(f"{key}: multi-channel file, using channel 0")
            ch = 0
        if ch >= nch:
            warn(f"{key}: no channel {ch}")
            num_err += 1
            continue
        warp = 1.0
        if vtln_reader is not None:
            if key not in vtln_reader:
                warn(f"no vtln-map entry for {key}")
                num_err += 1
                continue
            warp = float(vtln_reader[key])
        elif vtln_warp[0] != 1.0:
            warp = vtln_warp[0]
        if abs(wave_data.samp_freq - opts.frame_opts.samp_freq) > 0.01:
            warn(f"{key}: sample rate {wave_data.samp_freq} != "
                 f"--sample-frequency {opts.frame_opts.samp_freq}")
            num_err += 1
            continue
        pending.append((key, wave_data.channel(ch), warp))
        if len(pending) >= batch_size[0]:
            flush()
    flush()
    writer.close()
    if dur_writer is not None:
        dur_writer.close()
    log(f"Done {num_done} utterances, {num_err} with errors.")
    return 0 if num_done > 0 else 1


def copy_feats(argv: List[str]) -> int:
    po = ParseOptions("Copy features [and possibly change format]\n"
                      "Usage: copy-feats [options] <feature-rspecifier> <feature-wspecifier>")
    compress = po.register_value("compress", False, "If true, write output in compressed form")
    po.register_value("compression-method", 1, "Only relevant if --compress=true; the method to use (1 through 7)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    if compress[0]:
        raise NotImplementedError(
            "--compress=true needs the compressed-matrix holder "
            "(kaldi_tpu/matrix/compressed.py), which is not ported")
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, mat in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, mat)
        n += 1
    writer.close()
    log(f"Copied {n} feature matrices.")
    return 0


def compute_cmvn_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute cepstral mean and variance normalization statistics\n"
        "If wspecifier provided: per-utterance by default, or per-speaker if\n"
        "spk2utt option provided.\n"
        "Usage: compute-cmvn-stats [options] <feats-rspecifier> <stats-wspecifier>")
    spk2utt = po.register_value("spk2utt", "", "rspecifier for speaker to utterance-list map")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    if spk2utt[0]:
        feat_reader = RandomAccessTableReader("matrix", po.get_arg(1))
        for spk, utts in SequentialTableReader("token-vector", spk2utt[0]):
            stats = None
            for utt in utts:
                if utt not in feat_reader:
                    warn(f"no features for utterance {utt}")
                    continue
                stats = ff.acc_cmvn_stats(feat_reader[utt], stats=stats)
            if stats is None:
                warn(f"no stats accumulated for speaker {spk}")
                continue
            writer.write(spk, stats)
            n += 1
    else:
        for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
            writer.write(key, ff.acc_cmvn_stats(feats))
            n += 1
    writer.close()
    log(f"Wrote {n} CMVN stats.")
    return 0


def apply_cmvn(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply cepstral mean and (optionally) variance normalization\n"
        "Usage: apply-cmvn [options] (<cmvn-stats-rspecifier>|<cmvn-stats-rxfilename>) <feats-rspecifier> <feats-wspecifier>")
    norm_vars = po.register_value("norm-vars", False, "If true, normalize variances")
    norm_means = po.register_value("norm-means", True, "You can set this to false to turn off mean normalization")
    reverse = po.register_value("reverse", False, "If true, apply CMVN in a reverse sense")
    utt2spk = po.register_value("utt2spk", "", "rspecifier for utterance to speaker map")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    cmvn_reader = RandomAccessTableReaderMapped("matrix", po.get_arg(1),
                                                utt2spk[0])
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in cmvn_reader:
            warn(f"no cmvn stats for {key}")
            err += 1
            continue
        if not norm_means[0]:
            writer.write(key, feats)
        else:
            writer.write(key, ff.apply_cmvn(feats, cmvn_reader[key],
                                            norm_vars[0], reverse[0]))
        n += 1
    writer.close()
    log(f"Applied CMVN to {n} utterances; {err} errors.")
    return 0 if n else 1


def apply_cmvn_sliding(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply sliding-window cepstral mean (and optionally variance)\n"
        "normalization per utterance.\n"
        "Usage: apply-cmvn-sliding [options] <feats-rspecifier> <feats-wspecifier>")
    opts = ff.SlidingWindowCmnOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, ff.sliding_window_cmn(feats, opts))
        n += 1
    writer.close()
    log(f"Applied sliding-window CMVN to {n} utterances.")
    return 0


def add_deltas(argv: List[str]) -> int:
    po = ParseOptions("Add deltas (typically to raw mfcc or plp features)\n"
                      "Usage: add-deltas [options] <feats-rspecifier> <feats-wspecifier>")
    opts = ff.DeltaFeaturesOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, ff.compute_deltas(feats, opts))
        n += 1
    writer.close()
    log(f"Added deltas to {n} feature matrices.")
    return 0


def splice_feats(argv: List[str]) -> int:
    po = ParseOptions("Splice features with left and right context\n"
                      "Usage: splice-feats [options] <feats-rspecifier> <feats-wspecifier>")
    left = po.register_value("left-context", 4, "Number of frames of left context")
    right = po.register_value("right-context", 4, "Number of frames of right context")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, ff.splice_frames(feats, left[0], right[0]))
        n += 1
    writer.close()
    log(f"Spliced {n} feature matrices.")
    return 0


def feat_to_dim(argv: List[str]) -> int:
    po = ParseOptions("Reads an archive of features and writes a corresponding archive\n"
                      "that maps utterance-id to utterance dimension.\n"
                      "Usage: feat-to-dim [options] <feat-rspecifier> (<dim-wspecifier>|<dim-wxfilename>)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    out = po.get_arg(2)
    if ":" in out and out.split(":")[0].split(",")[0] in ("ark", "scp"):
        writer = TableWriter("int", out)
        for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
            writer.write(key, feats.shape[1])
        writer.close()
    else:
        for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
            text = f"{feats.shape[1]}\n"
            if out == "-":
                sys.stdout.write(text)
            else:
                with open(out, "w") as f:
                    f.write(text)
            break
    return 0


def feat_to_len(argv: List[str]) -> int:
    po = ParseOptions("Reads an archive of features and writes a corresponding archive\n"
                      "that maps utterance-id to utterance length in frames.\n"
                      "Usage: feat-to-len [options] <in-rspecifier> [<out-wspecifier>]")
    po.read(argv)
    if po.num_args() not in (1, 2):
        po.print_usage()
        return 1
    if po.num_args() == 2:
        writer = TableWriter("int", po.get_arg(2))
        for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
            writer.write(key, feats.shape[0])
        writer.close()
    else:
        for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
            print(f"{key} {feats.shape[0]}")
    return 0


def wav_to_duration(argv: List[str]) -> int:
    po = ParseOptions("Read wav files and output an archive consisting of a single float:\n"
                      "the duration of each one in seconds.\n"
                      "Usage: wav-to-duration [options] <wav-rspecifier> <duration-wspecifier>")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("float", po.get_arg(2))
    for key, wave_data in SequentialTableReader("wave", po.get_arg(1)):
        writer.write(key, wave_data.duration)
    writer.close()
    return 0


def extract_segments(argv: List[str]) -> int:
    po = ParseOptions(
        "Extract segments from a large audio file in WAV format.\n"
        "Usage: extract-segments [options] <wav-rspecifier> <segments-file> <wav-wspecifier>\n"
        "segments-file format: each line is <segment-id> <recording-id> <start-time> <end-time>")
    min_segment_length = po.register_value("min-segment-length", 0.1, "Minimum segment length in seconds (reject shorter segments)")
    max_overshoot = po.register_value("max-overshoot", 0.5, "End segments overshooting audio by less than this (in seconds) are truncated, else rejected")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.wave import WaveData
    wav_reader = RandomAccessTableReader("wave", po.get_arg(1))
    writer = TableWriter("wave", po.get_arg(3))
    n = err = 0
    with open(po.get_arg(2)) as segments:
        for line in segments:
            parts = line.split()
            if len(parts) not in (4, 5):
                warn(f"bad segments line: {line.strip()}")
                err += 1
                continue
            seg, reco = parts[0], parts[1]
            start, end = float(parts[2]), float(parts[3])
            channel = int(parts[4]) if len(parts) == 5 else 0
            if reco not in wav_reader:
                warn(f"no recording {reco}")
                err += 1
                continue
            wav = wav_reader[reco]
            fs = wav.samp_freq
            dur = wav.data.shape[1] / fs
            if end > dur + max_overshoot[0] or \
                    end - start < min_segment_length[0]:
                warn(f"rejecting segment {seg} [{start},{end}] vs duration "
                     f"{dur}")
                err += 1
                continue
            s = int(round(start * fs))
            e = min(int(round(end * fs)), wav.data.shape[1])
            writer.write(seg, WaveData(fs, wav.data[channel:channel + 1,
                                                    s:e]))
            n += 1
    writer.close()
    log(f"Extracted {n} segments; {err} errors.")
    return 0 if n else 1

