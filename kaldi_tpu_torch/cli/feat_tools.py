"""featbin tools (port of `kaldi_tpu/cli/feat_tools.py`): the feature
computers compute-mfcc-feats, -fbank-feats, -spectrogram-feats and
-plp-feats, the pitch tools compute-kaldi-pitch-feats,
process-kaldi-pitch-feats and interpolate-pitch, and the feature, CMVN,
matrix and wave tools (copy-feats, copy-matrix, paste-feats,
select-feats, subset-feats, shift-feats, subsample-feats, concat-feats,
compare-feats, append-vector-to-feats, post-to-feats, matrix-sum,
vector-sum, compute-cmvn-stats, apply-cmvn, apply-cmvn-sliding,
modify-cmvn-stats, add-deltas, splice-feats, feat-to-dim, feat-to-len,
wav-to-duration, wav-copy, extract-segments, extract-feature-segments).
Same positional arguments, option names and table specifiers as the
reference's.

The four feature computers share one runner (`_run_feature_tool`, the
reference's): it computes a batch of utterances at a time on the card
(`feat/frontend.py` `OfflineFeature`) unless --use-gpu=no.  Its VTLN
options (--vtln-warp, --vtln-map with --utt2spk, --vtln-low,
--vtln-high) warp the mel bins an utterance; a batch of mixed warps
takes one mel matrix a warp.  Dither draws its noise a batch from the
computer's own seed stream, as the reference does (the bits are not
JAX's).  --subtract-mean raises instead of being ignored (the reference
only warns).  copy-feats --compress=true writes the reference's
CompressedMatrix bytes.  The other tools are host numpy, as in the
reference.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.nnet3_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.feat import functions as ff
from kaldi_tpu_torch.feat.frontend import (FbankOptions, MfccOptions,
                                           OfflineFeature,
                                           SpectrogramOptions)
from kaldi_tpu_torch.feat.plp import PlpOptions
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (CompressedMatrixHolder,
                                        RandomAccessTableReader,
                                        RandomAccessTableReaderMapped,
                                        SequentialTableReader, TableWriter)


def _run_feature_tool(tool: str, opts_cls, argv: List[str],
                      default_batch_size: int = 32) -> int:
    po = ParseOptions(
        f"Create {tool.split('-')[1]} features from wave files.\n"
        f"Usage: {tool} [options...] <wav-rspecifier> <feats-wspecifier>")
    opts = opts_cls()
    po.register_struct(opts)
    channel = po.register_value("channel", -1, "Channel to extract (-1 -> expect mono, 0 -> left, 1 -> right)")
    subtract_mean = po.register_value("subtract-mean", False, "Subtract mean of each feature file [CMS]; not recommended to do it this way")
    vtln_warp = po.register_value("vtln-warp", 1.0, "Vtln warp factor (only applicable if vtln-map not specified)")
    vtln_map = po.register_value("vtln-map", "", "Map from utterance or speaker-id to vtln warp factor (rspecifier)")
    utt2spk = po.register_value("utt2spk", "", "Utterance to speaker-id map rspecifier (if doing VTLN and you have warps per speaker)")
    min_duration = po.register_value("min-duration", 0.0, "Minimum duration of segments to process (in seconds)")
    write_utt2dur = po.register_value("write-utt2dur", "", "Wspecifier to write duration of each utterance in seconds")
    batch_size = po.register_value("batch-size", default_batch_size, "Number of utterances per device batch")
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


def compute_mfcc_feats(argv: List[str]) -> int:
    return _run_feature_tool("compute-mfcc-feats", MfccOptions, argv)


def compute_fbank_feats(argv: List[str]) -> int:
    return _run_feature_tool("compute-fbank-feats", FbankOptions, argv)


def compute_plp_feats(argv: List[str]) -> int:
    return _run_feature_tool("compute-plp-feats", PlpOptions, argv)


def compute_spectrogram_feats(argv: List[str]) -> int:
    return _run_feature_tool("compute-spectrogram-feats",
                             SpectrogramOptions, argv)


def copy_feats(argv: List[str]) -> int:
    po = ParseOptions("Copy features [and possibly change format]\n"
                      "Usage: copy-feats [options] <feature-rspecifier> <feature-wspecifier>")
    compress = po.register_value("compress", False, "If true, write output in compressed form")
    compression_method = po.register_value("compression-method", 1, "Only relevant if --compress=true; the method to use (1 through 7)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    holder = (CompressedMatrixHolder(compression_method[0]) if compress[0]
              else "matrix")
    writer = TableWriter(holder, po.get_arg(2))
    n = 0
    for key, mat in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, mat)
        n += 1
    writer.close()
    log(f"Copied {n} feature matrices.")
    return 0


copy_matrix = copy_feats


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


def paste_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Paste feature files (assuming they have about the same durations),\n"
        "appending the features on each frame\n"
        "Usage: paste-feats <in-rspecifier1> <in-rspecifier2> [<in-rspecifierN>] <out-wspecifier>")
    length_tolerance = po.register_value("length-tolerance", 0, "If length is different, trim as shortest up to a frame difference of length-tolerance, otherwise exclude segment")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    first = SequentialTableReader("matrix", po.get_arg(1))
    others = [RandomAccessTableReader("matrix", po.get_arg(i))
              for i in range(2, po.num_args())]
    writer = TableWriter("matrix", po.get_arg(po.num_args()))
    n = err = 0
    for key, feats in first:
        mats = [feats]
        ok = True
        for r in others:
            if key not in r:
                ok = False
                break
            mats.append(r[key])
        if not ok:
            err += 1
            continue
        lens = [m.shape[0] for m in mats]
        if max(lens) - min(lens) > length_tolerance[0]:
            warn(f"{key}: length mismatch {lens}")
            err += 1
            continue
        t = min(lens)
        writer.write(key, np.concatenate([m[:t] for m in mats], axis=1))
        n += 1
    writer.close()
    log(f"Pasted {n} feature matrices; {err} errors.")
    return 0 if n else 1


def select_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Select certain dimensions of the feature file\n"
        "Usage: select-feats <selection> <in-rspecifier> <out-wspecifier>\n"
        "e.g. select-feats 0,24-22,3-12 scp:feats.scp ark,scp:feat-red.ark,feat-red.scp")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    sel = []
    for part in po.get_arg(1).split(","):
        if "-" in part[1:]:
            a, b = part.split("-")
            a, b = int(a), int(b)
            sel.extend(range(a, b + 1) if a <= b else range(a, b - 1, -1))
        else:
            sel.append(int(part))
    writer = TableWriter("matrix", po.get_arg(3))
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        writer.write(key, feats[:, sel])
    writer.close()
    return 0


def subset_feats(argv: List[str]) -> int:
    po = ParseOptions("Copy a subset of features\n"
                      "Usage: subset-feats [options] <in-rspecifier> <out-wspecifier>")
    n_opt = po.register_value("n", 10, "If nonnegative, copy the first n feature files")
    include = po.register_value("include", "", "Text file, the first field of each line being interpreted as an utterance-id whose features will be included")
    exclude = po.register_value("exclude", "", "Text file, the first field of each line being interpreted as an utterance-id whose features will be excluded")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    def first_fields(path):
        with open(path) as f:
            return {line.split()[0] for line in f if line.strip()}
    inc = first_fields(include[0]) if include[0] else None
    exc = first_fields(exclude[0]) if exclude[0] else None
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if inc is not None and key not in inc:
            continue
        if exc is not None and key in exc:
            continue
        if inc is None and exc is None and n >= n_opt[0]:
            break
        writer.write(key, feats)
        n += 1
    writer.close()
    log(f"Kept {n} feature matrices.")
    return 0


def matrix_sum(argv: List[str]) -> int:
    po = ParseOptions(
        "Sum matrices (e.g. stats accumulators stored as matrices);\n"
        "with --average, divide the result by the count\n"
        "Usage: matrix-sum [options] <matrix-out> <matrix-in1> "
        "<matrix-in2> ...  (or archive mode: matrix-sum "
        "<matrix-rspecifier> <matrix-out>)")
    average = po.register_value("average", False, "Output the average instead of the sum")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    first = po.get_arg(1)
    if ":" in first and first.split(":")[0].split(",")[0] in ("ark", "scp"):
        total = None
        n = 0
        for _key, m in SequentialTableReader("matrix", first):
            total = m.astype(np.float64) if total is None else total + m
            n += 1
        if total is None:
            return 1
        if average[0]:
            total = total / n
        kaldi_io.write_kaldi_object(
            lambda s, b: iof.write_matrix(s, b, total), po.get_arg(2))
        return 0
    total = None
    for i in range(2, po.num_args() + 1):
        m = kaldi_io.read_kaldi_object(iof.read_matrix, po.get_arg(i))
        total = m.astype(np.float64) if total is None else total + m
    if average[0]:
        total = total / (po.num_args() - 1)
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_matrix(s, b, total), first)
    return 0


def vector_sum(argv: List[str]) -> int:
    po = ParseOptions(
        "Sum vectors from an archive into one vector\n"
        "Usage: vector-sum <vector-rspecifier> <vector-out>")
    average = po.register_value("average", False, "Output the average")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    total = None
    n = 0
    for _key, v in SequentialTableReader("vector", po.get_arg(1)):
        total = v.astype(np.float64) if total is None else total + v
        n += 1
    if total is None:
        return 1
    if average[0]:
        total = total / n
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_vector(s, b, total), po.get_arg(2))
    return 0


def shift_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy features, and possibly shift them while maintaining the "
        "num-frames.\n"
        "Usage: shift-feats [options] <feature-rspecifier> "
        "<feature-wspecifier>")
    shift = po.register_value("shift", 0, "Number of frames by which to "
                              "shift the features (+ -> later in time)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        k = int(shift[0])
        out = np.empty_like(feats)
        if k >= 0:
            out[k:] = feats[:len(feats) - k] if k < len(feats) else 0
            out[:k] = feats[0]
        else:
            k = -k
            out[:len(feats) - k] = feats[k:]
            out[len(feats) - k:] = feats[-1]
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"shift-feats: {n} utterances")
    return 0


def subsample_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Sub-samples features (or repeats them): output every n'th "
        "frame (negative n -> repeat each frame n times).\n"
        "Usage: subsample-feats [options] <feature-rspecifier> "
        "<feature-wspecifier>")
    n_opt = po.register_value("n", 1, "Frame subsampling factor")
    offset = po.register_value("offset", 0, "Phase of subsampling")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    cnt = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        n = int(n_opt[0])
        if n > 0:
            out = feats[int(offset[0])::n]
        else:
            out = np.repeat(feats, -n, axis=0)
        writer.write(key, out)
        cnt += 1
    writer.close()
    log(f"subsample-feats: {cnt} utterances")
    return 0


def concat_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Concatenate feature files (in time).\n"
        "Usage: concat-feats <in-rxfilename1> <in-rxfilename2> "
        "[<in-rxfilenameN>...] <out-wxfilename>")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    mats = []
    for i in range(1, po.num_args()):
        mats.append(kaldi_io.read_kaldi_object(iof.read_matrix,
                                               po.get_arg(i)))
    out = np.concatenate(mats, axis=0)
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_matrix(s, b, out.astype(np.float32)),
        po.get_arg(po.num_args()))
    return 0


def compare_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Computes relative difference between two sets of features "
        "per-utterance; print the average similarity (1.0 = identical).\n"
        "Usage: compare-feats [options] <in-rspecifier1> <in-rspecifier2>")
    threshold = po.register_value("threshold", 0.99,
                                  "Similarity threshold for success")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    second = RandomAccessTableReader("matrix", po.get_arg(2))
    sims = []
    for key, a in SequentialTableReader("matrix", po.get_arg(1)):
        if key not in second:
            warn(f"compare-feats: no second features for {key}")
            continue
        b = second[key]
        if a.shape != b.shape:
            sims.append(0.0)
            continue
        num = float((a * b).sum())
        den = float(np.sqrt((a * a).sum() * (b * b).sum()))
        sims.append(num / den if den else 1.0)
    mean = float(np.mean(sims)) if sims else 0.0
    print(f"Average similarity is {mean} with similarity threshold "
          f"{threshold[0]}", file=sys.stderr)
    return 0 if sims and mean >= threshold[0] else 1


def append_vector_to_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Append a vector to each row of input feature files.\n"
        "Usage: append-vector-to-feats <in-rspecifier1> "
        "<vec-rspecifier2> <out-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    vecs = RandomAccessTableReader("vector", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if key not in vecs:
            warn(f"append-vector-to-feats: no vector for {key}")
            continue
        v = vecs[key]
        out = np.concatenate(
            [feats, np.broadcast_to(v, (len(feats), len(v)))], axis=1)
        writer.write(key, out.astype(np.float32))
        n += 1
    writer.close()
    log(f"append-vector-to-feats: {n} utterances")
    return 0


def post_to_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert posteriors to features (a dense matrix with one "
        "column per posterior entry id).\n"
        "Usage: post-to-feats [options] <post-rspecifier> "
        "<feats-wspecifier>")
    post_dim = po.register_value("post-dim", 0,
                                 "Dimensionality of the output")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    if post_dim[0] <= 0:
        warn("post-to-feats: --post-dim must be set")
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, post in SequentialTableReader("posterior", po.get_arg(1)):
        T = len(post)
        out = np.zeros((T, int(post_dim[0])), np.float32)
        for t, row in enumerate(post):
            for pid, w in row:
                if pid < post_dim[0]:
                    out[t, pid] += w
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"post-to-feats: {n} utterances")
    return 0


def wav_copy(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy wave file or archives of wave files.\n"
        "Usage: wav-copy [options] <wav-rspecifier> <wav-wspecifier>")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("wave", po.get_arg(2))
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(1)):
        writer.write(key, wav)
        n += 1
    writer.close()
    log(f"wav-copy: {n} files")
    return 0


def extract_feature_segments(argv: List[str]) -> int:
    po = ParseOptions(
        "Create feature files for segments from an input 'segments' "
        "file (each line: <segment-id> <utt-id> <start-time> "
        "<end-time>).\n"
        "Usage: extract-feature-segments [options] "
        "<feats-rspecifier> <segments-file> <feats-wspecifier>")
    frame_shift = po.register_value("frame-shift", 0.01,
                                    "Frame shift in seconds")
    min_segment_length = po.register_value("min-segment-length", 0.1,
                                           "Minimum segment length "
                                           "in seconds")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    feats = RandomAccessTableReader("matrix", po.get_arg(1))
    writer = TableWriter("matrix", po.get_arg(3))
    n = skipped = 0
    with open(po.get_arg(2)) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 4:
                continue
            seg, utt, t0, t1 = parts[0], parts[1], float(parts[2]), \
                float(parts[3])
            if t1 - t0 < min_segment_length[0] or utt not in feats:
                skipped += 1
                continue
            mat = feats[utt]
            i0 = int(round(t0 / frame_shift[0]))
            i1 = min(int(round(t1 / frame_shift[0])), len(mat))
            if i1 <= i0:
                skipped += 1
                continue
            writer.write(seg, mat[i0:i1])
            n += 1
    writer.close()
    log(f"extract-feature-segments: {n} segments ({skipped} skipped)")
    return 0


def compute_kaldi_pitch_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply Kaldi pitch extractor, starting from wav input.  Output "
        "is 2-dimensional features consisting of (NCCF, pitch in Hz).\n"
        "Usage: compute-kaldi-pitch-feats [options...] <wav-rspecifier> "
        "<feats-wspecifier>")
    from kaldi_tpu_torch.feat.pitch import PitchExtractionOptions, \
        compute_kaldi_pitch
    opts = PitchExtractionOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(1)):
        opts.samp_freq = float(wav.samp_freq)
        writer.write(key, compute_kaldi_pitch(wav.channel(0), opts))
        n += 1
    writer.close()
    log(f"compute-kaldi-pitch-feats: {n} utterances")
    return 0


def process_kaldi_pitch_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Post-process Kaldi pitch features, consisting of pitch and "
        "NCCF, into features suitable for input to ASR system.\n"
        "Usage: process-kaldi-pitch-feats [options...] "
        "<feat-rspecifier> <feats-wspecifier>")
    from kaldi_tpu_torch.feat.pitch import ProcessPitchOptions, process_pitch
    opts = ProcessPitchOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix",
                                            po.get_arg(1)):
        writer.write(key, process_pitch(feats, opts))
        n += 1
    writer.close()
    log(f"process-kaldi-pitch-feats: {n} utterances")
    return 0


def modify_cmvn_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Modify cepstral mean and variance normalization statistics: "
        "with --norm-vars=false, zero the variance stats so that "
        "apply-cmvn only normalizes means.\n"
        "Usage: modify-cmvn-stats [options] <in-rspecifier> "
        "<out-wspecifier>")
    norm_vars = po.register_value("norm-vars", True,
                                  "If false, zero the variance part")
    dims = po.register_value("skip-dims", "",
                             "Colon-separated dims for which to skip "
                             "normalization (set to 'none' stats)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    skip = [int(d) for d in dims[0].split(":") if d]
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, stats in SequentialTableReader("matrix",
                                            po.get_arg(1)):
        out = np.array(stats, np.float64)
        count = out[0, -1]
        if not norm_vars[0]:
            # variance row = count * 1 + mean^2-like stats that make
            # the variance exactly 1 => no variance normalization
            mean = out[0, :-1] / max(count, 1e-10)
            out[1, :-1] = count * (1.0 + mean * mean)
        for d in skip:
            if d < out.shape[1] - 1:
                out[0, d] = 0.0
                out[1, d] = count
        writer.write(key, out.astype(np.float64))
        n += 1
    writer.close()
    log(f"modify-cmvn-stats: {n} entries")
    return 0


def interpolate_pitch(argv: List[str]) -> int:
    po = ParseOptions(
        "Interpolate the pitch values over unvoiced regions (where "
        "the POV feature is below a threshold).\n"
        "Usage: interpolate-pitch [options] <feats-rspecifier> "
        "<feats-wspecifier>")
    pov_thresh = po.register_value("pov-threshold", 0.1,
                                   "POV (NCCF) threshold below which a "
                                   "frame counts as unvoiced")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix",
                                            po.get_arg(1)):
        out = np.array(feats, np.float32)
        voiced = np.abs(out[:, 0]) >= pov_thresh[0]
        if voiced.any():
            idx = np.nonzero(voiced)[0]
            out[:, 1] = np.interp(np.arange(len(out)), idx,
                                  out[idx, 1])
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"interpolate-pitch: {n} utterances")
    return 0
