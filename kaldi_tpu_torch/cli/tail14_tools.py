"""Feature, CMVN and matrix tools of the reference's batch 12 (port of
those tools of `kaldi_tpu/cli/tail14_tools.py`; parity: src/featbin
append-post-to-feats.cc, process-pitch-feats.cc,
compute-cmvn-stats-two-channel.cc, copy-feats-to-sphinx.cc;
src/online2bin apply-cmvn-online.cc; src/bin matrix-max.cc,
post-to-smat.cc).  Host numpy, as in the reference.

Not carried over yet: the module's decode-faster and align-mapped.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def append_post_to_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Append posteriors (as a dense block of dim --post-dim) to "
        "feature rows (append-post-to-feats.cc).\n"
        "Usage: append-post-to-feats [options] <feats-rspecifier> "
        "<post-rspecifier> <feats-wspecifier>")
    post_dim = po.register_value(
        "post-dim", 0, "Dimensionality of the posteriors")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    if post_dim[0] <= 0:
        print("append-post-to-feats: --post-dim must be set",
              flush=True)
        return 1
    post_reader = RandomAccessTableReader("posterior", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if key not in post_reader:
            warn(f"no posteriors for {key}")
            err += 1
            continue
        post = post_reader[key]
        feats = np.asarray(feats, np.float32)
        if len(post) != feats.shape[0]:
            warn(f"{key}: posterior length {len(post)} vs "
                 f"{feats.shape[0]} frames")
            err += 1
            continue
        block = np.zeros((feats.shape[0], post_dim[0]), np.float32)
        for t, frame in enumerate(post):
            for idx, w in frame:
                block[t, int(idx)] += w
        writer.write(key, np.concatenate([feats, block], axis=1))
        n += 1
    writer.close()
    log(f"done {n} utts, errors on {err}")
    return 0 if n else 1


def apply_cmvn_online(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply online CMVN with global-stats backoff, as the online2 "
        "decoding pipeline does (apply-cmvn-online.cc); with "
        "--spk2utt, earlier utterances of the speaker prime the "
        "stats.\n"
        "Usage: apply-cmvn-online [options] <global-cmvn-stats> "
        "<feature-rspecifier> <feature-wspecifier>")
    from kaldi_tpu_torch.online.features import (OnlineCmvn, OnlineCmvnOptions,
                                           OnlineCmvnState)
    opts = OnlineCmvnOptions()
    po.register_struct(opts)
    spk2utt_rs = po.register_value(
        "spk2utt", "", "rspecifier for speaker-to-utterance-list map")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.base import io_funcs as iof

    class _MatrixFeature:
        def __init__(self, mat):
            self.mat = np.asarray(mat, np.float32)

        def dim(self):
            return self.mat.shape[1]

        def num_frames_ready(self):
            return self.mat.shape[0]

        def is_last_frame(self, t):
            return t == self.mat.shape[0] - 1

        def get_frame(self, t):
            return self.mat[t]

    global_stats = np.asarray(kaldi_io.read_kaldi_object(
        iof.read_matrix, po.get_arg(1)), np.float64)
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0

    def _normalize(feats, state):
        cmvn = OnlineCmvn(opts, state, _MatrixFeature(feats))
        out = np.stack([cmvn.get_frame(t)
                        for t in range(feats.shape[0])])
        return out, cmvn.get_state(feats.shape[0] - 1)

    if spk2utt_rs[0]:
        feat_reader = RandomAccessTableReader("matrix", po.get_arg(2))
        for spk, utts in SequentialTableReader("token-vector",
                                               spk2utt_rs[0]):
            state = OnlineCmvnState(global_cmvn_stats=global_stats)
            for utt in utts:
                if utt not in feat_reader:
                    warn(f"no features for {utt}")
                    err += 1
                    continue
                out, state = _normalize(np.asarray(feat_reader[utt]),
                                        state)
                writer.write(utt, out)
                n += 1
    else:
        for key, feats in SequentialTableReader("matrix",
                                                po.get_arg(2)):
            out, _ = _normalize(
                np.asarray(feats),
                OnlineCmvnState(global_cmvn_stats=global_stats))
            writer.write(key, out)
            n += 1
    writer.close()
    log(f"applied online CMVN to {n} utts, errors on {err}")
    return 0 if n else 1


def matrix_max(argv: List[str]) -> int:
    po = ParseOptions(
        "Element-wise max of sets of matrices, grouped by a "
        "spk2utt-like map; differing row counts crop to the smallest "
        "(matrix-max.cc).\n"
        "Usage: matrix-max <spk2utt-rspecifier> <matrix-rspecifier> "
        "<matrix-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    mat_reader = RandomAccessTableReader("matrix", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for key, utts in SequentialTableReader("token-vector",
                                           po.get_arg(1)):
        mats = []
        for utt in utts:
            if utt not in mat_reader:
                warn(f"no matrix for {utt}")
                err += 1
                continue
            mats.append(np.asarray(mat_reader[utt], np.float32))
        if not mats:
            err += 1
            continue
        rows = min(m.shape[0] for m in mats)
        out = mats[0][:rows]
        for m in mats[1:]:
            out = np.maximum(out, m[:rows])
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"computed max over {n} groups, errors on {err}")
    return 0 if n else 1


def post_to_smat(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert per-frame posteriors to a SparseMatrix archive "
        "(post-to-smat.cc; pure format transformation).\n"
        "Usage: post-to-smat [options] <posteriors-rspecifier> "
        "<sparse-matrix-wspecifier>")
    dim = po.register_value(
        "dim", -1, "num-cols of each output SparseMatrix (all "
        "posterior indexes must be >= 0 and < dim)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    if dim[0] <= 0:
        print("post-to-smat: --dim must be set", flush=True)
        return 1
    from kaldi_tpu_torch.matrix.sparse import SparseMatrix
    writer = TableWriter("sparse-matrix", po.get_arg(2))
    n = 0
    for key, post in SequentialTableReader("posterior", po.get_arg(1)):
        rows = []
        ok = True
        for frame in post:
            idx = np.asarray([int(i) for i, _ in frame], np.int32)
            val = np.asarray([float(w) for _, w in frame], np.float32)
            if idx.size and (idx.min() < 0 or idx.max() >= dim[0]):
                warn(f"{key}: posterior index out of range for "
                     f"--dim={dim[0]}")
                ok = False
                break
            order = np.argsort(idx, kind="stable")
            rows.append((idx[order], val[order]))
        if not ok:
            continue
        writer.write(key, SparseMatrix(dim[0], rows))
        n += 1
    writer.close()
    log(f"converted {n} posteriors to sparse matrices")
    return 0 if n else 1


def process_pitch_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Post-process 2-dim (pov, pitch) features for recognition "
        "(process-pitch-feats.cc): pov -> logit, pitch -> log, "
        "moving-window mean subtraction, then short moving-average "
        "smoothing.\n"
        "Usage: process-pitch-feats [options] <feats-rspecifier> "
        "<feats-wspecifier>")
    norm_win = po.register_value(
        "normalization-window-size", 151,
        "Size of window for moving-window normalization (odd)")
    avg_win = po.register_value(
        "average-window-size", 5,
        "Size of moving average window (odd)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    if norm_win[0] % 2 == 0 or avg_win[0] % 2 == 0:
        print("process-pitch-feats: window sizes must be odd",
              flush=True)
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        f = np.asarray(feats, np.float64).copy()
        if f.shape[1] != 2:
            warn(f"{key}: expected 2-dim (pov, pitch) features, got "
                 f"dim {f.shape[1]}")
            continue
        T = f.shape[0]
        # pov logit: p -> log((p + 1e-4) / (1.0001 - p))
        f[:, 0] = np.log((f[:, 0] + 1e-4) / (1.0001 - f[:, 0]))
        f[:, 1] = np.log(f[:, 1])
        # moving-window mean subtraction: the reference keeps the
        # initial mean (over the first min(T, W) frames) for
        # t <= mid, then slides by replacing the frame leaving the
        # window with the one entering, freezing once the window
        # would run past the end
        W, mid = norm_win[0], (norm_win[0] - 1) // 2
        p = f[:, 1].copy()
        mean0 = p[:min(T, W)].mean()
        if T <= W:
            f[:, 1] -= mean0
        else:
            means = np.full(T, mean0)
            i = np.arange(mid + 1, T)
            delta = np.where(i + mid + 1 < T,
                             (p[np.minimum(i + mid + 1, T - 1)]
                              - p[i - mid - 1]) / W, 0.0)
            means[mid + 1:] = mean0 + np.cumsum(delta)
            f[:, 1] -= means
        # short moving average over the interior frames
        w = (avg_win[0] - 1) // 2
        if T > 2 * w:
            sm = f[:, 1].copy()
            acc = np.zeros(T - 2 * w)
            for j in range(-w, w + 1):
                acc += sm[w + j:T - w + j]
            f[w:T - w, 1] = acc / (2 * w + 1)
        writer.write(key, f.astype(np.float32))
        n += 1
    writer.close()
    log(f"post-processed pitch for {n} utterances")
    return 0 if n else 1


def compute_cmvn_stats_two_channel(argv: List[str]) -> int:
    po = ParseOptions(
        "CMVN stats for two-sided telephone data: per frame, the "
        "louder channel (by feature 0) gets weight 1, the quieter "
        "--quieter-channel-weight "
        "(compute-cmvn-stats-two-channel.cc).\n"
        "Usage: compute-cmvn-stats-two-channel [options] "
        "<reco2file-and-channel> <feats-rspecifier> "
        "<stats-wspecifier>")
    quieter = po.register_value(
        "quieter-channel-weight", 0.01,
        "Stats weight for the quieter channel")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.functions import acc_cmvn_stats
    # group utterances into A/B pairs by call-id
    call_to_utts: dict = {}
    with kaldi_io.input_stream(po.get_arg(1)) as f:
        for raw in f.read().decode().splitlines():
            parts = raw.split()
            if not parts:
                continue
            if len(parts) != 3:
                print(f"compute-cmvn-stats-two-channel: expected 3 "
                      f"fields, got: {raw!r}", flush=True)
                return 1
            call_to_utts.setdefault(parts[1], []).append(parts[0])
    pairs = []
    for call in call_to_utts:
        utts = call_to_utts[call]
        if len(utts) == 2:
            pairs.append(utts)
        else:
            warn(f"call {call} has {len(utts)} utterances, expected "
                 "two; treating them singly")
            pairs.extend([u] for u in utts)
    feat_reader = RandomAccessTableReader("matrix", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for pair in pairs:
        feats = []
        for utt in pair:
            if utt not in feat_reader:
                warn(f"no features for {utt}")
                feats.append(None)
            else:
                feats.append(np.asarray(feat_reader[utt], np.float32))
        if len(pair) == 2 and feats[0] is not None \
                and feats[1] is not None \
                and feats[0].shape[0] == feats[1].shape[0]:
            louder0 = feats[0][:, 0] > feats[1][:, 0]
            w0 = np.where(louder0, 1.0, quieter[0])
            w1 = np.where(louder0, quieter[0], 1.0)
            writer.write(pair[0], acc_cmvn_stats(feats[0], w0))
            writer.write(pair[1], acc_cmvn_stats(feats[1], w1))
            n += 2
        else:
            if len(pair) == 2 and feats[0] is not None \
                    and feats[1] is not None:
                warn(f"frame counts differ between {pair[0]} and "
                     f"{pair[1]}; treating separately")
            for utt, f in zip(pair, feats):
                if f is None:
                    err += 1
                    continue
                writer.write(utt, acc_cmvn_stats(f))
                n += 1
    writer.close()
    log(f"wrote two-channel CMVN stats for {n} utts, errors on {err}")
    return 0 if n else 1


def copy_feats_to_sphinx(argv: List[str]) -> int:
    po = ParseOptions(
        "Write each utterance's features as a CMUSphinx .mfc file "
        "(copy-feats-to-sphinx.cc: int32 float-count header then "
        "little-endian float32 data).\n"
        "Usage: copy-feats-to-sphinx [options] <feats-rspecifier>")
    out_dir = po.register_value("output-dir", "./", "Output directory")
    out_ext = po.register_value("output-ext", "mfc",
                                "Output extension of sphinx files")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    os.makedirs(out_dir[0], exist_ok=True)
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        feats = np.asarray(feats, "<f4")
        path = os.path.join(out_dir[0], f"{key}.{out_ext[0]}")
        with open(path, "wb") as f:
            f.write(np.int32(feats.size).tobytes())
            f.write(feats.tobytes())
        n += 1
    log(f"{n} sphinx feature files generated in {out_dir[0]}")
    return 0 if n else 1
