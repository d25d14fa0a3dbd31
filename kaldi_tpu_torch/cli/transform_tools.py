"""The feature-transform tools that steps/train_lda_mllt.sh and
steps/train_sat.sh run (port of transform-feats, est-lda, acc-lda and
gmm-est-fmllr of `kaldi_tpu/cli/misc_tools.py`, compose-transforms of
`kaldi_tpu/cli/feat_tools.py`, gmm-acc-mllt and est-mllt of
`kaldi_tpu/cli/tail6_tools.py` and gmm-transform-means of
`kaldi_tpu/cli/tail11_tools.py`).  Same positional arguments, options
and table specifiers as the reference's; an option the reference accepts
and never reads raises when it is given another value than its default.

transform-feats applies its transforms on the card, and acc-lda,
gmm-acc-mllt and gmm-est-fmllr accumulate their float64 statistics there
(all the utterances, or a speaker's, in one pass), unless --use-gpu=no;
the Gaussian posteriors, the estimates and the compositions run on the
host, as in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm, write_am_gmm
from kaldi_tpu_torch.cli.nnet3_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.device import full_f32, resolve_device
from kaldi_tpu_torch.transform.fmllr import (FmllrDiagGmmAccs,
                                             apply_affine_transform,
                                             posterior_groups)
from kaldi_tpu_torch.transform.lda import LdaEstimate, LdaOptions
from kaldi_tpu_torch.transform.mllt import MlltAccs
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        RandomAccessTableReaderMapped,
                                        SequentialTableReader, TableWriter)


def _read_matrix(rxfilename: str) -> np.ndarray:
    return kaldi_io.read_kaldi_object(iof.read_matrix, rxfilename)


def transform_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply transform (e.g. LDA; fMLLR) to features\n"
        "Usage: transform-feats [options] (<transform-rspecifier>|<transform-rxfilename>) <feats-rspecifier> <feats-wspecifier>")
    utt2spk = po.register_value("utt2spk", "", "rspecifier for utterance to speaker map")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    device = resolve_device(_device(use_gpu[0]))
    t_arg = po.get_arg(1)
    is_table = ":" in t_arg and t_arg.split(":")[0].split(",")[0] in \
        ("ark", "scp")
    reader = (RandomAccessTableReaderMapped("matrix", t_arg, utt2spk[0])
              if is_table else None)
    global_t = None if is_table else _read_matrix(t_arg)
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        t = global_t
        if reader is not None:
            if key not in reader:
                warn(f"no transform for {key}")
                err += 1
                continue
            t = reader[key]
        D = feats.shape[1]
        if t.shape[1] == D + 1:
            out = apply_affine_transform(feats, t, device)
        elif t.shape[1] == D:
            # feats @ t^T in numpy's result type of the two
            dt = torch.float64 if np.result_type(feats, t) == np.float64 \
                else torch.float32
            with full_f32():
                out = (torch.as_tensor(feats, device=device).to(dt)
                       @ torch.as_tensor(t, device=device).to(dt).T
                       ).cpu().numpy()
        else:
            warn(f"{key}: transform shape {t.shape} vs dim {D}")
            err += 1
            continue
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"transformed {n} feature matrices ({err} errors)")
    return 0 if n else 1


def est_lda(argv: List[str]) -> int:
    po = ParseOptions("Estimate LDA transform using stats obtained with acc-lda.\n"
                      "Usage: est-lda [options] <lda-matrix-out> <lda-acc-1> <lda-acc-2> ...")
    opts = LdaOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    if opts.allow_large_dim:
        raise NotImplementedError(
            "--allow-large-dim: the reference's estimate never reads it, "
            "so only its default (false) is accepted")
    total = None
    for i in range(2, po.num_args() + 1):
        acc = kaldi_io.read_kaldi_object(
            lambda s, b: LdaEstimate.read(s, b, device="cpu"), po.get_arg(i))
        if total is None:
            total = acc
        else:
            total.add(acc)
    lda, _ = total.estimate(opts)
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_matrix(s, b, lda), po.get_arg(1))
    return 0


def acc_lda(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate LDA statistics based on pdf-ids.\n"
        "Usage: acc-lda [options] <transition-model> <features-rspecifier> "
        "<posteriors-rspecifier> <lda-acc-out>")
    rand_prune = po.register_value("rand-prune", 0.0, "Randomized pruning threshold for posteriors")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    if rand_prune[0] != 0.0:
        raise NotImplementedError(
            "--rand-prune: the reference accepts it and never reads it, "
            "so only its default (0) is accepted")
    device = resolve_device(_device(use_gpu[0]))
    tm, _am = read_am_gmm(po.get_arg(1), device="cpu")
    ali_reader = RandomAccessTableReader("int-vector", po.get_arg(3))
    xs, classes = [], []
    err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in ali_reader:
            continue
        ali = ali_reader[key]
        if len(ali) != feats.shape[0]:
            warn(f"{key}: alignment length {len(ali)} vs "
                 f"{feats.shape[0]} frames")
            err += 1
            continue
        xs.append(np.asarray(feats, np.float64))
        classes.append(tm.transition_ids_to_pdfs(ali))
    if not xs:
        warn("acc-lda: no utterance with an alignment")
        return 1
    est = LdaEstimate(tm.num_pdfs, xs[0].shape[1], device=device)
    est.accumulate_batch(np.concatenate(xs), np.concatenate(classes))
    kaldi_io.write_kaldi_object(est.write, po.get_arg(4))
    log(f"accumulated LDA stats from {len(xs)} utterances ({err} errors)")
    return 0


def gmm_est_fmllr(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate global fMLLR transforms, either per utterance or for "
        "the supplied set of speakers (spk2utt option).\n"
        "Usage: gmm-est-fmllr [options] <model-in> <feature-rspecifier> "
        "<post-rspecifier> <transform-wspecifier>")
    spk2utt = po.register_value("spk2utt", "", "rspecifier for speaker to utterance-list map")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    device = resolve_device(_device(use_gpu[0]))
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    post_reader = RandomAccessTableReader("posterior", po.get_arg(3))
    writer = TableWriter("matrix", po.get_arg(4))
    n = 0

    def estimate(key, utts_feats):
        groups = []
        for feats, post in utts_feats:
            groups.extend(posterior_groups(am, tm, feats, post))
        accs = FmllrDiagGmmAccs(utts_feats[0][0].shape[1], device=device)
        if groups:
            accs.accumulate_groups(groups)
        W, _impr = accs.update()
        writer.write(key, W)

    if spk2utt[0]:
        feat_reader = RandomAccessTableReader("matrix", po.get_arg(2))
        for spk, utts in SequentialTableReader("token-vector", spk2utt[0]):
            pairs = [(np.asarray(feat_reader[utt], np.float64),
                      post_reader[utt]) for utt in utts
                     if utt in feat_reader and utt in post_reader]
            if not pairs:
                continue
            estimate(spk, pairs)
            n += 1
    else:
        for utt, feats in SequentialTableReader("matrix", po.get_arg(2)):
            if utt not in post_reader:
                continue
            estimate(utt, [(np.asarray(feats, np.float64),
                            post_reader[utt])])
            n += 1
    writer.close()
    log(f"estimated {n} fMLLR transforms")
    return 0 if n else 1


def compose_transforms(argv: List[str]) -> int:
    po = ParseOptions(
        "Compose (affine or linear) feature transforms: C = A o B "
        "(B applies first).\n"
        "Usage: compose-transforms [options] <transform-A> "
        "<transform-B> <transform-out>")
    b_is_affine = po.register_value("b-is-affine", False,
                                    "Treat last column of B as offset "
                                    "even if A has a matching column")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1

    def read_mat(rx):
        with kaldi_io.open_input(rx) as f:
            binary = iof.init_input_stream(f)
            return iof.read_matrix(f, binary)

    A = read_mat(po.get_arg(1))
    B = read_mat(po.get_arg(2))

    def split(M):
        """(linear, offset or None) treating an extra column as
        affine offset."""
        return M[:, :-1], M[:, -1]

    if A.shape[1] == B.shape[0]:
        # both linear (or A consumes B's rows directly)
        C = A @ B
    elif A.shape[1] == B.shape[0] + 1 or b_is_affine[0]:
        Al, Ao = split(A)
        if B.shape[1] == Al.shape[1] + 1 or b_is_affine[0]:
            Bl, Bo = split(B)
            C = np.concatenate(
                [Al @ Bl, (Al @ Bo + Ao)[:, None]], axis=1)
        else:
            C = np.concatenate([Al @ B, Ao[:, None]], axis=1)
    else:
        warn(f"compose-transforms: incompatible shapes {A.shape} "
             f"{B.shape}")
        return 1
    with kaldi_io.output_stream(po.get_arg(3)) as f:
        iof.init_output_stream(f, True)
        iof.write_matrix(f, True, C.astype(np.float32))
    return 0


def gmm_acc_mllt(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate MLLT (global STC) statistics.\n"
        "Usage: gmm-acc-mllt [options] <model-in> <feats-rspecifier> "
        "<posteriors-rspecifier> <stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    device = resolve_device(_device(use_gpu[0]))
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    post_reader = RandomAccessTableReader("posterior", po.get_arg(3))
    accs = MlltAccs(am.dim, device=device)
    groups = []
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in post_reader:
            warn(f"no posteriors for {key}")
            err += 1
            continue
        # per-pdf gaussian-level accumulation
        groups.extend(posterior_groups(am, tm, np.asarray(feats, np.float64),
                                       post_reader[key]))
        n += 1
    if groups:
        accs.accumulate_groups(groups)

    def write_accs(stream, b):
        iof.write_token(stream, b, "<MlltAccs>")
        iof.write_double(stream, b, accs.beta)
        iof.write_int32(stream, b, accs.dim)
        for i in range(accs.dim):
            iof.write_matrix(stream, b, accs.G[i])
        iof.write_token(stream, b, "</MlltAccs>")

    kaldi_io.write_kaldi_object(write_accs, po.get_arg(4), binary[0])
    log(f"accumulated MLLT stats from {n} utterances ({err} errors), "
        f"beta {accs.beta:.1f}")
    return 0 if n else 1


def est_mllt(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate the MLLT (global STC) transform from stats.\n"
        "Usage: est-mllt [options] <mat-out> <stats-in1> ...")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    total = None
    for i in range(2, po.num_args() + 1):
        with kaldi_io.input_stream(po.get_arg(i)) as f:
            b = iof.init_input_stream(f)
            iof.expect_token(f, b, "<MlltAccs>")
            beta = iof.read_double(f, b)
            dim = iof.read_int32(f, b)
            acc = MlltAccs(dim, device="cpu")
            acc.beta = beta
            for d in range(dim):
                acc.G[d] = iof.read_matrix(f, b)
            iof.expect_token(f, b, "</MlltAccs>")
        if total is None:
            total = acc
        else:
            total.add(acc)
    mat, impr = total.update()
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_matrix(s, b, mat), po.get_arg(1),
        binary[0])
    log(f"estimated MLLT: objf impr/frame {impr:.4f} over "
        f"{total.beta:.1f} frames")
    return 0


def gmm_transform_means(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply a linear/affine transform to all GMM means (e.g. after "
        "est-mllt; gmm-transform-means.cc).\n"
        "Usage: gmm-transform-means [options] <transform-rxfilename> "
        "<model-in> <model-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    mat = np.asarray(_read_matrix(po.get_arg(1)), np.float64)
    tm, am = read_am_gmm(po.get_arg(2), device="cpu")
    D = am.dim
    A, b = (mat[:, :D], mat[:, D]) if mat.shape[1] == D + 1 else \
        (mat, np.zeros(D))
    for pdf in range(am.num_pdfs):
        g = am.get_pdf(pdf)
        g.set_from_means_and_vars(g.weights, g.get_means() @ A.T + b,
                                  g.get_vars())
    write_am_gmm(po.get_arg(3), tm, am, binary[0])
    log(f"transformed means of {am.num_pdfs} pdfs")
    return 0
