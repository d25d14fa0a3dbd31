"""The i-vector tool chain: global UBMs (diagonal and full-covariance),
Gaussian selection, the i-vector extractor's training ladder, offline and
online extraction, VAD, and the PLDA speaker back end.  Ports of the
reference package's tools, with the same positional arguments, options
and table specifiers:

  kaldi_tpu/cli/gmm_tools.py: gmm-global-init-from-feats (:461),
    gmm-global-acc-stats (:504), gmm-global-est (:526),
    gmm-global-to-fgmm (:551), fgmm-global-acc-stats (:567),
    fgmm-global-est (:593);
  kaldi_tpu/cli/tail6_tools.py: gmm-gselect (:137), fgmm-gselect (:141),
    gmm-global-get-post (:145), gmm-global-info (:199),
    fgmm-global-info (:203), fgmm-global-copy (:207);
  kaldi_tpu/cli/tail10_tools.py: gmm-global-sum-accs (:21),
    gmm-global-copy (:44), gmm-global-get-frame-likes (:59),
    fgmm-global-sum-accs (:127), fgmm-global-to-gmm (:152),
    copy-gselect (:170);
  kaldi_tpu/cli/tail11_tools.py: fgmm-global-get-frame-likes (:264);
  kaldi_tpu/cli/tail12_tools.py: gmm-global-gselect-to-post (:204),
    fgmm-global-gselect-to-post (:209), fgmm-global-acc-stats-post
    (:214), ivector-extractor-copy (:253), ivector-randomize (:270);
  kaldi_tpu/cli/fmpe2_tools.py: fgmm-global-merge (:284),
    fgmm-global-init-from-accs (:319);
  kaldi_tpu/cli/tail5_tools.py: transform-vec (:274),
    select-voiced-frames (:372), merge-vads (:403),
    compute-vad-from-frame-likes (:437), ivector-extractor-init (:689),
    ivector-extractor-acc-stats (:722), ivector-extractor-sum-accs (:746),
    ivector-extractor-est (:769), ivector-compute-lda (:792),
    ivector-transform (:834);
  kaldi_tpu/cli/misc_tools.py: compute-vad (:174), ivector-extract
    (:191), ivector-compute-plda (:212), ivector-plda-scoring (:755),
    ivector-mean (:826);
  kaldi_tpu/cli/tail3_tools.py: compute-eer (:29),
    ivector-subtract-global-mean (:129), ivector-normalize-length (:169),
    ivector-plda-scoring-dense (:250);
  kaldi_tpu/cli/tail9_tools.py: ivector-adapt-plda (:19),
    ivector-copy-plda (:52), ivector-compute-dot-products (:74),
    ivector-extract-online (:169);
  kaldi_tpu/cli/latrnnlm_tools.py: ivector-extract-online2 (:428);
  kaldi_tpu/cli/tail7_tools.py: logistic-regression-train (:18),
    logistic-regression-eval (:57), logistic-regression-copy (:85);
  kaldi_tpu/cli/tail3_tools.py: agglomerative-cluster (:202).

The tools that work on frames or on the extractor run on the card unless
--use-gpu=no: the UBMs' scores, posteriors and statistics (float32 scores
for a diagonal UBM and float64 for a full one, as the reference computes
them; float64 statistics), Gaussian selection, the extractor's E-step and
M-step and the extraction (float64, batched over the utterances), the
LDA statistics, and the logistic regression's training (float32).  The
model updates of the GMMs, the file copies and sums, VAD, the PLDA back
end (i-vector-sized matrices) and the agglomerative clustering are host
numpy, as in the reference.

Kept from the reference package rather than upstream Kaldi: a FullGmm
file stores each inverse covariance as a full matrix, the fgmm stats
files are npz containers, ivector-extract computes its own posteriors
(3 arguments), and ivector-compute-plda is the two-covariance estimate.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.online_tools2 import (register_use_gpu,
                                               use_gpu_device)
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import (AccumFullGmm, FullGmm,
                                          MleFullGmmOptions,
                                          mle_full_gmm_update)
from kaldi_tpu_torch.gmm.mle import (AccumDiagGmm, MleDiagGmmOptions,
                                     mle_diag_gmm_update)
from kaldi_tpu_torch.gmm.ubm import UbmScorer, init_diag_ubm
from kaldi_tpu_torch.ivector.cluster import agglomerative_cluster
from kaldi_tpu_torch.ivector.extractor import (ExtractorOnDevice,
                                               IvectorExtractor,
                                               IvectorExtractorStats)
from kaldi_tpu_torch.ivector.logistic_regression import (
    LogisticRegression, LogisticRegressionConfig, train_logistic_regression)
from kaldi_tpu_torch.ivector.plda import Plda, train_plda
from kaldi_tpu_torch.ivector.vad import VadEnergyOptions, compute_vad_energy
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


# the tools that take --use-gpu
DEVICE_TOOLS = (
    "gmm-global-init-from-feats", "gmm-global-acc-stats",
    "fgmm-global-acc-stats", "gmm-gselect", "fgmm-gselect",
    "gmm-global-get-post", "gmm-global-get-frame-likes",
    "fgmm-global-get-frame-likes", "gmm-global-gselect-to-post",
    "fgmm-global-gselect-to-post", "fgmm-global-acc-stats-post",
    "ivector-extractor-acc-stats", "ivector-extractor-est",
    "ivector-extract", "ivector-extract-online", "ivector-extract-online2",
    "ivector-compute-lda", "logistic-regression-train")


def _read_feats(rspecifier: str) -> Tuple[List[str], List[np.ndarray]]:
    keys, feats = [], []
    for key, m in SequentialTableReader("matrix", rspecifier):
        keys.append(key)
        feats.append(np.asarray(m))
    return keys, feats


def _read_diag(path: str) -> DiagGmm:
    return kaldi_io.read_kaldi_object(DiagGmm.read, path)


def _read_full(path: str) -> FullGmm:
    return kaldi_io.read_kaldi_object(FullGmm.read, path)


def _read_full_accs(path: str) -> AccumFullGmm:
    with kaldi_io.input_stream(path) as f:
        return AccumFullGmm.read_npz(f)


def _write_full_accs(path: str, acc: AccumFullGmm) -> None:
    with kaldi_io.output_stream(path) as f:
        acc.write_npz(f)


def _log_likes(scorer: UbmScorer, feats) -> np.ndarray:
    """(T, M) component log-likelihoods of host frames, in the scorer's
    dtype, back on the host."""
    return scorer.log_likes(scorer.frames(
        np.asarray(feats, np.float32))).cpu().numpy()


# ---------------------------------------------------------------------------
# diagonal and full-covariance UBMs


def gmm_global_init_from_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize a single diagonal GMM from features (for UBM init)\n"
        "Usage: gmm-global-init-from-feats [options] "
        "<feature-rspecifier> <model-out>")
    num_gauss = po.register_value("num-gauss", 100, "Number of Gaussians")
    num_iters = po.register_value("num-iters", 4, "Number of EM iterations on the init sample")
    num_frames = po.register_value("num-frames", 200000, "Maximum frames to sample")
    srand = po.register_value("srand", 0, "Random seed")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    dev = use_gpu_device(use_gpu[0])
    rows = []
    total = 0
    for _key, m in SequentialTableReader("matrix", po.get_arg(1)):
        rows.append(m)
        total += m.shape[0]
        if total >= num_frames[0]:
            break
    feats = np.concatenate(rows)[: num_frames[0]]
    gmm, avg = init_diag_ubm(feats, num_gauss[0], num_iters[0], srand[0],
                             dev)
    for it, ll in enumerate(avg):
        log(f"init iter {it}: avg loglike {ll:.4f}")
    kaldi_io.write_kaldi_object(gmm.write, po.get_arg(2))
    return 0


def gmm_global_acc_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate stats for a single diagonal GMM\n"
        "Usage: gmm-global-acc-stats [options] <model-in> "
        "<feature-rspecifier> <stats-out>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    gmm = _read_diag(po.get_arg(1))
    acc = AccumDiagGmm(gmm.num_gauss, gmm.dim)
    _, feats = _read_feats(po.get_arg(2))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    like, n = acc.accumulate_device(scorer, feats)
    log(f"accumulated over {n} frames, avg loglike {like / max(n,1):.4f}")
    kaldi_io.write_kaldi_object(acc.write, po.get_arg(3))
    return 0


def gmm_global_est(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate a single diagonal GMM from stats\n"
        "Usage: gmm-global-est [options] <model-in> <stats-in> <model-out>")
    opts = MleDiagGmmOptions()
    po.register_struct(opts)
    mix_up = po.register_value("mix-up", 0, "Target number of Gaussians to mix up to")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    gmm = _read_diag(po.get_arg(1))
    acc = kaldi_io.read_kaldi_object(AccumDiagGmm.read, po.get_arg(2))
    mle_diag_gmm_update(opts, acc, gmm)
    if mix_up[0] > gmm.num_gauss:
        gmm.split(mix_up[0])
    kaldi_io.write_kaldi_object(gmm.write, po.get_arg(3))
    log(f"estimated global GMM with {gmm.num_gauss} gaussians")
    return 0


def gmm_global_to_fgmm(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert a single diagonal GMM to a full-covariance GMM\n"
        "Usage: gmm-global-to-fgmm <model-in> <fgmm-out>")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    gmm = _read_diag(po.get_arg(1))
    kaldi_io.write_kaldi_object(FullGmm.from_diag(gmm).write,
                                po.get_arg(2))
    return 0


def fgmm_global_acc_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate stats for a full-covariance GMM\n"
        "Usage: fgmm-global-acc-stats [options] <model-in> "
        "<feature-rspecifier> <stats-out>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    fgmm = _read_full(po.get_arg(1))
    acc = AccumFullGmm(fgmm.num_gauss, fgmm.dim)
    _, feats = _read_feats(po.get_arg(2))
    scorer = UbmScorer(fgmm, use_gpu_device(use_gpu[0]))
    like, n = acc.accumulate_device(scorer, feats)
    log(f"accumulated over {n} frames, avg loglike {like / max(n,1):.4f}")
    _write_full_accs(po.get_arg(3), acc)
    return 0


def fgmm_global_est(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate a full-covariance GMM from stats\n"
        "Usage: fgmm-global-est [options] <model-in> <stats-in> "
        "<model-out>")
    opts = MleFullGmmOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    fgmm = _read_full(po.get_arg(1))
    acc = _read_full_accs(po.get_arg(2))
    mle_full_gmm_update(opts, acc, fgmm)
    kaldi_io.write_kaldi_object(fgmm.write, po.get_arg(3))
    return 0


def _sum_tool(argv: List[str], usage: str, read_fn) -> int:
    po = ParseOptions(usage)
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    total = None
    for i in range(2, po.num_args() + 1):
        acc = kaldi_io.read_kaldi_object(read_fn, po.get_arg(i))
        if total is None:
            total = acc
        else:
            total.add(acc)
    kaldi_io.write_kaldi_object(total.write, po.get_arg(1), binary[0])
    return 0


def gmm_global_sum_accs(argv: List[str]) -> int:
    return _sum_tool(argv, "Sum stats for a single diagonal GMM.\n"
                     "Usage: gmm-global-sum-accs [options] <stats-out> "
                     "<stats-in1> <stats-in2> ...", AccumDiagGmm.read)


def fgmm_global_sum_accs(argv: List[str]) -> int:
    po = ParseOptions(
        "Sum stats for a full-covariance GMM (npz container, matching "
        "fgmm-global-acc-stats).\n"
        "Usage: fgmm-global-sum-accs <stats-out> <stats-in1> ...")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    tot = None
    for i in range(2, po.num_args() + 1):
        with kaldi_io.input_stream(po.get_arg(i)) as f:
            data = np.load(f)
            cur = {k: data[k] for k in data.files}
        if tot is None:
            tot = cur
        else:
            for k in tot:
                tot[k] = tot[k] + cur[k]
    with kaldi_io.output_stream(po.get_arg(1)) as f:
        np.savez(f, **tot)
    return 0


def _copy_tool(argv: List[str], usage: str, read_fn) -> int:
    po = ParseOptions(usage)
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    obj = kaldi_io.read_kaldi_object(read_fn, po.get_arg(1))
    kaldi_io.write_kaldi_object(obj.write, po.get_arg(2), binary[0])
    return 0


def gmm_global_copy(argv: List[str]) -> int:
    return _copy_tool(argv, "Copy a single diagonal GMM (possibly changing "
                      "format).\nUsage: gmm-global-copy [options] "
                      "<model-in> <model-out>", DiagGmm.read)


def fgmm_global_copy(argv: List[str]) -> int:
    return _copy_tool(argv, "Copy a full-covariance GMM (possibly changing "
                      "format).\nUsage: fgmm-global-copy [options] "
                      "<model-in> <model-out>", FullGmm.read)


def ivector_extractor_copy(argv: List[str]) -> int:
    return _copy_tool(argv, "Copy an i-vector extractor (possibly changing "
                      "format).\nUsage: ivector-extractor-copy [options] "
                      "<extractor-in> <extractor-out>", IvectorExtractor.read)


def fgmm_global_to_gmm(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert a full-covariance GMM to diagonal "
        "(fgmm-global-to-gmm.cc).\n"
        "Usage: fgmm-global-to-gmm [options] <fgmm-in> <gmm-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    fgmm = _read_full(po.get_arg(1))
    kaldi_io.write_kaldi_object(fgmm.to_diag().write, po.get_arg(2),
                                binary[0])
    return 0


def _global_info(argv: List[str], name: str, full: bool) -> int:
    po = ParseOptions(
        f"Print info about a global GMM.\nUsage: {name} <model-in>")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    gmm = (_read_full if full else _read_diag)(po.get_arg(1))
    print(f"number of gaussians {gmm.num_gauss}")
    print(f"feature dimension {gmm.dim}")
    return 0


def gmm_global_info(argv: List[str]) -> int:
    return _global_info(argv, "gmm-global-info", full=False)


def fgmm_global_info(argv: List[str]) -> int:
    return _global_info(argv, "fgmm-global-info", full=True)


def fgmm_global_merge(argv: List[str]) -> int:
    po = ParseOptions(
        "Concatenate full-covariance GMMs into one, weights "
        "proportional to each input's #Gauss; writes the sizes file "
        "(fgmm-global-merge.cc).\n"
        "Usage: fgmm-global-merge [options] <fgmm-out> "
        "<sizes-file-out> <fgmm-in1> <fgmm-in2> ...")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    gmms = [_read_full(po.get_arg(i)) for i in range(3, po.num_args() + 1)]
    total = sum(g.num_gauss for g in gmms)
    weights, means, covars, sizes = [], [], [], []
    for g in gmms:
        scale = g.num_gauss / total
        weights.append(np.asarray(g.weights) * scale)
        means.append(g.get_means())
        covars.append(g.get_covars())
        sizes.append(g.num_gauss)
    out = FullGmm(total, gmms[0].dim)
    out.set_from_means_and_covars(np.concatenate(weights),
                                  np.concatenate(means),
                                  np.concatenate(covars))
    out.compute_gconsts()
    kaldi_io.write_kaldi_object(out.write, po.get_arg(1), binary[0])
    with open(po.get_arg(2), "w") as f:
        f.write(" ".join(str(s) for s in sizes) + "\n")
    log(f"merged {len(gmms)} full GMMs into {total} gaussians")
    return 0


def fgmm_global_init_from_accs(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize a full-covariance GMM directly from accumulated "
        "stats (fgmm-global-init-from-accs.cc).\n"
        "Usage: fgmm-global-init-from-accs [options] <stats-in> "
        "<number-of-components> <model-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    variance_floor = po.register_value(
        "variance-floor", 0.001, "Covariance eigenvalue floor")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    acc = _read_full_accs(po.get_arg(1))
    occ = np.asarray(acc.occupancy, np.float64)
    mean_accs = np.asarray(acc.mean_accs, np.float64)
    covar_accs = np.asarray(acc.covar_accs, np.float64)
    want = int(po.get_arg(2))
    if want != occ.shape[0]:
        print(f"fgmm-global-init-from-accs: stats have "
              f"{occ.shape[0]} components, requested {want}",
              flush=True)
        return 1
    keep = occ > 0
    occ_safe = np.maximum(occ, 1e-10)
    means = mean_accs / occ_safe[:, None]
    covars = covar_accs / occ_safe[:, None, None] \
        - np.einsum("md,me->mde", means, means)
    D = means.shape[1]
    for m in range(covars.shape[0]):
        w, v = np.linalg.eigh(covars[m])
        w = np.maximum(w, variance_floor[0])
        covars[m] = (v * w) @ v.T
    gmm = FullGmm(int(keep.sum()), D)
    gmm.set_from_means_and_covars(occ[keep] / occ[keep].sum(),
                                  means[keep], covars[keep])
    gmm.compute_gconsts()
    kaldi_io.write_kaldi_object(gmm.write, po.get_arg(3), binary[0])
    log(f"initialized full GMM with {gmm.num_gauss} components "
        "from stats")
    return 0


# ---------------------------------------------------------------------------
# frame scores, Gaussian selection and posteriors


def _frame_likes(argv: List[str], name: str, full: bool) -> int:
    po = ParseOptions(
        f"Per-frame log-likelihoods under a global "
        f"{'full-covariance' if full else 'diagonal'} GMM ({name}.cc; "
        "--average writes one float per utterance instead).\n"
        f"Usage: {name} [options] <model-in> <feats-rspecifier> "
        "<likes-wspecifier>")
    average = po.register_value("average", False,
                                "Write per-utterance averages")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    gmm = (_read_full if full else _read_diag)(po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    writer = TableWriter("float" if average[0] else "vector",
                         po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        ll = scorer.log_likelihood(scorer.frames(
            np.asarray(feats, np.float32))).cpu().numpy()
        writer.write(key, float(np.mean(ll)) if average[0]
                     else np.asarray(ll, np.float32))
        n += 1
    writer.close()
    log(f"frame likes for {n} utterances")
    return 0 if n else 1


def gmm_global_get_frame_likes(argv: List[str]) -> int:
    return _frame_likes(argv, "gmm-global-get-frame-likes", full=False)


def fgmm_global_get_frame_likes(argv: List[str]) -> int:
    return _frame_likes(argv, "fgmm-global-get-frame-likes", full=True)


def _top_n(ll: np.ndarray, k: int) -> np.ndarray:
    """Each row's k best columns by decreasing value (the reference's
    argpartition, then a stable sort)."""
    kk = min(k, ll.shape[1])
    idx = np.argpartition(-ll, kk - 1, axis=1)[:, :kk]
    row = np.take_along_axis(ll, idx, axis=1)
    order = np.argsort(-row, axis=1, kind="stable")
    return np.take_along_axis(idx, order, axis=1)


def _gselect(argv: List[str], name: str, full: bool) -> int:
    po = ParseOptions(
        f"Precompute top-N Gaussian indices per frame ({name}).\n"
        f"Usage: {name} [options] <model-in> <feats-rspecifier> "
        "<gselect-wspecifier>")
    n_sel = po.register_value("n", 50, "Number of Gaussians to select")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    gmm = (_read_full if full else _read_diag)(po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    writer = TableWriter("int-vector-vector", po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        idx = _top_n(_log_likes(scorer, feats), n_sel[0])
        writer.write(key, [r.tolist() for r in idx])
        n += 1
    writer.close()
    log(f"{name}: wrote gselect for {n} utterances (n={n_sel[0]})")
    return 0 if n else 1


def gmm_gselect(argv: List[str]) -> int:
    return _gselect(argv, "gmm-gselect", full=False)


def fgmm_gselect(argv: List[str]) -> int:
    return _gselect(argv, "fgmm-gselect", full=True)


def copy_gselect(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy Gaussian-selection indices, optionally limiting to the "
        "first n per frame (copy-gselect.cc).\n"
        "Usage: copy-gselect [options] <gselect-rspecifier> "
        "<gselect-wspecifier>")
    n_keep = po.register_value("n", 0, "Keep only the best n "
                               "(0 = all; input order is best-first)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("int-vector-vector", po.get_arg(2))
    n = 0
    for key, gsel in SequentialTableReader("int-vector-vector",
                                           po.get_arg(1)):
        if n_keep[0] > 0:
            gsel = [row[:n_keep[0]] for row in gsel]
        writer.write(key, gsel)
        n += 1
    writer.close()
    log(f"copied gselect for {n} utterances")
    return 0 if n else 1


def gmm_global_get_post(argv: List[str]) -> int:
    po = ParseOptions(
        "Per-frame top-N Gaussian posteriors from a global diagonal "
        "GMM.\n"
        "Usage: gmm-global-get-post [options] <model-in> "
        "<feats-rspecifier> <post-wspecifier>")
    n_sel = po.register_value("n", 50, "Posterior entries per frame")
    min_post = po.register_value("min-post", 0.0,
                                 "Prune posteriors below this")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    scorer = UbmScorer(_read_diag(po.get_arg(1)), use_gpu_device(use_gpu[0]))
    writer = TableWriter("posterior", po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        post = scorer.posteriors(scorer.frames(feats)).cpu().numpy()
        out = []
        for row, idx in zip(post, _top_n(post, n_sel[0])):
            sel = [(int(i), float(row[i])) for i in idx
                   if row[i] > min_post[0]]
            s = sum(p for _, p in sel)
            if s > 0:
                sel = [(i, p / s) for i, p in sel]
            out.append(sel)
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"wrote posteriors for {n} utterances")
    return 0 if n else 1


def _gselect_to_post(argv: List[str], name: str, full: bool) -> int:
    po = ParseOptions(
        f"Posteriors restricted to preselected Gaussians ({name}; "
        "the i-vector pipeline's pruned E-step).\n"
        f"Usage: {name} [options] <model-in> <feats-rspecifier> "
        "<gselect-rspecifier> <post-wspecifier>")
    min_post = po.register_value("min-post", 0.0,
                                 "Prune posteriors below this")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    gmm = (_read_full if full else _read_diag)(po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    gsel_reader = RandomAccessTableReader("int-vector-vector",
                                          po.get_arg(3))
    writer = TableWriter("posterior", po.get_arg(4))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in gsel_reader:
            warn(f"no gselect for {key}")
            err += 1
            continue
        comp = _log_likes(scorer, feats)
        out = []
        for t, row in enumerate(gsel_reader[key]):
            idx = np.asarray(list(row), np.int64)
            ll = comp[t, idx]
            p = np.exp(ll - ll.max())
            p /= p.sum()
            out.append([(int(i), float(pi)) for i, pi in zip(idx, p)
                        if pi > min_post[0]])
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"{name}: posteriors for {n} utterances ({err} errors)")
    return 0 if n else 1


def gmm_global_gselect_to_post(argv: List[str]) -> int:
    return _gselect_to_post(argv, "gmm-global-gselect-to-post", full=False)


def fgmm_global_gselect_to_post(argv: List[str]) -> int:
    return _gselect_to_post(argv, "fgmm-global-gselect-to-post", full=True)


def fgmm_global_acc_stats_post(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate full-covariance GMM stats from precomputed "
        "posteriors (fgmm-global-acc-stats-post.cc; the UBM stage of "
        "the i-vector pipeline).\n"
        "Usage: fgmm-global-acc-stats-post [options] <model-in> "
        "<post-rspecifier> <feats-rspecifier> <stats-out>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    dev = use_gpu_device(use_gpu[0])
    fgmm = _read_full(po.get_arg(1))
    post_reader = RandomAccessTableReader("posterior", po.get_arg(2))
    acc = AccumFullGmm(fgmm.num_gauss, fgmm.dim)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
        if key not in post_reader:
            warn(f"no posteriors for {key}")
            err += 1
            continue
        post = post_reader[key]
        T = min(len(post), feats.shape[0])
        dense = np.zeros((T, fgmm.num_gauss))
        for t in range(T):
            for gi, w in post[t]:
                dense[t, gi] = w
        acc.accumulate_tensors(
            torch.from_numpy(np.asarray(feats[:T], np.float64)).to(dev),
            torch.from_numpy(dense).to(dev))
        n += 1
    _write_full_accs(po.get_arg(4), acc)
    log(f"accumulated posterior stats from {n} utterances "
        f"({err} errors)")
    return 0 if n else 1


# ---------------------------------------------------------------------------
# the extractor


def ivector_extractor_init(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize an i-vector extractor from a (diag or full) UBM.\n"
        "Usage: ivector-extractor-init [options] <ubm-in> "
        "<extractor-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    ivector_dim = po.register_value("ivector-dim", 100,
                                    "Dimension of iVector")
    prior_offset = po.register_value(
        "prior-offset", 100.0, "Offset of the prior's mean in dim 0")
    full = po.register_value(
        "use-full-ubm", False, "Read the UBM as full-covariance "
        "(fgmm-global)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    ubm = (_read_full if full[0] else _read_diag)(po.get_arg(1))
    ex = IvectorExtractor(ubm, ivector_dim[0], prior_offset[0])
    kaldi_io.write_kaldi_object(ex.write, po.get_arg(2), binary[0])
    log(f"initialized extractor: {ex.num_gauss} gaussians, dim "
        f"{ex.dim}, ivector-dim {ex.R}")
    return 0


def ivector_extractor_acc_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate i-vector extractor training stats.\n"
        "Usage: ivector-extractor-acc-stats [options] <extractor-in> "
        "<feats-rspecifier> <stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, po.get_arg(1))
    on = ExtractorOnDevice(ex, use_gpu_device(use_gpu[0]))
    stats = IvectorExtractorStats(ex)
    _, feats = _read_feats(po.get_arg(2))
    for i in range(0, len(feats), 256):
        stats.acc_device(on, feats[i:i + 256])
    kaldi_io.write_kaldi_object(stats.write, po.get_arg(3), binary[0])
    log(f"accumulated extractor stats from {len(feats)} utterances")
    return 0 if feats else 1


def ivector_extractor_sum_accs(argv: List[str]) -> int:
    return _sum_tool(argv, "Sum i-vector extractor stats.\n"
                     "Usage: ivector-extractor-sum-accs <stats-out> "
                     "<stats-in1> ...", IvectorExtractorStats.read)


def ivector_extractor_est(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply the M-step to an i-vector extractor from stats.\n"
        "Usage: ivector-extractor-est [options] <extractor-in> "
        "<stats-in> <extractor-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, po.get_arg(1))
    stats = kaldi_io.read_kaldi_object(IvectorExtractorStats.read,
                                       po.get_arg(2))
    stats.update(ex, use_gpu_device(use_gpu[0]))
    kaldi_io.write_kaldi_object(ex.write, po.get_arg(3), binary[0])
    log(f"re-estimated extractor from {stats.num_utts} utterances "
        "of stats")
    return 0


def ivector_randomize(argv: List[str]) -> int:
    po = ParseOptions(
        "Randomize rows of online-ivector matrices: each row is kept "
        "or replaced by a LATER row with probability "
        "--randomize-prob (ivector-randomize.cc).\n"
        "Usage: ivector-randomize [options] <ivector-rspecifier> "
        "<ivector-wspecifier>")
    prob = po.register_value("randomize-prob", 0.5,
                             "Replacement probability")
    seed = po.register_value("srand", 0, "Random seed")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    rng = np.random.default_rng(seed[0])
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, mat in SequentialTableReader("matrix", po.get_arg(1)):
        m = np.asarray(mat).copy()
        T = m.shape[0]
        for t in range(T - 1):
            if rng.random() < prob[0]:
                m[t] = m[int(rng.integers(t, T))]
        writer.write(key, m)
        n += 1
    writer.close()
    log(f"randomized online ivectors for {n} utterances")
    return 0 if n else 1


# ---------------------------------------------------------------------------
# extraction


def ivector_extract(argv: List[str]) -> int:
    po = ParseOptions(
        "Extract iVectors for utterances\n"
        "Usage: ivector-extract [options] <model-in> <feature-rspecifier> "
        "<ivector-wspecifier>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, po.get_arg(1))
    on = ExtractorOnDevice(ex, use_gpu_device(use_gpu[0]))
    keys, feats = _read_feats(po.get_arg(2))
    writer = TableWriter("vector", po.get_arg(3))
    for i in range(0, len(feats), 256):
        ivs = on.extract(feats[i:i + 256], remove_offset=True)
        for key, iv in zip(keys[i:i + 256], ivs):
            writer.write(key, iv)
    writer.close()
    log(f"extracted {len(keys)} ivectors")
    return 0


def ivector_extract_online(argv: List[str]) -> int:
    po = ParseOptions(
        "Extract i-vectors ONLINE: one row per --ivector-period "
        "frames, each the MAP estimate from all frames seen so far "
        "(ivector-extract-online.cc; the value a streaming decoder "
        "would have had at that point).\n"
        "Usage: ivector-extract-online [options] <extractor-in> "
        "<feats-rspecifier> <ivector-matrix-wspecifier>")
    period = po.register_value("ivector-period", 10,
                               "Frames between outputs")
    max_count = po.register_value(
        "max-count", 0.0, "Soft cap on the stats count (0 = none)")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, po.get_arg(1))
    on = ExtractorOnDevice(ex, use_gpu_device(use_gpu[0]))
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if feats.shape[0] == 0:
            continue
        rows = on.online_rows([feats], period[0], max_count[0])[0]
        writer.write(key, rows.astype(np.float32))
        n += 1
    writer.close()
    log(f"online i-vectors for {n} utterances (period {period[0]})")
    return 0 if n else 1


def ivector_extract_online2(argv: List[str]) -> int:
    po = ParseOptions(
        "Extract online i-vectors with speaker carry-over: the "
        "spk2utt map primes each utterance with the speaker's "
        "accumulated stats, as the online2 decoding pipeline does "
        "(ivector-extract-online2.cc).\n"
        "Usage: ivector-extract-online2 [options] <spk2utt-rspecifier> "
        "<extractor-in> <feats-rspecifier> <ivector-wspecifier>")
    period = po.register_value("ivector-period", 10,
                               "Frames between i-vector outputs")
    max_count = po.register_value(
        "max-count", 0.0, "Soft cap on the stats count (0 = none)")
    repeat = po.register_value(
        "repeat", False,
        "If true, output one row per frame instead of per period")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, po.get_arg(2))
    on = ExtractorOnDevice(ex, use_gpu_device(use_gpu[0]))
    feats_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    writer = TableWriter("matrix", po.get_arg(4))
    step = 1 if repeat[0] else period[0]
    n = 0
    for spk, utts in SequentialTableReader("token-vector", po.get_arg(1)):
        have = []
        for u in utts:
            if u not in feats_reader:
                warn(f"no features for {u}")
                continue
            have.append(u)
        feats = [np.asarray(feats_reader[u]) for u in have]
        rows = on.online_rows(feats, step, max_count[0], carry=True)
        for u, f, r in zip(have, feats, rows):
            if f.shape[0] == 0:
                warn(f"no frames for {u}")
                continue
            writer.write(u, r.astype(np.float32))
            n += 1
    writer.close()
    log(f"extracted online2 i-vectors for {n} utterances")
    return 0 if n else 1


# ---------------------------------------------------------------------------
# VAD


def compute_vad(argv: List[str]) -> int:
    po = ParseOptions("Apply energy-based voice activity detection\n"
                      "Usage: compute-vad [options] <feats-rspecifier> <vad-wspecifier>")
    opts = VadEnergyOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("vector", po.get_arg(2))
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        writer.write(key, compute_vad_energy(opts, feats))
    writer.close()
    return 0


def select_voiced_frames(argv: List[str]) -> int:
    po = ParseOptions(
        "Select the feature rows whose VAD decision is voiced.\n"
        "Usage: select-voiced-frames <feats-rspecifier> "
        "<vad-rspecifier> <feats-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    vad_reader = RandomAccessTableReader("vector", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if key not in vad_reader:
            warn(f"no VAD for {key}")
            err += 1
            continue
        vad = np.asarray(vad_reader[key])
        if len(vad) != feats.shape[0]:
            warn(f"{key}: VAD length {len(vad)} vs {feats.shape[0]}")
            err += 1
            continue
        sel = np.asarray(feats)[vad > 0.5]
        if len(sel) == 0:
            warn(f"{key}: no voiced frames")
            err += 1
            continue
        writer.write(key, sel)
        n += 1
    writer.close()
    log(f"selected voiced frames for {n} utterances ({err} errors)")
    return 0 if n else 1


def merge_vads(argv: List[str]) -> int:
    po = ParseOptions(
        "Merge VAD decisions from two archives (logical AND by "
        "default, OR with --map='or').\n"
        "Usage: merge-vads [options] <vad-rspecifier1> "
        "<vad-rspecifier2> <vad-wspecifier>")
    mode = po.register_value("map", "and", "Combination: and | or")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    other = RandomAccessTableReader("vector", po.get_arg(2))
    writer = TableWriter("vector", po.get_arg(3))
    n = err = 0
    for key, v1 in SequentialTableReader("vector", po.get_arg(1)):
        if key not in other:
            err += 1
            continue
        a = np.asarray(v1) > 0.5
        b = np.asarray(other[key]) > 0.5
        if len(a) != len(b):
            err += 1
            continue
        out = (a | b) if mode[0] == "or" else (a & b)
        writer.write(key, out.astype(np.float32))
        n += 1
    writer.close()
    log(f"merged VAD for {n} utterances ({err} errors)")
    return 0 if n else 1


def compute_vad_from_frame_likes(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute VAD decisions from per-class frame log-likelihood "
        "archives (class 0 = silence, others = speech).\n"
        "Usage: compute-vad-from-frame-likes [options] "
        "<likes-rspecifier-1> <likes-rspecifier-2> ... <vad-wspecifier>")
    prior = po.register_value(
        "priors", "", "Comma-separated class priors (default uniform)")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    k = po.num_args() - 1
    extras = [RandomAccessTableReader("vector", po.get_arg(i))
              for i in range(2, k + 1)]
    pri = (np.asarray([float(x) for x in prior[0].split(",")])
           if prior[0] else np.ones(k))
    if len(pri) != k:
        print("compute-vad-from-frame-likes: #priors must equal "
              "#classes", flush=True)
        return 1
    logp = np.log(pri / pri.sum())
    writer = TableWriter("vector", po.get_arg(k + 1))
    n = err = 0
    for key, l0 in SequentialTableReader("vector", po.get_arg(1)):
        ls = [np.asarray(l0) + logp[0]]
        ok = True
        for i, r in enumerate(extras):
            if key not in r:
                ok = False
                break
            ls.append(np.asarray(r[key]) + logp[i + 1])
        if not ok or any(len(x) != len(ls[0]) for x in ls):
            err += 1
            continue
        best = np.argmax(np.stack(ls), axis=0)
        writer.write(key, (best > 0).astype(np.float32))
        n += 1
    writer.close()
    log(f"computed VAD for {n} utterances ({err} errors)")
    return 0 if n else 1


# ---------------------------------------------------------------------------
# i-vector post-processing, LDA and the PLDA back end


def transform_vec(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply a linear or affine transform to vectors (e.g. an LDA "
        "matrix to i-vectors).\n"
        "Usage: transform-vec <transform-rxfilename> <vec-rspecifier> "
        "<vec-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    mat = np.asarray(kaldi_io.read_kaldi_object(iof.read_matrix,
                                                po.get_arg(1)))
    writer = TableWriter("vector", po.get_arg(3))
    n = 0
    for key, vec in SequentialTableReader("vector", po.get_arg(2)):
        v = np.asarray(vec)
        if mat.shape[1] == len(v):
            out = mat @ v
        elif mat.shape[1] == len(v) + 1:     # affine: last col = bias
            out = mat[:, :-1] @ v + mat[:, -1]
        else:
            raise ValueError(
                f"transform-vec: transform cols {mat.shape[1]} vs "
                f"vector dim {len(v)}")
        writer.write(key, out)
        n += 1
    writer.close()
    log(f"transformed {n} vectors")
    return 0 if n else 1


def ivector_transform(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply a transform matrix to i-vectors (alias of "
        "transform-vec with the reference's ivectorbin name).\n"
        "Usage: ivector-transform <matrix-rxfilename> "
        "<ivector-rspecifier> <ivector-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    return transform_vec(["transform-vec"] + [po.get_arg(i)
                                              for i in (1, 2, 3)])


def ivector_compute_lda(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate an LDA projection for i-vectors using speaker "
        "labels as classes.\n"
        "Usage: ivector-compute-lda [options] <ivector-rspecifier> "
        "<utt2spk-rspecifier> <lda-matrix-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    lda_dim = po.register_value("dim", 0, "LDA output dim (0 = input)")
    covariance_factor = po.register_value(
        "covariance-factor", 0.1, "Extra diagonal smoothing of the "
        "within-class covariance")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    if covariance_factor[0] != 0.1:
        raise NotImplementedError(
            "--covariance-factor: the reference package registers it and "
            "never reads it, so only its default is accepted")
    from kaldi_tpu_torch.transform.lda import LdaEstimate, LdaOptions
    utt2spk = RandomAccessTableReader("token-vector", po.get_arg(2))
    ivecs, spk_of = [], []
    for key, vec in SequentialTableReader("vector", po.get_arg(1)):
        if key not in utt2spk:
            continue
        ivecs.append(np.asarray(vec, np.float64))
        spk_of.append(utt2spk[key][0])
    if not ivecs:
        warn("no i-vectors with speaker labels")
        return 1
    X = np.stack(ivecs)
    spks = sorted(set(spk_of))
    sid = {s: i for i, s in enumerate(spks)}
    est = LdaEstimate(len(spks), X.shape[1], device=use_gpu_device(use_gpu[0]))
    est.accumulate_batch(X, np.asarray([sid[s] for s in spk_of]))
    mat = est.estimate(LdaOptions(dim=lda_dim[0] or X.shape[1]))[0]
    kaldi_io.write_kaldi_object(
        lambda s, b: iof.write_matrix(s, b, np.asarray(mat)),
        po.get_arg(3), binary[0])
    log(f"estimated i-vector LDA {np.asarray(mat).shape} from "
        f"{len(ivecs)} ivectors / {len(spks)} speakers")
    return 0


def ivector_mean(argv: List[str]) -> int:
    po = ParseOptions(
        "Average iVectors over speakers (spk2utt map)\n"
        "Usage: ivector-mean <spk2utt-rspecifier> <ivector-rspecifier> "
        "<ivector-wspecifier> [<num-utts-wspecifier>]")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    ivecs = RandomAccessTableReader("vector", po.get_arg(2))
    writer = TableWriter("vector", po.get_arg(3))
    nw = (TableWriter("vector", po.get_arg(4))
          if po.num_args() >= 4 else None)
    n = 0
    for spk, utts in SequentialTableReader("token-vector", po.get_arg(1)):
        vecs = [ivecs[u] for u in utts if u in ivecs]
        if not vecs:
            continue
        writer.write(spk, np.mean(vecs, axis=0))
        if nw:
            nw.write(spk, np.array([float(len(vecs))], np.float32))
        n += 1
    writer.close()
    if nw:
        nw.close()
    log(f"averaged ivectors for {n} speakers")
    return 0 if n else 1


def ivector_subtract_global_mean(argv: List[str]) -> int:
    po = ParseOptions(
        "Copies a table of iVectors but subtracts the global mean as "
        "it does so.\n"
        "Usage: ivector-subtract-global-mean <ivector-rspecifier> "
        "<ivector-wspecifier>\n"
        "   or: ivector-subtract-global-mean <mean-rxfilename> "
        "<ivector-rspecifier> <ivector-wspecifier>")
    po.read(argv)
    if po.num_args() not in (2, 3):
        po.print_usage()
        return 1
    if po.num_args() == 2:
        vecs = [(k, v) for k, v in
                SequentialTableReader("vector", po.get_arg(1))]
        if not vecs:
            print("no ivectors", file=sys.stderr)
            return 1
        mean = np.mean([v for _, v in vecs], axis=0)
        with TableWriter("vector", po.get_arg(2)) as w:
            for k, v in vecs:
                w.write(k, v - mean)
        log(f"ivector-subtract-global-mean: {len(vecs)} vectors")
        return 0
    mean = kaldi_io.read_kaldi_object(iof.read_vector, po.get_arg(1))
    n = 0
    with TableWriter("vector", po.get_arg(3)) as w:
        for k, v in SequentialTableReader("vector", po.get_arg(2)):
            w.write(k, v - mean)
            n += 1
    log(f"ivector-subtract-global-mean: {n} vectors")
    return 0


def ivector_normalize_length(argv: List[str]) -> int:
    po = ParseOptions(
        "Normalize length of iVectors to equal sqrt(feature-dimension)\n"
        "Usage: ivector-normalize-length <ivector-rspecifier> "
        "<ivector-wspecifier>")
    normalize = po.register_value("normalize", True,
                                  "Set this to false to disable "
                                  "normalization")
    scaleup = po.register_value("scaleup", True,
                                "If 'true', the normalized iVector is "
                                "scaled-up by sqrt(ivector-dim)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    n = 0
    ratio_sum = 0.0
    with TableWriter("vector", po.get_arg(2)) as w:
        for k, v in SequentialTableReader("vector", po.get_arg(1)):
            norm = float(np.linalg.norm(v))
            ratio_sum += norm / np.sqrt(v.size)
            if normalize[0] and norm > 0:
                v = v * ((np.sqrt(v.size) / norm) if scaleup[0]
                         else 1.0 / norm)
            w.write(k, v)
            n += 1
    log(f"ivector-normalize-length: {n} vectors, avg ratio "
        f"{ratio_sum / max(n, 1):.4f}")
    return 0


def ivector_compute_plda(argv: List[str]) -> int:
    po = ParseOptions(
        "Computes a Plda object from a set of iVectors.\n"
        "Usage: ivector-compute-plda [options] <spk2utt-rspecifier> "
        "<ivector-rspecifier> <plda-out>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    iv_reader = RandomAccessTableReader("vector", po.get_arg(2))
    classes = {}
    for spk, utts in SequentialTableReader("token-vector", po.get_arg(1)):
        vecs = [iv_reader[u] for u in utts if u in iv_reader]
        if vecs:
            classes[spk] = vecs
    kaldi_io.write_kaldi_object(train_plda(classes).write, po.get_arg(3))
    return 0


def _text_out(wxfilename: str):
    return sys.stdout if wxfilename == "-" else open(wxfilename, "w")


def ivector_plda_scoring(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute log-likelihood-ratio PLDA scores for trials\n"
        "Usage: ivector-plda-scoring <plda> <train-ivector-rspecifier> "
        "<test-ivector-rspecifier> <trials-rxfilename> <scores-wxfilename>\n"
        "Trials file: lines of '<train-key> <test-key>'.")
    num_utts = po.register_value("num-utts", "", "rspecifier for number of utterances per train key")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    plda = kaldi_io.read_kaldi_object(Plda.read, po.get_arg(1))
    train = dict(SequentialTableReader("vector", po.get_arg(2)))
    test = dict(SequentialTableReader("vector", po.get_arg(3)))
    counts = {}
    if num_utts[0]:
        counts = {k: int(v[0]) for k, v in
                  SequentialTableReader("vector", num_utts[0])}
    tr_t = {k: plda.transform_ivector(v, counts.get(k, 1))
            for k, v in train.items()}
    te_t = {k: plda.transform_ivector(v, 1) for k, v in test.items()}
    out = _text_out(po.get_arg(5))
    n = err = 0
    with open(po.get_arg(4)) as trials:
        for line in trials:
            parts = line.split()
            if len(parts) < 2:
                continue
            a, b = parts[0], parts[1]
            if a not in tr_t or b not in te_t:
                err += 1
                continue
            score = plda.log_likelihood_ratio(tr_t[a], counts.get(a, 1),
                                              te_t[b])
            out.write(f"{a} {b} {score:.6f}\n")
            n += 1
    if out is not sys.stdout:
        out.close()
    log(f"scored {n} trials ({err} missing)")
    return 0 if n else 1


def ivector_plda_scoring_dense(argv: List[str]) -> int:
    po = ParseOptions(
        "Perform PLDA scoring for speaker diarization: for each "
        "recording, compute the pairwise PLDA score matrix of its "
        "utterance iVectors (in reco2utt order).\n"
        "Usage: ivector-plda-scoring-dense <plda> <reco2utt-rspecifier> "
        "<ivectors-rspecifier> <scores-wspecifier>")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    plda = kaldi_io.read_kaldi_object(Plda.read, po.get_arg(1))
    ivecs = RandomAccessTableReader("vector", po.get_arg(3))
    n = 0
    with TableWriter("matrix", po.get_arg(4)) as w:
        for reco, utt_toks in SequentialTableReader("token-vector",
                                                    po.get_arg(2)):
            utts = list(utt_toks)
            tr = [plda.transform_ivector(np.asarray(ivecs[u]), 1)
                  for u in utts]
            S = np.zeros((len(utts), len(utts)), np.float32)
            for i in range(len(utts)):
                for j in range(len(utts)):
                    S[i, j] = plda.log_likelihood_ratio(tr[i], 1, tr[j])
            w.write(reco, S)
            n += 1
    log(f"ivector-plda-scoring-dense: {n} recordings")
    return 0


def ivector_adapt_plda(argv: List[str]) -> int:
    po = ParseOptions(
        "Unsupervised PLDA domain adaptation from unlabeled "
        "target-domain i-vectors (ivector-adapt-plda.cc).\n"
        "Usage: ivector-adapt-plda [options] <plda-in> "
        "<ivector-rspecifier> <plda-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    within_scale = po.register_value(
        "within-covar-scale", 0.75,
        "Excess-variance share added to the within-class covariance")
    between_scale = po.register_value(
        "between-covar-scale", 0.25,
        "Excess-variance share added to the between-class covariance")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    plda = kaldi_io.read_kaldi_object(Plda.read, po.get_arg(1))
    ivs = [np.asarray(v, np.float64) for _k, v in
           SequentialTableReader("vector", po.get_arg(2))]
    if len(ivs) < 2:
        warn("need at least 2 adaptation ivectors")
        return 1
    adapted = plda.adapt(np.stack(ivs),
                         within_covar_scale=within_scale[0],
                         between_covar_scale=between_scale[0])
    kaldi_io.write_kaldi_object(adapted.write, po.get_arg(3), binary[0])
    log(f"adapted PLDA with {len(ivs)} ivectors")
    return 0


def ivector_copy_plda(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy a PLDA model, optionally smoothing the within-class "
        "covariance (ivector-copy-plda.cc).\n"
        "Usage: ivector-copy-plda [options] <plda-in> <plda-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    smoothing = po.register_value(
        "smoothing", 0.0, "Smoothing factor: interpolates the "
        "between-class variances toward their mean")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    plda = kaldi_io.read_kaldi_object(Plda.read, po.get_arg(1))
    if smoothing[0] > 0:
        s = smoothing[0]
        plda.psi = (1 - s) * plda.psi + s * plda.psi.mean()
    kaldi_io.write_kaldi_object(plda.write, po.get_arg(2), binary[0])
    return 0


def ivector_compute_dot_products(argv: List[str]) -> int:
    po = ParseOptions(
        "Dot products (cosine scores with --normalize) between "
        "i-vector pairs from a trials file of '<key1> <key2>' lines "
        "(ivector-compute-dot-products.cc).\n"
        "Usage: ivector-compute-dot-products [options] "
        "<trials-rxfilename> <ivector1-rspecifier> "
        "<ivector2-rspecifier> <scores-wxfilename>")
    normalize = po.register_value("normalize", True,
                                  "Length-normalize before the dot "
                                  "product (cosine scoring)")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    r1 = RandomAccessTableReader("vector", po.get_arg(2))
    r2 = RandomAccessTableReader("vector", po.get_arg(3))
    out = _text_out(po.get_arg(4))
    n = err = 0
    with kaldi_io.input_stream(po.get_arg(1)) as f:
        trials = f.read().decode("utf-8").splitlines()
    for line in trials:
        parts = line.split()
        if len(parts) < 2:
            continue
        k1, k2 = parts[0], parts[1]
        if k1 not in r1 or k2 not in r2:
            warn(f"missing ivector for trial {k1} {k2}")
            err += 1
            continue
        a = np.asarray(r1[k1], np.float64)
        b = np.asarray(r2[k2], np.float64)
        if normalize[0]:
            a = a / max(np.linalg.norm(a), 1e-20)
            b = b / max(np.linalg.norm(b), 1e-20)
        out.write(f"{k1} {k2} {float(a @ b):.6f}\n")
        n += 1
    if out is not sys.stdout:
        out.close()
    log(f"scored {n} trials ({err} missing)")
    return 0 if n else 1


def equal_error_rate(target: Sequence[float], nontarget: Sequence[float]
                     ) -> Tuple[float, float]:
    """(EER, threshold) by the reference package's sweep over the target
    scores: FRR rises, FAR falls."""
    t = np.sort(np.asarray(target, np.float64))
    n = np.sort(np.asarray(nontarget, np.float64))
    frr = np.arange(len(t)) / len(t)
    far = 1.0 - np.searchsorted(n, t, side="left") / len(n)
    i = int(np.argmin(np.abs(frr - far)))
    return float(0.5 * (frr[i] + far[i])), float(t[i])


def compute_eer(argv: List[str]) -> int:
    po = ParseOptions(
        "Computes the Equal Error Rate.\n"
        "Input is a series of lines, each with two fields: score, and "
        "either the string 'target' or 'nontarget'.\n"
        "Usage: compute-eer <scores-in>")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    fn = po.get_arg(1)
    target, nontarget = [], []
    stream = sys.stdin if fn == "-" else open(fn)
    try:
        for line in stream:
            parts = line.split()
            if len(parts) != 2:
                print(f"compute-eer: bad line {line!r}", file=sys.stderr)
                return 1
            if parts[1] == "target":
                target.append(float(parts[0]))
            elif parts[1] == "nontarget":
                nontarget.append(float(parts[0]))
            else:
                print(f"compute-eer: bad label {parts[1]!r}",
                      file=sys.stderr)
                return 1
    finally:
        if stream is not sys.stdin:
            stream.close()
    if not target or not nontarget:
        print("compute-eer: need both target and nontarget scores",
              file=sys.stderr)
        return 1
    eer, thr = equal_error_rate(target, nontarget)
    print(f"{eer * 100:.4f}%")
    log(f"compute-eer: EER {eer * 100:.4f}% threshold {thr:.4f} "
        f"({len(target)} target / {len(nontarget)} nontarget)")
    return 0


# ---------------------------------------------------------------------------
# the language-id and diarization back ends (kaldi_tpu/cli/tail7_tools.py
# logistic-regression-train (:18), -eval (:57), -copy (:85);
# kaldi_tpu/cli/tail3_tools.py agglomerative-cluster (:202))


def logistic_regression_train(argv: List[str]) -> int:
    po = ParseOptions(
        "Train a multinomial logistic regression model on vectors "
        "(e.g. i-vectors for language id).\n"
        "Usage: logistic-regression-train [options] "
        "<vector-rspecifier> <utt2class-rspecifier> <model-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    max_steps = po.register_value("max-steps", 200,
                                  "Optimization steps")
    normalizer = po.register_value("normalizer", 0.0025,
                                   "L2 regularization weight")
    mix_up = po.register_value("mix-up", 0,
                               "Target number of mixture components")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    dev = use_gpu_device(use_gpu[0])
    cls_reader = RandomAccessTableReader("int", po.get_arg(2))
    xs, ys = [], []
    for key, vec in SequentialTableReader("vector", po.get_arg(1)):
        if key not in cls_reader:
            warn(f"no class for {key}")
            continue
        xs.append(np.asarray(vec, np.float64))
        ys.append(int(cls_reader[key]))
    if not xs:
        warn("no training vectors")
        return 1
    cfg = LogisticRegressionConfig(max_steps=max_steps[0],
                                   normalizer=normalizer[0],
                                   mix_up=mix_up[0])
    model = train_logistic_regression(np.stack(xs), np.asarray(ys), cfg,
                                      device=dev)
    kaldi_io.write_kaldi_object(model.write, po.get_arg(3), binary[0])
    return 0


def logistic_regression_eval(argv: List[str]) -> int:
    po = ParseOptions(
        "Evaluate a logistic regression model: write per-utterance "
        "class log-posterior vectors (apply --apply-log=false for "
        "posteriors).\n"
        "Usage: logistic-regression-eval [options] <model-in> "
        "<vector-rspecifier> <log-posterior-wspecifier>")
    apply_log = po.register_value("apply-log", True,
                                  "Write log-posteriors (else "
                                  "posteriors)")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    model = kaldi_io.read_kaldi_object(LogisticRegression.read,
                                       po.get_arg(1))
    writer = TableWriter("vector", po.get_arg(3))
    n = 0
    for key, vec in SequentialTableReader("vector", po.get_arg(2)):
        lp = model.log_posteriors(np.asarray(vec)[None, :])[0]
        writer.write(key, lp if apply_log[0] else np.exp(lp))
        n += 1
    writer.close()
    log(f"evaluated {n} vectors")
    return 0 if n else 1


def logistic_regression_copy(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy a logistic regression model, optionally scaling the "
        "class priors out of the offsets.\n"
        "Usage: logistic-regression-copy [options] <model-in> "
        "<model-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    scale_priors = po.register_value(
        "scale-priors", "", "Colon-separated per-class prior scales "
        "applied to the offsets (log is added)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    model = kaldi_io.read_kaldi_object(LogisticRegression.read,
                                       po.get_arg(1))
    if scale_priors[0]:
        scales = [float(s) for s in scale_priors[0].split(":")]
        if len(scales) != model.num_classes:
            print("logistic-regression-copy: #scales must equal "
                  "#classes", flush=True)
            return 1
        for comp, cls in enumerate(model.class_of):
            model.weights[comp, -1] += np.log(max(scales[cls], 1e-30))
    kaldi_io.write_kaldi_object(model.write, po.get_arg(2), binary[0])
    return 0


def agglomerative_cluster_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Cluster utterances by similarity score (diarization).\n"
        "Takes a table of score matrices (one per recording, utterances "
        "in reco2utt order) and clusters agglomeratively to a stopping "
        "threshold or a known number of speakers.\n"
        "Usage: agglomerative-cluster <scores-rspecifier> "
        "<reco2utt-rspecifier> <labels-wspecifier>")
    threshold = po.register_value("threshold", 0.0,
                                  "Merging stops when the best score "
                                  "falls below this")
    num_spk = po.register_value("num-speakers", 0,
                                "If > 0, cluster to this many speakers "
                                "(reco2num-spk mode uses the table "
                                "variant)")
    reco2num = po.register_value("reco2num-spk-rspecifier", "",
                                 "Table of recording -> num speakers")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    r2n = {}
    if reco2num[0]:
        for k, v in SequentialTableReader("int-vector", reco2num[0]):
            r2n[k] = int(v[0])
    n = 0
    with TableWriter("int-vector", po.get_arg(3)) as w:
        reco2utt = {k: list(v) for k, v in
                    SequentialTableReader("token-vector",
                                          po.get_arg(2))}
        for reco, scores in SequentialTableReader("matrix",
                                                  po.get_arg(1)):
            utts = reco2utt.get(reco)
            k = r2n.get(reco, num_spk[0])
            labels = agglomerative_cluster(np.asarray(scores),
                                           threshold=float(threshold[0]),
                                           num_clusters=k if k > 0
                                           else None)
            if utts is not None:
                for u, lab in zip(utts, labels):
                    w.write(u, [int(lab) + 1])
            else:
                w.write(reco, [int(x) + 1 for x in labels])
            n += 1
    log(f"agglomerative-cluster: {n} recordings")
    return 0
