"""The linear-VTLN tools and the global-GMM transform tools, ports of the
reference package's tools with the same positional arguments, options and
table specifiers:

  kaldi_tpu/cli/tail8_tools.py: gmm-init-lvtln (:254),
    gmm-train-lvtln-special (:279), gmm-est-lvtln-trans (:329);
  kaldi_tpu/cli/fmpe2_tools.py: gmm-acc-stats-twofeats (:189),
    gmm-global-acc-stats-twofeats (:246), gmm-global-est-lvtln-trans
    (:364);
  kaldi_tpu/cli/tail10_tools.py: gmm-global-est-fmllr (:87).

The frame-level work runs on the card unless --use-gpu=no: the GMMs'
component posteriors (float32, `gmm/ubm.py` `UbmScorer`, as the
reference's `component_posteriors`), the statistics they weight (float64:
`AccumDiagGmm`, `FmllrDiagGmmAccs`), and the least-squares Gram matrices
of gmm-train-lvtln-special (float64).  The solves, the fMLLR update and
the choice of a speaker's warp class are host float64 numpy, as in the
reference.  A LinearVtln file is the reference tools' container
(`transform/lvtln.py` `write_lvtln_file`)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
from kaldi_tpu_torch.cli.online_tools2 import (register_use_gpu,
                                               use_gpu_device)
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm, AccumDiagGmm
from kaldi_tpu_torch.gmm.ubm import UbmScorer
from kaldi_tpu_torch.transform.fmllr import FmllrDiagGmmAccs
from kaldi_tpu_torch.transform.lvtln import (LinearVtln, LvtlnGram,
                                             read_lvtln_file,
                                             write_lvtln_file)
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)

# the tools that take --use-gpu
DEVICE_TOOLS = (
    "gmm-train-lvtln-special", "gmm-est-lvtln-trans",
    "gmm-acc-stats-twofeats", "gmm-global-acc-stats-twofeats",
    "gmm-global-est-lvtln-trans", "gmm-global-est-fmllr")


def _read_lvtln(path: str) -> LinearVtln:
    with kaldi_io.input_stream(path) as f:
        return read_lvtln_file(f, iof.init_input_stream(f))


def _write_lvtln(path: str, lv: LinearVtln, binary: bool) -> None:
    kaldi_io.write_kaldi_object(
        lambda s, b: write_lvtln_file(s, b, lv), path, binary)


def _spk_groups(spk2utt_rs: str, keys) -> List[Tuple[str, List[str]]]:
    """[(spk, [utts])]: from spk2utt, or one utterance a speaker."""
    if spk2utt_rs:
        return [(spk, list(utts)) for spk, utts in
                SequentialTableReader("token-vector", spk2utt_rs)]
    return [(k, [k]) for k in sorted(keys)]


def gmm_init_lvtln(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize a linear-VTLN object with identity transforms.\n"
        "Usage: gmm-init-lvtln [options] <lvtln-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    dim = po.register_value("dim", 13, "Feature dimension")
    num_classes = po.register_value("num-classes", 31,
                                    "Number of warp classes")
    default_class = po.register_value("default-class", 15,
                                      "Index of the 1.0 warp")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    C, d0 = num_classes[0], default_class[0]
    warps = [1.0 + 0.01 * (c - d0) for c in range(C)]
    _write_lvtln(po.get_arg(1), LinearVtln(dim[0], warps), binary[0])
    log(f"initialized LVTLN: dim {dim[0]}, {C} classes, warps "
        f"{warps[0]:.2f}..{warps[-1]:.2f}")
    return 0


def gmm_train_lvtln_special(argv: List[str]) -> int:
    po = ParseOptions(
        "Train one LVTLN class transform as the least-squares map "
        "from unwarped to warped parallel features "
        "(gmm-train-lvtln-special.cc).\n"
        "Usage: gmm-train-lvtln-special [options] <class-index> "
        "<lvtln-in> <lvtln-out> <feats-unwarped-rspecifier> "
        "<feats-warped-rspecifier>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    warp = po.register_value("warp", 0.0,
                             "Record this warp factor for the class "
                             "(0 = keep current)")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    c = int(po.get_arg(1))
    lv = _read_lvtln(po.get_arg(2))
    gram = LvtlnGram(lv.dim, use_gpu_device(use_gpu[0]))
    warped_reader = RandomAccessTableReader("matrix", po.get_arg(5))
    for key, un in SequentialTableReader("matrix", po.get_arg(4)):
        if key not in warped_reader:
            warn(f"no warped feats for {key}")
            continue
        w = np.asarray(warped_reader[key], np.float64)
        u = np.asarray(un, np.float64)
        T = min(len(u), len(w))
        gram.add(u[:T], w[:T])
    if not gram.frames:
        return 1
    A, err = gram.solve()
    lv.set_transform(c, A)
    if warp[0]:
        lv.warps[c] = warp[0]
    _write_lvtln(po.get_arg(3), lv, binary[0])
    log(f"trained LVTLN class {c}: mse {err:.5f} over "
        f"{gram.frames} frames")
    return 0


def gmm_est_lvtln_trans(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate per-speaker linear-VTLN transforms (choose the "
        "best warp class by fMLLR auxiliary; "
        "gmm-est-lvtln-trans.cc).\n"
        "Usage: gmm-est-lvtln-trans [options] <model-in> <lvtln-in> "
        "<feats-rspecifier> <ali-rspecifier> <trans-wspecifier> "
        "[<warp-wspecifier>]")
    spk2utt = po.register_value("spk2utt", "",
                                "Speaker-to-utterance map rspecifier")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 5 or po.num_args() > 6:
        po.print_usage()
        return 1
    dev = use_gpu_device(use_gpu[0])
    tm, am = read_am_gmm(po.get_arg(1), device=dev)
    lv = _read_lvtln(po.get_arg(2))
    feats_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    ali_reader = RandomAccessTableReader("int-vector", po.get_arg(4))
    writer = TableWriter("matrix", po.get_arg(5))
    warp_writer = (TableWriter("float", po.get_arg(6))
                   if po.num_args() == 6 else None)
    warps_out = []
    for spk, utts in _spk_groups(spk2utt[0], feats_reader.keys()):
        accs = FmllrDiagGmmAccs(am.dim, device=dev)
        for u in utts:
            if u not in feats_reader or u not in ali_reader:
                continue
            accs.accumulate_from_alignment(
                am, tm, np.asarray(feats_reader[u], np.float64),
                ali_reader[u])
        if accs.beta <= 0:
            continue
        W, warp, _impr = lv.compute_transform(accs)
        writer.write(spk, W)
        if warp_writer:
            warp_writer.write(spk, float(warp))
        warps_out.append(warp)
    writer.close()
    if warp_writer:
        warp_writer.close()
    log(f"LVTLN transforms for {len(warps_out)} speakers; warps "
        f"{min(warps_out, default=0):.2f}.."
        f"{max(warps_out, default=0):.2f}")
    return 0 if warps_out else 1


def gmm_acc_stats_twofeats(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate GMM stats with posteriors computed on one feature "
        "stream and statistics on another "
        "(gmm-acc-stats-twofeats.cc; fMPE/feature-transform "
        "training).\n"
        "Usage: gmm-acc-stats-twofeats [options] <model-in> "
        "<feature1-rspecifier> <feature2-rspecifier> "
        "<posteriors-rspecifier> <stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    dev = use_gpu_device(use_gpu[0])
    tm, am = read_am_gmm(po.get_arg(1), device=dev)
    feat2_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    post_reader = RandomAccessTableReader("posterior", po.get_arg(4))
    # pdf -> (stream-1 rows, stream-2 rows, weights) over all utterances
    by_pdf: Dict[int, Tuple[list, list, list]] = {}
    accs = None
    n = err = 0
    for key, feats1 in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in feat2_reader or key not in post_reader:
            warn(f"missing second features or posteriors for {key}")
            err += 1
            continue
        feats2 = np.asarray(feat2_reader[key], np.float64)
        if accs is None:
            accs = AccumAmDiagGmm(num_transition_ids=tm.num_transition_ids)
            accs.accs = [AccumDiagGmm(am.get_pdf(p).num_gauss,
                                      feats2.shape[1])
                         for p in range(am.num_pdfs)]
        post = post_reader[key]
        feats1 = np.asarray(feats1, np.float64)
        T = min(feats1.shape[0], feats2.shape[0], len(post))
        for t in range(T):
            for tid, w in post[t]:
                if w == 0.0:
                    continue
                accs.transition_accs[int(tid)] += w
                rows1, rows2, ws = by_pdf.setdefault(
                    tm.transition_id_to_pdf(int(tid)), ([], [], []))
                rows1.append(feats1[t])
                rows2.append(feats2[t])
                ws.append(w)
        n += 1
    if accs is None:
        print("gmm-acc-stats-twofeats: no data", flush=True)
        return 1
    for pdf in sorted(by_pdf):
        rows1, rows2, ws = by_pdf[pdf]
        accs.accs[pdf].accumulate_device(
            UbmScorer(am.get_pdf(pdf), dev), [np.stack(rows1)],
            [np.stack(rows2)], [np.asarray(ws, np.float64)])
    kaldi_io.write_kaldi_object(accs.write, po.get_arg(5), binary[0])
    log(f"accumulated twofeats stats from {n} utterances "
        f"({err} errors); second dim {accs.accs[0].dim}")
    return 0 if n else 1


def gmm_global_acc_stats_twofeats(argv: List[str]) -> int:
    po = ParseOptions(
        "Global-GMM twofeats stats: posteriors from the first "
        "stream, moments from the second "
        "(gmm-global-acc-stats-twofeats.cc).\n"
        "Usage: gmm-global-acc-stats-twofeats [options] <model-in> "
        "<feature1-rspecifier> <feature2-rspecifier> <stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    gmm = kaldi_io.read_kaldi_object(DiagGmm.read, po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    feat2_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    xs1, xs2 = [], []
    for key, feats1 in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in feat2_reader:
            warn(f"no second features for {key}")
            continue
        feats2 = np.asarray(feat2_reader[key], np.float64)
        T = min(len(feats1), len(feats2))
        xs1.append(np.asarray(feats1, np.float32)[:T])
        xs2.append(feats2[:T])
    if not xs1:
        print("gmm-global-acc-stats-twofeats: no data", flush=True)
        return 1
    acc = AccumDiagGmm(gmm.num_gauss, xs2[0].shape[1])
    acc.accumulate_device(scorer, xs1, xs2)
    kaldi_io.write_kaldi_object(acc.write, po.get_arg(4), binary[0])
    log(f"accumulated global twofeats stats from {len(xs1)} utterances")
    return 0


def _global_fmllr_accs(gmm: DiagGmm, scorer: UbmScorer, feats_reader,
                       utts) -> FmllrDiagGmmAccs:
    accs = FmllrDiagGmmAccs(gmm.dim, device=scorer.device)
    for u in utts:
        if u in feats_reader:
            accs.accumulate_from_ubm(scorer, gmm, feats_reader[u])
    return accs


def gmm_global_est_lvtln_trans(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate per-speaker LVTLN transforms against a single "
        "global diagonal GMM (gmm-global-est-lvtln-trans.cc).\n"
        "Usage: gmm-global-est-lvtln-trans [options] <gmm-in> "
        "<lvtln-in> <feature-rspecifier> <trans-wspecifier> "
        "[<warp-wspecifier>]")
    spk2utt = po.register_value("spk2utt", "",
                                "Speaker-to-utterance map rspecifier")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 5:
        po.print_usage()
        return 1
    gmm = kaldi_io.read_kaldi_object(DiagGmm.read, po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    lv = _read_lvtln(po.get_arg(2))
    feats_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    writer = TableWriter("matrix", po.get_arg(4))
    warp_writer = (TableWriter("float", po.get_arg(5))
                   if po.num_args() == 5 else None)
    n = 0
    for spk, utts in _spk_groups(spk2utt[0], feats_reader.keys()):
        accs = _global_fmllr_accs(gmm, scorer, feats_reader, utts)
        if accs.beta <= 0:
            continue
        W, warp, _impr = lv.compute_transform(accs)
        writer.write(spk, W)
        if warp_writer:
            warp_writer.write(spk, float(warp))
        n += 1
    writer.close()
    if warp_writer:
        warp_writer.close()
    log(f"global-GMM LVTLN transforms for {n} speakers")
    return 0 if n else 1


def gmm_global_est_fmllr(argv: List[str]) -> int:
    po = ParseOptions(
        "Estimate (UBM-level) fMLLR transforms against a global "
        "diagonal GMM (gmm-global-est-fmllr.cc; diarization/SRE "
        "front-end adaptation).\n"
        "Usage: gmm-global-est-fmllr [options] <gmm-in> "
        "<feats-rspecifier> <trans-wspecifier>")
    spk2utt = po.register_value("spk2utt", "",
                                "Speaker-to-utterance map rspecifier")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    gmm = kaldi_io.read_kaldi_object(DiagGmm.read, po.get_arg(1))
    scorer = UbmScorer(gmm, use_gpu_device(use_gpu[0]))
    feats_reader = RandomAccessTableReader("matrix", po.get_arg(2))
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for spk, utts in _spk_groups(spk2utt[0], feats_reader.keys()):
        accs = _global_fmllr_accs(gmm, scorer, feats_reader, utts)
        if accs.beta <= 0:
            continue
        W, _impr = accs.update(min_count=100.0)
        writer.write(spk, W)
        n += 1
    writer.close()
    log(f"global fMLLR transforms for {n} speakers")
    return 0 if n else 1
