"""gmmbin tools (port of the tools of `kaldi_tpu/cli/gmm_tools.py` that
GMM training and decoding run): gmm-init-mono, compile-train-graphs,
gmm-align-compiled, gmm-acc-stats-ali, gmm-sum-accs, gmm-est, gmm-info,
gmm-latgen-faster, the MMI tools (gmm-acc-stats2, gmm-ismooth-stats,
gmm-est-gaussians-ebw, gmm-est-weights-ebw, gmm-rescore-lattice) and the
decoders of log-likelihood matrices (latgen-faster-mapped,
decode-faster-mapped).  Same positional arguments, options and table
specifiers as the reference's.

Model files follow the reference's convention: the TransitionModel,
then the AmDiagGmm, in one binary stream (`read_am_gmm` /
`write_am_gmm`), so a `final.mdl` of either package reads in the other.
The GMM log-likelihoods of gmm-align-compiled, gmm-latgen-faster and
gmm-rescore-lattice run on the card (`AmDiagGmm.log_likes_device`)
unless --use-gpu=no; the statistics, the EBW updates (host float64,
`gmm/ebw.py`) and the searches (the host `FasterDecoder`,
`LatticeFasterDecoder`) stay on the host, as in the reference.
latgen-faster-mapped shares nnet3-latgen-faster's decode loop: the
determinization, the `det_fallbacks` count and the stats line.

The global-GMM tools are in `cli/ivector_tools.py` and
`cli/vtln_tools.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.nnet3_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.fstext.fst import VectorFst
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.mle import (AccumAmDiagGmm, MleDiagGmmOptions,
                                     mle_am_diag_gmm_update)
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import (
    ContextDependency, monophone_context_dependency,
    monophone_context_dependency_shared)
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def read_am_gmm(rxfilename: str, device: DeviceLike = None):
    """-> (TransitionModel, AmDiagGmm scoring on `device`)."""
    with kaldi_io.input_stream(rxfilename) as f:
        binary = iof.init_input_stream(f)
        tm = TransitionModel.read(f, binary)
        am = AmDiagGmm.read(f, binary, device=device)
    return tm, am


def write_am_gmm(wxfilename: str, tm: TransitionModel, am: AmDiagGmm,
                 binary: bool = True) -> None:
    with kaldi_io.output_stream(wxfilename) as f:
        iof.init_output_stream(f, binary)
        tm.write(f, binary)
        am.write(f, binary)


def gmm_init_mono(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize monophone GMM.\n"
        "Usage: gmm-init-mono <topology-in> <dim> <model-out> <tree-out>\n"
        "e.g.: gmm-init-mono topo 39 mono.mdl mono.tree")
    train_feats = po.register_value("train-feats", "", "rspecifier for training features [used to set mean and variance]")
    shared_phones = po.register_value("shared-phones", "", "rxfilename containing sets of phones to share pdfs with [integer lines]")
    perturb_factor = po.register_value("perturb-factor", 0.0, "Perturb the means using this fraction of standard deviation")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    topo = kaldi_io.read_kaldi_object(HmmTopology.read, po.get_arg(1))
    dim = int(po.get_arg(2))
    mean = np.zeros(dim)
    var = np.ones(dim)
    if train_feats[0]:
        count = 0.0
        s = np.zeros(dim)
        s2 = np.zeros(dim)
        for i, (key, feats) in enumerate(
                SequentialTableReader("matrix", train_feats[0])):
            s += feats.sum(axis=0)
            s2 += (feats.astype(np.float64) ** 2).sum(axis=0)
            count += feats.shape[0]
            if i >= 10:
                break
        if count:
            mean = s / count
            var = np.maximum(s2 / count - mean ** 2, 1e-4)
    phones = topo.phones
    npc = {p: topo.num_pdf_classes(p) for p in phones}
    if shared_phones[0]:
        sets = []
        with open(shared_phones[0]) as f:
            for line in f:
                if line.strip():
                    sets.append([int(t) for t in line.split()])
        tree = monophone_context_dependency_shared(sets, npc)
    else:
        tree = monophone_context_dependency(phones, npc)
    tm = TransitionModel(topo, tree)
    am = AmDiagGmm(device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(tree.num_pdfs):
        g = DiagGmm(1, dim)
        m = mean.copy()
        if perturb_factor[0]:
            m = m + perturb_factor[0] * rng.normal(size=dim) * np.sqrt(var)
        g.set_from_means_and_vars([1.0], m[None, :], var[None, :])
        am.add_pdf(g)
    write_am_gmm(po.get_arg(3), tm, am)
    kaldi_io.write_kaldi_object(tree.write, po.get_arg(4))
    log(f"initialized mono system: {tree.num_pdfs} pdfs, dim {dim}")
    return 0


def compile_train_graphs(argv: List[str]) -> int:
    po = ParseOptions(
        "Creates training graphs (without transition-probabilities, by default)\n"
        "Usage: compile-train-graphs [options] <tree-in> <model-in> "
        "<lexicon-fst-in> <transcriptions-rspecifier> <graphs-wspecifier>")
    transition_scale = po.register_value("transition-scale", 1.0, "Scale of transition probabilities (excluding self-loops)")
    self_loop_scale = po.register_value("self-loop-scale", 1.0, "Scale of self-loop versus non-self-loop log probs [relative to acoustics]")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.decoder.graph import compile_graph_from_lexicon_fst
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    tree = kaldi_io.read_kaldi_object(ContextDependency.read, po.get_arg(1))
    # only the TransitionModel is needed, so any .mdl works, as in Kaldi
    tm = kaldi_io.read_kaldi_object(TransitionModel.read, po.get_arg(2))
    lex = read_fst_file(po.get_arg(3))
    writer = TableWriter(VectorFst, po.get_arg(5))
    n = err = 0
    for key, words in SequentialTableReader("int-vector", po.get_arg(4)):
        try:
            g = compile_graph_from_lexicon_fst(
                lex, words, tm, tree, transition_scale[0], self_loop_scale[0])
            writer.write(key, g)
            n += 1
        except Exception as e:  # noqa: BLE001 (one bad transcript)
            warn(f"failed to compile graph for {key}: {e}")
            err += 1
    writer.close()
    log(f"compiled {n} training graphs, {err} failures")
    return 0 if n else 1


def gmm_align_compiled(argv: List[str]) -> int:
    po = ParseOptions(
        "Align features given [GMM-based] models.\n"
        "Usage: gmm-align-compiled [options] <model-in> <graphs-rspecifier> "
        "<feature-rspecifier> <alignments-wspecifier>")
    beam = po.register_value("beam", 10.0, "Decoding beam used in alignment")
    retry_beam = po.register_value("retry-beam", 40.0, "Decoding beam for second try at alignment")
    acoustic_scale = po.register_value("acoustic-scale", 1.0, "Scaling factor for acoustic likelihoods")
    transition_scale = po.register_value("transition-scale", 1.0, "Transition-probability scale [relative to acoustics]")
    careful = po.register_value("careful", False, "If true, do 'careful' alignment")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    if careful[0]:
        raise NotImplementedError("--careful alignment is not ported "
                                  "(the reference accepts and ignores it)")
    if transition_scale[0] != 1.0:
        raise NotImplementedError(
            "--transition-scale other than 1 is not ported (the reference "
            "accepts and ignores it; compile the graphs with the scale)")
    from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                 FasterDecoderOptions)
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))
    graphs = RandomAccessTableReader(VectorFst, po.get_arg(2))
    writer = TableWriter("int-vector", po.get_arg(4))
    n = err = 0
    tot_like = 0.0
    tot_frames = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
        if key not in graphs:
            warn(f"no graph for {key}")
            err += 1
            continue
        loglikes = am.log_likes_batch(feats)
        graph = graphs[key]
        res = FasterDecoder(graph, FasterDecoderOptions(beam=beam[0])).decode(
            loglikes, tm.id2pdf_id, acoustic_scale[0])
        if res is None and retry_beam[0] > beam[0]:
            res = FasterDecoder(graph, FasterDecoderOptions(
                beam=retry_beam[0])).decode(loglikes, tm.id2pdf_id,
                                            acoustic_scale[0])
        if res is None:
            warn(f"alignment failed for {key}")
            err += 1
            continue
        writer.write(key, res[0])
        tot_like -= res[2]
        tot_frames += feats.shape[0]
        n += 1
    writer.close()
    log(f"aligned {n} utterances ({err} failed); avg cost/frame "
        f"{-tot_like / max(tot_frames, 1):.4f}")
    return 0 if n else 1


def gmm_acc_stats_ali(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate stats for GMM training.\n"
        "Usage: gmm-acc-stats-ali [options] <model-in> <feature-rspecifier> "
        "<alignments-rspecifier> <stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    ali_reader = RandomAccessTableReader("int-vector", po.get_arg(3))
    acc = AccumAmDiagGmm(am, num_transition_ids=tm.num_transition_ids)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in ali_reader:
            warn(f"no alignment for {key}")
            err += 1
            continue
        ali = ali_reader[key]
        if len(ali) != feats.shape[0]:
            warn(f"{key}: alignment length {len(ali)} vs "
                 f"{feats.shape[0]} frames")
            err += 1
            continue
        acc.accumulate_alignment(am, tm, feats, ali)
        n += 1
    kaldi_io.write_kaldi_object(acc.write, po.get_arg(4), binary[0])
    log(f"accumulated stats from {n} utterances ({err} errors); "
        f"loglike/frame {acc.total_loglike / max(acc.total_frames, 1):.4f}")
    return 0 if n else 1


def gmm_sum_accs(argv: List[str]) -> int:
    po = ParseOptions("Sum multiple accumulated stats files for GMM training.\n"
                      "Usage: gmm-sum-accs [options] <stats-out> <stats-in1> <stats-in2> ...")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    total = None
    for i in range(2, po.num_args() + 1):
        acc = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(i))
        if total is None:
            total = acc
        else:
            total.add(acc)
    kaldi_io.write_kaldi_object(total.write, po.get_arg(1))
    return 0


def gmm_est(argv: List[str]) -> int:
    po = ParseOptions(
        "Do Maximum Likelihood re-estimation of GMM-based acoustic model\n"
        "Usage: gmm-est [options] <model-in> <stats-in> <model-out>")
    opts = MleDiagGmmOptions()
    po.register_struct(opts)
    mix_up = po.register_value("mix-up", 0, "Increase number of mixture components to this overall target")
    power = po.register_value("power", 0.25, "If mixing up, power to allocate Gaussians to states")
    perturb_factor = po.register_value("perturb-factor", 0.01, "While mixing up, perturb means by standard deviation times this factor")
    update_flags = po.register_value("update-flags", "mvwt", "Which GMM parameters to update: subset of mvwt")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    if power[0] != 0.25:
        raise NotImplementedError(
            "--power: the reference's mixing-up allocates Gaussians in "
            "proportion to each pdf's occupancy and never reads the "
            "option, so only its default is accepted")
    if set(update_flags[0]) - {"t"} != set("mvw"):
        raise NotImplementedError(
            f"--update-flags={update_flags[0]}: the reference updates "
            "means, variances and weights always ('t' switches the "
            "transitions), so only mvw and mvwt are accepted")
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    acc = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(2))
    mle_am_diag_gmm_update(opts, acc, am,
                           tm if "t" in update_flags[0] else None,
                           mixup=mix_up[0] if mix_up[0] else None,
                           perturb_factor=perturb_factor[0])
    write_am_gmm(po.get_arg(3), tm, am)
    log(f"estimated model: {am.num_gauss()} gaussians")
    return 0


def gmm_info(argv: List[str]) -> int:
    po = ParseOptions("Write to standard output various properties of GMM-based model\n"
                      "Usage: gmm-info [options] <model-in>")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    print(f"number of phones {len(tm.get_phones())}")
    print(f"number of pdfs {am.num_pdfs}")
    print(f"number of transition-ids {tm.num_transition_ids}")
    print(f"number of transition-states {tm.num_transition_states}")
    print(f"feature dimension {am.dim}")
    print(f"number of gaussians {am.num_gauss()}")
    return 0


def gmm_latgen_faster(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices using GMM-based model.\n"
        "Usage: gmm-latgen-faster [options] <model-in> <fst-in> "
        "<features-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier> [<alignments-wspecifier>]]")
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import _decode_loop, _Forward
    from kaldi_tpu_torch.decoder.lattice_decoder import \
        LatticeFasterDecoderOptions
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value("acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    allow_partial = po.register_value("allow-partial", False, "If true, produce output even if end state was not reached")
    word_symbol_table = po.register_value("word-symbol-table", "", "Symbol table for words [for debug output]")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 6:
        po.print_usage()
        return 1
    if allow_partial[0] or word_symbol_table[0]:
        raise NotImplementedError(
            "--allow-partial and --word-symbol-table are not ported (the "
            "reference accepts and ignores them)")
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))

    class GmmForward(_Forward):
        """_Forward's timing around the GMM's log-likelihoods."""

        def _output(self, x):
            return self.model.log_likes_device(x.to(self.device))

    forward = GmmForward(am)

    def items():
        for key, feats in SequentialTableReader("matrix", po.get_arg(3)):
            yield key, forward(feats).cpu().numpy(), len(feats)

    return _decode_loop(items(), po.get_arg(2), tm, forward,
                        acoustic_scale[0], dopts, po.get_arg(4),
                        po.get_arg(5) if po.num_args() >= 5 else None,
                        "gmm-latgen-faster",
                        po.get_arg(6) if po.num_args() >= 6 else None)


# ---------------------------------------------------------------------------
# discriminative (MMI) training: kaldi_tpu/cli/gmm_tools.py
# gmm-est-gaussians-ebw (:335), gmm-est-weights-ebw (:356),
# gmm-ismooth-stats (:382); kaldi_tpu/cli/tail10_tools.py gmm-acc-stats2
# (:195); kaldi_tpu/cli/tail5_tools.py gmm-rescore-lattice (:592)


def gmm_est_gaussians_ebw(argv: List[str]) -> int:
    po = ParseOptions(
        "Update GMM means and variances with Extended Baum-Welch from\n"
        "numerator and denominator stats (discriminative MMI/MPE)\n"
        "Usage: gmm-est-gaussians-ebw [options] <model-in> <num-stats-in> "
        "<den-stats-in> <model-out>")
    from kaldi_tpu_torch.gmm.ebw import EbwOptions, update_ebw_am_diag_gmm
    opts = EbwOptions()
    po.register_struct(opts)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    num = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(2))
    den = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(3))
    update_ebw_am_diag_gmm(num, den, am, opts)
    write_am_gmm(po.get_arg(4), tm, am)
    return 0


def gmm_est_weights_ebw(argv: List[str]) -> int:
    po = ParseOptions(
        "Update GMM weights with Extended Baum-Welch\n"
        "Usage: gmm-est-weights-ebw [options] <model-in> <num-stats-in> "
        "<den-stats-in> <model-out>")
    from kaldi_tpu_torch.gmm.ebw import update_ebw_weights_diag_gmm
    weight_iters = po.register_value(
        "weight-iters", 1, "Iterations of the weight auxiliary solve")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    num = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(2))
    den = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(3))
    impr = 0.0
    for pdf in range(am.num_pdfs):
        impr += update_ebw_weights_diag_gmm(num.accs[pdf], den.accs[pdf],
                                            am.get_pdf(pdf),
                                            weight_iters[0])
    am.invalidate_pack()
    log(f"EBW weight update: total auxf impr {impr:.2f}")
    write_am_gmm(po.get_arg(4), tm, am)
    return 0


def gmm_ismooth_stats(argv: List[str]) -> int:
    po = ParseOptions(
        "Apply I-smoothing to GMM stats (add tau frames of the source\n"
        "stats' per-Gaussian average to the destination)\n"
        "Usage: gmm-ismooth-stats [options] <src-stats-in> <dst-stats-in> "
        "<stats-out>")
    from kaldi_tpu_torch.gmm.ebw import ismooth_stats_diag_gmm
    tau = po.register_value("tau", 100.0, "I-smoothing constant")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    src = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(1))
    dst = kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, po.get_arg(2))
    for pdf in range(len(dst.accs)):
        ismooth_stats_diag_gmm(src.accs[pdf], tau[0], dst.accs[pdf])
    kaldi_io.write_kaldi_object(dst.write, po.get_arg(3), binary=True)
    return 0


def gmm_acc_stats2(argv: List[str]) -> int:
    po = ParseOptions(
        "Accumulate numerator and denominator GMM stats in one pass "
        "from SIGNED posteriors (gmm-acc-stats2.cc; positive weights "
        "feed the num accs, negative the den accs — the MMI "
        "accumulation contract).\n"
        "Usage: gmm-acc-stats2 [options] <model-in> "
        "<feats-rspecifier> <posteriors-rspecifier> <num-stats-out> "
        "<den-stats-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    tm, am = read_am_gmm(po.get_arg(1), device="cpu")
    post_reader = RandomAccessTableReader("posterior", po.get_arg(3))
    num = AccumAmDiagGmm(am, num_transition_ids=tm.num_transition_ids)
    den = AccumAmDiagGmm(am, num_transition_ids=tm.num_transition_ids)
    n = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        if key not in post_reader:
            warn(f"no posteriors for {key}")
            err += 1
            continue
        post = post_reader[key]
        pos = [[(tid, w) for tid, w in frame if w > 0]
               for frame in post]
        neg = [[(tid, -w) for tid, w in frame if w < 0]
               for frame in post]
        num.accumulate_posterior(am, tm, np.asarray(feats), pos)
        den.accumulate_posterior(am, tm, np.asarray(feats), neg)
        n += 1
    kaldi_io.write_kaldi_object(num.write, po.get_arg(4), binary[0])
    kaldi_io.write_kaldi_object(den.write, po.get_arg(5), binary[0])
    log(f"accumulated num/den stats from {n} utterances ({err} "
        "errors)")
    return 0 if n else 1


def gmm_rescore_lattice(argv: List[str]) -> int:
    po = ParseOptions(
        "Replace lattice acoustic scores with a (new) GMM model's.\n"
        "Usage: gmm-rescore-lattice [options] <model-in> "
        "<lattice-rspecifier> <feats-rspecifier> <lattice-wspecifier>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.nnet3.discriminative_train import \
        rescore_lattice_acoustics
    tm, am = read_am_gmm(po.get_arg(1), device=_device(use_gpu[0]))
    feats_reader = RandomAccessTableReader("matrix", po.get_arg(3))
    writer = TableWriter(LatticeHolder(), po.get_arg(4))
    n = err = 0
    for key, lat in SequentialTableReader(LatticeHolder(),
                                          po.get_arg(2)):
        if key not in feats_reader:
            warn(f"no feats for {key}")
            err += 1
            continue
        ll = am.log_likes_batch(feats_reader[key])
        writer.write(key, rescore_lattice_acoustics(lat, tm, ll))
        n += 1
    writer.close()
    log(f"rescored {n} lattices ({err} errors)")
    return 0 if n else 1


# ---------------------------------------------------------------------------
# decoding from log-likelihood matrices: kaldi_tpu/cli/gmm_tools.py
# latgen-faster-mapped (:402); kaldi_tpu/cli/tail5_tools.py
# decode-faster-mapped (:623)


def _read_tm(rxfilename: str) -> TransitionModel:
    """Just the TransitionModel of a model file (it leads every .mdl)."""
    with kaldi_io.input_stream(rxfilename) as f:
        return TransitionModel.read(f, iof.init_input_stream(f))


class _NoForward:
    """The stats line's forward fields for a tool that reads its
    log-likelihoods instead of computing them."""
    device = torch.device("cpu")
    host_s = 0.0
    span_ms = 0.0
    calls = 0


def latgen_faster_mapped(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices, reading log-likelihoods as matrices\n"
        "(model is needed only for the integer mappings in its "
        "transition-model)\n"
        "Usage: latgen-faster-mapped [options] <model-in> <fst-in> "
        "<loglikes-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier> [<alignments-wspecifier>]]")
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import _decode_loop
    from kaldi_tpu_torch.decoder.lattice_decoder import \
        LatticeFasterDecoderOptions
    dopts = LatticeFasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 6:
        po.print_usage()
        return 1
    tm = _read_tm(po.get_arg(1))

    def items():
        for key, loglikes in SequentialTableReader("matrix",
                                                   po.get_arg(3)):
            loglikes = np.asarray(loglikes)
            yield key, loglikes, len(loglikes)

    return _decode_loop(items(), po.get_arg(2), tm, _NoForward(),
                        acoustic_scale[0], dopts, po.get_arg(4),
                        po.get_arg(5) if po.num_args() >= 5 else None,
                        "latgen-faster-mapped",
                        po.get_arg(6) if po.num_args() >= 6 else None)


def decode_faster_mapped(argv: List[str]) -> int:
    po = ParseOptions(
        "Best-path decode from loglike matrices (rows indexed by "
        "transition-id via the model's pdf map).\n"
        "Usage: decode-faster-mapped [options] <model-in> <fst-in> "
        "<loglikes-rspecifier> <words-wspecifier> "
        "[<alignments-wspecifier>]")
    from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                 FasterDecoderOptions)
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    dopts = FasterDecoderOptions()
    po.register_struct(dopts)
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    po.read(argv)
    if po.num_args() < 4 or po.num_args() > 5:
        po.print_usage()
        return 1
    tm = _read_tm(po.get_arg(1))
    hclg = read_fst_file(po.get_arg(2))
    word_writer = TableWriter("int-vector", po.get_arg(4))
    ali_writer = (TableWriter("int-vector", po.get_arg(5))
                  if po.num_args() >= 5 else None)
    dec = FasterDecoder(hclg, dopts)
    n = err = 0
    for key, ll in SequentialTableReader("matrix", po.get_arg(3)):
        res = dec.decode(np.asarray(ll), tm.id2pdf_id,
                         acoustic_scale=acoustic_scale[0])
        if res is None:
            warn(f"decode failed for {key}")
            err += 1
            continue
        ali, words, _cost = res
        word_writer.write(key, words)
        if ali_writer:
            ali_writer.write(key, ali)
        n += 1
    word_writer.close()
    if ali_writer:
        ali_writer.close()
    log(f"decoded {n} utterances ({err} failed)")
    return 0 if n else 1
