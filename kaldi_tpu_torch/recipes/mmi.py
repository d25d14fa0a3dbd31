"""Discriminative GMM training: lattice-based MMI with EBW updates (port
of kaldi_tpu/recipes/mmi.py).

Parity: steps/train_mmi.sh + gmmbin/gmm-rescore-lattice +
gmm-acc-stats2 + gmm-est-gaussians-ebw / gmm-est-weights-ebw.
Numerator statistics come from the reference transcription's Viterbi
alignment, denominator statistics from forward-backward posteriors of
lattices decoded against a weak (unigram) LM, and the model-space update
is Extended Baum-Welch (`gmm/ebw.py`).  The GMM log-likelihoods of the
alignment and of the lattice decode are scored on the GMMs' device (the
card unless the system was loaded for the CPU); the lattice search, the
forward-backward and the statistics stay on the host, as in the
reference.

Boosted MMI (b > 0) lowers each lattice arc's graph cost by b x its
frame's phone error against the numerator alignment, as Kaldi's
lattice-boost-ali does (Povey et al. 2008: the denominator paths are
weighted by exp(-b x accuracy)), so the in-process loop and the tool
chain (`lattice-boost-ali`) boost alike.  The reference package's
`_boost_lattice` lowers the cost of the arcs that MATCH the numerator
instead, the opposite sign (ROADMAP.md §3)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.decoder.graph import TrainingGraphCompiler
from kaldi_tpu_torch.decoder.lattice_decoder import (
    LatticeFasterDecoder, LatticeFasterDecoderOptions)
from kaldi_tpu_torch.fstext.fst import VectorFst
from kaldi_tpu_torch.gmm.ebw import EbwOptions, update_ebw_am_diag_gmm
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm
from kaldi_tpu_torch.lat.functions import (boost_lattice_phone_errors,
                                           lattice_forward_backward_post)
from kaldi_tpu_torch.recipes.mono import (MonoSystem, _align_all,
                                          _batch_loglikes, make_hclg)


@dataclass
class TrainMmiOptions:
    num_iters: int = 4
    acoustic_scale: float = 0.1
    beam: float = 16.0
    lattice_beam: float = 10.0
    align_beam: float = 10.0
    transition_scale: float = 1.0
    self_loop_scale: float = 0.1
    boost: float = 0.0             # boosted MMI factor b
    ebw: EbwOptions = field(default_factory=lambda: EbwOptions(
        E=2.0, tau=100.0))
    update_weights: bool = False


def _boost_lattice(lat, alignment: Sequence[int], tm, boost: float):
    """The lattice boosted by boost x each arc's frame phone error
    against `alignment` (lattice-boost-ali without silence phones)."""
    ref = [tm.transition_id_to_phone(t) for t in alignment]
    return boost_lattice_phone_errors(lat, tm, ref, boost)


def mmi_objf(num_acc: AccumAmDiagGmm, den_acc: AccumAmDiagGmm,
             acoustic_scale: float) -> float:
    """Per-frame MMI criterion estimate from the accumulators."""
    frames = max(num_acc.total_frames, 1.0)
    return acoustic_scale * (num_acc.total_loglike
                             - den_acc.total_loglike) / frames


def train_mmi(sys_: MonoSystem, feats: Dict[str, np.ndarray],
              transcripts: Dict[str, List[str]], g_fst: VectorFst,
              opts: Optional[TrainMmiOptions] = None,
              timing: Optional[Dict[str, float]] = None) -> List[float]:
    """Run MMI/bMMI iterations in place on sys_.am -> each iteration's
    objective.  `timing`, when given, gains the seconds of the scoring
    on the GMMs' device with the Viterbi alignment ("align_s"), of the
    batched lattice log-likelihoods ("score_s"), of the host lattice
    work (decode, boost, forward-backward: "lattice_s") and of the
    statistics and the update ("update_s")."""
    opts = opts or TrainMmiOptions()
    timing = {} if timing is None else timing
    for k in ("align_s", "score_s", "lattice_s", "update_s"):
        timing.setdefault(k, 0.0)
    compiler = TrainingGraphCompiler(sys_.tm, sys_.tree, sys_.lang,
                                     opts.transition_scale,
                                     opts.self_loop_scale)
    graphs = {u: compiler.compile(transcripts[u]) for u in feats}
    hclg = make_hclg(sys_, g_fst, opts.transition_scale,
                     opts.self_loop_scale)
    lat_dec = LatticeFasterDecoder(hclg, LatticeFasterDecoderOptions(
        beam=opts.beam, lattice_beam=opts.lattice_beam))
    utts = list(feats)
    objs: List[float] = []
    for it in range(opts.num_iters):
        num_acc = AccumAmDiagGmm(
            sys_.am, num_transition_ids=sys_.tm.num_transition_ids)
        den_acc = AccumAmDiagGmm(
            sys_.am, num_transition_ids=sys_.tm.num_transition_ids)
        t0 = time.perf_counter()
        alignments = _align_all(sys_, graphs, feats, opts.align_beam,
                                opts.acoustic_scale,
                                opts.transition_scale)
        t1 = time.perf_counter()
        loglikes = _batch_loglikes(sys_, feats)
        timing["align_s"] += t1 - t0
        timing["score_s"] += time.perf_counter() - t1
        for i, u in enumerate(utts):
            if u not in alignments:
                continue
            f = feats[u]
            t0 = time.perf_counter()
            num_acc.accumulate_alignment(sys_.am, sys_.tm, f,
                                         alignments[u])
            t1 = time.perf_counter()
            lat = lat_dec.decode(loglikes[i, :f.shape[0]],
                                 sys_.tm.id2pdf_id, opts.acoustic_scale)
            if lat is None:
                warn(f"MMI: lattice decode failed for {u}")
                timing["lattice_s"] += time.perf_counter() - t1
                continue
            if opts.boost > 0:
                lat = _boost_lattice(lat, alignments[u], sys_.tm,
                                     opts.boost)
            post = lattice_forward_backward_post(lat, 1.0)
            t2 = time.perf_counter()
            den_acc.accumulate_posterior(sys_.am, sys_.tm, f, post)
            timing["lattice_s"] += t2 - t1
            timing["update_s"] += (t1 - t0) + (time.perf_counter() - t2)
        obj = mmi_objf(num_acc, den_acc, opts.acoustic_scale)
        objs.append(obj)
        log(f"MMI iter {it}: objf/frame {obj:.4f} "
            f"(num {num_acc.total_frames:.0f} frames, "
            f"den {den_acc.total_frames:.0f})")
        t0 = time.perf_counter()
        update_ebw_am_diag_gmm(num_acc, den_acc, sys_.am, opts.ebw,
                               opts.update_weights)
        timing["update_s"] += time.perf_counter() - t0
    return objs
