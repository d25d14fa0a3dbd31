"""Monophone GMM training (port of `TrainMonoOptions`, `MonoSystem`,
`init_mono`, `train_mono`, `_align_all` and `_estimate` of
`kaldi_tpu/recipes/mono.py`).

Parity: steps/train_mono.sh (flat start, equal alignment, EM with
realignment and Gaussian mixing-up, train_mono.sh:73-120 conventions).
The GMM statistics stay on the host in numpy; the loglikes of every
(frame, pdf) pair of an utterance batch come from the card
(`AmDiagGmm.log_likes_batch`), and the host's native beam Viterbi
(`decoder/native_viterbi.py`) aligns each utterance against its training
graph, falling back to the Python `FasterDecoder` where the native
library cannot be built.

Not carried over yet: `decode` and `make_hclg` (monophone decoding over
an HCLG).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
from kaldi_tpu_torch.decoder.native_viterbi import NativeViterbi, get_lib
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions,
                                             align_equal)
from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.fstext.fst import VectorFst
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.mle import (AccumAmDiagGmm, MleDiagGmmOptions,
                                     mle_am_diag_gmm_update)
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import (ContextDependency,
                                              monophone_context_dependency)

_log = logging.getLogger(__name__)

NATIVE, PYTHON = "native", "FasterDecoder"


@dataclass
class TrainMonoOptions:
    num_iters: int = 40
    max_iter_inc: int = 30
    totgauss: int = 1000
    beam: float = 6.0
    initial_beam: float = 10.0
    realign_iters: Sequence[int] = field(default_factory=lambda: (
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32,
        35, 38))
    transition_scale: float = 1.0
    acoustic_scale: float = 0.1
    self_loop_scale: float = 0.1
    min_gaussian_occupancy: float = 3.0


class MonoSystem:
    """A trained monophone system: lang + tree + transition model + GMMs.
    `aligner` names the aligner of the last `_align_all` (NATIVE or
    PYTHON); `avg_loglikes` holds each `_estimate`'s average loglike a
    frame; `word_graphs` the phone-level graphs of the training
    transcripts (`TrainingGraphCompiler.word_graph`, by utterance), from
    which a later compile with the trained transition model starts."""

    def __init__(self, lang: Lang, tree: ContextDependency,
                 tm: TransitionModel, am: AmDiagGmm):
        self.lang = lang
        self.tree = tree
        self.tm = tm
        self.am = am
        self.aligner: Optional[str] = None
        self.avg_loglikes: List[float] = []
        self.word_graphs: Dict[str, VectorFst] = {}


def init_mono(lang: Lang, feats: Sequence[np.ndarray],
              device: DeviceLike = None) -> MonoSystem:
    """Flat start (gmm-init-mono): trivial tree, one global-stats
    Gaussian per pdf.  The GMMs score on `device`."""
    topo = lang.topo or lang.make_topology()
    phones = sorted(lang.phones.values())
    npc = {p: topo.num_pdf_classes(p) for p in phones}
    tree = monophone_context_dependency(phones, npc)
    tm = TransitionModel(topo, tree)
    stack = np.concatenate([np.asarray(f) for f in feats], axis=0)
    mean = stack.mean(axis=0)
    var = np.maximum(stack.var(axis=0), 1e-4)
    am = AmDiagGmm(device=device)
    for _ in range(tree.num_pdfs):
        g = DiagGmm(1, stack.shape[1])
        g.set_from_means_and_vars([1.0], mean[None, :], var[None, :])
        am.add_pdf(g)
    return MonoSystem(lang, tree, tm, am)


def train_mono(lang: Lang, feats: Dict[str, np.ndarray],
               transcripts: Dict[str, List[str]],
               opts: Optional[TrainMonoOptions] = None,
               device: DeviceLike = None) -> MonoSystem:
    if opts is None:
        opts = TrainMonoOptions()
    sys_ = init_mono(lang, list(feats.values()), device=device)
    tm, tree, am = sys_.tm, sys_.tree, sys_.am
    compiler = TrainingGraphCompiler(tm, tree, lang, opts.transition_scale,
                                     opts.self_loop_scale)
    sys_.word_graphs = {utt: compiler.word_graph(lang.word_ids(
        transcripts[utt])) for utt in feats}
    graphs = {utt: compiler.expand(g)
              for utt, g in sys_.word_graphs.items()}
    _log.info("compiled %d training graphs", len(graphs))

    # iteration 0: equal alignment + first estimate
    alignments: Dict[str, List[int]] = {}
    for i, (utt, f) in enumerate(feats.items()):
        ali = align_equal(graphs[utt], f.shape[0], tm, seed=i)
        if ali is None:
            _log.warning("could not equal-align %s (%d frames); skipping",
                         utt, f.shape[0])
            continue
        alignments[utt] = ali
    _estimate(sys_, feats, alignments, opts, mixup=None)

    num_gauss = am.num_gauss()
    inc = ((opts.totgauss - num_gauss) // opts.max_iter_inc
           if opts.totgauss > num_gauss else 0)
    if opts.totgauss > num_gauss:
        inc = max(inc, 1)
    for it in range(1, opts.num_iters):
        if it in opts.realign_iters:
            beam = opts.initial_beam if it == 1 else opts.beam
            alignments = _align_all(sys_, graphs, feats, beam,
                                    opts.acoustic_scale,
                                    opts.transition_scale,
                                    prev=alignments)
        if num_gauss < opts.totgauss:
            num_gauss = min(opts.totgauss, num_gauss + inc)
        _estimate(sys_, feats, alignments, opts, mixup=num_gauss)
    return sys_


def _align_all(sys_: MonoSystem, graphs: Dict[str, VectorFst],
               feats: Dict[str, np.ndarray], beam: float,
               acoustic_scale: float, transition_scale: float,
               prev: Optional[Dict[str, List[int]]] = None
               ) -> Dict[str, List[int]]:
    """gmm-align-compiled equivalent: batched loglikes on the card, a
    host Viterbi per utterance (native where it builds), retried at 4x
    the beam when no path survives."""
    out: Dict[str, List[int]] = {}
    utts = list(feats.keys())
    lens = [feats[u].shape[0] for u in utts]
    dim = feats[utts[0]].shape[1]
    Tmax = max(lens)
    batch = np.zeros((len(utts), Tmax, dim), np.float32)
    for i, u in enumerate(utts):
        batch[i, :lens[i]] = feats[u]
    loglikes = sys_.am.log_likes_batch(batch)  # (B, Tmax, P)
    use_native = get_lib() is not None
    sys_.aligner = NATIVE if use_native else PYTHON
    id2pdf = sys_.tm.id2pdf_id
    for i, utt in enumerate(utts):
        ll = loglikes[i, :lens[i]]
        if use_native:
            nat = NativeViterbi(graphs[utt])
            res = nat.decode(ll, id2pdf, acoustic_scale, beam=beam)
            if res is None:
                res = nat.decode(ll, id2pdf, acoustic_scale, beam=beam * 4)
        else:
            res = FasterDecoder(graphs[utt], FasterDecoderOptions(
                beam=beam)).decode(ll, id2pdf, acoustic_scale)
            if res is None:
                # retry with a wide beam, like the steps' retry-beam
                res = FasterDecoder(graphs[utt], FasterDecoderOptions(
                    beam=beam * 4)).decode(ll, id2pdf, acoustic_scale)
        if res is None:
            _log.warning("alignment failed for %s", utt)
            if prev and utt in prev:
                out[utt] = prev[utt]
            continue
        out[utt] = res[0]
    return out


def _estimate(sys_: MonoSystem, feats: Dict[str, np.ndarray],
              alignments: Dict[str, List[int]], opts: TrainMonoOptions,
              mixup: Optional[int]) -> None:
    """gmm-acc-stats-ali + gmm-est."""
    acc = AccumAmDiagGmm(sys_.am,
                         num_transition_ids=sys_.tm.num_transition_ids)
    for utt, ali in alignments.items():
        acc.accumulate_alignment(sys_.am, sys_.tm, feats[utt], ali)
    gopts = MleDiagGmmOptions(
        min_gaussian_occupancy=opts.min_gaussian_occupancy)
    mle_am_diag_gmm_update(gopts, acc, sys_.am, sys_.tm, mixup=mixup)
    if acc.total_frames:
        sys_.avg_loglikes.append(acc.total_loglike / acc.total_frames)
        _log.info("avg loglike/frame %.4f over %d frames; %d gaussians",
                  sys_.avg_loglikes[-1], int(acc.total_frames),
                  sys_.am.num_gauss())
