"""LDA+MLLT and SAT (fMLLR) training (port of `kaldi_tpu/recipes/
lda_mllt.py`; parity: steps/train_lda_mllt.sh and steps/train_sat.sh).

train_lda_mllt: splice the raw features, estimate LDA from the aligned
classes, train a triphone system in the transformed space with periodic
MLLT (STC) updates composed into the feature transform.

train_sat: speaker-adapted training, per-speaker fMLLR transforms
estimated between EM iterations and applied to the features.

The statistics of LDA, MLLT and fMLLR run in float64 on the GMMs' device,
each pass over all utterances (a speaker's, for fMLLR) at once; the
feature transforms in float32 there too, an utterance at a time; the
solves and the searches on the host, as in the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.feat.functions import splice_frames
from kaldi_tpu_torch.recipes.deltas import TrainDeltasOptions, train_deltas
from kaldi_tpu_torch.recipes.mono import (MonoSystem, TrainMonoOptions,
                                          _align_all, _estimate)
from kaldi_tpu_torch.transform.fmllr import (FmllrDiagGmmAccs,
                                             alignment_groups,
                                             apply_affine_transform)
from kaldi_tpu_torch.transform.lda import LdaEstimate, LdaOptions
from kaldi_tpu_torch.transform.mllt import MlltAccs

_log = logging.getLogger(__name__)


@dataclass
class TrainLdaMlltOptions(TrainDeltasOptions):
    lda_dim: int = 40
    splice_left: int = 3
    splice_right: int = 3
    mllt_iters: Sequence[int] = field(default_factory=lambda: (2, 4, 6))


def transform_all(feats: Dict[str, np.ndarray], W: np.ndarray,
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """`apply_affine_transform` of every utterance on its own, as the
    reference and transform-feats apply it: a product's float32 rounding
    depends on its shape on the card, so one product of all the
    utterances would round otherwise than the tool does."""
    return {u: apply_affine_transform(f, W, device) for u, f in feats.items()}


def lda_estimate(sys_: MonoSystem, feats_spliced: Dict[str, np.ndarray],
                 alignments: Dict[str, List[int]]) -> LdaEstimate:
    """The LDA statistics of the aligned frames, by pdf."""
    tm = sys_.tm
    xs, classes = [], []
    for utt, ali in alignments.items():
        f = feats_spliced[utt]
        T = min(f.shape[0], len(ali))
        xs.append(f[:T])
        classes.append(tm.transition_ids_to_pdfs(ali[:T]))
    est = LdaEstimate(tm.num_pdfs, xs[0].shape[1], device=sys_.am.device)
    est.accumulate_batch(np.concatenate(xs), np.concatenate(classes))
    return est


def estimate_lda(sys_: MonoSystem, feats_spliced: Dict[str, np.ndarray],
                 alignments: Dict[str, List[int]], dim: int) -> np.ndarray:
    lda, _ = lda_estimate(sys_, feats_spliced, alignments).estimate(
        LdaOptions(dim=dim))
    return lda


def mllt_groups(sys_: MonoSystem, feats: Dict[str, np.ndarray],
                alignments: Dict[str, List[int]]):
    """(gmm, frames, Gaussian posteriors) of each pdf of each aligned
    utterance, as the reference's MLLT pass forms them."""
    groups = []
    for utt, ali in alignments.items():
        f = feats[utt]
        T = min(f.shape[0], len(ali))
        groups.extend(alignment_groups(sys_.am, sys_.tm, f[:T], ali[:T]))
    return groups


def train_lda_mllt(lang: Lang, raw_feats: Dict[str, np.ndarray],
                   transcripts: Dict[str, List[str]],
                   prev_sys: MonoSystem,
                   prev_alignments: Dict[str, List[int]],
                   opts: Optional[TrainLdaMlltOptions] = None
                   ) -> Tuple[MonoSystem, np.ndarray, Dict[str, np.ndarray]]:
    """Returns (system, final feature transform (affine), transformed
    features).  Runs on prev_sys's device."""
    if opts is None:
        opts = TrainLdaMlltOptions()
    device = prev_sys.am.device
    spliced = {u: splice_frames(f, opts.splice_left, opts.splice_right)
               for u, f in raw_feats.items()}
    transform = estimate_lda(prev_sys, spliced, prev_alignments,
                             opts.lda_dim)  # (dim, spliced_dim + 1)
    feats = transform_all(spliced, transform, device)
    # a triphone system in the LDA space from the converted alignments
    sys_ = train_deltas(lang, feats, transcripts, prev_sys,
                        prev_alignments, opts)
    compiler = TrainingGraphCompiler(sys_.tm, sys_.tree, lang,
                                     opts.transition_scale,
                                     opts.self_loop_scale)
    graphs = {u: compiler.compile(transcripts[u]) for u in feats}
    alignments = _align_all(sys_, graphs, feats, opts.beam,
                            opts.acoustic_scale, opts.transition_scale)
    # MLLT iterations: estimate STC in the current space, compose it into
    # the global transform, transform the means
    for it in opts.mllt_iters:
        accs = MlltAccs(opts.lda_dim, device=device)
        accs.accumulate_groups(mllt_groups(sys_, feats, alignments))
        M, impr = accs.update()
        _log.info("MLLT iteration %d: objf impr %.4f", it, impr)
        # compose: transform <- M @ transform ; means <- M @ means
        transform = np.concatenate(
            [M @ transform[:, :-1], (M @ transform[:, -1])[:, None]], axis=1)
        for g in sys_.am.densities:
            means = g.get_means() @ M.T
            g.set_from_means_and_vars(g.weights, means, g.get_vars())
        sys_.am.invalidate_pack()
        feats = transform_all(spliced, transform, device)
        alignments = _align_all(sys_, graphs, feats, opts.beam,
                                opts.acoustic_scale, opts.transition_scale,
                                prev=alignments)
        _estimate(sys_, feats, alignments,
                  TrainMonoOptions(min_gaussian_occupancy=
                                   opts.min_gaussian_occupancy),
                  mixup=None)
    return sys_, transform, feats


@dataclass
class TrainSatOptions(TrainDeltasOptions):
    fmllr_iters: Sequence[int] = field(default_factory=lambda: (2, 4, 6))
    fmllr_min_count: float = 100.0


def speaker_fmllr_accs(sys_: MonoSystem, feats: Dict[str, np.ndarray],
                       alignments: Dict[str, List[int]],
                       utt2spk: Dict[str, str]
                       ) -> Dict[str, FmllrDiagGmmAccs]:
    """Each speaker's fMLLR statistics over its aligned utterances (an
    utterance with no speaker is its own), one device pass a speaker."""
    groups: Dict[str, list] = {}
    for utt, ali in alignments.items():
        f = feats[utt]
        T = min(f.shape[0], len(ali))
        groups.setdefault(utt2spk.get(utt, utt), []).extend(
            alignment_groups(sys_.am, sys_.tm, f[:T], ali[:T]))
    dim = next(iter(feats.values())).shape[1]
    out = {}
    for spk, gs in groups.items():
        out[spk] = FmllrDiagGmmAccs(dim, device=sys_.am.device)
        out[spk].accumulate_groups(gs)
    return out


def adapt_all(feats: Dict[str, np.ndarray], utt2spk: Dict[str, str],
              transforms: Dict[str, np.ndarray],
              device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Each utterance through its speaker's transform (the identity where
    the speaker has none)."""
    ident = _identity(next(iter(feats.values())).shape[1])
    return {u: apply_affine_transform(
        f, transforms.get(utt2spk.get(u, u), ident), device)
        for u, f in feats.items()}


def train_sat(lang: Lang, feats: Dict[str, np.ndarray],
              transcripts: Dict[str, List[str]],
              utt2spk: Dict[str, str],
              prev_sys: MonoSystem,
              prev_alignments: Dict[str, List[int]],
              opts: Optional[TrainSatOptions] = None
              ) -> Tuple[MonoSystem, Dict[str, np.ndarray]]:
    """Speaker-adapted training.  Returns (system, per-speaker fMLLR
    transforms).  Each pass estimates a speaker's transform from the
    untransformed features, as the reference does.  Runs on prev_sys's
    device."""
    if opts is None:
        opts = TrainSatOptions()
    device = prev_sys.am.device
    sys_ = train_deltas(lang, feats, transcripts, prev_sys,
                        prev_alignments, opts)
    compiler = TrainingGraphCompiler(sys_.tm, sys_.tree, lang,
                                     opts.transition_scale,
                                     opts.self_loop_scale)
    graphs = {u: compiler.compile(transcripts[u]) for u in feats}
    alignments = _align_all(sys_, graphs, feats, opts.beam,
                            opts.acoustic_scale, opts.transition_scale)
    transforms: Dict[str, np.ndarray] = {}
    for it in opts.fmllr_iters:
        # per-speaker fMLLR from the current alignments
        for spk, accs in speaker_fmllr_accs(sys_, feats, alignments,
                                            utt2spk).items():
            transforms[spk], _impr = accs.update(
                min_count=opts.fmllr_min_count)
        cur_feats = adapt_all(feats, utt2spk, transforms, device)
        alignments = _align_all(sys_, graphs, cur_feats, opts.beam,
                                opts.acoustic_scale, opts.transition_scale,
                                prev=alignments)
        _estimate(sys_, cur_feats, alignments,
                  TrainMonoOptions(min_gaussian_occupancy=
                                   opts.min_gaussian_occupancy),
                  mixup=None)
        _log.info("SAT iteration %d: %d speaker transforms", it,
                  len(transforms))
    return sys_, transforms


def _identity(dim: int) -> np.ndarray:
    return np.concatenate([np.eye(dim), np.zeros((dim, 1))],
                          axis=1).astype(np.float32)
