"""MLE accumulation and update for diagonal GMMs (port of
`MleDiagGmmOptions`, `AccumDiagGmm`, `AccumAmDiagGmm` and
`mle_am_diag_gmm_update` of `kaldi_tpu/gmm/mle.py`; parity:
gmm/mle-diag-gmm.h:106, mle-am-diag-gmm.h:34).  Host-side numpy, as in
the reference: given per-frame posteriors over components (or Viterbi
one-hots over pdfs) the sufficient statistics are weighted matmuls.
`AccumDiagGmm.accumulate_device` accumulates a global UBM's statistics
on a device (the gmm-global-* tools).

The accumulators serialize as the reference's do (gmm-acc-stats-ali /
gmm-sum-accs files), byte for byte.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.device import frame_chunks
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm

_log = logging.getLogger(__name__)


@dataclass
class MleDiagGmmOptions:
    min_gaussian_weight: float = field(default=1e-5, metadata={
        "doc": "Min Gaussian weight before we remove it"})
    min_gaussian_occupancy: float = field(default=10.0, metadata={
        "doc": "Minimum occupancy to update a Gaussian"})
    min_variance: float = field(default=0.001, metadata={
        "doc": "Variance floor (absolute variance)"})
    remove_low_count_gaussians: bool = field(default=True, metadata={
        "doc": "If true, remove Gaussians that fall below the floors"})


class AccumDiagGmm:
    def __init__(self, num_comp: int = 0, dim: int = 0, flags: str = "mvw"):
        self.flags = flags
        self.occupancy = np.zeros(num_comp, np.float64)
        self.mean_accs = np.zeros((num_comp, dim), np.float64)
        self.var_accs = np.zeros((num_comp, dim), np.float64)

    @property
    def num_comp(self):
        return self.occupancy.shape[0]

    @property
    def dim(self):
        return self.mean_accs.shape[1]

    def accumulate(self, data: np.ndarray, posteriors: np.ndarray) -> None:
        """data (T, D), posteriors (T, M)."""
        data = np.asarray(data, np.float64)
        post = np.asarray(posteriors, np.float64)
        self.occupancy += post.sum(axis=0)
        if "m" in self.flags:
            self.mean_accs += post.T @ data
        if "v" in self.flags:
            self.var_accs += post.T @ (data * data)

    def accumulate_from_gmm(self, gmm: DiagGmm, data: np.ndarray,
                            frame_weights: Optional[np.ndarray] = None
                            ) -> float:
        """Accumulate with GMM-computed posteriors; returns total loglike."""
        data = np.atleast_2d(np.asarray(data, np.float64))
        post = gmm.component_posteriors(data)
        ll = gmm.log_likelihood(data)
        if frame_weights is not None:
            post = post * np.asarray(frame_weights)[:, None]
            ll = ll * np.asarray(frame_weights)
        self.accumulate(data, post)
        return float(ll.sum())

    def accumulate_device(self, scorer, feats_list, stats_list=None,
                          weights_list=None) -> Tuple[float, int]:
        """`accumulate_from_gmm` of every utterance of `feats_list` (host
        (T, D) arrays) against the diagonal UBM of `scorer`
        (`gmm.ubm.UbmScorer`) on its device: float32 scores and
        posteriors as the reference computes them, float64 statistics ->
        (total log-likelihood, frames).  With `stats_list` (arrays of the
        same lengths as `feats_list`'s) the posteriors of `feats_list`'s
        frames weight the statistics of `stats_list`'s
        (gmm-global-acc-stats-twofeats).  With `weights_list` ((T,)
        arrays) each frame's posteriors and log-likelihood are scaled by
        its weight, as `accumulate_from_gmm`'s frame_weights
        (gmm-acc-stats-twofeats)."""
        dev = scorer.device
        M, D = self.num_comp, self.dim
        occ = torch.zeros(M, dtype=torch.float64, device=dev)
        mean = torch.zeros((M, D), dtype=torch.float64, device=dev)
        var = torch.zeros((M, D), dtype=torch.float64, device=dev)
        like = torch.zeros((), dtype=torch.float64, device=dev)
        frames = 0
        chunks = frame_chunks(feats_list, dev)
        pairs = (((x, x) for x in chunks) if stats_list is None
                 else zip(chunks, frame_chunks(stats_list, dev)))
        weights = (itertools.repeat(None) if weights_list is None
                   else frame_chunks(weights_list, dev))
        for (x_post, x), w in zip(pairs, weights):
            x32 = x_post.to(torch.float32)
            post = scorer.posteriors(x32).to(torch.float64)
            ll = scorer.log_likelihood(x32).to(torch.float64)
            if w is not None:
                post = post * w[:, None]
                ll = ll * w
            like += ll.sum()
            occ += post.sum(dim=0)
            if "m" in self.flags:
                mean += post.T @ x
            if "v" in self.flags:
                var += post.T @ (x * x)
            frames += x.shape[0]
        self.occupancy += occ.cpu().numpy()
        self.mean_accs += mean.cpu().numpy()
        self.var_accs += var.cpu().numpy()
        return float(like), frames

    def add(self, other: "AccumDiagGmm") -> None:
        self.occupancy += other.occupancy
        self.mean_accs += other.mean_accs
        self.var_accs += other.var_accs

    # -- serialization (gmm-acc-stats / gmm-sum-accs) -----------------------

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<GMMACCS>")
        iof.write_token(stream, binary, "<VECSIZE>")
        iof.write_int32(stream, binary, self.dim)
        iof.write_token(stream, binary, "<NUMCOMPONENTS>")
        iof.write_int32(stream, binary, self.num_comp)
        iof.write_token(stream, binary, "<FLAGS>")
        iof.write_token(stream, binary, self.flags)
        iof.write_token(stream, binary, "<OCCUPANCY>")
        iof.write_vector(stream, binary, self.occupancy)
        iof.write_token(stream, binary, "<MEANACCS>")
        iof.write_matrix(stream, binary, self.mean_accs)
        iof.write_token(stream, binary, "<DIAGVARACCS>")
        iof.write_matrix(stream, binary, self.var_accs)
        iof.write_token(stream, binary, "</GMMACCS>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "AccumDiagGmm":
        iof.expect_token(stream, binary, "<GMMACCS>")
        iof.expect_token(stream, binary, "<VECSIZE>")
        dim = iof.read_int32(stream, binary)
        iof.expect_token(stream, binary, "<NUMCOMPONENTS>")
        n = iof.read_int32(stream, binary)
        iof.expect_token(stream, binary, "<FLAGS>")
        flags = iof.read_token(stream, binary)
        acc = cls(n, dim, flags)
        iof.expect_token(stream, binary, "<OCCUPANCY>")
        acc.occupancy = iof.read_vector(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "<MEANACCS>")
        acc.mean_accs = iof.read_matrix(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "<DIAGVARACCS>")
        acc.var_accs = iof.read_matrix(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "</GMMACCS>")
        return acc

def mle_diag_gmm_update(opts: MleDiagGmmOptions, acc: AccumDiagGmm,
                        gmm: DiagGmm) -> Tuple[float, float]:
    """In-place MLE update (mle-diag-gmm.cc MleDiagGmmUpdate).
    Returns (objf improvement estimate, total count)."""
    occ = acc.occupancy
    tot = occ.sum()
    if tot == 0:
        _log.warning("no stats to update GMM")
        return 0.0, 0.0
    keep = occ > opts.min_gaussian_occupancy
    if not keep.any():
        _log.warning("all Gaussians below min occupancy; not updating")
        return 0.0, tot

    old_means = gmm.get_means().astype(np.float64)
    old_vars = gmm.get_vars().astype(np.float64)
    weights = occ / tot
    means = np.where(keep[:, None],
                     acc.mean_accs / np.maximum(occ[:, None], 1e-10),
                     old_means)
    if "v" in acc.flags:
        variances = np.where(
            keep[:, None],
            acc.var_accs / np.maximum(occ[:, None], 1e-10) - means ** 2,
            old_vars)
        variances = np.maximum(variances, opts.min_variance)
    else:
        variances = old_vars
    weights = np.maximum(weights, opts.min_gaussian_weight)
    weights /= weights.sum()

    if opts.remove_low_count_gaussians and (~keep).any() and keep.sum() >= 1:
        weights, means, variances = (weights[keep], means[keep],
                                     variances[keep])
        weights /= weights.sum()
    gmm.set_from_means_and_vars(weights, means, variances)
    return 0.0, float(tot)


class AccumAmDiagGmm:
    """Per-pdf accumulators (mle-am-diag-gmm.h:34) + transition stats."""

    def __init__(self, am: Optional[AmDiagGmm] = None, flags: str = "mvw",
                 num_transition_ids: int = 0):
        self.accs: List[AccumDiagGmm] = []
        if am is not None:
            self.accs = [AccumDiagGmm(g.num_gauss, g.dim, flags)
                         for g in am.densities]
        self.transition_accs = np.zeros(num_transition_ids + 1, np.float64)
        self.total_loglike = 0.0
        self.total_frames = 0.0

    def accumulate_for_pdf(self, am: AmDiagGmm, pdf: int, frame: np.ndarray,
                           weight: float = 1.0) -> float:
        ll = self.accs[pdf].accumulate_from_gmm(
            am.get_pdf(pdf), frame[None, :], np.array([weight]))
        self.total_loglike += ll
        self.total_frames += weight
        return ll

    def accumulate_alignment(self, am: AmDiagGmm, trans_model,
                             feats: np.ndarray,
                             alignment: List[int]) -> float:
        """Accumulate GMM + transition stats from a Viterbi alignment
        (gmm-acc-stats-ali main loop, vectorized per pdf)."""
        alignment = np.asarray(alignment, np.int64)
        assert len(alignment) == feats.shape[0]
        np.add.at(self.transition_accs, alignment, 1.0)
        pdfs = trans_model.transition_ids_to_pdfs(alignment)
        total = 0.0
        for pdf in np.unique(pdfs):
            idx = np.nonzero(pdfs == pdf)[0]
            sub = feats[idx]
            ll = self.accs[pdf].accumulate_from_gmm(am.get_pdf(pdf), sub)
            total += ll
        self.total_loglike += total
        self.total_frames += len(alignment)
        return total


    def accumulate_posterior(self, am: AmDiagGmm, trans_model,
                             feats: np.ndarray, post) -> float:
        """Accumulate from per-frame (transition-id, weight) posteriors
        (gmm-acc-stats2 with lattice posteriors, the denominator side of
        MMI training), grouped by pdf so each GMM sees one batched
        weighted accumulate."""
        by_pdf: dict = {}
        for t, entries in enumerate(post):
            if t >= feats.shape[0]:
                break
            for tid, w in entries:
                if tid <= 0 or w == 0.0:
                    continue
                pdf = trans_model.transition_id_to_pdf(tid)
                by_pdf.setdefault(pdf, ([], []))
                by_pdf[pdf][0].append(t)
                by_pdf[pdf][1].append(w)
                self.transition_accs[tid] += w
        total = 0.0
        frames = 0.0
        for pdf, (idx, w) in by_pdf.items():
            wa = np.asarray(w, np.float64)
            ll = self.accs[pdf].accumulate_from_gmm(
                am.get_pdf(pdf), feats[np.asarray(idx)], wa)
            total += ll
            frames += wa.sum()
        self.total_loglike += total
        self.total_frames += frames
        return total

    def add(self, other: "AccumAmDiagGmm") -> None:
        for a, b in zip(self.accs, other.accs):
            a.add(b)
        self.transition_accs += other.transition_accs
        self.total_loglike += other.total_loglike
        self.total_frames += other.total_frames

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<AMDIAGGMMACCS>")
        iof.write_int32(stream, binary, len(self.accs))
        for a in self.accs:
            a.write(stream, binary)
        iof.write_token(stream, binary, "<TRANSACCS>")
        iof.write_vector(stream, binary, self.transition_accs)
        iof.write_token(stream, binary, "<TOTALS>")
        iof.write_double(stream, binary, self.total_loglike)
        iof.write_double(stream, binary, self.total_frames)
        iof.write_token(stream, binary, "</AMDIAGGMMACCS>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "AccumAmDiagGmm":
        obj = cls()
        iof.expect_token(stream, binary, "<AMDIAGGMMACCS>")
        n = iof.read_int32(stream, binary)
        obj.accs = [AccumDiagGmm.read(stream, binary) for _ in range(n)]
        iof.expect_token(stream, binary, "<TRANSACCS>")
        obj.transition_accs = iof.read_vector(stream,
                                              binary).astype(np.float64)
        iof.expect_token(stream, binary, "<TOTALS>")
        obj.total_loglike = iof.read_double(stream, binary)
        obj.total_frames = iof.read_double(stream, binary)
        iof.expect_token(stream, binary, "</AMDIAGGMMACCS>")
        return obj

def mle_am_diag_gmm_update(opts: MleDiagGmmOptions, acc: AccumAmDiagGmm,
                           am: AmDiagGmm, trans_model=None,
                           mixup: Optional[int] = None,
                           perturb_factor: float = 0.01) -> None:
    """Update every pdf (and optionally transitions + mixing-up)."""
    tot_count = 0.0
    for pdf in range(am.num_pdfs):
        _, c = mle_diag_gmm_update(opts, acc.accs[pdf], am.get_pdf(pdf))
        tot_count += c
    if trans_model is not None:
        impr, tcount = trans_model.mle_update(acc.transition_accs)
        _log.info("transition update: impr/frame %.4f over %s frames",
                  impr, tcount)
    if mixup is not None and mixup > am.num_gauss():
        _mixup(am, acc, mixup, perturb_factor)
    am.invalidate_pack()
    _log.info("GMM update done over %s frames", tot_count)


def _mixup(am: AmDiagGmm, acc: AccumAmDiagGmm, target: int,
           perturb_factor: float) -> None:
    """Distribute new Gaussians proportionally to pdf occupancy
    (am-diag-gmm.cc SplitByCount)."""
    occs = np.array([a.occupancy.sum() for a in acc.accs])
    tot = occs.sum()
    if tot <= 0:
        return
    current = np.array([g.num_gauss for g in am.densities])
    targets = np.maximum(current,
                         np.floor(occs / tot * target + 0.5).astype(int))
    # adjust to hit the global target approximately
    rng = np.random.default_rng(0)
    for pdf in np.argsort(-occs):
        if targets.sum() >= target:
            break
        targets[pdf] += 1
    for pdf, g in enumerate(am.densities):
        if targets[pdf] > g.num_gauss:
            g.split(int(targets[pdf]), perturb_factor, rng)
    am.invalidate_pack()
