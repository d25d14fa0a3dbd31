"""Extended Baum-Welch (EBW) discriminative GMM updates (port of
kaldi_tpu/gmm/ebw.py; host float64 numpy, as in the reference: the
updates work on per-Gaussian statistics that the card accumulated).

Parity: gmm/ebw-diag-gmm.h / ebw-diag-gmm.cc (UpdateEbwDiagGmm,
UpdateEbwWeightsDiagGmm, IsmoothStatsDiagGmm, UpdateEbwAmDiagGmm) —
the MMI/MPE "model-space" update: numerator stats come from the
reference transcription's posteriors, denominator stats from lattice
posteriors, and each Gaussian is updated with a per-Gaussian smoothing
constant D chosen so the new variance stays positive:

    occ = num_occ - den_occ + D
    mu' = (num_x - den_x + D mu) / occ
    var' = (num_x2 - den_x2 + D (var + mu^2)) / occ - mu'^2

Weights use the iterated EBW fix-point (Povey 2003, eq. 4.33):
    w_j <- w_j (num_occ_j / w_j - den_occ_j / w_j + k) / Z,
with k = max_j den_occ_j / w_j so every term stays nonnegative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm, AccumDiagGmm


@dataclass
class EbwOptions:
    E: float = 2.0                 # D = E * den_occ (doubled until valid)
    tau: float = 0.0               # I-smoothing constant (to ML stats)
    min_gaussian_occupancy: float = 1e-2


def update_ebw_diag_gmm(num: AccumDiagGmm, den: AccumDiagGmm,
                        gmm: DiagGmm,
                        opts: EbwOptions = EbwOptions()
                        ) -> Tuple[float, float]:
    """Means+variances EBW update in place (UpdateEbwDiagGmm).
    Returns (auxf improvement estimate, frames counted)."""
    means = gmm.get_means().astype(np.float64)
    variances = (1.0 / gmm.inv_vars).astype(np.float64)
    impr = 0.0
    count = 0.0
    for j in range(gmm.num_gauss):
        num_occ = float(num.occupancy[j])
        den_occ = float(den.occupancy[j])
        if num_occ - den_occ + opts.E * max(den_occ, 0.0) \
                < opts.min_gaussian_occupancy:
            continue
        mu, var = means[j], variances[j]
        D = opts.E * den_occ
        ok = False
        for _ in range(20):
            occ = num_occ - den_occ + D
            if occ > opts.min_gaussian_occupancy:
                x = num.mean_accs[j] - den.mean_accs[j] + D * mu
                x2 = num.var_accs[j] - den.var_accs[j] \
                    + D * (var + mu * mu)
                new_mu = x / occ
                new_var = x2 / occ - new_mu * new_mu
                if np.all(new_var > 1e-10):
                    ok = True
                    break
            D = max(D * 2.0, opts.E * max(den_occ, 1.0))
        if not ok:
            warn(f"EBW: could not find valid D for gaussian {j}; skipped")
            continue
        # auxf improvement ~ weak-sense auxiliary function delta
        d_mu = new_mu - mu
        impr += float(occ * np.sum(d_mu * d_mu / np.maximum(new_var,
                                                            1e-10))) * 0.5
        count += max(num_occ, 0.0)
        means[j] = new_mu
        variances[j] = new_var
    gmm.set_from_means_and_vars(gmm.weights, means, variances)
    return impr, count


def update_ebw_weights_diag_gmm(num: AccumDiagGmm, den: AccumDiagGmm,
                                gmm: DiagGmm, num_iters: int = 1
                                ) -> float:
    """EBW weight update in place (UpdateEbwWeightsDiagGmm): maximizes
    the weak-sense auxiliary function

        F(w) = sum_j num_occ_j log w_j - sum_j den_occ_j w_j / w_j_old

    subject to sum_j w_j = 1 — the stationary condition gives
    w_j = num_occ_j / (lambda + den_occ_j / w_j_old), with lambda
    solved by bisection so the weights normalize. One solve by default:
    each refresh of w_old re-linearizes the denominator term and
    ascends sum_j (num_occ_j - den_occ_j) log w_j, which is unbounded
    when den_occ_j > num_occ_j — iterating drives such weights to 0
    (the classic MMI weight degeneracy), so more iterations need the
    auxf safeguard below to bail out."""
    w = gmm.weights.astype(np.float64).copy()
    num_occ = np.maximum(num.occupancy.astype(np.float64), 0.0)
    den_occ = np.maximum(den.occupancy.astype(np.float64), 0.0)
    if num_occ.sum() <= 0:
        return 0.0
    w0 = w.copy()

    def auxf(wx):
        return (float(np.sum(num_occ * np.log(np.maximum(wx, 1e-20))))
                - float(np.sum(den_occ * wx / np.maximum(w0, 1e-20))))

    before = auxf(w0)
    for _ in range(num_iters):
        ratio = den_occ / np.maximum(w, 1e-20)

        def total(lam):
            return float(np.sum(num_occ / (lam + ratio)))

        lo = max(1e-10, -float(np.min(ratio)) + 1e-10)
        hi = max(lo * 2, float(np.sum(num_occ)))
        while total(hi) > 1.0:
            hi *= 2.0
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            if total(mid) > 1.0:
                lo = mid
            else:
                hi = mid
        new_w = num_occ / (hi + ratio)
        new_w = np.maximum(new_w / new_w.sum(), 1e-10)
        w = new_w / new_w.sum()
    after = auxf(w)
    if after < before:  # safeguard: never degrade the auxiliary
        return 0.0
    gmm.weights = w
    gmm.valid_gconsts = False
    gmm.compute_gconsts()
    return after - before


def ismooth_stats_diag_gmm(src: AccumDiagGmm, tau: float,
                           dst: AccumDiagGmm) -> None:
    """I-smoothing (IsmoothStatsDiagGmm): add tau frames' worth of the
    per-Gaussian AVERAGE of src's stats to dst — smooths the
    discriminative update toward the ML estimate."""
    for j in range(dst.num_comp):
        occ = float(src.occupancy[j])
        if occ <= 0:
            continue
        scale = tau / occ
        dst.occupancy[j] += tau
        dst.mean_accs[j] += scale * src.mean_accs[j]
        dst.var_accs[j] += scale * src.var_accs[j]


def update_ebw_am_diag_gmm(num: AccumAmDiagGmm, den: AccumAmDiagGmm,
                           am: AmDiagGmm,
                           opts: EbwOptions = EbwOptions(),
                           update_weights: bool = False) -> Tuple[float,
                                                                  float]:
    """Whole-model EBW update (UpdateEbwAmDiagGmm). With opts.tau > 0,
    I-smooths the numerator stats toward themselves (the MMI+ismoothing
    config of the reference's train_mmi.sh)."""
    tot_impr = 0.0
    tot_count = 0.0
    for pdf in range(am.num_pdfs):
        num_acc = num.accs[pdf]
        if opts.tau > 0:
            num_acc = AccumDiagGmm(num_acc.num_comp, num_acc.dim,
                                   num_acc.flags)
            num_acc.add(num.accs[pdf])
            ismooth_stats_diag_gmm(num.accs[pdf], opts.tau, num_acc)
        impr, count = update_ebw_diag_gmm(num_acc, den.accs[pdf],
                                          am.get_pdf(pdf), opts)
        if update_weights:
            update_ebw_weights_diag_gmm(num_acc, den.accs[pdf],
                                        am.get_pdf(pdf))
        tot_impr += impr
        tot_count += count
    am.invalidate_pack()
    log(f"EBW update: auxf impr/frame "
        f"{tot_impr / max(tot_count, 1.0):.4f} over {tot_count:.1f} frames")
    return tot_impr, tot_count
