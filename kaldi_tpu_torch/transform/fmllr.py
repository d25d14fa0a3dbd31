"""fMLLR (CMLLR) estimation (port of `kaldi_tpu/transform/fmllr.py`;
parity: transform/fmllr-diag-gmm.h FmllrDiagGmmAccs and the row-wise
update with cofactors).

Affine transform W = [A; b] (D x D+1) maximizing the GMM likelihood of
the transformed features; the statistics are K (D x D+1) and per-row
quadratics G_i (D+1 x D+1).  They accumulate in float64 on the device,
every frame and Gaussian of a batch in one pass (`accumulate_groups`):
with ext_t = [x_t; 1] and a_t,i = sum_m post[t, m] invvar[m, i],
G_i = sum_t a_t,i ext_t ext_t^T and K = sum_t (sum_m post invvar mu)_t
ext_t^T.  The Gaussian posteriors come from the host's float32
`DiagGmm.component_posteriors`, as in the reference; `update` is the
reference's row iteration on the host in numpy float64.
`apply_affine_transform` runs on the device in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.transform.gauss_rows import (GaussRows, pack_groups,
                                                  third_moment)

# the reference skips a Gaussian whose posteriors in a call sum below this
MIN_TOTAL = 1e-9


def apply_affine_transform(feats: np.ndarray, W: np.ndarray,
                           device: DeviceLike = None) -> np.ndarray:
    """feats (T, D), W (D, D+1) -> (T, D) float32, as feats @ A^T + b."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    W = np.asarray(W)
    A = torch.as_tensor(W[:, :-1].astype(np.float32), device=dev)
    b = torch.as_tensor(W[:, -1].astype(np.float32), device=dev)
    with full_f32():
        return (x @ A.T + b).cpu().numpy()


def alignment_groups(am, tm, data: np.ndarray, alignment: Sequence[int]
                     ) -> List[Tuple[DiagGmm, np.ndarray, np.ndarray]]:
    """(gmm, frames, Gaussian posteriors) of each pdf of an alignment
    (1-best state posteriors), as `accumulate_from_alignment` forms
    them."""
    pdfs = tm.transition_ids_to_pdfs(alignment)
    out = []
    for pdf in np.unique(pdfs):
        idx = np.nonzero(pdfs == pdf)[0]
        g = am.get_pdf(int(pdf))
        sub = data[idx]
        out.append((g, sub, g.component_posteriors(sub.astype(np.float32))))
    return out


def posterior_groups(am, tm, data: np.ndarray, post
                     ) -> List[Tuple[DiagGmm, np.ndarray, np.ndarray]]:
    """(gmm, frames, Gaussian posteriors scaled by the entries' weights)
    of each pdf that transition-id posteriors `post` reach, as
    `accumulate_from_posterior` forms them; a zero weight adds nothing
    and frames past data's end are not read."""
    by_pdf: dict = {}
    for t, frame in enumerate(post):
        if t >= data.shape[0]:
            break
        for tid, w in frame:
            if w == 0.0:
                continue
            pdf = tm.transition_id_to_pdf(int(tid))
            rows, wts = by_pdf.setdefault(pdf, ([], []))
            rows.append(t)
            wts.append(float(w))
    groups = []
    for pdf, (rows, wts) in by_pdf.items():
        g = am.get_pdf(int(pdf))
        sub = data[rows]
        gp = g.component_posteriors(sub.astype(np.float32))
        groups.append((g, sub, gp * np.asarray(wts)[:, None]))
    return groups


class FmllrDiagGmmAccs:
    """beta, K and G live on the host as float64 numpy arrays; each
    accumulation runs on `device` and adds its sums to them."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.beta = 0.0
        self.K = np.zeros((dim, dim + 1))
        self.G = np.zeros((dim, dim + 1, dim + 1))

    @property
    def dim(self):
        return self.K.shape[0]

    def accumulate_from_posteriors(self, gmm: DiagGmm, data: np.ndarray,
                                   posteriors: np.ndarray) -> None:
        self.accumulate_groups([(gmm, data, posteriors)])

    def accumulate_groups(self, groups: Iterable[
            Tuple[DiagGmm, np.ndarray, np.ndarray]]) -> None:
        """`accumulate_from_posteriors` of each (gmm, data, posteriors),
        in one pass on the device."""
        self.accumulate_rows(pack_groups(groups, MIN_TOTAL, self.device))

    def accumulate_rows(self, r: GaussRows) -> None:
        """The device part of `accumulate_groups`."""
        ext = torch.cat([r.x, torch.ones_like(r.x[:, :1])], dim=1)
        a = torch.einsum("ng,ngi->ni", r.post, r.inv_vars)
        b = torch.einsum("ng,ngi->ni", r.post, r.inv_vars * r.means)
        self.K += (b.T @ ext).cpu().numpy()
        self.G += third_moment(a, ext, ext).cpu().numpy()
        self.beta += float(r.post.sum())

    def accumulate_from_alignment(self, am, tm, data: np.ndarray,
                                  alignment) -> None:
        """Viterbi-style accumulation using 1-best state posteriors."""
        self.accumulate_groups(alignment_groups(am, tm, data, alignment))

    def accumulate_from_posterior(self, am, tm, data: np.ndarray,
                                  post) -> None:
        """Soft-count accumulation from transition-id posteriors
        (fmllr-diag-gmm.cc AccumulateFromPosteriors path of
        gmm-est-fmllr.cc): each (tid, w) entry contributes the pdf's
        Gaussian posteriors scaled by w."""
        groups = posterior_groups(am, tm, data, post)
        if groups:
            self.accumulate_groups(groups)

    def accumulate_from_gauss_post(self, am, data: np.ndarray,
                                   gpost) -> None:
        """Accumulation from Gaussian-level posteriors
        (gmm-est-fmllr-gpost.cc): entries carry (pdf-id,
        per-Gaussian weight vector)."""
        by_pdf: dict = {}
        for t, frame in enumerate(gpost):
            if t >= data.shape[0]:
                break
            for pdf, vec in frame:
                rows, vecs = by_pdf.setdefault(int(pdf), ([], []))
                rows.append(t)
                vecs.append(np.asarray(vec, np.float64))
        groups = [(am.get_pdf(int(pdf)), data[rows], np.stack(vecs))
                  for pdf, (rows, vecs) in by_pdf.items()]
        if groups:
            self.accumulate_groups(groups)

    def update(self, num_iters: int = 20, min_count: float = 500.0
               ) -> Tuple[np.ndarray, float]:
        """Row-wise iterative update; returns (W (D, D+1), objf impr/frame)."""
        D = self.dim
        W = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
        if self.beta < min_count:
            return W, 0.0

        def objf(Wm):
            A = Wm[:, :D]
            sign, logdet = np.linalg.slogdet(A)
            if sign <= 0:
                return -np.inf
            q = sum(Wm[i] @ self.G[i] @ Wm[i] for i in range(D))
            return self.beta * logdet + np.sum(Wm * self.K) - 0.5 * q

        start = objf(W) / self.beta
        for _ in range(num_iters):
            for i in range(D):
                A = W[:, :D]
                inv = np.linalg.inv(A.T)
                cof = np.zeros(D + 1)
                cof[:D] = inv[i]  # cofactor row direction
                Gi_inv = np.linalg.inv(self.G[i]
                                       + 1e-6 * np.eye(D + 1))
                k = self.K[i]
                p = Gi_inv @ cof
                q = Gi_inv @ k
                a = p @ self.G[i] @ p
                b = p @ self.G[i] @ q - p @ k
                c = -self.beta
                # solve a s^2 + b s + c = 0 for step s along p
                disc = b * b - 4 * a * c
                if disc < 0 or abs(a) < 1e-12:
                    continue
                s1 = (-b + np.sqrt(disc)) / (2 * a)
                s2 = (-b - np.sqrt(disc)) / (2 * a)
                cand = []
                for s in (s1, s2):
                    row = q + s * p
                    Wtry = W.copy()
                    Wtry[i] = row
                    val = objf(Wtry)
                    cand.append((val, row))
                val, row = max(cand, key=lambda t: t[0])
                if np.isfinite(val):
                    W[i] = row
        impr = (objf(W) - start * self.beta) / self.beta
        return W, float(impr)


def estimate_fmllr(am, tm, feats: np.ndarray, alignment,
                   min_count: float = 100.0,
                   device: DeviceLike = None) -> np.ndarray:
    accs = FmllrDiagGmmAccs(feats.shape[1], device=device)
    accs.accumulate_from_alignment(am, tm, feats, alignment)
    W, _ = accs.update(min_count=min_count)
    return W
