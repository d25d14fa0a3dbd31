"""PLDA scoring and estimation (port of `Plda` and `train_plda` of
`kaldi_tpu/ivector/plda.py`; parity: ivector/plda.h).  Host numpy in
float64, as in the reference: the matrices are i-vector-sized.

Two-covariance PLDA in the reference's diagonalized form: a transform
that simultaneously whitens the within-class covariance and
diagonalizes the between-class covariance (eigenvalues psi). Scoring is
the log-likelihood-ratio of same- vs different-speaker hypotheses.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof


class Plda:
    def __init__(self, mean: np.ndarray, transform: np.ndarray,
                 psi: np.ndarray):
        self.mean = mean          # (D,)
        self.transform = transform  # (D, D): x -> transform @ (x - mean)
        self.psi = psi            # (D,) between-class variances

    @property
    def dim(self):
        return len(self.mean)

    def transform_ivector(self, ivector: np.ndarray,
                          num_examples: int = 1,
                          simple_length_norm: bool = False) -> np.ndarray:
        """Project + length-normalize (plda.cc TransformIvector)."""
        x = self.transform @ (np.asarray(ivector, np.float64) - self.mean)
        D = self.dim
        if simple_length_norm:
            factor = math.sqrt(D) / np.linalg.norm(x)
        else:
            inv_covar = 1.0 / (self.psi + 1.0 / num_examples)
            factor = math.sqrt(D / float(inv_covar @ (x * x)))
        return x * factor

    def log_likelihood_ratio(self, transformed_train: np.ndarray,
                             num_train_examples: int,
                             transformed_test: np.ndarray) -> float:
        """LLR of same- vs different-class (plda.cc LogLikelihoodRatio)."""
        n = num_train_examples
        psi = self.psi
        mean = (n * psi) / (n * psi + 1.0) * transformed_train
        var_given = 1.0 + psi / (n * psi + 1.0)
        var_without = 1.0 + psi
        sq_given = (transformed_test - mean) ** 2
        loglike_given = -0.5 * (np.log(2 * np.pi * var_given)
                                + sq_given / var_given).sum()
        sq_wo = transformed_test ** 2
        loglike_without = -0.5 * (np.log(2 * np.pi * var_without)
                                  + sq_wo / var_without).sum()
        return float(loglike_given - loglike_without)

    def adapt(self, ivectors: np.ndarray,
              within_covar_scale: float = 0.75,
              between_covar_scale: float = 0.25) -> "Plda":
        """Unsupervised domain adaptation (plda.cc
        PldaUnsupervisedAdaptor::UpdatePlda): in the PLDA-transformed
        space (within = I, between = diag(psi)) the adaptation data's
        total covariance should be I + diag(psi); per eigen-direction
        of the OBSERVED covariance, the excess variance is split
        between the within and between covariances by the given
        scales, and the model is re-diagonalized.  Returns a new
        Plda."""
        X = np.stack([self.transform @ (np.asarray(v, np.float64)
                                        - self.mean) for v in ivectors])
        mu = X.mean(axis=0)
        S = (X - mu).T @ (X - mu) / max(len(X) - 1, 1)
        evals, evecs = np.linalg.eigh(S)
        D = self.dim
        W = np.eye(D)
        B = np.diag(self.psi)
        for lam, v in zip(evals, evecs.T):
            psi_proj = float(v @ (self.psi * v))
            excess = max(0.0, float(lam) - (1.0 + psi_proj))
            if excess <= 0:
                continue
            W += within_covar_scale * excess * np.outer(v, v)
            B += between_covar_scale * excess * np.outer(v, v)
        # re-diagonalize: find T with T W T' = I and T B T' diagonal
        wvals, wvecs = np.linalg.eigh(W)
        w_half_inv = (wvecs / np.sqrt(np.maximum(wvals, 1e-10))) \
            @ wvecs.T
        M = w_half_inv @ B @ w_half_inv.T
        bvals, bvecs = np.linalg.eigh(M)
        order = np.argsort(-bvals)
        T = bvecs[:, order].T @ w_half_inv
        new_transform = T @ self.transform
        new_psi = np.maximum(bvals[order], 0.0)
        # the adaptation mean shifts the model mean in the ORIGINAL
        # space: mean_new = mean + transform^{-1} mu
        new_mean = self.mean + np.linalg.solve(self.transform, mu)
        return Plda(new_mean, new_transform, new_psi)

    def write(self, stream, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<Plda>")
        iof.write_vector(stream, binary, self.mean)
        iof.write_matrix(stream, binary, self.transform)
        iof.write_vector(stream, binary, self.psi)
        iof.write_token(stream, binary, "</Plda>")

    @classmethod
    def read(cls, stream, binary: bool = True) -> "Plda":
        iof.expect_token(stream, binary, "<Plda>")
        mean = iof.read_vector(stream, binary).astype(np.float64)
        transform = iof.read_matrix(stream, binary).astype(np.float64)
        psi = iof.read_vector(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "</Plda>")
        return cls(mean, transform, psi)


def train_plda(class_vectors: Dict[str, Sequence[np.ndarray]]) -> Plda:
    """Estimate PLDA from per-class example vectors (two-covariance
    estimation: within/between scatter then simultaneous
    diagonalization; the reference uses EM but converges to the same
    two-covariance solution for full-rank data)."""
    classes = {k: np.asarray(v, np.float64) for k, v in class_vectors.items()
               if len(v) > 0}
    all_x = np.concatenate(list(classes.values()))
    gmean = all_x.mean(axis=0)
    D = all_x.shape[1]
    within = np.zeros((D, D))
    between = np.zeros((D, D))
    n_total = 0
    for k, x in classes.items():
        cmean = x.mean(axis=0)
        diff = x - cmean
        within += diff.T @ diff
        d = (cmean - gmean)[:, None]
        between += len(x) * (d @ d.T)
        n_total += len(x)
    within /= max(n_total, 1)
    between /= max(n_total, 1)
    within += 1e-6 * np.eye(D)
    # whiten within: W = L^{-1} with within = L L^T
    w_vals, w_vecs = np.linalg.eigh(within)
    whiten = (w_vecs * (1.0 / np.sqrt(np.maximum(w_vals, 1e-10)))) @ w_vecs.T
    b2 = whiten @ between @ whiten.T
    b_vals, b_vecs = np.linalg.eigh(b2)
    order = np.argsort(-b_vals)
    b_vals = np.maximum(b_vals[order], 0.0)
    b_vecs = b_vecs[:, order]
    transform = b_vecs.T @ whiten
    return Plda(gmean, transform, b_vals)
