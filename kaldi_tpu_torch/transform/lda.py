"""LDA estimation (port of `kaldi_tpu/transform/lda.py`; parity:
transform/lda-estimate.h).

Per-class (pdf) zeroth and first order statistics and the total second
order statistics, in float64.  A batch of frames with their classes
accumulates in one pass on the device (`accumulate_batch`: products with
the one-hot classes and one X^T X, each adding in a fixed order, so one
batch gives one set of sums); `estimate` solves the generalized
eigenproblem on the host in numpy float64, a copy of the reference's,
and returns the (target_dim x dim(+1)) transform with the reference's
within-class-covariance normalization, so that MLLT can follow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.device import DeviceLike, resolve_device


@dataclass
class LdaOptions:
    dim: int = field(default=40, metadata={"doc": "Dimension to project to with LDA"})
    within_class_factor: float = 1.0
    allow_large_dim: bool = False
    remove_offset: bool = field(default=True, metadata={"doc": "Remove the mean (add an offset column to the transform)"})


class LdaEstimate:
    """The statistics live on the host as float64 numpy arrays; each
    accumulation runs on `device` and adds its sums to them."""

    def __init__(self, num_classes: int, dim: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.zero_acc = np.zeros(num_classes)
        self.first_acc = np.zeros((num_classes, dim))
        self.total_second_acc = np.zeros((dim, dim))

    @property
    def dim(self):
        return self.first_acc.shape[1]

    def accumulate(self, data: np.ndarray, class_id: int,
                   weight: float = 1.0) -> None:
        x = np.atleast_2d(np.asarray(data, np.float64))
        self.accumulate_batch(x, np.full(x.shape[0], class_id), weight)

    def accumulate_batch(self, data: np.ndarray, class_ids: np.ndarray,
                         weight: float = 1.0) -> None:
        """data (N, dim), class_ids (N,): each frame counted in its
        class, as `accumulate` of each class's frames would."""
        self.accumulate_tensors(
            torch.as_tensor(np.asarray(data, np.float64), device=self.device),
            torch.as_tensor(np.asarray(class_ids, np.int64),
                            device=self.device), weight)

    def accumulate_tensors(self, x: torch.Tensor, c: torch.Tensor,
                           weight: float = 1.0) -> None:
        """The device part of `accumulate_batch`: x (N, dim) float64 and
        c (N,) int64 on the device."""
        # class sums as a product with the one-hot classes, which adds
        # in a fixed order on the card (an index_add would add in the
        # order its atomics land)
        onehot = torch.nn.functional.one_hot(
            c, self.zero_acc.shape[0]).to(torch.float64)
        zero = onehot.sum(dim=0)
        first = onehot.T @ x
        second = x.T @ x
        self.zero_acc += weight * zero.cpu().numpy()
        self.first_acc += weight * first.cpu().numpy()
        self.total_second_acc += weight * second.cpu().numpy()

    def add(self, other: "LdaEstimate") -> None:
        self.zero_acc += other.zero_acc
        self.first_acc += other.first_acc
        self.total_second_acc += other.total_second_acc

    def estimate(self, opts: LdaOptions
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (lda_mat (target, dim[+1]), full_mat (dim, dim[+1])).
        The rows past the between-class rank (the classes seen, less
        one) span a degenerate eigenspace: there the rows depend on the
        last bits of the statistics, so two orders of summation give two
        bases of the same space."""
        count = self.zero_acc.sum()
        D = self.dim
        mean = self.first_acc.sum(axis=0) / count
        total_covar = self.total_second_acc / count - np.outer(mean, mean)
        # between-class covariance
        mask = self.zero_acc > 0
        cmeans = self.first_acc[mask] / self.zero_acc[mask][:, None]
        diffs = cmeans - mean
        bc = (self.zero_acc[mask][:, None, None]
              * np.einsum("cd,ce->cde", diffs, diffs)).sum(axis=0) / count
        wc = total_covar - bc
        wc += 1e-8 * np.trace(wc) / D * np.eye(D)
        # solve generalized eig: wc^{-1/2} bc wc^{-1/2}
        vals, vecs = np.linalg.eigh(wc)
        w_half_inv = (vecs * (1.0 / np.sqrt(np.maximum(vals, 1e-10)))) @ vecs.T
        m = w_half_inv @ bc @ w_half_inv.T
        evals, evecs = np.linalg.eigh(m)
        order = np.argsort(-evals)
        full = (evecs[:, order].T @ w_half_inv)  # (D, D)
        if opts.within_class_factor != 1.0:
            scale = np.sqrt(opts.within_class_factor
                            / np.maximum(1.0 + evals[order], 1e-10))
            full = full * scale[:, None]
        lda = full[:opts.dim]
        if opts.remove_offset:
            off_full = -full @ mean
            off = -lda @ mean
            full = np.concatenate([full, off_full[:, None]], axis=1)
            lda = np.concatenate([lda, off[:, None]], axis=1)
        return lda, full

    def write(self, stream, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<LDAACCS>")
        iof.write_vector(stream, binary, self.zero_acc)
        iof.write_matrix(stream, binary, self.first_acc)
        iof.write_matrix(stream, binary, self.total_second_acc)
        iof.write_token(stream, binary, "</LDAACCS>")

    @classmethod
    def read(cls, stream, binary: bool = True,
             device: DeviceLike = None) -> "LdaEstimate":
        iof.expect_token(stream, binary, "<LDAACCS>")
        za = iof.read_vector(stream, binary).astype(np.float64)
        fa = iof.read_matrix(stream, binary).astype(np.float64)
        sa = iof.read_matrix(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "</LDAACCS>")
        obj = cls(len(za), fa.shape[1], device=device)
        obj.zero_acc, obj.first_acc, obj.total_second_acc = za, fa, sa
        return obj
