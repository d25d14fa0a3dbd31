"""Linear VTLN (port of kaldi_tpu/transform/lvtln.py; parity:
transform/lvtln.{h,cc} LinearVtln, gmmbin/gmm-train-lvtln-special.cc,
steps/train_lvtln.sh).

VTLN warps the mel filterbank per speaker; linear VTLN approximates each
warp factor's effect as one linear transform of the features, trained as
the least-squares map from unwarped to warped features over the training
data.  For a speaker, the class (warp) is chosen to maximize the fMLLR
auxiliary function of the speaker's statistics, with a bias re-estimated
for each class, so that a test speaker needs no second feature pass.

The frame-level sums (the Gram matrices of the least squares, the fMLLR
statistics of `transform/fmllr.py`) run on the device in float64; the
solves and the auxiliary-function comparison are host float64 numpy, as
in the reference.  `write`/`read` are the class's own format;
`write_lvtln_file`/`read_lvtln_file` are the one the reference's tools
read and write (kaldi_tpu/cli/tail8_tools.py `_write_lvtln`,
`_read_lvtln`)."""

from __future__ import annotations

from typing import BinaryIO, Iterable, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.transform.fmllr import FmllrDiagGmmAccs


class LinearVtln:
    def __init__(self, dim: int, warps: Sequence[float]):
        self.warps = list(warps)
        self.A = np.stack([np.eye(dim) for _ in warps])

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    @property
    def num_classes(self) -> int:
        return len(self.warps)

    def set_transform(self, c: int, A: np.ndarray) -> None:
        self.A[c] = np.asarray(A, np.float64)

    def compute_transform(self, accs: FmllrDiagGmmAccs,
                          norm_type: str = "offset"
                          ) -> Tuple[np.ndarray, float, float]:
        """Select the best class for a speaker -> (W (D, D+1), chosen
        warp, auxf improvement a frame).  norm_type: 'offset'
        re-estimates a bias for each class; 'none' uses the bare linear
        transform."""
        D = self.dim
        if accs.beta <= 0:
            return np.concatenate([np.eye(D), np.zeros((D, 1))], 1), \
                self.warps[len(self.warps) // 2], 0.0

        def auxf(W):
            A = W[:, :D]
            sign, logdet = np.linalg.slogdet(A)
            if sign <= 0:
                return -np.inf
            q = sum(W[i] @ accs.G[i] @ W[i] for i in range(D))
            return accs.beta * logdet + float(np.sum(W * accs.K)) \
                - 0.5 * q

        W0 = np.concatenate([np.eye(D), np.zeros((D, 1))], 1)
        f0 = auxf(W0)
        best = (f0, W0, 1.0)
        for c, warp in enumerate(self.warps):
            W = np.concatenate([self.A[c], np.zeros((D, 1))], 1)
            if norm_type == "offset":
                # the bias of each row maximizing the auxiliary given A:
                # d/db_i = K_i[D] - (G_i W_i)[D] = 0
                for i in range(D):
                    g = accs.G[i]
                    num = accs.K[i, D] - self.A[c][i] @ g[:D, D]
                    den = max(g[D, D], 1e-10)
                    W[i, D] = num / den
            f = auxf(W)
            if f > best[0]:
                best = (f, W, warp)
        return best[1], best[2], (best[0] - f0) / accs.beta

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<LinearVtln>")
        iof.write_int32(stream, binary, self.dim)
        iof.write_int32(stream, binary, self.num_classes)
        iof.write_vector(stream, binary,
                         np.asarray(self.warps, np.float32))
        for c in range(self.num_classes):
            iof.write_matrix(stream, binary, self.A[c].astype(np.float32))
        iof.write_token(stream, binary, "</LinearVtln>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "LinearVtln":
        iof.expect_token(stream, binary, "<LinearVtln>")
        dim = iof.read_int32(stream, binary)
        n = iof.read_int32(stream, binary)
        warps = iof.read_vector(stream, binary).tolist()
        out = cls(dim, warps)
        for c in range(n):
            out.A[c] = iof.read_matrix(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "</LinearVtln>")
        return out


def write_lvtln_file(stream: BinaryIO, binary: bool, lv: LinearVtln) -> None:
    """The tools' format: float64 warps, then each class's matrix."""
    iof.write_token(stream, binary, "<LinearVtln>")
    iof.write_vector(stream, binary, np.asarray(lv.warps, np.float64))
    for c in range(lv.num_classes):
        iof.write_matrix(stream, binary, lv.A[c])
    iof.write_token(stream, binary, "</LinearVtln>")


def read_lvtln_file(stream: BinaryIO, binary: bool) -> LinearVtln:
    iof.expect_token(stream, binary, "<LinearVtln>")
    warps = iof.read_vector(stream, binary).tolist()
    first = iof.read_matrix(stream, binary).astype(np.float64)
    lv = LinearVtln(first.shape[0], warps)
    lv.set_transform(0, first)
    for c in range(1, len(warps)):
        lv.set_transform(c, iof.read_matrix(stream, binary))
    iof.expect_token(stream, binary, "</LinearVtln>")
    return lv


class LvtlnGram:
    """X^T X, X^T Y and Y^T Y of frame-parallel unwarped (X) and warped
    (Y) features, summed in float64 on the device."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        z = torch.zeros((dim, dim), dtype=torch.float64, device=self.device)
        self.xx, self.xy, self.yy = z.clone(), z.clone(), z.clone()
        self.frames = 0

    def add(self, x: np.ndarray, y: np.ndarray) -> None:
        xt = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        yt = torch.as_tensor(np.asarray(y, np.float64), device=self.device)
        self.xx += xt.T @ xt
        self.xy += xt.T @ yt
        self.yy += yt.T @ yt
        self.frames += x.shape[0]

    def solve(self) -> Tuple[np.ndarray, float]:
        """-> (A, the mean squared error a dimension) of the map
        A = Y^T X (X^T X + 1e-6 I)^-1, solved on the host in float64."""
        xx, xy, yy = (m.cpu().numpy() for m in (self.xx, self.xy, self.yy))
        D = xx.shape[0]
        A = np.linalg.solve((xx + 1e-6 * np.eye(D)).T, xy).T
        sq = np.trace(A @ xx @ A.T) - 2.0 * np.trace(A @ xy) + np.trace(yy)
        return A, float(sq / max(self.frames * D, 1))


def train_lvtln(unwarped: Sequence[np.ndarray],
                warped_per_class: Iterable[Sequence[np.ndarray]],
                warps: Sequence[float], device: DeviceLike = None
                ) -> LinearVtln:
    """Fit each class transform as the least-squares linear map from
    unwarped to warped features over the whole corpus
    (gmm-train-lvtln-special's MSE solution): A_c = (Y^T X)(X^T X)^-1
    with X, Y frame-parallel."""
    D = unwarped[0].shape[1]
    lv = LinearVtln(D, warps)
    for c, warped in enumerate(warped_per_class):
        gram = LvtlnGram(D, device)
        for x, y in zip(unwarped, warped):
            assert np.shape(x) == np.shape(y), "parallel features required"
            gram.add(x, y)
        A, err = gram.solve()
        lv.set_transform(c, A)
        log(f"lvtln class {c} (warp {warps[c]}): mse {err:.4f}")
    return lv
