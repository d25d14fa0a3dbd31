"""Acoustic model = one DiagGmm per pdf, with batched scoring of every
(frame, pdf) pair on the card (port of `AmDiagGmm` of
`kaldi_tpu/gmm/am_diag_gmm.py`; parity: gmm/am-diag-gmm.h:36).

The reference scores per (frame, pdf) on demand inside the decoder
(DecodableAmDiagGmmScaled).  Here every Gaussian of every pdf is packed
into one (total_gauss x dim) matrix, the component loglikes of a whole
utterance batch are two float32 matmuls (TF32 off, as the reference asks
for `Precision.HIGHEST`), and a logsumexp over each pdf's Gaussians gives
the (frames x pdfs) matrix that the aligner reads.  The Gaussians are
laid out (pdf, slot) with unused slots at -inf, so the segment logsumexp
is a dense `logsumexp` over the slot axis, free of atomics.

`write` / `read` follow am-diag-gmm.cc.  Not carried over yet:
`cluster_gaussians_to_ubm`.
"""

from __future__ import annotations

from typing import BinaryIO, List

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm


class AmDiagGmm:
    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.densities: List[DiagGmm] = []
        self._packed = None

    @property
    def num_pdfs(self) -> int:
        return len(self.densities)

    @property
    def dim(self) -> int:
        return self.densities[0].dim if self.densities else 0

    def num_gauss(self) -> int:
        return sum(g.num_gauss for g in self.densities)

    def add_pdf(self, gmm: DiagGmm) -> None:
        self.densities.append(gmm)
        self._packed = None

    def get_pdf(self, i: int) -> DiagGmm:
        return self.densities[i]

    def invalidate_pack(self) -> None:
        self._packed = None

    def _pack(self):
        """-> (gconsts (P, G), means_invvars (P*G, D), inv_vars (P*G, D))
        on the device, G the largest Gaussian count of a pdf; a pdf's
        unused slots have gconst -inf and zero parameters."""
        if self._packed is None:
            P, D = self.num_pdfs, self.dim
            G = max(g.num_gauss for g in self.densities)
            gc = np.full((P, G), -np.inf, np.float32)
            mi = np.zeros((P, G, D), np.float32)
            iv = np.zeros((P, G, D), np.float32)
            for i, g in enumerate(self.densities):
                n = g.num_gauss
                gc[i, :n] = g.gconsts
                mi[i, :n] = g.means_invvars
                iv[i, :n] = g.inv_vars
            self._packed = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (gc, mi.reshape(P * G, D), iv.reshape(P * G, D)))
        return self._packed

    def log_likes_device(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (..., D) float32 on the device -> (..., num_pdfs)."""
        gc, mi, iv = self._pack()
        P, G = gc.shape
        with full_f32():
            comp = (gc.reshape(P * G) + feats @ mi.T
                    - 0.5 * ((feats * feats) @ iv.T))
        return torch.logsumexp(comp.unflatten(-1, (P, G)), dim=-1)

    def log_likes_batch(self, feats: np.ndarray) -> np.ndarray:
        """(T, D) or (B, T, D) -> (..., num_pdfs) loglikes, computed on
        the device."""
        x = torch.as_tensor(np.asarray(feats, np.float32), device=self.device)
        with torch.inference_mode():
            return self.log_likes_device(x).cpu().numpy()

    # -- I/O (format of am-diag-gmm.cc) -------------------------------------

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<DIMENSION>")
        iof.write_int32(stream, binary, self.dim)
        iof.write_token(stream, binary, "<NUMPDFS>")
        iof.write_int32(stream, binary, self.num_pdfs)
        for g in self.densities:
            g.write(stream, binary)

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True,
             device: DeviceLike = None) -> "AmDiagGmm":
        am = cls(device=device)
        iof.expect_token(stream, binary, "<DIMENSION>")
        iof.read_int32(stream, binary)
        iof.expect_token(stream, binary, "<NUMPDFS>")
        n = iof.read_int32(stream, binary)
        for _ in range(n):
            am.add_pdf(DiagGmm.read(stream, binary))
        return am
