"""Global UBMs on a device: `UbmScorer` scores a diagonal or full
UBM's frames in the dtype the reference scores them in, and
`init_diag_ubm` is gmm-global-init-from-feats's seeded initialisation
and EM (port of `kaldi_tpu/cli/gmm_tools.py:461` and of the UBM half of
`kaldi_tpu/ivector/batched.py` `train_bench_extractor`, which repeat the
same steps).  The tool and the main path's extractor training both call
it."""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from kaldi_tpu_torch.device import (CHUNK_FRAMES, DeviceLike, full_f32,
                                    resolve_device)
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import FullGmm, outer_rows
from kaldi_tpu_torch.gmm.mle import (AccumDiagGmm, MleDiagGmmOptions,
                                     mle_diag_gmm_update)


class UbmScorer:
    """A global GMM's per-frame scores on a device, in the dtype the
    reference scores it in: a `DiagGmm` in float32 (gconsts, means x
    inverse variances and inverse variances as stored, TF32 off), a
    `FullGmm` in float64 with the gconsts it holds.  Frames go in as a
    (T, D) tensor on the device; `frames_dtype` is the dtype they are
    scored in (the caller rounds them as the reference does).

    On the CPU a diagonal UBM is scored by its own numpy methods, the
    reference's float32 arithmetic itself: torch's float32 products round
    differently in the last bits, and one unit in the last place of a
    log-likelihood of a few hundred moves a posterior by about 1e-5, so
    only the same products give the reference's EM number for number."""

    def __init__(self, ubm: Union[DiagGmm, FullGmm],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.full = isinstance(ubm, FullGmm)
        if not ubm.valid_gconsts:
            ubm.compute_gconsts()
        dev = self.device
        self._numpy = ubm if not self.full and dev.type == "cpu" else None
        if self.full:
            self.frames_dtype = torch.float64
            self._gconsts = torch.from_numpy(ubm.gconsts).to(dev)
            self._lin = torch.from_numpy(
                np.ascontiguousarray(ubm.means_invcovars.T)).to(dev)
            M, D = ubm.num_gauss, ubm.dim
            self._quad = torch.from_numpy(np.ascontiguousarray(
                ubm.inv_covars.reshape(M, D * D).T)).to(dev)
        else:
            self.frames_dtype = torch.float32
            self._gconsts = torch.from_numpy(
                np.asarray(ubm.gconsts, np.float32)).to(dev)
            self._lin = torch.from_numpy(np.ascontiguousarray(
                np.asarray(ubm.means_invvars, np.float32).T)).to(dev)
            self._quad = torch.from_numpy(np.ascontiguousarray(
                np.asarray(ubm.inv_vars, np.float32).T)).to(dev)
        self.num_gauss = self._gconsts.shape[0]

    def frames(self, feats) -> torch.Tensor:
        """Host frames (T, D), of any float dtype, -> the scoring dtype on
        the device (float32 first for a diagonal UBM)."""
        x = torch.as_tensor(np.asarray(feats))
        if not self.full:
            x = x.to(torch.float32)
        return x.to(self.device).to(self.frames_dtype)

    def log_likes(self, x: torch.Tensor) -> torch.Tensor:
        """(T, D) -> (T, M) per-component log-likelihoods."""
        if self._numpy is not None:
            return torch.from_numpy(
                self._numpy.component_log_likes(x.numpy()))
        with full_f32():
            if self.full:
                out = torch.empty((x.shape[0], self.num_gauss),
                                  dtype=torch.float64, device=self.device)
                for s in range(0, x.shape[0], CHUNK_FRAMES):
                    xs = x[s:s + CHUNK_FRAMES]
                    out[s:s + CHUNK_FRAMES] = (
                        self._gconsts + xs @ self._lin
                        - 0.5 * (outer_rows(xs) @ self._quad))
                return out
            return self._gconsts + x @ self._lin - 0.5 * ((x * x) @ self._quad)

    def posteriors(self, x: torch.Tensor) -> torch.Tensor:
        if self._numpy is not None:
            return torch.from_numpy(
                self._numpy.component_posteriors(x.numpy()))
        return torch.softmax(self.log_likes(x), dim=1)

    def log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """(T, D) -> (T,) total log-likelihood of each frame."""
        if self._numpy is not None:
            return torch.from_numpy(self._numpy.log_likelihood(x.numpy()))
        return torch.logsumexp(self.log_likes(x), dim=1)


def init_diag_ubm(feats: np.ndarray, num_gauss: int, num_iters: int,
                  seed: int = 0, device: DeviceLike = None
                  ) -> Tuple[DiagGmm, List[float]]:
    """A diagonal UBM from pooled frames (T, D): the means on `num_gauss`
    frames drawn by `default_rng(seed).choice`, one shared variance (the
    frames' own, floored at 1e-4), equal weights, then `num_iters` EM
    passes scored on `device` (float32 posteriors, float64 statistics,
    min-gaussian-occupancy 1) -> (the UBM, each pass's average
    log-likelihood per frame)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    G = min(num_gauss, len(feats))
    gmm = DiagGmm(G, feats.shape[1])
    sel = feats[rng.choice(len(feats), G, replace=False)]
    gmm.set_from_means_and_vars(np.ones(G) / G, sel,
                                np.tile(np.maximum(feats.var(0), 1e-4),
                                        (G, 1)))
    blocks = [feats[i:i + CHUNK_FRAMES]
              for i in range(0, len(feats), CHUNK_FRAMES)]
    avg = []
    for _ in range(num_iters):
        acc = AccumDiagGmm(gmm.num_gauss, gmm.dim)
        ll, _ = acc.accumulate_device(UbmScorer(gmm, dev), blocks)
        mle_diag_gmm_update(MleDiagGmmOptions(min_gaussian_occupancy=1.0),
                            acc, gmm)
        avg.append(ll / len(feats))
    return gmm, avg
