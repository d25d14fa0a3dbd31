"""Batched device i-vector extraction and the bench corpus's extractor
training (port of `kaldi_tpu/ivector/batched.py`).

Two modes:
  * extract_batch: whole-utterance i-vectors for the offline batched
    pipeline: diagonal UBM posteriors as a (B*T, G) matmul, masked
    zeroth/first-order stats, and one R x R solve per lane;
  * init_state / acc_chunk / ivector / reset_lanes: the carried
    (linear, quadratic) estimation state of the online batched
    pipeline, one chunk of frames at a time.
Everything is float32 with TF32 off: the quadratic term x^2 @ inv_vars
is O(1e4-1e6) for raw MFCCs while the logit differences that pick the
component are O(1), so a reduced mantissa destroys the posteriors.
`train_bench_extractor` trains the UBM and the extractor through
`gmm.ubm.init_diag_ubm` and `ivector.extractor.train_ivector_extractor`,
the code of the gmm-global-init-from-feats and ivector-extractor-* tools.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.gmm.ubm import init_diag_ubm
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               IvectorExtractorOptions,
                                               train_ivector_extractor)


class BatchedIvectorExtractor:
    """extract_batch(feats (B, T, D), lengths) -> (B, R) i-vectors with
    the prior offset removed (the nnet3 input convention)."""

    def __init__(self, extractor: Dict[str, np.ndarray],
                 device: DeviceLike = None):
        """extractor: the arrays of `recipes.bench_corpus.
        load_ivector_extractor` (M, sigma_inv, prior, weights, means,
        inv_vars) of a diagonal-UBM extractor."""
        self.device = resolve_device(device)
        M = np.asarray(extractor["M"], np.float64)             # (G, D, R)
        sigma_inv = np.asarray(extractor["sigma_inv"], np.float64)
        if sigma_inv.ndim != 2:
            raise ValueError("batched i-vectors need a diagonal UBM")
        self.R = M.shape[2]
        self.prior_offset = float(extractor["prior"])
        # the UBM as DiagGmm.set_from_means_and_vars stores it: float32
        # inverse variances and means*inv_vars, means read back from both
        variances = 1.0 / np.asarray(extractor["inv_vars"], np.float64)
        weights = np.asarray(extractor["weights"], np.float64)
        inv_vars = (1.0 / variances).astype(np.float32)         # (G, D)
        means_invvars = (np.asarray(extractor["means"], np.float64)
                         / variances).astype(np.float32)
        means = (means_invvars / inv_vars).astype(np.float32)   # (G, D)
        dim = means.shape[1]
        # diag-GMM loglikes: gconst + x @ (m*iv)^T - 0.5 x^2 @ iv^T
        gconst = (np.log(np.maximum(weights, 1e-30))
                  + 0.5 * np.log(inv_vars).sum(axis=1)
                  - 0.5 * dim * np.log(2 * np.pi)
                  - 0.5 * (means ** 2 * inv_vars).sum(axis=1))
        MS = (M * sigma_inv[:, :, None]).astype(np.float32)      # (G, D, R)
        U = np.einsum("gdr,gds->grs", MS, M).astype(np.float32)  # (G, R, R)
        dev = self.device
        self._gconst = torch.from_numpy(gconst.astype(np.float32)).to(dev)
        self._lin_w = torch.from_numpy((means * inv_vars).T.copy()).to(dev)
        self._quad_w = torch.from_numpy(inv_vars.T.copy()).to(dev)
        self._MS = torch.from_numpy(MS).to(dev)
        self._U = torch.from_numpy(U).to(dev)

    def _posteriors(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, G) UBM component posteriors."""
        ll = (feats @ self._lin_w
              - 0.5 * ((feats ** 2) @ self._quad_w)
              + self._gconst)
        return torch.softmax(ll, dim=-1)

    def _stats(self, feats: torch.Tensor, mask: torch.Tensor):
        """gamma (B, G), x (B, G, D) with frame mask (B, T)."""
        post = self._posteriors(feats) * mask[:, :, None]
        gamma = post.sum(dim=1)
        x = torch.einsum("btg,btd->bgd", post, feats)
        return gamma, x

    def _solve(self, quad: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
        iv = torch.linalg.solve(quad, lin[..., None])[..., 0]
        iv[:, 0] -= self.prior_offset
        return iv

    def extract_batch(self, feats: torch.Tensor,
                      lengths: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
        """feats (B, T, D) on this extractor's device, lengths (B,)
        valid frame counts -> (B, R) float32."""
        B, T, _ = feats.shape
        lens = torch.as_tensor(np.asarray(
            lengths if lengths is not None else [T] * B, np.int64),
            device=self.device)
        with torch.inference_mode(), full_f32():
            mask = (torch.arange(T, device=self.device)[None, :]
                    < lens[:, None]).to(torch.float32)
            gamma, x = self._stats(feats.to(torch.float32), mask)
            quad = (torch.eye(self.R, device=self.device)[None]
                    + torch.einsum("bg,grs->brs", gamma, self._U))
            lin = torch.einsum("gdr,bgd->br", self._MS, x)
            lin[:, 0] += self.prior_offset
            return self._solve(quad, lin)

    # -- online (carried) estimation -----------------------------------
    def init_state(self, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh state of B lanes: (linear (B, R) with the prior offset
        in column 0, quadratic (B, R, R) the identity)."""
        lin = torch.zeros((B, self.R), dtype=torch.float32,
                          device=self.device)
        lin[:, 0] = self.prior_offset
        quad = torch.eye(self.R, device=self.device).expand(
            B, self.R, self.R).contiguous()
        return lin, quad

    def acc_chunk(self, state, feats: torch.Tensor, mask: torch.Tensor,
                  weights: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Accumulate one chunk: feats (B, C, D), mask (B, C) valid
        frames, weights (B, C) per-frame weights (silence weighting; all
        ones by default) -> the new state."""
        lin, quad = state
        with torch.inference_mode(), full_f32():
            m = mask.to(torch.float32)
            if weights is not None:
                m = m * weights.to(torch.float32)
            gamma, x = self._stats(feats.to(torch.float32), m)
            quad = quad + torch.einsum("bg,grs->brs", gamma, self._U)
            lin = lin + torch.einsum("gdr,bgd->br", self._MS, x)
        return lin, quad

    def ivector(self, state) -> torch.Tensor:
        """Each lane's current i-vector from the carried state: (B, R),
        the prior offset removed."""
        lin, quad = state
        with torch.inference_mode(), full_f32():
            return self._solve(quad, lin)

    def reset_lanes(self, state, done: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The state with the lanes flagged in `done` (B,) bool back at
        init_state's (rebinding a lane to a new utterance)."""
        lin, quad = state
        lin0, quad0 = self.init_state(lin.shape[0])
        with torch.inference_mode():
            return (torch.where(done[:, None], lin0, lin),
                    torch.where(done[:, None, None], quad0, quad))


def train_bench_extractor(feats_dict, num_gauss: int = 64,
                          ivector_dim: int = 32, seed: int = 0,
                          num_em_iters: int = 4,
                          max_frames: int = 200_000,
                          device: DeviceLike = None) -> IvectorExtractor:
    """UBM + T-matrix training for the bench corpus on `device`: a
    diagonal UBM from the pooled frames of the utterances in sorted order
    (`init_diag_ubm`, as gmm-global-init-from-feats), then 5 passes of the
    extractor's EM.  Deterministic in `seed`."""
    feats_list = [np.asarray(feats_dict[u], np.float32)
                  for u in sorted(feats_dict)]
    pooled = np.concatenate(feats_list)[:max_frames]
    ubm, _ = init_diag_ubm(pooled, num_gauss, num_em_iters, seed, device)
    return train_ivector_extractor(
        ubm, feats_list,
        IvectorExtractorOptions(ivector_dim=ivector_dim, num_iters=5),
        device)
