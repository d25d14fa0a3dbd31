"""Frames with their Gaussian posteriors, laid out for one pass of
float64 statistics on the device (the MLLT and fMLLR accumulators).

The reference accumulates one (GMM, frames, posteriors) group at a time
and, within a group, skips a Gaussian whose posteriors sum below a
threshold (`kaldi_tpu/transform/mllt.py:41-45`,
`kaldi_tpu/transform/fmllr.py:45-52`).  Here every group of a batch is
stacked: each frame's posteriors over its GMM's Gaussians in a row
padded to the largest GMM with zeros, a skipped Gaussian's column zeroed
in its group's rows, and the GMMs' means and inverse variances in
tables indexed by each row's GMM.  A zero posterior adds nothing, so the
sums over the rows are the reference's sums, in another order.

Posteriors come from the caller: the recipes and tools compute them on
the host with `DiagGmm.component_posteriors` (float32, as the reference
does), so that the statistics on the card and on the CPU start from the
same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm


@dataclass
class GaussRows:
    """N frames on the device: x (N, D), post (N, G), and each row's
    GMM's means and inverse variances (N, G, D), all float64."""
    x: torch.Tensor
    post: torch.Tensor
    means: torch.Tensor
    inv_vars: torch.Tensor


def pack_groups(groups: Iterable[Tuple[DiagGmm, np.ndarray, np.ndarray]],
                min_total: float, device: torch.device) -> GaussRows:
    """groups: (gmm, data (T, D), posteriors (T, gmm.num_gauss)).  A
    Gaussian whose posteriors in its group sum below `min_total` is left
    out of that group."""
    xs, posts, gidx = [], [], []
    index = {}
    tables = []
    for gmm, data, post in groups:
        data = np.asarray(data, np.float64)
        post = np.array(post, np.float64)
        if data.shape[0] == 0:
            continue
        post[:, post.sum(axis=0) < min_total] = 0.0
        k = index.get(id(gmm))
        if k is None:
            k = index[id(gmm)] = len(tables)
            # the reference's float32 means, then float64
            tables.append((gmm.get_means().astype(np.float64),
                           gmm.inv_vars.astype(np.float64)))
        xs.append(data)
        posts.append(post)
        gidx.append(np.full(data.shape[0], k))
    if not xs:
        raise ValueError("pack_groups: no frames")
    G = max(t[0].shape[0] for t in tables)
    D = xs[0].shape[1]
    means = np.zeros((len(tables), G, D))
    inv_vars = np.zeros((len(tables), G, D))
    for k, (m, iv) in enumerate(tables):
        means[k, :m.shape[0]] = m
        inv_vars[k, :iv.shape[0]] = iv
    post = np.zeros((sum(len(x) for x in xs), G))
    row = 0
    for p in posts:
        post[row:row + p.shape[0], :p.shape[1]] = p
        row += p.shape[0]
    g = torch.as_tensor(np.concatenate(gidx), device=device)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return GaussRows(dev(np.concatenate(xs)), dev(post), dev(means)[g],
                     dev(inv_vars)[g])


def third_moment(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 chunk: int = 1 << 15) -> torch.Tensor:
    """sum over rows m of a[m, i] b[m, j] c[m, k] -> (I, J, K), in chunks
    of rows so that the (rows, J, K) intermediate stays small."""
    out = a.new_zeros((a.shape[1], b.shape[1], c.shape[1]))
    for s in range(0, a.shape[0], chunk):
        out += torch.einsum("mi,mj,mk->ijk", a[s:s + chunk], b[s:s + chunk],
                            c[s:s + chunk])
    return out
