"""Multinomial logistic regression on i-vectors, the language-id and
speaker-id back end of the lre07 recipes (port of
kaldi_tpu/ivector/logistic_regression.py).

Training maximizes the L2-regularized multiclass log-likelihood with
full-batch Adam on the card in float32, in the reference's arithmetic:
its seeded initial weights, its mix-up allocation, the class posterior
as a sum over the class's components floored at 1e-30, the L2 term over
the whole weight matrix, and optax's Adam (`parallel/optim.py` `adam`).
The sum over components is a product with a (components, classes)
one-hot matrix, so a step has no atomics and one seed gives one model.
Evaluation stays float64 on the host, as the reference keeps it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device


@dataclass
class LogisticRegressionConfig:
    max_steps: int = 200
    normalizer: float = 0.0025       # L2 on the weights
    mix_up: int = 0                  # target #components (0 = #classes)
    power: float = 0.15              # occupancy power for mix-up
    learning_rate: float = 0.5


class LogisticRegression:
    def __init__(self, weights: Optional[np.ndarray] = None,
                 class_of: Optional[np.ndarray] = None):
        # weights: (C_components, D+1), the last column the offset
        self.weights = weights
        # component -> class map (mix-up expands classes)
        self.class_of = class_of

    @property
    def num_classes(self) -> int:
        return int(self.class_of.max()) + 1

    def log_posteriors(self, x: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, num_classes) log p(class | x), float64."""
        x = np.asarray(x, np.float64)
        z = x @ self.weights[:, :-1].T + self.weights[:, -1]
        z = z - z.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        out = np.zeros((x.shape[0], self.num_classes))
        for comp, cls in enumerate(self.class_of):
            out[:, cls] += p[:, comp]
        return np.log(np.maximum(out, 1e-300))

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<LogisticRegression>")
        iof.write_token(stream, binary, "<weights>")
        iof.write_matrix(stream, binary, self.weights)
        iof.write_token(stream, binary, "<class-map>")
        iof.write_int_vector(stream, binary,
                             [int(c) for c in self.class_of])
        iof.write_token(stream, binary, "</LogisticRegression>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "LogisticRegression":
        iof.expect_token(stream, binary, "<LogisticRegression>")
        iof.expect_token(stream, binary, "<weights>")
        w = iof.read_matrix(stream, binary).astype(np.float64)
        iof.expect_token(stream, binary, "<class-map>")
        cmap = np.asarray(iof.read_int_vector(stream, binary), np.int32)
        iof.expect_token(stream, binary, "</LogisticRegression>")
        return cls(w, cmap)


def mix_up_class_map(y: np.ndarray, num_classes: int,
                     cfg: LogisticRegressionConfig) -> np.ndarray:
    """component -> class: one component a class, or with mix-up the
    target spread by occupancy**power, floored, at least one a class."""
    class_of = np.arange(num_classes, dtype=np.int32)
    if cfg.mix_up > num_classes:
        counts = np.bincount(y, minlength=num_classes).astype(np.float64)
        wts = np.maximum(counts, 1.0) ** cfg.power
        alloc = np.maximum(1, np.floor(
            cfg.mix_up * wts / wts.sum()).astype(int))
        class_of = np.concatenate(
            [np.full(a, c, np.int32) for c, a in enumerate(alloc)])
    return class_of


def train_logistic_regression(x: np.ndarray, y: np.ndarray,
                              cfg: Optional[LogisticRegressionConfig]
                              = None, device: DeviceLike = None
                              ) -> LogisticRegression:
    """x (N, D), y (N,) class ids -> trained model (card by default)."""
    from kaldi_tpu_torch.parallel.optim import adam
    cfg = cfg or LogisticRegressionConfig()
    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.int64)
    N, D = x.shape
    C = int(y.max()) + 1
    class_of = mix_up_class_map(y, C, cfg)
    K = len(class_of)
    rng = np.random.default_rng(0)
    w0 = np.asarray(0.01 * rng.normal(size=(K, D + 1)), np.float32)
    xb = torch.from_numpy(np.concatenate(
        [x, np.ones((N, 1))], axis=1).astype(np.float32)).to(dev)
    onehot = torch.zeros(K, C, dtype=torch.float32, device=dev)
    onehot[torch.arange(K), torch.from_numpy(class_of.astype(np.int64))] = 1
    yt = torch.from_numpy(y).to(dev)
    rows = torch.arange(N, device=dev)

    def neg_objf(w: torch.Tensor) -> torch.Tensor:
        z = xb @ w.T                                    # (N, K)
        lse = torch.logsumexp(z, dim=1)
        zc = torch.exp(z - lse[:, None]) @ onehot       # (N, C)
        ll = torch.log(torch.clamp(zc[rows, yt], min=1e-30))
        return -(ll.mean() - cfg.normalizer * torch.sum(w * w))

    tx = adam(cfg.learning_rate)
    w = torch.from_numpy(w0).to(dev)
    state = tx.init({"w": w})
    loss = torch.zeros(())
    with full_f32():
        for _ in range(cfg.max_steps):
            wg = w.detach().requires_grad_(True)
            loss = neg_objf(wg)
            (g,) = torch.autograd.grad(loss, wg)
            upd, state = tx.update({"w": g}, state)
            w = w + upd["w"]
    log(f"logistic regression: {N} examples, {C} classes, {K} "
        f"components, final objf {-float(loss.detach()):.4f}")
    return LogisticRegression(w.cpu().numpy().astype(np.float64), class_of)
