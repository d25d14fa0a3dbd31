"""Diverged-model handling for synchronous training (port of
`kaldi_tpu/parallel/recovery.py`).

The reference tolerates diverged/crashed parallel SGD jobs by dropping
them from the periodic model average (`get_successful_models`,
steps/libs/nnet3/train/chain_objf/acoustic_model.py:332) and restarts
an outer iteration from the previous model when its objective goes bad
(steps/nnet3/chain/train.py surveillance of compute_prob logs).  With
a single synchronous train step there are no independent jobs to
drop; the equivalent policy is reject-and-rollback:

  * snapshot the full train state every `snapshot_every` steps;
  * after every step, inspect the objective (and gradient norm): a
    non-finite value or a collapse of more than `collapse_tol` nats
    below the recent-window best rejects the step, restores the last
    snapshot, and continues with the learning rate scaled down by
    `lr_backoff` (applied through the `lr_scale` input of
    make_sharded_train_step);
  * the LR scale recovers multiplicatively (`lr_recover` per accepted
    step) back toward 1 once training is healthy again.

Use: guard = DivergenceGuard(); each step:
    batch["lr_scale"] = guard.lr_scale
    state, metrics = step_fn(state, batch)
    state, ok = guard.observe(state, float(metrics["objf"]))
(when ok is False the returned state is the restored snapshot and the
minibatch should be retried or skipped).

The guard hides nothing: `rejects` counts every rejected step, and a
caller on healthy data can hold it to 0."""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Optional, Tuple

import torch

from kaldi_tpu_torch.base.logging import warn
from kaldi_tpu_torch.parallel.optim import tree_map


class DivergenceGuard:
    def __init__(self, snapshot_every: int = 25,
                 collapse_tol: float = 10.0,
                 window: int = 20,
                 lr_backoff: float = 0.5,
                 lr_recover: float = 1.05,
                 min_lr_scale: float = 1.0 / 64,
                 max_rejects: int = 20,
                 to_host: bool = False):
        """to_host=True keeps snapshots in host RAM — slower to restore
        but no device memory; by default a copy stays on the card (one
        extra copy of the parameters, statistics and optimizer state)."""
        self.snapshot_every = int(snapshot_every)
        self.collapse_tol = float(collapse_tol)
        self.window = int(window)
        self.lr_backoff = float(lr_backoff)
        self.lr_recover = float(lr_recover)
        self.min_lr_scale = float(min_lr_scale)
        self.max_rejects = int(max_rejects)
        self.to_host = bool(to_host)
        self.lr_scale = 1.0
        self.rejects = 0
        self._snap: Optional[Any] = None
        self._device: Optional[torch.device] = None
        self._accepted = 0
        self._objfs: deque = deque(maxlen=self.window)

    # ------------------------------------------------------------------
    def _take_snapshot(self, state) -> None:
        if self.to_host:
            devices = []

            def host(x):
                devices.append(x.device)
                return x.detach().to("cpu", copy=True)
            self._snap = tree_map(host, state)
            self._device = devices[0] if devices else None
        else:
            # a copy on the state's device: the step may update the live
            # state's tensors in place later
            self._snap = tree_map(lambda x: x.detach().clone(), state)

    def _restore(self):
        snap = self._snap
        if self.to_host:
            return tree_map(lambda x: x.to(self._device, copy=True), snap)
        return tree_map(lambda x: x.clone(), snap)

    # ------------------------------------------------------------------
    def observe(self, state, objf: float,
                grad_norm: Optional[float] = None) -> Tuple[Any, bool]:
        """Inspect one finished step.  Returns (state', accepted):
        on acceptance state' is the input state (snapshotting it when
        due); on rejection state' is the restored snapshot."""
        bad = not math.isfinite(objf)
        if grad_norm is not None and not math.isfinite(grad_norm):
            bad = True
        if not bad and self._objfs:
            ref = max(self._objfs)
            if objf < ref - self.collapse_tol:
                bad = True
        if bad and self._snap is not None:
            self.rejects += 1
            self.lr_scale = max(self.min_lr_scale,
                                self.lr_scale * self.lr_backoff)
            warn(f"DivergenceGuard: rejected step (objf={objf:.4g}); "
                 f"restored snapshot, lr_scale -> {self.lr_scale:.4g}")
            if self.rejects > self.max_rejects:
                raise RuntimeError(
                    f"DivergenceGuard: {self.rejects} rejected steps — "
                    "training cannot recover (bad data or LR far too "
                    "high)")
            return self._restore(), False
        if bad:
            # no snapshot yet (diverged before the first one): treat
            # the pre-training state as implicitly good is impossible
            # here, so just back the LR off and continue
            self.rejects += 1
            self.lr_scale = max(self.min_lr_scale,
                                self.lr_scale * self.lr_backoff)
            warn(f"DivergenceGuard: bad step before first snapshot "
                 f"(objf={objf:.4g}); lr_scale -> {self.lr_scale:.4g}")
            return state, False
        self._objfs.append(objf)
        self._accepted += 1
        if self.lr_scale < 1.0:
            self.lr_scale = min(1.0, self.lr_scale * self.lr_recover)
        if (self._accepted - 1) % self.snapshot_every == 0:
            self._take_snapshot(state)
        return state, True
