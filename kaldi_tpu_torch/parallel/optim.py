"""Gradient transformations over dicts of tensors: the optax subset that
the JAX package trains with (`clip_by_global_norm`, `adam`, `sgd` with
momentum, `chain`), written out with optax's arithmetic in optax's order.

A transformation is a pair of pure functions, as in optax:

    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

`update` leaves its inputs alone, so a caller may run it twice from one
state (backstitch, parallel/trainer.py).  A learning rate is a float or a
schedule, count -> rate, read before the update as optax reads it.
States are tuples, dicts, ints and tensors; `tree_map` maps over them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Tensors = Dict[object, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], object]
    update: Callable[[Tensors, object, Optional[Tensors]],
                     Tuple[Tensors, object]]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """fn over every tensor of nested dicts, lists, tuples (named ones
    too) and dataclasses; anything else is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tensors.values()))


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return {k: p + updates[k] for k, p in params.items()}


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: (),
                                  lambda g, state, params=None: (g, state))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """g <- g if |g| < max_norm else (g / |g|) * max_norm (|g| global)."""
    def update(g, state, params=None):
        norm = global_norm(g)
        keep = norm < max_norm
        return {k: torch.where(keep, t, (t / norm) * max_norm)
                for k, t in g.items()}, state
    return GradientTransformation(lambda params: (), update)


class AdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;
    u <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), n = count + 1,
    the bias corrections in float32 as optax computes them."""
    def init(params):
        return AdamState(0, {k: torch.zeros_like(p) for k, p in
                             params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(g, state, params=None):
        mu = {k: (1 - b1) * t + b1 * state.mu[k] for k, t in g.items()}
        nu = {k: (1 - b2) * (t * t) + b2 * state.nu[k] for k, t in g.items()}
        n = state.count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        return ({k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                 for k in g}, AdamState(n, mu, nu))
    return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
    """Momentum: t <- g + decay t, the update t."""
    def update(g, state, params=None):
        new = {k: t + decay * state[k] for k, t in g.items()}
        return new, new
    return GradientTransformation(
        lambda params: {k: torch.zeros_like(p) for k, p in params.items()},
        update)


def scale_by_learning_rate(lr: LearningRate) -> GradientTransformation:
    """u <- -lr u; a schedule is read at the count of earlier updates."""
    if not callable(lr):
        return GradientTransformation(
            lambda params: (),
            lambda g, state, params=None: (
                {k: -lr * t for k, t in g.items()}, state))

    def update(g, count, params=None):
        step = -float(lr(count))
        return {k: step * t for k, t in g.items()}, count + 1
    return GradientTransformation(lambda params: 0, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(g, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            g, s = tx.update(g, s, params)
            new.append(s)
        return g, tuple(new)
    return GradientTransformation(init, update)


def adam(lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def sgd(lr: LearningRate,
        momentum: Optional[float] = None) -> GradientTransformation:
    return chain(identity() if momentum is None else trace(momentum),
                 scale_by_learning_rate(lr))
