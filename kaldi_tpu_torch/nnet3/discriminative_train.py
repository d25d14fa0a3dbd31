"""Sequence-discriminative fine-tuning of nnet3 acoustic models (port of
`kaldi_tpu/nnet3/discriminative_train.py`; parity:
nnet3bin/nnet3-discriminative-train + the
steps/nnet3/train_discriminative.sh loop).

The reference pipeline decodes the training data once (denominator
lattices), aligns it (numerator), then fine-tunes with MMI/MPFE/sMBR.
Each step of `train_discriminative`:

  1. the live forward of one utterance runs on the card;
  2. its outputs come to the host, the denominator lattice is rescored
     with them (`rescore_lattice_acoustics`) and the host forward-backward
     (nnet3/discriminative.py) gives the per-frame pdf gradient G;
  3. autograd's backward of  -kappa * sum(ll * G) + l2 * sum(|p|^2)
     (G held constant, the l2 sum over the trainable parameters only,
     not BatchNorm's statistics) through the same forward;
  4. Adam (parallel/optim.py, optax's defaults) updates the parameters.

The reference's DiscriminativeComputation applies the same chain rule on
the GPU.  The JAX package runs the forward twice a step (once for the
lattice, once under its gradient); the port keeps the first forward's
graph, which gives the same numbers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.fstext.fst import Arc, LatticeWeight, VectorFst
from kaldi_tpu_torch.lat.functions import lattice_state_times
from kaldi_tpu_torch.nnet3.discriminative import (
    DiscriminativeOptions, compute_discriminative_objf_and_grad)
from kaldi_tpu_torch.parallel import optim


@dataclass
class DiscTrainOptions:
    num_epochs: int = 2
    learning_rate: float = 1e-4
    acoustic_scale: float = 0.1
    criterion: str = "smbr"
    l2: float = 1e-5


def rescore_lattice_acoustics(lat, tm, loglikes: np.ndarray):
    """Replace each arc's acoustic cost with -loglike[t, pdf(tid)]
    under the CURRENT model (the reference recomputes arc loglikes
    from the nnet output every minibatch; stored lattice acoustics
    would go stale as parameters move)."""
    times = lattice_state_times(lat)
    out = VectorFst(LatticeWeight)
    for _ in range(lat.num_states):
        out.add_state()
    out.set_start(lat.start)
    T = loglikes.shape[0]
    for s in range(lat.num_states):
        out.finals[s] = lat.finals[s]
        for a in lat.arcs[s]:
            g, ac = a.weight
            if a.ilabel != 0 and times[s] < T:
                pdf = tm.transition_id_to_pdf(a.ilabel)
                ac = -float(loglikes[times[s], pdf])
            out.add_arc(s, Arc(a.ilabel, a.olabel, (g, ac), a.nextstate))
    return out


def utterance_gradient(tm, ll: np.ndarray, num_ali: Sequence[int], den_lat,
                       num_pdfs: int, d_opts: DiscriminativeOptions):
    """The host half of a step -> (objf, frames, G): the lattice rescored
    with the outputs `ll` (T', num_pdfs), the objective and its gradient
    over the first min(len(num_ali), T') frames, G zero-padded to ll's
    shape."""
    T = min(len(num_ali), ll.shape[0])
    lat = rescore_lattice_acoustics(den_lat, tm, ll)
    objf, grad = compute_discriminative_objf_and_grad(
        d_opts, tm, list(num_ali)[:T], lat, num_pdfs)
    g = np.zeros(ll.shape, np.float64)
    g[:grad.shape[0]] = grad[:ll.shape[0]]
    return objf, T, g


def step_loss(ll: torch.Tensor, g: torch.Tensor,
              params: Sequence[torch.Tensor], acoustic_scale: float,
              l2: float) -> torch.Tensor:
    """-kappa * sum(ll * G) + l2 * sum(|p|^2), G held constant."""
    obj = (ll * g).sum() * acoustic_scale
    return -obj + l2 * sum(torch.sum(p * p) for p in params)


def train_discriminative(model: Callable[[torch.Tensor], torch.Tensor], tm,
                         feats: Dict[str, np.ndarray],
                         num_ali: Dict[str, Sequence[int]],
                         den_lats: Dict[str, object],
                         num_pdfs: int,
                         opts: Optional[DiscTrainOptions] = None,
                         params: Optional[Dict[str, torch.Tensor]] = None,
                         device: DeviceLike = None,
                         stats: Optional[dict] = None):
    """model(feats (1, T, D) on `device`) -> loglikes (1, T', num_pdfs),
    an nn.Module or a callable; params: the tensors it trains, by default
    the module's named parameters (BatchNorm's statistics are buffers,
    outside them).  They are updated in place.  Returns (params,
    per-epoch objective list).

    stats, when given, receives the host seconds of the lattice work
    ("host_s"), and on CUDA each step's device milliseconds of the
    forward ("forward_ms") and of the backward and update
    ("backward_ms") by CUDA events, and the peak allocation
    ("peak_memory_gb")."""
    opts = opts or DiscTrainOptions()
    dev = resolve_device(device)
    d_opts = DiscriminativeOptions(criterion=opts.criterion,
                                   acoustic_scale=opts.acoustic_scale)
    if params is None:
        params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tx = optim.adam(opts.learning_rate)
    state = tx.init(params)
    keys = list(params)
    stats = {} if stats is None else stats
    stats.update(host_s=0.0, forward_ms=[], backward_ms=[])
    events = []
    objfs: List[float] = []
    for epoch in range(opts.num_epochs):
        tot_obj = tot_frames = 0.0
        for u in sorted(feats):
            f = torch.from_numpy(np.asarray(feats[u], np.float32)[None]).to(
                dev)
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  if dev.type == "cuda" else None)
            with full_f32():
                if ev:
                    ev[0].record()
                ll = model(f)[0]
                if ev:
                    ev[1].record()
                t0 = time.perf_counter()
                objf, T, g = utterance_gradient(
                    tm, ll.detach().cpu().numpy(), num_ali[u], den_lats[u],
                    num_pdfs, d_opts)
                stats["host_s"] += time.perf_counter() - t0
                loss = step_loss(ll, torch.from_numpy(g).to(ll), [
                    params[k] for k in keys], opts.acoustic_scale, opts.l2)
                grads = torch.autograd.grad(loss, [params[k] for k in keys])
                with torch.no_grad():
                    updates, state = tx.update(dict(zip(keys, grads)),
                                               state, params)
                    for k in keys:
                        params[k].add_(updates[k])
                if ev:
                    ev[2].record()
                    events.append(ev)
            tot_obj += objf * T
            tot_frames += T
        objfs.append(tot_obj / max(tot_frames, 1))
        log(f"discriminative epoch {epoch} ({opts.criterion}): "
            f"objf/frame {objfs[-1]:.4f}")
    if events:
        torch.cuda.synchronize(dev)
        stats["forward_ms"] = [a.elapsed_time(b) for a, b, _ in events]
        stats["backward_ms"] = [b.elapsed_time(c) for _, b, c in events]
        stats["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return params, objfs
