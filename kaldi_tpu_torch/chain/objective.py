"""Chain (LF-MMI) objective: the batched log-domain forward pass over the
numerator and denominator graphs, its gradient from autograd (port of
`ChainTrainingOptions` and `chain_loss` of `kaldi_tpu/chain/objective.py`).

Parity: chain/chain-training.h:146 ComputeChainObjfAndDeriv = numerator
forward-backward - denominator forward-backward + l2 + cross-entropy.
The reference implements the alpha/beta recursions as CUDA kernels in the
probability domain with a renormalization every frame
(chain-denominator.h:44-180); the JAX package runs a log-domain
`lax.scan` with per-arc gathers and a segment logsumexp, and takes the
gradient (the occupancies) from autodiff of the scan.  Here the same
recursion is a Python loop of PyTorch ops over the output frames, and
autograd gives the gradient.  The numerator graphs of a minibatch are
padded to one shape (`batch_pack`) and run as one (B, S) recursion, the
counterpart of the reference's `vmap`; the denominator graph is shared by
every sequence.  Leaky-HMM is the rank-1 escape to the initial
distribution each frame.

The arcs are laid out by destination (`InArcs`): each state's segment
logsumexp is a dense reduction over its padded in-arc slots, and the two
gathers (the source states' values, the arcs' pdf scores) run their
backward pass through the transposed tables, so a step adds in one fixed
order on any device and needs no atomics and no global switch.

Costs are kept at NEG_INF = -1e30 (finite), not -inf, with the
reference's `isfinite` tests: a dead state's value stays near -1e30 and a
segment with no arc at all gets NEG_INF.  The segment max and the
per-frame shift are detached from the graph: in exact arithmetic the
result does not depend on them, so the gradient is unchanged, and ties
do not split it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class ChainTrainingOptions:
    l2_regularize: float = 0.0
    leaky_hmm_coefficient: float = 1.0e-05
    xent_regularize: float = 0.0


def _ranks(key: np.ndarray, num_keys: int) -> Tuple[np.ndarray, int]:
    """key (sorted, in [0, num_keys)) -> (each entry's rank among the
    entries of its key, the largest count, at least 1)."""
    counts = np.bincount(key, minlength=num_keys)
    starts = np.cumsum(counts) - counts
    return np.arange(key.size) - starts[key], max(int(counts.max()), 1)


def _uses(owner: np.ndarray, slot: np.ndarray, num_owners: int,
          pad: int) -> np.ndarray:
    """For each owner (a graph's state or pdf), the slots that read it,
    in slot order and padded with `pad` -> (num_owners * width,)."""
    order = np.lexsort((slot, owner))
    owner, slot = owner[order], slot[order]
    rank, width = _ranks(owner, num_owners)
    out = np.full(num_owners * width, pad, np.int64)
    out[owner * width + rank] = slot
    return out


class InArcs:
    """G graphs (one a sequence, or one that every sequence shares) in
    padded in-arc form on a device.  The arcs into state s sit in slots
    [s*K, s*K + K) of their graph's row, in arc order, then padding:

      src, pdf     (G, S*K) int64    each slot's source state and pdf
                                     (0 in padding)
      log_prob     (G, S*K) float32  -inf in padding, which adds nothing
      initial, final  (G, S) float32
      src_uses     (G, S*Ko) int64   each state's out-arc slots (S*K pads)
      pdf_uses     (G, P*Kp) int64   each pdf's slots (S*K pads)

    The `*_uses` tables are the two gathers' transposes (`_Gather`).
    Arcs at or below -1e29 that repeat (source, destination, pdf) keep
    one copy: these are `batch_pack`'s padding self-loops on a dead
    state, and their n copies move its value, near -1e30, by log(n),
    below float32's resolution there."""

    def __init__(self, src, dst, pdf, log_prob, initial, final,
                 num_pdfs: int, device: torch.device):
        src, dst, pdf = (np.atleast_2d(np.asarray(a, np.int64))
                         for a in (src, dst, pdf))
        lp = np.atleast_2d(np.asarray(log_prob, np.float32))
        initial = np.atleast_2d(np.asarray(initial, np.float32))
        final = np.atleast_2d(np.asarray(final, np.float32))
        G, A = src.shape
        S, P = initial.shape[1], num_pdfs
        g = np.repeat(np.arange(G), A)
        src, dst, pdf, lp = src.ravel(), dst.ravel(), pdf.ravel(), lp.ravel()
        keep = lp > -1e29
        dead = np.flatnonzero(~keep)
        if dead.size:
            _, first = np.unique(np.stack([g[dead], src[dead], dst[dead],
                                           pdf[dead]]), axis=1,
                                 return_index=True)
            keep[dead[first]] = True
        key = (g * S + dst)[keep]
        order = np.argsort(key, kind="stable")
        key = key[order]
        g, src, pdf, lp = (a[keep][order] for a in (g, src, pdf, lp))
        rank, K = _ranks(key, G * S)
        pos = key * K + rank                    # in (G * S * K)
        in_src = np.zeros(G * S * K, np.int64)
        in_pdf = np.zeros(G * S * K, np.int64)
        in_lp = np.full(G * S * K, -np.inf, np.float32)
        in_src[pos], in_pdf[pos], in_lp[pos] = src, pdf, lp
        slot = pos - g * (S * K)                # within its graph's row
        ints = [in_src, in_pdf, _uses(g * S + src, slot, G * S, S * K),
                _uses(g * P + pdf, slot, G * P, S * K)]
        dev_ints = torch.from_numpy(np.concatenate(ints)).to(device)
        self.src, self.pdf, self.src_uses, self.pdf_uses = (
            t.view(G, -1) for t in torch.split(dev_ints,
                                               [a.size for a in ints]))
        floats = torch.from_numpy(np.concatenate(
            [in_lp, initial.ravel(), final.ravel()])).to(device)
        self.log_prob, self.initial, self.final = (
            t.view(G, -1) for t in torch.split(
                floats, [in_lp.size, G * S, G * S]))
        self.num_states, self.slots = S, K


class _Gather(torch.autograd.Function):
    """x.gather(-1, index) whose backward pass gathers the output's
    gradient through `uses` (for each element of x's last dim, a fixed
    number of output positions, the output's length padding) and sums
    them in that order, where gather's own backward scatter-adds with
    atomics on CUDA."""

    @staticmethod
    def forward(ctx, x, index, uses):
        ctx.save_for_backward(uses)
        ctx.n = x.shape[-1]
        return x.gather(-1, index)

    @staticmethod
    def backward(ctx, grad):
        uses, = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros(grad.shape[:-1] + (1,))],
                           dim=-1)
        g = padded.gather(-1, uses)
        return g.view(*g.shape[:-1], ctx.n, -1).sum(dim=-1), None, None


def _logsumexp_slots(vals: torch.Tensor) -> torch.Tensor:
    """(B, S, K) -> (B, S): each state's logsumexp over its in-arc slots,
    the max detached.  A state with no arc at all gets NEG_INF; one whose
    arcs are all near -1e30 (dead) stays near there."""
    m = vals.detach().amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    s = torch.exp(vals - m_safe[..., None]).sum(dim=-1)
    return (m_safe + torch.log(torch.clamp_min(s, 1e-37))
            + torch.where(finite, 0.0, NEG_INF))


def _forward_loglike(nnet_out: torch.Tensor, graphs: InArcs,
                     leaky: float) -> torch.Tensor:
    """Batched forward pass.  nnet_out (B, T, P) log-space scores over
    `graphs` (one graph a sequence, or one for all) -> (B,) total
    loglikes."""
    B, T, _P = nnet_out.shape
    S, K = graphs.num_states, graphs.slots
    G = graphs.src.shape[0]
    # every frame's emission plus transition score, slot by slot
    slot_scores = _Gather.apply(
        nnet_out, graphs.pdf[:, None].expand(B, T, -1),
        graphs.pdf_uses[:, None].expand(B, T, -1)) \
        + graphs.log_prob[:, None]
    src = graphs.src.expand(B, -1)
    src_uses = graphs.src_uses.expand(B, -1)
    initial = graphs.initial.expand(B, -1) if G == 1 else graphs.initial
    final = graphs.final.expand(B, -1) if G == 1 else graphs.final
    alpha = initial
    shifts = []
    log_leaky = math.log(leaky) if leaky > 0 else NEG_INF
    for t in range(T):
        if leaky > 0:
            # leaky-HMM: from the total mass, an escape to the initial
            # distribution
            tot = torch.logsumexp(alpha, dim=1, keepdim=True)
            alpha = torch.logaddexp(alpha, log_leaky + initial + tot)
        vals = _Gather.apply(alpha, src, src_uses) + slot_scores[:, t]
        new_alpha = _logsumexp_slots(vals.view(B, S, K))
        # renormalize to keep magnitudes bounded; the constant is added
        # back at the end
        shift = new_alpha.detach().amax(dim=1, keepdim=True)
        alpha = new_alpha - shift
        shifts.append(shift[:, 0])
    total = torch.logsumexp(alpha + final, dim=1)
    return total + torch.stack(shifts, dim=1).sum(dim=1)


def chain_loss(opts: ChainTrainingOptions, den_graph, num_graphs_batched,
               nnet_out: torch.Tensor,
               xent_out: Optional[torch.Tensor] = None,
               num_posteriors: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, dict]:
    """Differentiable objective PER FRAME (higher is better):
    (num - den + xent_regularize * xent) / (B*T), plus l2 on nnet_out
    (the reference's 'output-l2' style regularizer).

    den_graph: DenominatorGraph.  num_graphs_batched: the stacked numpy
    (src, dst, pdf, log_prob, initial, final) of `chain.graphs.batch_pack`.
    num_posteriors: optional (B, T, P) targets for the xent head; without
    them the xent term is skipped.  Returns (objf, aux) with the
    per-frame "num" and "den" (and "l2", "xent")."""
    B, T, P = nnet_out.shape
    dev = nnet_out.device
    num_ll = _forward_loglike(
        nnet_out, InArcs(*num_graphs_batched, P, dev), 0.0)
    g = den_graph.graph
    den_ll = _forward_loglike(
        nnet_out, InArcs(g.src, g.dst, g.pdf, g.log_prob, g.initial,
                         g.final, P, dev),
        float(opts.leaky_hmm_coefficient))
    tot_frames = B * T
    objf = (num_ll.sum() - den_ll.sum()) / tot_frames
    aux = {"num": num_ll.sum() / tot_frames,
           "den": den_ll.sum() / tot_frames}
    if opts.l2_regularize > 0:
        l2 = -0.5 * opts.l2_regularize * torch.mean(
            torch.sum(nnet_out ** 2, dim=-1))
        objf = objf + l2
        aux["l2"] = l2
    if opts.xent_regularize > 0 and xent_out is not None \
            and num_posteriors is not None:
        xent = torch.mean(torch.sum(num_posteriors * xent_out, dim=-1))
        objf = objf + opts.xent_regularize * xent
        aux["xent"] = xent
    return objf, aux
