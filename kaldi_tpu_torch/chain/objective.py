"""Chain (LF-MMI) objective: the batched log-domain forward pass over the
numerator and denominator graphs and its gradient (port of
`ChainTrainingOptions` and `chain_loss` of `kaldi_tpu/chain/objective.py`).

Parity: chain/chain-training.h:146 ComputeChainObjfAndDeriv = numerator
forward-backward - denominator forward-backward + l2 + cross-entropy.
The reference implements the alpha/beta recursions as CUDA kernels in the
probability domain with a renormalization every frame
(chain-denominator.h:44-180); the JAX package runs a log-domain
`lax.scan` with per-arc gathers and a segment logsumexp, checkpoints each
frame step, and takes the gradient (the occupancies) from autodiff of the
scan.  Here the same recursion is a Python loop of PyTorch ops over the
output frames that keeps each frame's alpha and each state's max and
exp-sum over its in-arcs, and the backward pass is the beta recursion
written out (`_ChainForward`): each frame's arc posteriors are recomputed
from its alpha, summed into the pdfs' gradient and passed back to the
source states, with the derivative formulas and operation order that
autograd of the plain recursion uses.  The numerator graphs of a
minibatch are padded to one shape (`batch_pack`) and run as one (B, S)
recursion, the counterpart of the reference's `vmap`; the denominator
graph is shared by every sequence, and its layout is built once a graph
and device (`den_arcs`).  Leaky-HMM is the rank-1 escape to the initial
distribution each frame.

The arcs are laid out by destination (`InArcs`): each state's logsumexp
is a dense reduction over its in-arc slots.  A small graph takes one
width, its largest in-degree; a large one (the --scale recipe's 31,745-
state, 2.0M-arc window-LM denominator, in-degrees 1, 33 and 994) is cut
into buckets of states of similar in-degree, each (B, n, K) with K their
largest in-degree, so its slots are its arcs and not 31.5M.  The
backward pass sums each state's out-slots and each pdf's slots through
transposed tables laid out the same way, so a step adds in one fixed
order on any device and needs no atomics and no global switch.

Costs are kept at NEG_INF = -1e30 (finite), not -inf, with the
reference's `isfinite` tests: a dead state's value stays near -1e30 and a
segment with no arc at all gets NEG_INF.  The per-frame shift is a
constant of the recursion: in exact arithmetic the result does not depend
on it, so it takes no part in the gradient.
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


def _widths(count: np.ndarray) -> np.ndarray:
    """Each count's bucket width: the least power of two >= count, at
    least 1."""
    w = np.ones_like(count)
    big = count > 1
    w[big] = np.left_shift(1, np.ceil(np.log2(count[big])).astype(np.int64))
    return w


# Buckets merge while a merge pads the graphs by at most this many slots
# more: below it a pass over the padding costs the card less than a
# bucket's launches cost the host
ONE_WIDTH_SLOTS = 1 << 20


def _bucket_layout(g: np.ndarray, owner: np.ndarray, G: int,
                   num_owners: int):
    """Items (graph g, owner) in their order, grouped by owner into
    buckets.  The owners whose item count rounds up to the same power of
    two form a class; neighbouring classes, narrowest first, share a
    bucket while that pads the graphs by at most ONE_WIDTH_SLOTS more
    slots (a small graph takes one bucket).  In each graph, a bucket of
    width k (the most items any of its owners has) holds n owners (the
    most any graph has in it; owners with fewer items pad, a graph with
    fewer owners pads with empty rows), in owner order, each a row of k
    slots holding its items in their order, then padding.
      -> (buckets [(n, k)] by width, row (G, num_owners): each owner's
          row in the buckets' concatenation, slot (items,): each item's
          position in its graph's flat row of sum(n * k) slots)."""
    key = g * num_owners + owner
    count = np.bincount(key, minlength=G * num_owners).reshape(G, num_owners)
    width = _widths(count)

    def shape(classes):
        mine = np.isin(width, classes)
        return (mine, int(mine.sum(axis=1).max()),
                max(int(count[mine].max()), 1))

    def padded(classes):
        _, n, k = shape(classes)
        return G * n * k

    groups = []
    for w in np.unique(width):
        if groups and padded(groups[-1] + [w]) - padded(groups[-1]) \
                - padded([w]) <= ONE_WIDTH_SLOTS:
            groups[-1].append(w)
        else:
            groups.append([w])
    buckets, row = [], np.zeros((G, num_owners), np.int64)
    base = np.zeros((G, num_owners), np.int64)    # first slot of the row
    row_off = slot_off = 0
    for classes in groups:
        mine, n, k = shape(classes)
        rank = np.cumsum(mine, axis=1) - 1
        row[mine] = row_off + rank[mine]
        base[mine] = slot_off + rank[mine] * k
        buckets.append((n, k))
        row_off += n
        slot_off += n * k
    order = np.argsort(key, kind="stable")
    starts = np.cumsum(count.ravel()) - count.ravel()
    within = np.empty_like(key)
    within[order] = np.arange(key.size) - starts[key[order]]
    slot = base.ravel()[key] + within
    return buckets, row, slot


def _select(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, N) by index (G, M) -> (B, M): one index row that every
    sequence shares (G = 1), or one a sequence (G = B)."""
    return x.gather(1, index.expand(x.shape[0], -1))


class _Transpose:
    """For each owner of a graph (a state or a pdf), the slots that read
    it, bucketed: `sum(w)` adds each owner's slots of w (B, L + 1) (slot
    L is 0) in slot order -> (B, num_owners)."""

    def __init__(self, owner: np.ndarray, g: np.ndarray, slot: np.ndarray,
                 G: int, num_owners: int, L: int, device: torch.device):
        order = np.lexsort((slot, owner, g))
        g, owner, slot = g[order], owner[order], slot[order]
        self.buckets, row, pos = _bucket_layout(g, owner, G, num_owners)
        width = sum(n * w for n, w in self.buckets)
        uses = np.full((G, width), L, np.int64)
        uses[g, pos] = slot
        self.uses = torch.from_numpy(uses).to(device)
        self.row = torch.from_numpy(row).to(device)
        self.one_width = len(self.buckets) == 1

    def sum(self, w: torch.Tensor) -> torch.Tensor:
        B = w.shape[0]
        parts, off = [], 0
        for n, k in self.buckets:
            v = _select(w, self.uses[:, off:off + n * k])
            parts.append(v.view(B, n, k).sum(dim=-1))
            off += n * k
        if self.one_width:          # owners in their own order
            return parts[0]
        return _select(torch.cat(parts, dim=1), self.row)


class InArcs:
    """G graphs (one a sequence, or one that every sequence shares) in
    bucketed in-arc form on a device.  A graph's states are renumbered so
    that each bucket's states are consecutive (`state_row` (G, S): each
    original state's number); bucket (n, K) holds n states of K in-arc
    slots each, and its slots follow the earlier buckets' in one column
    of L slots, plus slot L, which is padding:

      src, pdf     (G, L + 1) int64    each slot's source state (new
                                       numbering) and pdf (0 in padding)
      log_prob     (G, L + 1) float32  -inf in padding, which adds nothing
      initial, final  (G, S') float32  S' = sum of the buckets' n
      from_src, from_pdf  _Transpose   each state's out-slots, each pdf's
                                       slots (the backward pass's sums)

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
        g, src, dst, pdf, lp = (a[keep] for a in (g, src, dst, pdf, lp))
        self.buckets, row, slot = _bucket_layout(g, dst, G, S)
        L = sum(n * k for n, k in self.buckets)
        S2 = sum(n for n, _ in self.buckets)
        in_src = np.zeros((G, L + 1), np.int64)
        in_pdf = np.zeros((G, L + 1), np.int64)
        in_lp = np.full((G, L + 1), -np.inf, np.float32)
        new_src = row[g, src]
        in_src[g, slot], in_pdf[g, slot], in_lp[g, slot] = new_src, pdf, lp
        init2 = np.full((G, S2), NEG_INF, np.float32)
        fin2 = np.full((G, S2), NEG_INF, np.float32)
        gg = np.repeat(np.arange(G), S)
        init2[gg, row.ravel()] = initial.ravel()
        fin2[gg, row.ravel()] = final.ravel()
        self.from_src = _Transpose(new_src, g, slot, G, S2, L, device)
        self.from_pdf = _Transpose(pdf, g, slot, G, P, L, device)
        self.src, self.pdf = (torch.from_numpy(a).to(device)
                              for a in (in_src, in_pdf))
        self.log_prob, self.initial, self.final = (
            torch.from_numpy(a).to(device) for a in (in_lp, init2, fin2))
        self.state_row = row
        self.num_states, self.num_slots = S2, L
        self.num_arcs = int(keep.sum())

    def slot_sizes(self) -> dict:
        """The layout's sizes: states, arcs, slots and {width: states} of
        the in-arc buckets (per graph)."""
        return {"states": self.num_states, "arcs": self.num_arcs,
                "slots": self.num_slots,
                "buckets": {k: n for n, k in self.buckets}}


def den_arcs(den_graph, num_pdfs: int, device: torch.device) -> InArcs:
    """The denominator graph's InArcs on `device`, built on the first call
    for that device and pdf count and kept on the graph."""
    cache = den_graph.__dict__.setdefault("_in_arcs", {})
    key = (str(device), num_pdfs)
    if key not in cache:
        g = den_graph.graph
        cache[key] = InArcs(g.src, g.dst, g.pdf, g.log_prob, g.initial,
                            g.final, num_pdfs, device)
    return cache[key]


def _frame_vals(arcs: InArcs, alpha: torch.Tensor,
                out_t: torch.Tensor) -> torch.Tensor:
    """(B, L + 1): each slot's source value + (emission + transition);
    alpha (B, S'), out_t (B, P)."""
    scores = _select(out_t, arcs.pdf)
    scores += arcs.log_prob
    vals = _select(alpha, arcs.src)
    vals += scores
    return vals


def _exp_slots(vals: torch.Tensor, buckets, m_safe=None):
    """Each state's max over its in-arc slots and the slots' exp(val -
    max) in place of vals (B, L + 1), bucket by bucket -> the max with 0
    where every slot is -inf (B, S'), or m_safe as given."""
    B = vals.shape[0]
    ms, off, row = [], 0, 0
    for n, k in buckets:
        v = vals[:, off:off + n * k].view(B, n, k)
        if m_safe is None:
            m = v.amax(dim=-1)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        else:
            m = m_safe[:, row:row + n]
        ms.append(m)
        v.sub_(m[..., None]).exp_()
        off += n * k
        row += n
    return ms[0] if len(ms) == 1 else torch.cat(ms, dim=1)


def _slot_sums(vals: torch.Tensor, buckets) -> torch.Tensor:
    """(B, S'): each state's sum of its slots of vals (B, L + 1)."""
    B = vals.shape[0]
    out, off = [], 0
    for n, k in buckets:
        out.append(vals[:, off:off + n * k].view(B, n, k).sum(dim=-1))
        off += n * k
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _leak(alpha: torch.Tensor, init: torch.Tensor, leaky: float):
    """Leaky-HMM: from the total mass, an escape to the initial
    distribution -> (alpha after the escape, the escape's value, the total
    mass)."""
    if leaky <= 0:
        return alpha, None, None
    tot = torch.logsumexp(alpha, dim=1, keepdim=True)
    escape = math.log(leaky) + init + tot
    return torch.logaddexp(alpha, escape), escape, tot


class _ChainForward(torch.autograd.Function):
    """(B, T, P) scores over `arcs` -> (B,) total loglikes.  Saves each
    frame's alpha (B, T + 1, S') and each state's max and exp-sum over its
    slots (B, T, S'); the backward pass recomputes a frame's slot values
    from its alpha.  Every value and gradient is computed with the
    operations, in the order, that autograd of the plain recursion uses
    (logaddexp's, logsumexp's, log's and exp's derivative formulas), so
    a one-width layout gives that recursion's numbers bit for bit."""

    @staticmethod
    def forward(ctx, nnet_out, arcs: InArcs, leaky: float):
        B, T, _ = nnet_out.shape
        dt = nnet_out.dtype
        init = arcs.initial.to(dt).expand(B, -1)
        S = arcs.num_states
        alphas = nnet_out.new_empty((B, T + 1, S))
        maxes = nnet_out.new_empty((B, T, S))
        sums = nnet_out.new_empty((B, T, S))
        shifts = nnet_out.new_empty((B, T))
        alphas[:, 0] = alpha = init
        for t in range(T):
            leaked = _leak(alpha, init, leaky)[0]
            vals = _frame_vals(arcs, leaked, nnet_out[:, t])
            m_safe = _exp_slots(vals, arcs.buckets)
            s = _slot_sums(vals, arcs.buckets)
            maxes[:, t], sums[:, t] = m_safe, s
            # a state with no arc at all (every slot -inf: the exp-sum
            # is 0, else the max's own slot adds 1) gets NEG_INF; one
            # whose arcs are all near -1e30 (dead) stays near there
            new = (m_safe + torch.log(torch.clamp_min(s, 1e-37))
                   + torch.where(s > 0, 0.0, NEG_INF))
            shift = new.amax(dim=1, keepdim=True)
            alphas[:, t + 1] = alpha = new - shift
            shifts[:, t] = shift[:, 0]
        total = torch.logsumexp(alphas[:, T] + arcs.final.to(dt), dim=1) \
            + shifts.sum(dim=1)
        ctx.save_for_backward(nnet_out, alphas, maxes, sums)
        ctx.arcs, ctx.leaky = arcs, leaky
        return total

    @staticmethod
    def backward(ctx, grad_total):
        nnet_out, alphas, maxes, sums = ctx.saved_tensors
        arcs, leaky = ctx.arcs, ctx.leaky
        B, T, _ = nnet_out.shape
        dt = nnet_out.dtype
        init = arcs.initial.to(dt).expand(B, -1)
        grad_out = torch.zeros_like(nnet_out)
        # d total / d alpha_T (logsumexp's derivative)
        last = alphas[:, T] + arcs.final.to(dt)
        g = grad_total[:, None] * torch.exp(
            last - torch.logsumexp(last, dim=1, keepdim=True))
        for t in range(T - 1, -1, -1):
            # a dense copy: the leak's kernels then take the forward's path
            a = alphas[:, t].contiguous() if t else init
            leaked, escape, tot = _leak(a, init, leaky)
            vals = _frame_vals(arcs, leaked, nnet_out[:, t])
            _exp_slots(vals, arcs.buckets, maxes[:, t])
            # log(clamp_min(s)) and exp: each slot's gradient is its
            # exponential times g / s
            s = sums[:, t]
            gs = torch.where(s >= 1e-37, g / torch.clamp_min(s, 1e-37), 0.0)
            off, row = 0, 0
            for n, k in arcs.buckets:
                vals[:, off:off + n * k].view(B, n, k).mul_(
                    gs[:, row:row + n, None])
                off += n * k
                row += n
            vals[:, -1] = 0.0
            grad_out[:, t] = arcs.from_pdf.sum(vals)
            g = arcs.from_src.sum(vals)
            if leaky > 0:
                # leaked = logaddexp(a, escape), escape = c + init + tot,
                # tot = logsumexp(a)
                g_esc = g / (1 + torch.exp(a - escape))
                g = g / (1 + torch.exp(escape - a)) + g_esc.sum(
                    dim=1, keepdim=True) * torch.exp(a - tot)
        return grad_out, None, None


def _forward_loglike(nnet_out: torch.Tensor, graphs: InArcs,
                     leaky: float) -> torch.Tensor:
    """Batched forward pass.  nnet_out (B, T, P) log-space scores over
    `graphs` (one graph a sequence, or one for all) -> (B,) total
    loglikes, differentiable in nnet_out."""
    return _ChainForward.apply(nnet_out, graphs, float(leaky))


def chain_loss(opts: ChainTrainingOptions, den_graph, num_graphs_batched,
               nnet_out: torch.Tensor,
               xent_out: Optional[torch.Tensor] = None,
               num_posteriors: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, dict]:
    """Differentiable objective PER FRAME (higher is better):
    (num - den + xent_regularize * xent) / (B*T), plus l2 on nnet_out
    (the reference's 'output-l2' style regularizer).

    den_graph: DenominatorGraph.  num_graphs_batched: the stacked numpy
    (src, dst, pdf, log_prob, initial, final) of `chain.graphs.batch_pack`,
    or their InArcs on nnet_out's device (built ahead, so that its copies
    to the card do not wait for the network's forward pass).
    num_posteriors: optional (B, T, P) targets for the xent head; without
    them the xent term is skipped.  Returns (objf, aux) with the
    per-frame "num" and "den" (and "l2", "xent")."""
    B, T, P = nnet_out.shape
    dev = nnet_out.device
    num_arcs = num_graphs_batched if isinstance(num_graphs_batched, InArcs) \
        else InArcs(*num_graphs_batched, P, dev)
    num_ll = _forward_loglike(nnet_out, num_arcs, 0.0)
    den_ll = _forward_loglike(nnet_out, den_arcs(den_graph, P, dev),
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
