"""Lattice-based sequence-discriminative training objectives (port of
`kaldi_tpu/nnet3/discriminative.py`, numpy as there; parity:
nnet3/discriminative-training.h — MMI, MPFE, sMBR — and the nnet2-era
smbr recipes).

Given per-utterance numerator alignments and denominator lattices
(from decoding the training data), computes the objective and the
per-frame pdf gradient:

  MMI:   log p_num - log p_den ; gradient = γ_num − γ_den
  sMBR:  expected frame accuracy under lattice posteriors; gradient
         via the standard γ_den (acc − acc_avg) form.

The lattice forward-backward runs on the host (lattices are small
after pruning); the resulting (T, pdfs) gradient matrix G feeds the
backward pass through the acoustic model on the card
(nnet3/discriminative_train.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import EPS, LatticeWeight
from kaldi_tpu_torch.lat.functions import _topsort, lattice_state_times
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice


@dataclass
class DiscriminativeOptions:
    criterion: str = field(default="smbr", metadata={"doc": "Criterion, 'mmi'|'mpfe'|'smbr'"})
    acoustic_scale: float = field(default=0.1, metadata={"doc": "Weighting factor on acoustic likelihoods"})
    one_silence_class: bool = False
    silence_phones: Sequence[int] = field(default_factory=list)


def _arc_posteriors(lat: Lattice, acoustic_scale: float):
    """Returns (order, times, alpha, beta, total) in log domain."""
    n = lat.num_states
    order = _topsort(lat)
    times = lattice_state_times(lat)

    def ll(a):
        return -(a.weight[0] + acoustic_scale * a.weight[1])

    alpha = np.full(n, -np.inf)
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == -np.inf:
            continue
        for a in lat.arcs[s]:
            alpha[a.nextstate] = np.logaddexp(alpha[a.nextstate],
                                              alpha[s] + ll(a))
    beta = np.full(n, -np.inf)
    for s in range(n):
        if lat.finals[s] != LatticeWeight.zero:
            beta[s] = -(lat.finals[s][0] + acoustic_scale * lat.finals[s][1])
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = np.logaddexp(beta[s], ll(a) + beta[a.nextstate])
    return order, times, alpha, beta, beta[lat.start], ll


def compute_discriminative_objf_and_grad(
        opts: DiscriminativeOptions, tm,
        num_alignment: Sequence[int], den_lattice: Lattice,
        num_pdfs: int) -> Tuple[float, np.ndarray]:
    """Returns (objective, grad (T, num_pdfs)) — the derivative of the
    objective wrt per-frame pdf log-likelihoods (to be chained through
    acoustic_scale by the caller's autodiff)."""
    T = len(num_alignment)
    num_pdf_seq = tm.transition_ids_to_pdfs(num_alignment)
    order, times, alpha, beta, total, ll = _arc_posteriors(
        den_lattice, opts.acoustic_scale)
    # denominator occupancies γ_den[t, pdf]
    gamma = np.zeros((T, num_pdfs))
    # per-arc frame accuracies for sMBR
    sil = set(opts.silence_phones)
    acc_num = np.zeros((T, num_pdfs))     # sum of post*acc per (t,pdf)
    for s in order:
        if alpha[s] == -np.inf:
            continue
        for a in den_lattice.arcs[s]:
            if a.ilabel == EPS:
                continue
            t = times[s]
            if t >= T:
                continue
            post = np.exp(alpha[s] + ll(a) + beta[a.nextstate] - total)
            pdf = tm.transition_id_to_pdf(a.ilabel)
            gamma[t, pdf] += post
            if opts.criterion in ("smbr", "mpfe"):
                if opts.criterion == "smbr":
                    correct = float(pdf == num_pdf_seq[t])
                else:  # mpfe: phone-level accuracy
                    correct = float(
                        tm.transition_id_to_phone(a.ilabel)
                        == tm.transition_id_to_phone(num_alignment[t]))
                if opts.one_silence_class and \
                        tm.transition_id_to_phone(a.ilabel) in sil:
                    correct = float(
                        tm.transition_id_to_phone(num_alignment[t]) in sil)
                acc_num[t, pdf] += post * correct
    if opts.criterion == "mmi":
        # objf = log p_num - log p_den ; here we report the den part +
        # num path indicator; gradient = 1[num pdf] - γ_den
        grad = -gamma
        objf = 0.0
        for t in range(T):
            grad[t, num_pdf_seq[t]] += 1.0
            objf += np.log(max(gamma[t, num_pdf_seq[t]], 1e-20))
        objf /= max(T, 1)
        return objf, grad
    # smbr / mpfe
    frame_post = gamma.sum(axis=1)
    acc_t = acc_num.sum(axis=1) / np.maximum(frame_post, 1e-20)
    objf = float(acc_t.mean())
    # gradient: γ(t,pdf) * (acc(t,pdf)/γ(t,pdf) − acc_avg(t))
    with np.errstate(divide="ignore", invalid="ignore"):
        acc_pdf = np.where(gamma > 0, acc_num / np.maximum(gamma, 1e-20), 0.0)
    grad = gamma * (acc_pdf - acc_t[:, None])
    return objf, grad
