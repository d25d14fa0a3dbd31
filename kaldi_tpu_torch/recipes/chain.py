"""Chain (LF-MMI) training over the monophone chain topology and over a
context-dependent (triphone) tree (port of `ChainTrainOptions`,
`make_chain_system`, `mono_ali_to_chain_ali`, `train_chain_topo`,
`segment_alignment_words`, `build_ctx_chain_system`, `train_chain_ctx`,
`_fit_chain`, the frame-rate `train_chain` with `make_chunks`, the
flat-start `train_chain_e2e` and `nnet_log_likes` of
`kaldi_tpu/recipes/chain.py`).

Parity: steps/chain/train.py (den graph from the alignments' phone LM,
time-tolerant numerators from the alignments, SGD on the chain
objective), single-process.  The TDNN-F trains in float32 with TF32 off,
as the reference's float32 parameters do.  The optimizer is optax's
`chain(clip_by_global_norm(max_param_change), adam(schedule))` written
out (`ChainOptimizer`), the schedule optax's `join_schedules` of a
warm-up and a linear fall (`lr_schedule`; `train_chain` falls linearly
from the first step, `linear_schedule`), the chunk order numpy's
`default_rng(seed).shuffle`, and the semi-orthogonal constraint runs on
every TDNN-F `linear` factor, in the reference's layout, every
`orthonormal_interval` steps.  Every op of a step adds in a fixed order
(the chain objective's gathers included, `chain.objective.InArcs`), so
on the card too one seed gives one model.  With per-utterance i-vectors
each chunk carries its utterance's i-vector as the model's second input.
A config with `dropout` trains with masks drawn from a generator on the
device seeded with opts.seed.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.chain.graphs import DenominatorGraph, batch_pack
from kaldi_tpu_torch.chain.objective import (ChainTrainingOptions, InArcs,
                                             chain_loss, den_arcs)
from kaldi_tpu_torch.chain.supervision import (
    alignment_to_numerator_graph, alignment_to_phone_segments,
    alignment_to_tolerance_numerator, denominator_graph_from_phone_lm,
    estimate_phone_lm, estimate_window_lm, make_denominator_graph,
    make_tolerance_supervision, transcript_to_e2e_numerator)
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.nnet3.components import constrain_orthonormal
from kaldi_tpu_torch.nnet3.models import (ChainTdnnf, ChainTdnnfConfig,
                                          chain_tdnnf_from_flax,
                                          chain_tdnnf_init,
                                          chain_tdnnf_to_flax)
from kaldi_tpu_torch.parallel import optim
from kaldi_tpu_torch.tree.build_tree import (BuildTreeOptions, build_tree,
                                             cluster_phones)
from kaldi_tpu_torch.tree.clusterable import GaussClusterable
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
from kaldi_tpu_torch.tree.event_map import PDF_CLASS_KEY

_log = logging.getLogger(__name__)

# the profiler range around each step of `_fit_chain`: the forward pass,
# the chain loss, the backward pass and the update
STEP_RANGE = "chain_step"


@dataclass
class ChainTrainOptions:
    num_epochs: int = 10
    learning_rate: float = 1e-3
    final_learning_rate: float = 1e-4
    minibatch_size: int = 8
    chunk_width: int = 60          # input frames per chunk
    chain: ChainTrainingOptions = field(
        default_factory=lambda: ChainTrainingOptions(
            l2_regularize=5e-5, leaky_hmm_coefficient=0.1,
            xent_regularize=0.0))
    max_param_change: float = 2.0
    orthonormal_interval: int = 4  # apply semi-orthogonal constraint
    seed: int = 0
    # time-tolerant numerator supervision (chain-supervision.cc
    # defaults); 0/0 = exact linear numerators from the alignment
    left_tolerance: int = 0
    right_tolerance: int = 0


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def linear_schedule(lr: float, final_lr: float,
                    steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule(lr, final_lr, steps), in float32 as optax
    computes it."""
    return lambda count: _linear(lr, final_lr, steps, count)


def lr_schedule(lr: float, final_lr: float, warmup: int,
                total_steps: int) -> Callable[[int], np.float32]:
    """optax.join_schedules([linear_schedule(0.1 lr, lr, warmup),
    linear_schedule(lr, final_lr, max(total - warmup, 1))], [warmup]),
    in float32 as optax computes it."""
    def at(count: int) -> np.float32:
        if count < warmup:
            return _linear(lr * 0.1, lr, warmup, count)
        return _linear(lr, final_lr, max(total_steps - warmup, 1),
                       count - warmup)
    return at


class ChainOptimizer:
    """optax.chain(clip_by_global_norm(max_norm), adam(schedule)) over a
    list of float32 tensors (`parallel/optim.py`), updated in place by
    `step(grads)` (a None gradient counts as zeros, as optax sees a
    parameter that does not reach the loss):

      g   <- g if |g| < max_norm else (g / |g|) * max_norm   (|g| global)
      mu  <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
      u   <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps),  n = step+1
      p   <- p - lr(step) u        (the schedule read before the update)
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], max_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(enumerate(params))
        self.tx = optim.chain(optim.clip_by_global_norm(max_norm),
                              optim.adam(schedule, b1, b2, eps))
        self.state = self.tx.init(self.params)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.params.items(), grads)}
        updates, self.state = self.tx.update(grads, self.state, self.params)
        for k, p in self.params.items():
            p.add_(updates[k])


def apply_orthonormal(model: ChainTdnnf) -> None:
    """The semi-orthogonal constraint on every TDNN-F bottleneck factor
    (steps/libs/nnet3/train/frame_level_objf/common.py: applied
    periodically during training; without it the factored bottleneck
    degenerates at scale), on the reference's (bottleneck, k*D) layout
    of the factor."""
    with torch.no_grad():
        for layer in model.tdnnf:
            linear, affine = layer.reference_factors()
            layer.load_reference(constrain_orthonormal(linear.detach()),
                                 affine.detach().clone())


def make_chain_system(lang, mono_tm) -> Tuple:
    """Build the chain-topology system (1-state HMMs, forward/self pdf
    split) over the same phone set (steps/nnet3/chain/gen_topo.py +
    build-tree stage of the chain recipe, monophone version).
    Returns (chain_tm, chain_tree)."""
    phones = mono_tm.get_phones()
    topo = HmmTopology.chain_topology(list(phones))
    npc = {p: 2 for p in phones}
    tree = monophone_context_dependency(list(phones), npc)
    tm = TransitionModel(topo, tree)
    return tm, tree


def mono_ali_to_chain_ali(ali: Sequence[int], mono_tm, chain_tm,
                          subsample: int = 3) -> List[int]:
    """Convert a frame-level alignment to chain transition-ids at the
    subsampled output rate: each phone segment of d input frames
    becomes ceil(d/subsample) output frames = [forward, self-loop...]."""
    # phone segments
    segs: List[Tuple[int, int]] = []  # (phone, num_frames)
    for tid in ali:
        phone = mono_tm.transition_id_to_phone(tid)
        is_start = (mono_tm.transition_id_to_hmm_state(tid) == 0
                    and not mono_tm.is_self_loop(tid))
        if is_start or not segs:
            segs.append((phone, 1))
        else:
            segs[-1] = (segs[-1][0], segs[-1][1] + 1)
    # boundary-preserving conversion: input segment [s, e) maps to
    # output frames [round(s/sub), round(e/sub)) with minimum 1 frame
    target = len(ali) // subsample

    def tids_for(phone):
        ts = None
        for cand in range(1, chain_tm.num_transition_states + 1):
            if chain_tm.transition_state_to_phone(cand) == phone:
                ts = cand
                break
        sl = chain_tm.self_loop_of(ts)
        fwd = None
        for idx in range(chain_tm.num_transition_indices(ts)):
            tid = chain_tm.pair_to_transition_id(ts, idx)
            if not chain_tm.is_self_loop(tid):
                fwd = tid
                break
        return fwd, sl

    out: List[int] = []
    pos = 0
    out_pos = 0
    for phone, dur in segs:
        end = pos + dur
        o_end = max(out_pos + 1, int(round(end / subsample)))
        o_end = min(o_end, target) if target else o_end
        fwd, sl = tids_for(phone)
        d_out = o_end - out_pos
        if d_out >= 1:
            out.extend([fwd] + [sl] * (d_out - 1))
            out_pos = o_end
        pos = end
    # pad/trim tail to exactly the target length
    if target > 0:
        while len(out) < target:
            out.append(out[-1] if out else 1)
        del out[target:]
    return out


def chain_egs(sys_mono, feats: Dict[str, np.ndarray],
              mono_alignments: Dict[str, List[int]],
              chain_tm: TransitionModel, chain_tree,
              opts: ChainTrainOptions, sub: int = 3,
              ivectors: Optional[Dict[str, np.ndarray]] = None):
    """The denominator graph and the training examples of
    `train_chain_topo` -> (den_graph, chunks, num_graphs): the den graph
    from the phone LM of the chain alignments, and the utterances cut
    into chunks of chunk_width input frames (a multiple of sub), each
    (feats, chain alignment at the output rate, the utterance's i-vector
    or None) with its numerator (time-tolerant where opts asks for a
    tolerance)."""
    # chain alignments at the output rate
    chain_ali = {u: mono_ali_to_chain_ali(a, sys_mono.tm, chain_tm, sub)
                 for u, a in mono_alignments.items()}
    phone_seqs = []
    for u, a in chain_ali.items():
        seq = []
        for tid in a:
            if not chain_tm.is_self_loop(tid):
                seq.append(chain_tm.transition_id_to_phone(tid))
        if seq:
            phone_seqs.append(seq)
    den_graph = make_denominator_graph(phone_seqs, chain_tm, chain_tree)
    chunks = []
    num_graphs = []  # per-chunk numerator PackedGraph
    tol = (opts.left_tolerance, opts.right_tolerance)
    cw = (opts.chunk_width // sub) * sub
    for u, f in feats.items():
        if u not in chain_ali:
            continue
        ca = chain_ali[u]
        T_in = min(f.shape[0], len(ca) * sub)
        for start in range(0, T_in - cw + 1, cw):
            o_start, o_end = start // sub, (start + cw) // sub
            if tol != (0, 0):
                g = alignment_to_tolerance_numerator(
                    mono_alignments[u][start:start + cw], sys_mono.tm,
                    chain_tm, sub, *tol)
            else:
                g = alignment_to_numerator_graph(ca[o_start:o_end],
                                                 chain_tm, subsample=1)
            iv = None if ivectors is None else np.asarray(
                ivectors[u], np.float32)
            chunks.append((f[start:start + cw], ca[o_start:o_end], iv))
            num_graphs.append(g)
    if not chunks:
        raise ValueError("no chain chunks")
    _log.info("chain-topo training: %d chunks of %d frames (%d outputs), "
              "tolerance %s", len(chunks), cw, cw // sub, tol)
    return den_graph, chunks, num_graphs


def train_chain_topo(sys_mono, feats: Dict[str, np.ndarray],
                     mono_alignments: Dict[str, List[int]],
                     cfg: Optional[ChainTdnnfConfig] = None,
                     opts: Optional[ChainTrainOptions] = None,
                     ivectors: Optional[Dict[str, np.ndarray]] = None,
                     device: DeviceLike = None,
                     stats: Optional[dict] = None,
                     variables: Optional[dict] = None):
    """Chain training with the chain topology and frame subsampling.
    Returns (model, variables, den_graph, chain_tm, chain_tree); the
    model trains on `device`, and `stats` (when given) receives what
    `_fit_chain` records plus the chunk count.  ivectors: per-utterance
    i-vectors, the model's second input (cfg.ivector_dim of them).
    variables: the initial weights (`_fit_chain`'s), by default the
    port's seeded draw."""
    if opts is None:
        opts = ChainTrainOptions()
    chain_tm, chain_tree = make_chain_system(sys_mono.lang, sys_mono.tm)
    sub = 3 if cfg is None else cfg.frame_subsampling_factor
    dim = next(iter(feats.values())).shape[1]
    if cfg is None:
        cfg = ChainTdnnfConfig(feat_dim=dim, num_pdfs=chain_tm.num_pdfs,
                               hidden_dim=128, bottleneck_dim=32,
                               prefinal_dim=64, num_layers=5,
                               subsample_layer=3,
                               frame_subsampling_factor=3)
        sub = 3
    den_graph, chunks, num_graphs = chain_egs(
        sys_mono, feats, mono_alignments, chain_tm, chain_tree, opts, sub,
        ivectors)
    cw = (opts.chunk_width // sub) * sub
    if stats is not None:
        stats["chunks"] = len(chunks)
    model, variables = _fit_chain(cfg, den_graph, chunks, num_graphs,
                                  opts, cw, dim, variables=variables,
                                  device=device, stats=stats,
                                  use_ivectors=ivectors is not None)
    return model, variables, den_graph, chain_tm, chain_tree


class _ChainFit:
    """The state of a chain SGD run (the train_one_iteration body of
    steps/chain/train.py, single-process): the model in training mode on
    the device, `ChainOptimizer` over `lr_schedule`'s warm-up and fall,
    and what the run records in `stats`.  `step` takes one minibatch;
    `end_epoch` closes an epoch; `finish` -> (model, variables).
    schedule: count -> learning rate, by default `lr_schedule`'s."""

    def __init__(self, cfg, den_graph: DenominatorGraph,
                 opts: ChainTrainOptions, n_items: int,
                 variables: Optional[dict], device: DeviceLike,
                 stats: Optional[dict],
                 schedule: Optional[Callable[[int], float]] = None):
        self.dev = resolve_device(device)
        if variables is None:
            variables = chain_tdnnf_init(
                cfg, torch.Generator().manual_seed(opts.seed))
        self.cfg, self.den_graph, self.opts = cfg, den_graph, opts
        self.model = chain_tdnnf_from_flax(cfg, variables, torch.float32,
                                           self.dev)
        self.model.train()
        self.model.requires_grad_(True)
        if cfg.dropout > 0:
            self.model.dropout_gen = torch.Generator(
                self.dev).manual_seed(opts.seed)
        self.params = list(self.model.parameters())
        if schedule is None:
            steps_per_epoch = max(1, n_items // opts.minibatch_size)
            total_steps = steps_per_epoch * opts.num_epochs
            warmup = min(max(total_steps // 20, 10), total_steps // 2 or 1)
            schedule = lr_schedule(opts.learning_rate,
                                   opts.final_learning_rate, warmup,
                                   total_steps)
        self.opt = ChainOptimizer(self.params, schedule,
                                  opts.max_param_change)
        self.stats = {} if stats is None else stats
        self.stats.update(step_objf=[], epoch_objf=[], step_ms=[])
        self.events = []
        self.objfs: List[float] = []
        self.it = 0

    def step(self, feats_b: np.ndarray, num_graphs,
             ivecs_b: Optional[np.ndarray] = None) -> None:
        dev, model = self.dev, self.model
        x = torch.from_numpy(feats_b).to(dev)
        iv = None if ivecs_b is None else torch.from_numpy(ivecs_b).to(dev)
        # the numerators' layout, copied to the card before the forward
        # pass is queued
        num_arcs = InArcs(*batch_pack(num_graphs), self.cfg.num_pdfs, dev)
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with full_f32():
            with torch.profiler.record_function(STEP_RANGE):
                chain_out, xent_out = model(x, iv)
                objf, _aux = chain_loss(self.opts.chain, self.den_graph,
                                        num_arcs, chain_out, xent_out)
                grads = torch.autograd.grad(-objf, self.params,
                                            allow_unused=True)
                self.opt.step(grads)
            if dev.type == "cuda":
                ev[1].record()
                self.events.append(ev)
            self.objfs.append(float(objf.detach()))
            self.it += 1
            if self.it % self.opts.orthonormal_interval == 0:
                apply_orthonormal(model)

    def end_epoch(self, epoch: int) -> None:
        self.stats["step_objf"].extend(self.objfs)
        self.stats["epoch_objf"].append(float(np.mean(self.objfs)))
        self.objfs = []
        _log.info("chain epoch %d: objf/frame %.4f", epoch,
                  self.stats["epoch_objf"][-1])

    def finish(self):
        if self.events:
            torch.cuda.synchronize(self.dev)
            self.stats["step_ms"] = [a.elapsed_time(b)
                                     for a, b in self.events]
            self.stats["peak_memory_gb"] = \
                torch.cuda.max_memory_allocated(self.dev) / 1e9
        self.model.eval()
        self.model.requires_grad_(False)
        return self.model, chain_tdnnf_to_flax(self.model)


def _fit_chain(cfg, den_graph: DenominatorGraph, chunks, num_graphs,
               opts: ChainTrainOptions, cw: int, dim: int,
               variables: Optional[dict] = None, device: DeviceLike = None,
               stats: Optional[dict] = None, use_ivectors: bool = False):
    """The chain SGD loop over chunks -> (model, variables).
    use_ivectors: each chunk's third item, its utterance's i-vector, is
    the model's second input.

    variables: the initial {"params", "batch_stats"} in flax's layout;
    by default `chain_tdnnf_init` from a generator seeded with
    opts.seed.  stats, when given, receives each step's objective
    ("step_objf"), each epoch's mean ("epoch_objf"), and on CUDA each
    step's milliseconds on the card by CUDA events, from the forward
    pass to the end of the update ("step_ms"), and the card's peak
    allocation since its last reset ("peak_memory_gb")."""
    fit = _ChainFit(cfg, den_graph, opts, len(chunks), variables, device,
                    stats)
    rng_np = np.random.default_rng(opts.seed)
    order = np.arange(len(chunks))
    for epoch in range(opts.num_epochs):
        rng_np.shuffle(order)
        for i in range(0, len(order) - opts.minibatch_size + 1,
                       opts.minibatch_size):
            idx = order[i:i + opts.minibatch_size]
            fit.step(np.stack([chunks[j][0] for j in idx]),
                     [num_graphs[j] for j in idx],
                     np.stack([chunks[j][2] for j in idx])
                     if use_ivectors else None)
        fit.end_epoch(epoch)
    return fit.finish()


def make_chunks(feats: Dict[str, np.ndarray],
                alignments: Dict[str, List[int]],
                chunk_width: int, subsample: int
                ) -> List[Tuple[np.ndarray, List[int]]]:
    """Cut utterances into fixed-width chunks with matching alignment
    slices (the egs-generation equivalent, chain-supervision.h:448
    SplitIntoRanges — simple non-overlapping version)."""
    chunks = []
    for utt, f in feats.items():
        if utt not in alignments:
            continue
        ali = alignments[utt]
        T = min(f.shape[0], len(ali))
        for start in range(0, T - chunk_width + 1, chunk_width):
            chunks.append((f[start:start + chunk_width],
                           ali[start:start + chunk_width]))
    return chunks


def train_chain(sys_, feats: Dict[str, np.ndarray],
                alignments: Dict[str, List[int]],
                cfg: Optional[ChainTdnnfConfig] = None,
                opts: Optional[ChainTrainOptions] = None,
                variables: Optional[dict] = None,
                device: DeviceLike = None,
                stats: Optional[dict] = None):
    """Chain training at the frame rate over a GMM system's own topology
    and tree (sys_: a MonoSystem): the den graph from the alignments'
    phone sequences, exact linear numerators of each chunk, chunks of
    opts.chunk_width frames in the order of one `default_rng(opts.seed)`,
    the learning rate falling linearly from the first step
    (`linear_schedule`).  variables, device and stats as `_fit_chain`
    takes them.  Returns (model, variables, den_graph)."""
    if opts is None:
        opts = ChainTrainOptions()
    tm, tree = sys_.tm, sys_.tree
    dim = next(iter(feats.values())).shape[1]
    if cfg is None:
        cfg = ChainTdnnfConfig(feat_dim=dim, num_pdfs=tm.num_pdfs,
                               hidden_dim=128, bottleneck_dim=32,
                               prefinal_dim=64, num_layers=5,
                               subsample_layer=3,
                               frame_subsampling_factor=1)
    sub = cfg.frame_subsampling_factor

    # denominator graph from training phone sequences
    phone_seqs = []
    for utt, ali in alignments.items():
        phones = []
        for tid in ali:
            # a phone starts at a non-self-loop transition out of state 0
            if (tm.transition_id_to_hmm_state(tid) == 0
                    and not tm.is_self_loop(tid)):
                phones.append(tm.transition_id_to_phone(tid))
        if phones:
            phone_seqs.append(phones)
    den_graph = make_denominator_graph(phone_seqs, tm, tree)

    chunks = make_chunks(feats, alignments, opts.chunk_width, sub)
    if not chunks:
        raise ValueError("no training chunks")
    _log.info("chain training: %d chunks of %d frames", len(chunks),
              opts.chunk_width)
    total_steps = max(1, len(chunks) // opts.minibatch_size) * opts.num_epochs
    fit = _ChainFit(cfg, den_graph, opts, len(chunks), variables, device,
                    stats, schedule=linear_schedule(
                        opts.learning_rate, opts.final_learning_rate,
                        total_steps))
    fit.stats.update(chunks=len(chunks))
    rng_np = np.random.default_rng(opts.seed)
    order = np.arange(len(chunks))
    for epoch in range(opts.num_epochs):
        rng_np.shuffle(order)
        for start in range(0, len(order) - opts.minibatch_size + 1,
                           opts.minibatch_size):
            idx = order[start:start + opts.minibatch_size]
            fit.step(np.stack([chunks[i][0] for i in idx]),
                     [alignment_to_numerator_graph(chunks[i][1], tm, sub)
                      for i in idx])
        fit.end_epoch(epoch)
    model, variables = fit.finish()
    return model, variables, den_graph


# ----------------------------------------------------------------------
# Context-dependent (triphone) chain system.  The reference builds the
# chain tree from GMM alignments (steps/nnet3/chain/build_tree.sh) and
# composes the den phone-LM through the context expansion
# (chain-den-graph.cc); here the context convention is word-internal
# windows (0-padded at word boundaries), matching the n-gram decoder's
# graph build (decoder/lexchain_ng.py), so train-side pdfs and
# decode-side pdfs agree exactly.

def segment_alignment_words(ali: Sequence[int], mono_tm,
                            word_prons: Sequence[Sequence[int]],
                            sil_phone: int, N: int = 3, P: int = 1):
    """Mono frame alignment + per-word phone lists ->
    [(window, phone, start, end)] full-rate segments with word-internal
    context windows; silence segments get the 0-padded window.  Raises
    ValueError where the alignment and the transcript disagree."""
    segs = alignment_to_phone_segments(ali, mono_tm)
    exp: List[Tuple[int, Tuple[int, ...]]] = []
    for pron in word_prons:
        padded = [0] * P + [int(x) for x in pron] + [0] * (N - P - 1)
        for i in range(len(pron)):
            exp.append((int(pron[i]), tuple(padded[i:i + N])))
    sil_win = tuple([0] * P + [sil_phone] + [0] * (N - P - 1))
    out = []
    j = 0
    for (ph, s, e) in segs:
        if ph == sil_phone and (j >= len(exp) or exp[j][0] != sil_phone):
            out.append((sil_win, ph, s, e))
            continue
        if j < len(exp) and exp[j][0] == ph:
            out.append((exp[j][1], ph, s, e))
            j += 1
        else:
            raise ValueError(
                f"alignment/transcript phone mismatch at segment "
                f"{len(out)}: got phone {ph}, expected "
                f"{exp[j] if j < len(exp) else 'EOS'}")
    if j != len(exp):
        raise ValueError(f"alignment ended with {len(exp) - j} "
                         "transcript phones unconsumed")
    return out


def ctx_segments(sys_mono, mono_alignments: Dict[str, List[int]],
                 word_prons: Dict[str, List[List[int]]],
                 sil_phone: Optional[int] = None, N: int = 3, P: int = 1):
    """`segment_alignment_words` of every utterance -> ({utt: segments},
    the number of utterances whose alignment and transcript disagree,
    left out)."""
    if sil_phone is None:
        sil_phone = sys_mono.lang.phones["SIL"]
    seg_windows = {}
    skipped = 0
    for u, ali in mono_alignments.items():
        try:
            seg_windows[u] = segment_alignment_words(
                ali, sys_mono.tm, word_prons[u], sil_phone, N, P)
        except ValueError:
            skipped += 1
    if skipped:
        _log.warning("%d utterances failed word segmentation", skipped)
    return seg_windows, skipped


def build_ctx_chain_system(feats: Dict[str, np.ndarray],
                           seg_windows: Dict[str, list],
                           phones: Sequence[int],
                           N: int = 3, P: int = 1,
                           max_leaves: int = 2000,
                           min_gain: float = 30.0):
    """Triphone chain tree from windowed alignment stats (the first frame
    of a segment pdf-class 0, the rest pdf-class 1) + the chain
    TransitionModel over it -> (chain_tm, chain_tree)."""
    stats: Dict[tuple, GaussClusterable] = {}
    for u, segs in seg_windows.items():
        f = feats[u]
        for (win, ph, s, e) in segs:
            e = min(e, f.shape[0])
            if e <= s:
                continue
            for pc, sl in ((0, slice(s, s + 1)), (1, slice(s + 1, e))):
                frames = f[sl]
                if frames.shape[0] == 0:
                    continue
                ev = tuple(sorted(
                    [(PDF_CLASS_KEY, pc)]
                    + [(i, int(w)) for i, w in enumerate(win)]))
                gc = stats.get(ev)
                if gc is None:
                    gc = GaussClusterable(f.shape[1])
                    stats[ev] = gc
                gc.accumulate(frames)
    qsets = cluster_phones(stats, list(phones), P)
    # out-of-word position 0 can appear in context keys
    questions = {k: [[0]] + qsets for k in range(N)}
    questions[PDF_CLASS_KEY] = [[0], [1]]
    roots = [([p], True, True) for p in phones]
    topo = HmmTopology.chain_topology(list(phones))
    tree = build_tree(stats, questions, roots, N, P,
                      opts=BuildTreeOptions(max_leaves=max_leaves,
                                            min_gain=min_gain),
                      topo=topo)
    tm = TransitionModel(topo, tree)
    _log.info("ctx chain system: N=%d P=%d leaves=%d tids=%d", N, P,
              tree.num_pdfs, tm.num_transition_ids)
    return tm, tree


def ctx_den_graph(seg_windows: Dict[str, list], chain_tm, chain_tree,
                  window_den: Optional[bool] = None):
    """The denominator of `train_chain_ctx` -> (den_graph, the context
    tokens, window_den): a token-level bigram through the tree below
    1000 seen context tokens, above that (window_den None) or when
    window_den is True the tied pair-state window LM
    (`estimate_window_lm`)."""
    tokens = sorted({win for segs in seg_windows.values()
                     for (win, _, _, _) in segs})
    if window_den is None:
        window_den = len(tokens) > 1000
    if window_den:
        win_seqs = [[win for (win, _, _, _) in segs]
                    for segs in seg_windows.values()]
        lm, ilabel_info = estimate_window_lm(win_seqs)
    else:
        tok_id = {w: i + 1 for i, w in enumerate(tokens)}
        ilabel_info = [()] + list(tokens)
        tok_seqs = [[tok_id[win] for (win, _, _, _) in segs]
                    for segs in seg_windows.values()]
        lm = estimate_phone_lm(tok_seqs, list(tok_id.values()))
    den = denominator_graph_from_phone_lm(lm, chain_tm, chain_tree,
                                          ilabel_info=ilabel_info)
    return den, tokens, window_den


def ctx_chain_egs(feats: Dict[str, np.ndarray], seg_windows: Dict[str, list],
                  chain_tm, chain_tree, opts: ChainTrainOptions, sub: int,
                  ivectors: Optional[Dict[str, np.ndarray]] = None):
    """The examples of `train_chain_ctx` -> (chunks, num_graphs): each
    utterance cut into chunks of chunk_width input frames (a multiple of
    sub), each (feats, None, the utterance's i-vector or None) with its
    context-aware time-tolerant numerator."""
    cw = (opts.chunk_width // sub) * sub
    tol = (opts.left_tolerance, opts.right_tolerance)
    pdf_cache: Dict[tuple, Tuple[int, int]] = {}

    def pdfs_of(win):
        if win not in pdf_cache:
            pdf_cache[win] = (chain_tree.compute(list(win), 0),
                              chain_tree.compute(list(win), 1))
        return pdf_cache[win]

    chunks, num_graphs = [], []
    for u, f in feats.items():
        if u not in seg_windows:
            continue
        segs = seg_windows[u]
        T_in = min(f.shape[0], max(e for (_, _, _, e) in segs))
        for start in range(0, T_in - cw + 1, cw):
            end = start + cw
            clip = [(ph, max(s, start) - start, min(e, end) - start,
                     win) for (win, ph, s, e) in segs
                    if s < end and e > start]
            if not clip:
                continue
            seg3 = [(ph, s, e) for (ph, s, e, _) in clip]
            pairs = [pdfs_of(win) for (_, _, _, win) in clip]
            try:
                g = make_tolerance_supervision(
                    seg3, cw, chain_tm, sub, *tol, pdf_pairs=pairs)
            except ValueError:
                continue
            iv = None if ivectors is None else np.asarray(
                ivectors[u], np.float32)
            chunks.append((f[start:end], None, iv))
            num_graphs.append(g)
    if not chunks:
        raise ValueError("no chain chunks")
    return chunks, num_graphs


def train_chain_ctx(sys_mono, feats: Dict[str, np.ndarray],
                    mono_alignments: Dict[str, List[int]],
                    word_prons: Dict[str, List[List[int]]],
                    cfg=None, opts: Optional[ChainTrainOptions] = None,
                    N: int = 3, P: int = 1,
                    max_leaves: int = 2000, min_gain: float = 30.0,
                    sil_phone: Optional[int] = None,
                    ivectors: Optional[Dict[str, np.ndarray]] = None,
                    window_den: Optional[bool] = None,
                    device: DeviceLike = None,
                    stats: Optional[dict] = None):
    """Chain training over a context-dependent (triphone) tree with
    word-internal windows.  word_prons: per utterance the transcript's
    per-word phone lists.  cfg: a ChainTdnnfConfig, or a factory
    num_pdfs -> cfg (the tree's leaf count depends on the data).
    window_den: None (auto) picks the denominator LM as `ctx_den_graph`
    does.  Returns (model, variables, den_graph, chain_tm, chain_tree);
    the model trains on `device`.  stats, when given, receives the
    seconds of the tree (tree_s), the denominator and its layout on the
    device (den_s), the examples (egs_s) and the training (chain_s), the
    leaves, tids, tokens, the denominator's sizes ("den", from
    `InArcs.slot_sizes`), the chunk count and what `_fit_chain`
    records."""
    if opts is None:
        opts = ChainTrainOptions()
    if stats is None:
        stats = {}
    t0 = time.perf_counter()
    seg_windows, skipped = ctx_segments(sys_mono, mono_alignments,
                                        word_prons, sil_phone, N, P)
    phones = sorted(sys_mono.tm.get_phones())
    chain_tm, chain_tree = build_ctx_chain_system(
        feats, seg_windows, phones, N, P, max_leaves, min_gain)
    stats["tree_s"] = time.perf_counter() - t0
    stats.update(leaves=chain_tree.num_pdfs,
                 tids=chain_tm.num_transition_ids, segment_skipped=skipped)
    if callable(cfg):
        cfg = cfg(chain_tm.num_pdfs)
    dim = next(iter(feats.values())).shape[1]
    if cfg is None:
        cfg = ChainTdnnfConfig(feat_dim=dim, num_pdfs=chain_tm.num_pdfs,
                               hidden_dim=128, bottleneck_dim=32,
                               prefinal_dim=64, num_layers=5,
                               subsample_layer=3,
                               frame_subsampling_factor=3)
    sub = cfg.frame_subsampling_factor
    t0 = time.perf_counter()
    den_graph, tokens, window_den = ctx_den_graph(
        seg_windows, chain_tm, chain_tree, window_den)
    stats["den"] = den_arcs(den_graph, cfg.num_pdfs,
                            resolve_device(device)).slot_sizes()
    stats["den_s"] = time.perf_counter() - t0
    stats.update(tokens=len(tokens), window_den=window_den)
    t0 = time.perf_counter()
    chunks, num_graphs = ctx_chain_egs(feats, seg_windows, chain_tm,
                                       chain_tree, opts, sub, ivectors)
    stats["egs_s"] = time.perf_counter() - t0
    stats["chunks"] = len(chunks)
    cw = (opts.chunk_width // sub) * sub
    _log.info("chain-ctx training: %d chunks of %d frames, tolerance %s, "
              "%d context tokens", len(chunks), cw,
              (opts.left_tolerance, opts.right_tolerance), len(tokens))
    t0 = time.perf_counter()
    model, variables = _fit_chain(cfg, den_graph, chunks, num_graphs,
                                  opts, cw, dim, device=device, stats=stats,
                                  use_ivectors=ivectors is not None)
    stats["chain_s"] = time.perf_counter() - t0
    return model, variables, den_graph, chain_tm, chain_tree


def nnet_log_likes(model: ChainTdnnf, variables: dict,
                   feats: Dict[str, np.ndarray],
                   ivectors: Optional[Dict[str, np.ndarray]] = None,
                   device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Batched AM scores for decoding (pseudo-loglikes; chain models need
    no prior division): the utterances padded into one batch through the
    eval-mode model of `variables`, in float32 with TF32 off, on `device`
    (by default the device of `model`'s weights) -> each utterance's
    (ceil(T / sub), num_pdfs) scores."""
    dev = (next(model.parameters()).device if device is None
           else resolve_device(device))
    eval_model = chain_tdnnf_from_flax(model.cfg, variables, torch.float32,
                                       dev)
    utts = list(feats)
    lens = [feats[u].shape[0] for u in utts]
    batch = np.zeros((len(utts), max(lens), feats[utts[0]].shape[1]),
                     np.float32)
    for i, u in enumerate(utts):
        batch[i, :lens[i]] = feats[u]
    iv_b = (torch.from_numpy(np.stack([np.asarray(ivectors[u], np.float32)
                                       for u in utts])).to(dev)
            if ivectors is not None else None)
    with torch.inference_mode(), full_f32():
        out = eval_model.chain(torch.from_numpy(batch).to(dev),
                               iv_b).cpu().numpy()
    sub = model.cfg.frame_subsampling_factor
    return {u: out[i, : (lens[i] + sub - 1) // sub]
            for i, u in enumerate(utts)}


def e2e_chain_system(lang) -> Tuple[TransitionModel, object]:
    """The flat-start system over the lang's phones: the chain topology
    and a monophone tree with 2 pdfs a phone -> (chain_tm, chain_tree)."""
    phone_ids = sorted(lang.phones.values())
    chain_tree = monophone_context_dependency(
        phone_ids, {p: 2 for p in phone_ids})
    return (TransitionModel(HmmTopology.chain_topology(phone_ids),
                            chain_tree), chain_tree)


def e2e_chain_egs(lang, feats: Dict[str, np.ndarray],
                  transcripts: Dict[str, List[str]], chain_tm, chain_tree,
                  sub: int):
    """The denominator and examples of `train_chain_e2e` -> (den_graph,
    buckets): the den graph from the silence-padded transcripts' phone
    LM, and whole utterances bucketed by input length rounded down to a
    multiple of sub, {T_in: [(feats[:T_in], e2e numerator)]}, skipping
    those too short to traverse their transcript."""
    sil = lang.phones[lang.sil_phone]

    def phones_of(words: List[str]) -> List[int]:
        seq: List[int] = []
        for w in words:
            seq.extend(lang.phones[p] for p in lang.lexicon[w][0])
        return seq

    utts = [u for u in feats if u in transcripts and transcripts[u]]
    seqs = {u: phones_of(list(transcripts[u])) for u in utts}
    den_graph = make_denominator_graph(
        [[sil] + s + [sil] for s in seqs.values()], chain_tm, chain_tree)
    buckets: Dict[int, list] = {}
    for u in utts:
        f = np.asarray(feats[u])
        T_in = (f.shape[0] // sub) * sub
        if T_in == 0 or (T_in // sub) < len(seqs[u]):
            continue        # too short to traverse the transcript
        g = transcript_to_e2e_numerator(seqs[u], chain_tm, optional_sil=sil)
        buckets.setdefault(T_in, []).append((f[:T_in], g))
    if not buckets:
        raise ValueError("train_chain_e2e: no usable utterances")
    return den_graph, buckets


def train_chain_e2e(lang, feats: Dict[str, np.ndarray],
                    transcripts: Dict[str, List[str]],
                    cfg: Optional[ChainTdnnfConfig] = None,
                    opts: Optional[ChainTrainOptions] = None,
                    variables: Optional[dict] = None,
                    device: DeviceLike = None,
                    stats: Optional[dict] = None):
    """FLAT-START ('end2end') LF-MMI: no bootstrap GMM, no alignments
    (egs/wsj/s5 local/e2e recipes; chain-supervision.cc
    TrainingGraphToSupervisionE2e).  The numerator of each utterance is
    its whole transcript's graph with free phone durations and optional
    silences at every boundary (`transcript_to_e2e_numerator`); the
    denominator's phone LM comes from the silence-padded transcripts.
    Each epoch takes each length bucket in turn, shuffled by one
    `default_rng(opts.seed)`, in minibatches of min(minibatch_size, the
    bucket's size).  variables, device and stats as `_fit_chain` takes
    them; stats also receives the utterances and buckets.  Returns
    (model, variables, den_graph, chain_tm, chain_tree)."""
    if opts is None:
        opts = ChainTrainOptions()
    dev = resolve_device(device)
    chain_tm, chain_tree = e2e_chain_system(lang)
    dim = next(iter(feats.values())).shape[1]
    if cfg is None:
        cfg = ChainTdnnfConfig(feat_dim=dim, num_pdfs=chain_tm.num_pdfs,
                               hidden_dim=128, bottleneck_dim=32,
                               prefinal_dim=64, num_layers=5,
                               subsample_layer=3,
                               frame_subsampling_factor=3)
    den_graph, buckets = e2e_chain_egs(lang, feats, transcripts, chain_tm,
                                       chain_tree,
                                       cfg.frame_subsampling_factor)
    n_items = sum(len(v) for v in buckets.values())
    _log.info("chain-e2e training: %d utterances in %d length buckets",
              n_items, len(buckets))
    fit = _ChainFit(cfg, den_graph, opts, n_items, variables, dev, stats)
    fit.stats.update(utterances=n_items, buckets=len(buckets))
    rng_np = np.random.default_rng(opts.seed)
    for epoch in range(opts.num_epochs):
        for items in buckets.values():
            order = np.arange(len(items))
            rng_np.shuffle(order)
            mb = min(opts.minibatch_size, len(items))
            for i in range(0, len(order) - mb + 1, mb):
                idx = order[i:i + mb]
                fit.step(np.stack([items[j][0] for j in idx]),
                         [items[j][1] for j in idx])
        fit.end_epoch(epoch)
    model, variables = fit.finish()
    return model, variables, den_graph, chain_tm, chain_tree
