"""Chain training step and the trainers of the egs tools (port of
`kaldi_tpu/parallel/trainer.py`: `ChainTrainState`,
`make_chain_train_state`, `make_sharded_train_step`,
`train_chain_from_egs`, `train_xent_from_egs`).

The step is a function of its state, as the reference's jitted step is:
the model is a template that `torch.func.functional_call` runs over the
state's parameter and statistics tensors, so a step can be taken twice
from one state (backstitch) and a state can be snapshotted and restored
(parallel/recovery.py).  The optimizer is a transformation of
`parallel/optim.py` with optax's `init`/`update`.  max-param-change is
the reference's global gradient-norm clip.  Matrix products run in full
float32 (TF32 off), as the reference's float32 parameters do.

The reference's step shards over a device mesh; the port's runs on one
device, and a mesh waits for torch.distributed (ROADMAP item 11).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from kaldi_tpu_torch.chain.objective import ChainTrainingOptions, chain_loss
from kaldi_tpu_torch.device import DeviceLike, full_f32, resolve_device
from kaldi_tpu_torch.nnet3.models import (ChainTdnnf, ChainTdnnfConfig,
                                          chain_tdnnf_from_flax,
                                          chain_tdnnf_init,
                                          chain_tdnnf_to_flax)
from kaldi_tpu_torch.parallel import optim

Tensors = Dict[str, torch.Tensor]


@dataclass
class ChainTrainState:
    params: Tensors          # the model's parameters by name
    batch_stats: Tensors     # its BatchNorm statistics by name
    opt_state: Any
    step: int = 0


def _state_tensors(model: torch.nn.Module) -> Tuple[Tensors, Tensors]:
    """Copies of the model's parameters and statistics by name: the model
    stays a template that `load_state` may overwrite."""
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def make_chain_train_state(cfg: ChainTdnnfConfig, rng: torch.Generator,
                           learning_rate: float = 1e-3,
                           momentum: float = 0.0,
                           max_param_change: float = 2.0,
                           device: DeviceLike = None):
    """Initialize model + optimizer on `device` -> (state, model, tx).
    The weights are `chain_tdnnf_init`'s draws from `rng`; the optimizer
    clips the global gradient norm at max_param_change, then takes Adam
    steps (SGD with momentum when momentum is not 0)."""
    dev = resolve_device(device)
    model = chain_tdnnf_from_flax(cfg, chain_tdnnf_init(cfg, rng),
                                  torch.float32, dev)
    model.train()
    params, stats = _state_tensors(model)
    tx = optim.chain(
        optim.clip_by_global_norm(max_param_change),
        optim.sgd(learning_rate, momentum) if momentum
        else optim.adam(learning_rate))
    return ChainTrainState(params, stats, tx.init(params), 0), model, tx


def value_and_grad(model: torch.nn.Module, params: Tensors,
                   batch_stats: Tensors, feats: torch.Tensor,
                   loss_fn: Callable) -> Tuple:
    """The model in training mode over `params` and a copy of
    `batch_stats` (which the forward pass updates) on `feats`;
    loss_fn(outputs) -> (loss, aux).  Returns (loss, aux, the new
    statistics, the gradient of loss by parameter; zeros where the loss
    does not reach a parameter, as jax.grad gives)."""
    stats = {k: v.clone() for k, v in batch_stats.items()}
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(functional_call(model, {**leaves, **stats},
                                            (feats,)))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}, stats,
            grads)


def make_sharded_train_step(model: ChainTdnnf, tx, opts: ChainTrainingOptions,
                            den_graph, mesh=None,
                            backstitch_scale: float = 0.0) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch dict:
      feats          (B, T, D) tensor on the model's device
      num_graphs     the 6 stacked arrays of chain.graphs.batch_pack
      lr_scale       optional runtime LR multiplier (the divergence
                     guard's backoff)
      num_posteriors optional (B, T, P) targets of the xent head

    backstitch_scale (alpha > 0) enables backstitch SGD
    (nnet3/nnet-utils.h, Wang et al. 2017): first take a NEGATIVE step
    of size alpha*lr at the current point, then a (1+alpha)*lr step
    from there — two gradient evaluations per minibatch; the
    optimizer state is advanced only by the second (corrective) step
    so momentum/Adam statistics track the main direction.  The
    statistics are those of the second evaluation, from the state's."""
    if mesh is not None:
        raise NotImplementedError(
            "make_sharded_train_step: the port's step runs on one device; "
            "a mesh waits for torch.distributed (ROADMAP item 11)")

    def loss_fn(batch):
        def fn(outputs):
            chain_out, xent_out = outputs
            objf, aux = chain_loss(opts, den_graph, batch["num_graphs"],
                                   chain_out, xent_out,
                                   batch.get("num_posteriors"))
            return -objf, aux
        return fn

    def train_step(state: ChainTrainState, batch) -> Tuple[ChainTrainState,
                                                           Dict]:
        lr_scale = float(batch.get("lr_scale", 1.0))
        fn = loss_fn(batch)
        with full_f32():
            loss, aux, new_stats, grads = value_and_grad(
                model, state.params, state.batch_stats, batch["feats"], fn)
            with torch.no_grad():
                if backstitch_scale > 0:
                    upd1, _ = tx.update(grads, state.opt_state, state.params)
                    mid = optim.apply_updates(state.params, {
                        k: (-backstitch_scale * lr_scale) * u
                        for k, u in upd1.items()})
                    loss, aux, new_stats, grads = value_and_grad(
                        model, mid, state.batch_stats, batch["feats"], fn)
                    upd2, new_opt = tx.update(grads, state.opt_state, mid)
                    new_params = optim.apply_updates(mid, {
                        k: ((1 + backstitch_scale) * lr_scale) * u
                        for k, u in upd2.items()})
                else:
                    updates, new_opt = tx.update(grads, state.opt_state,
                                                 state.params)
                    new_params = optim.apply_updates(
                        state.params,
                        {k: lr_scale * u for k, u in updates.items()})
                metrics = {"objf": -loss, **aux,
                           "grad_norm": optim.global_norm(grads)}
        return ChainTrainState(new_params, new_stats, new_opt,
                               state.step + 1), metrics

    return train_step


def load_state(model: torch.nn.Module, state: ChainTrainState) -> dict:
    """Copy the state's tensors into the model -> its variables in flax's
    layout ({"params", "batch_stats"}, numpy)."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(state.params[k])
        for k, b in model.named_buffers():
            b.copy_(state.batch_stats[k])
    return chain_tdnnf_to_flax(model)


def recompute_batch_stats(model: torch.nn.Module, params: Tensors,
                          batch_stats: Tensors, batches) -> Tensors:
    """The BatchNorm statistics of the trained weights, as Kaldi's
    RecomputeStats (nnet-utils.h) sets them before a model is used in test
    mode: one pass over `batches` (feature tensors) with the model in
    training mode (each BatchNorm normalising by its minibatch's own
    statistics; the model's mode is restored after), each BatchNorm's
    mean and variance pooled over every frame it saw, in float64.
    Returns the new statistics by name."""
    from kaldi_tpu_torch.nnet3.components import BatchNorm
    sums: Dict[str, list] = {}

    def hook(name):
        def pre(_mod, args):
            x = args[0].detach().to(torch.float64)
            x = x.reshape(-1, x.shape[-1])
            acc = sums.setdefault(name, [0, 0.0, 0.0])
            acc[0] += x.shape[0]
            acc[1] = acc[1] + x.sum(0)
            acc[2] = acc[2] + (x * x).sum(0)
        return pre
    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    training = model.training
    model.train()
    try:
        with torch.no_grad(), full_f32():
            for feats in batches:
                functional_call(model, {**params, **{
                    k: v.clone() for k, v in batch_stats.items()}}, (feats,))
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    new = dict(batch_stats)
    for name, (n, s1, s2) in sums.items():
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        new[f"{name}.mean"] = mean.to(batch_stats[f"{name}.mean"].dtype)
        new[f"{name}.var"] = var.to(batch_stats[f"{name}.var"].dtype)
    return new


def _trimmed(batches, dev):
    """merged_minibatches' batches -> (feats on dev with the stored
    context trimmed, the batch).  The model pads its convs internally
    (SAME), so the extra acoustic context stored with each eg is trimmed
    to keep output frames aligned with the numerator graph."""
    for batch in batches:
        lc = int(batch.get("left_context", 0))
        rc = int(batch.get("right_context", 0))
        feats = np.asarray(batch["feats"])
        yield torch.from_numpy(np.ascontiguousarray(
            feats[:, lc:feats.shape[1] - rc if rc else None])).to(dev), batch


def _write_raw(model, variables: dict, model_out: str) -> None:
    from kaldi_tpu_torch.nnet3.mdl_io import (chain_tdnnf_to_nnet3,
                                              write_raw_nnet3)
    write_raw_nnet3(chain_tdnnf_to_nnet3(model, variables), model_out)


def train_chain_from_egs(den_fst_path: str, egs_rspecifier: str,
                         model_out: str, num_epochs: int = 4,
                         minibatch_size: int = 32,
                         learning_rate: float = 1e-3,
                         hidden_dim: int = 256,
                         bottleneck_dim: int = 64,
                         num_layers: int = 6,
                         xent_regularize: float = 0.1,
                         frame_subsampling_factor: int = 3,
                         seed: int = 0,
                         divergence_guard: bool = True,
                         device: DeviceLike = None,
                         stats: Optional[dict] = None) -> Tuple[int, float]:
    """nnet3-chain-train: train the native TDNN-F from prepared
    chain egs + a den.fst on `device`, write an exporter raw nnet (the
    reference's raw-nnet in/out contract,
    src/chainbin/nnet3-chain-train.cc).  divergence_guard enables
    snapshot/rollback + LR backoff on non-finite or collapsing
    objectives (parallel/recovery.py — the reference's
    get_successful_models / iteration-restart policy).  The raw's
    BatchNorm statistics are `recompute_batch_stats`' over the egs with
    the final weights; the JAX package writes its moving averages
    (momentum 0.99), which lag the weights (ROADMAP §3).
    Returns (num_steps, final_objf).  stats, when given, receives each
    accepted step's objective ("step_objf"), the guard's rejects, the
    recompute's seconds, and on CUDA each step's milliseconds by CUDA
    events ("step_ms") and the card's peak allocation
    ("peak_memory_gb")."""
    from kaldi_tpu_torch.chain.graphs import den_graph_from_fst_file
    from kaldi_tpu_torch.nnet3.egs import merged_minibatches
    dev = resolve_device(device)
    den_graph = den_graph_from_fst_file(den_fst_path)
    num_pdfs = int(den_graph.graph.pdf.max()) + 1
    state = model = step_fn = None
    opts = ChainTrainingOptions(xent_regularize=xent_regularize)
    n_steps, objf = 0, float("nan")
    guard = None
    if divergence_guard:
        from kaldi_tpu_torch.parallel.recovery import DivergenceGuard
        guard = DivergenceGuard()
    stats = {} if stats is None else stats
    stats.update(step_objf=[], step_ms=[])
    events = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    def batches():
        return _trimmed(merged_minibatches(egs_rspecifier, minibatch_size,
                                           drop_last=False), dev)

    for _epoch in range(num_epochs):
        for feats, batch in batches():
            if state is None:
                # the subsample point must fall INSIDE the stack or the
                # output stays at the input rate and never matches the
                # numerator graph (the config default of 8 assumes the
                # 17-layer flagship)
                cfg = ChainTdnnfConfig(
                    feat_dim=int(feats.shape[-1]),
                    num_pdfs=max(num_pdfs,
                                 int(batch["num_graphs"][2].max()) + 1),
                    hidden_dim=hidden_dim,
                    bottleneck_dim=bottleneck_dim,
                    prefinal_dim=max(hidden_dim // 2, bottleneck_dim),
                    num_layers=num_layers,
                    subsample_layer=min(8, max(1, num_layers // 2)),
                    frame_subsampling_factor=frame_subsampling_factor)
                state, model, tx = make_chain_train_state(
                    cfg, torch.Generator().manual_seed(seed),
                    learning_rate=learning_rate, device=dev)
                step_fn = make_sharded_train_step(model, tx, opts,
                                                  den_graph)
            step_batch = {"feats": feats, "num_graphs": batch["num_graphs"]}
            if guard is not None:
                step_batch["lr_scale"] = np.float32(guard.lr_scale)
            if dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            state, metrics = step_fn(state, step_batch)
            if dev.type == "cuda":
                ev[1].record()
                events.append(ev)
            objf = float(metrics["objf"])
            if guard is not None and n_steps > 0:
                state, ok = guard.observe(
                    state, objf, float(metrics["grad_norm"]))
                if not ok:
                    continue
            if n_steps == 0 and objf < -1e9:
                raise ValueError(
                    "train_chain_from_egs: numerator forward-backward "
                    "returned -inf on the first minibatch — the model's "
                    "output frame rate does not match the egs' "
                    "supervision (check frame-subsampling-factor / "
                    "chunk-width)")
            stats["step_objf"].append(objf)
            n_steps += 1
    if state is None:
        raise ValueError("train_chain_from_egs: no examples")
    stats["rejects"] = 0 if guard is None else guard.rejects
    if events:
        torch.cuda.synchronize(dev)
        stats["step_ms"] = [a.elapsed_time(b) for a, b in events]
        stats["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    state.batch_stats = recompute_batch_stats(
        model, state.params, state.batch_stats, (f for f, _ in batches()))
    stats["recompute_s"] = time.perf_counter() - t0
    _write_raw(model, load_state(model, state), model_out)
    return n_steps, objf


def train_xent_from_egs(egs_rspecifier: str, model_out: str,
                        num_epochs: int = 4, minibatch_size: int = 32,
                        learning_rate: float = 1e-3,
                        hidden_dim: int = 256,
                        bottleneck_dim: int = 64,
                        num_layers: int = 4,
                        num_pdfs: int = 0,
                        seed: int = 0,
                        device: DeviceLike = None) -> Tuple[int, float]:
    """nnet3-train: plain frame-level cross-entropy training from
    NnetExample egs on `device` (src/nnet3bin/nnet3-train.cc contract:
    egs in, raw nnet out).  The model is the native TDNN-F stack at
    frame rate 1; targets are the egs' sparse per-frame posteriors.  The
    raw's BatchNorm statistics are recomputed as train_chain_from_egs
    recomputes them."""
    from kaldi_tpu_torch.nnet3.egs import ExampleHolder
    from kaldi_tpu_torch.util.table import SequentialTableReader

    dev = resolve_device(device)
    egs = [eg for _k, eg in SequentialTableReader(ExampleHolder(),
                                                  egs_rspecifier)]
    if not egs:
        raise ValueError("train_xent_from_egs: no examples")
    if num_pdfs <= 0:
        num_pdfs = 1 + max((p for eg in egs for fr in eg.targets
                            for p, _w in fr), default=0)
    feat_dim = egs[0].feats.shape[1]
    # group egs by shape so each minibatch stacks cleanly
    by_shape: dict = {}
    for eg in egs:
        by_shape.setdefault((eg.feats.shape[0], len(eg.targets),
                             eg.left_context), []).append(eg)
    cfg = ChainTdnnfConfig(
        feat_dim=feat_dim, num_pdfs=num_pdfs, hidden_dim=hidden_dim,
        bottleneck_dim=bottleneck_dim,
        prefinal_dim=max(hidden_dim // 2, bottleneck_dim),
        num_layers=num_layers, subsample_layer=10 ** 9,
        frame_subsampling_factor=1)
    model = chain_tdnnf_from_flax(
        cfg, chain_tdnnf_init(cfg, torch.Generator().manual_seed(seed)),
        torch.float32, dev)
    model.train()
    params, batch_stats = _state_tensors(model)
    tx = optim.adam(learning_rate)
    opt_state = tx.init(params)

    n_steps, objf = 0, float("nan")
    rng_np = np.random.default_rng(seed)
    with full_f32():
        for _epoch in range(num_epochs):
            for shape_key in sorted(by_shape):
                group = by_shape[shape_key]
                order = rng_np.permutation(len(group))
                for i0 in range(0, len(group), minibatch_size):
                    mb = [group[j] for j in order[i0:i0 + minibatch_size]]
                    feats = torch.from_numpy(
                        np.stack([eg.feats for eg in mb])).to(dev)
                    lc, n_out = int(mb[0].left_context), len(mb[0].targets)
                    tgt = np.zeros((len(mb), n_out, num_pdfs), np.float32)
                    for b, eg in enumerate(mb):
                        for t, fr in enumerate(eg.targets):
                            for p, w in fr:
                                tgt[b, t, p] += w
                    tgt = torch.from_numpy(tgt).to(dev)

                    def ce_fn(outputs):
                        # the exported graph's output is the chain head:
                        # train it; context rows trimmed so output frames
                        # align with targets
                        logp = torch.log_softmax(outputs[0], dim=-1)
                        logp = logp[:, lc:lc + n_out]
                        return (-(tgt * logp).sum()
                                / torch.clamp_min(tgt.sum(), 1.0)), {}
                    ce, _aux, batch_stats, grads = value_and_grad(
                        model, params, batch_stats, feats, ce_fn)
                    with torch.no_grad():
                        updates, opt_state = tx.update(grads, opt_state,
                                                       params)
                        params = optim.apply_updates(params, updates)
                    objf = -float(ce)
                    n_steps += 1
    batch_stats = recompute_batch_stats(
        model, params, batch_stats,
        (torch.from_numpy(np.stack([eg.feats for eg in
                                    group[i0:i0 + minibatch_size]])).to(dev)
         for _k, group in sorted(by_shape.items())
         for i0 in range(0, len(group), minibatch_size)))
    state = ChainTrainState(params, batch_stats, opt_state, n_steps)
    _write_raw(model, load_state(model, state), model_out)
    return n_steps, objf
