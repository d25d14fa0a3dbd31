"""Port parity: the chain trainer of kaldi_tpu_torch (parallel/trainer.py,
parallel/optim.py, parallel/recovery.py) against the JAX package's, on
the CPU, at small sizes, from the JAX package's initial variables:
`make_sharded_train_step` plain and with backstitch under SGD and
clip+Adam (the objective within 1e-5 relative, every gradient leaf within
1e-4 of its own largest value, the new batch statistics, and under SGD
the new parameters); the optimizer transformations fed the same
gradients as optax's (within 1e-6); backstitch against its two manual
steps; the three DivergenceGuard cases of tests/test_divergence_guard.py;
and `train_chain_from_egs` / `train_xent_from_egs` for 2 steps against
the JAX package's objectives."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kaldi_tpu.chain.objective import ChainTrainingOptions as JOpts
from kaldi_tpu.chain.objective import chain_loss as jchain_loss
from kaldi_tpu.nnet3.models import ChainTdnnf as JModel
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.parallel import trainer as jtrainer
from kaldi_tpu.parallel.trainer import ChainTrainState as JState
from kaldi_tpu_torch.chain.graphs import DenominatorGraph, PackedGraph
from kaldi_tpu_torch.chain.objective import ChainTrainingOptions
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.parallel import optim
from kaldi_tpu_torch.parallel import trainer as ptrainer
from kaldi_tpu_torch.parallel.recovery import DivergenceGuard
from tests.test_backstitch import CFG, _setup

KW = dict(feat_dim=CFG.feat_dim, num_pdfs=CFG.num_pdfs,
          hidden_dim=CFG.hidden_dim, bottleneck_dim=CFG.bottleneck_dim,
          prefinal_dim=CFG.prefinal_dim, num_layers=CFG.num_layers,
          subsample_layer=CFG.subsample_layer,
          frame_subsampling_factor=CFG.frame_subsampling_factor)
LEAKY = 0.1


def to_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def port_inputs(state, den, batch):
    """The JAX setup's state, den graph and batch as the port takes them
    -> (model, port state without optimizer state, den, batch)."""
    variables = {"params": to_np(dict(state.params)),
                 "batch_stats": to_np(dict(state.batch_stats))}
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**KW), variables,
                                  device="cpu")
    model.train()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: b.detach().clone() for k, b in model.named_buffers()}
    g = den.graph
    pden = DenominatorGraph(PackedGraph(*(np.asarray(a) for a in (
        g.src, g.dst, g.pdf, g.log_prob, g.initial, g.final))))
    pbatch = {"feats": torch.from_numpy(np.array(batch["feats"])),
              "num_graphs": tuple(np.asarray(a)
                                  for a in batch["num_graphs"])}
    return model, params, stats, pden, pbatch


def flax_of(model, params, stats=None) -> dict:
    """Tensors by the model's names -> {"params", "batch_stats"} in flax's
    layout (the statistics the model's own when stats is None)."""
    st = ptrainer.ChainTrainState(
        params, stats if stats is not None else
        {k: b.clone() for k, b in model.named_buffers()}, None)
    return ptrainer.load_state(model, st)


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict) or hasattr(tree[k], "keys"):
            yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(tree[k], np.float64)


def assert_leaves_close(got: dict, want: dict, frac: float) -> None:
    """Each leaf within frac of the leaf's own largest |want| (an
    all-zero leaf exactly)."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for p in w:
        scale = float(np.abs(w[p]).max())
        err = float(np.abs(g[p] - w[p]).max())
        assert err <= frac * scale, (p, err, scale)


TXS = {"sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
       "clip_adam": (lambda: optax.chain(optax.clip_by_global_norm(2.0),
                                         optax.adam(1e-3)),
                     lambda: optim.chain(optim.clip_by_global_norm(2.0),
                                         optim.adam(1e-3)))}


@pytest.mark.parametrize("opt", list(TXS))
@pytest.mark.parametrize("backstitch", [0.0, 0.3])
def test_train_step_matches_jax(opt, backstitch):
    _m, _tx, state, den, batch = _setup()
    jtx, ptx = TXS[opt][0](), TXS[opt][1]()
    jmodel = JModel(CFG, train=True)
    state = JState(state.params, state.batch_stats,
                   jtx.init(state.params), 0)
    opts = ChainTrainingOptions(leaky_hmm_coefficient=LEAKY)
    model, params, stats, pden, pbatch = port_inputs(state, den, batch)
    j_new, j_met = jtrainer.make_sharded_train_step(
        jmodel, jtx, JOpts(leaky_hmm_coefficient=LEAKY), den, donate=False,
        backstitch_scale=backstitch)(state, batch)
    step = ptrainer.make_sharded_train_step(model, ptx, opts, pden,
                                            backstitch_scale=backstitch)
    p_new, p_met = step(ptrainer.ChainTrainState(
        params, stats, ptx.init(params), 0), pbatch)
    assert p_new.step == 1
    j_objf = float(j_met["objf"])
    assert abs(float(p_met["objf"]) - j_objf) <= 1e-5 * abs(j_objf)
    assert float(p_met["grad_norm"]) == pytest.approx(
        float(j_met["grad_norm"]), rel=1e-4)
    got = flax_of(model, p_new.params, p_new.batch_stats)
    np.testing.assert_allclose(
        np.concatenate([v.ravel() for _k, v in leaves(got["batch_stats"])]),
        np.concatenate([v.ravel() for _k, v in
                        leaves(to_np(j_new.batch_stats))]),
        rtol=1e-5, atol=1e-6)
    if opt == "sgd":
        # Adam's first move is g / (|g| + eps): its sign flips with a
        # rounding of a near-zero gradient, so Adam's moves are held in
        # test_transformations_match_optax, fed one gradient
        assert_leaves_close(got["params"], to_np(j_new.params), 1e-5)


def test_gradients_match_jax():
    """Every leaf's gradient of minus the objective, JAX's jax.grad
    against the port's value_and_grad, each within 1e-4 of its own
    largest value (the xent head's, all 0, exactly)."""
    _m, _tx, state, den, batch = _setup()
    jmodel = JModel(CFG, train=True)
    opts = JOpts(leaky_hmm_coefficient=LEAKY)

    def loss(params):
        (c, x), _ = jmodel.apply({"params": params,
                                  "batch_stats": state.batch_stats},
                                 batch["feats"], mutable=["batch_stats"])
        return -jchain_loss(opts, den, batch["num_graphs"], c, x)[0]
    j_grads = to_np(jax.grad(loss)(state.params))
    model, params, stats, pden, pbatch = port_inputs(state, den, batch)
    popts = ChainTrainingOptions(leaky_hmm_coefficient=LEAKY)
    from kaldi_tpu_torch.chain.objective import chain_loss

    def fn(outputs):
        objf, aux = chain_loss(popts, pden, pbatch["num_graphs"], *outputs)
        return -objf, aux
    _loss, _aux, _stats, grads = ptrainer.value_and_grad(
        model, params, stats, pbatch["feats"], fn)
    assert_leaves_close(flax_of(model, grads)["params"], j_grads, 1e-4)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "clip_adam",
                                  "clip_sgd_momentum"])
def test_transformations_match_optax(name):
    """Three updates of each transformation fed the same gradients (some
    large enough to clip) as optax's, and the parameters they move."""
    jtx, ptx = {
        "sgd": (optax.sgd(0.05), optim.sgd(0.05)),
        "sgd_momentum": (optax.sgd(0.05, momentum=0.9),
                         optim.sgd(0.05, momentum=0.9)),
        "clip_adam": (optax.chain(optax.clip_by_global_norm(2.0),
                                  optax.adam(1e-3)),
                      optim.chain(optim.clip_by_global_norm(2.0),
                                  optim.adam(1e-3))),
        "clip_sgd_momentum": (
            optax.chain(optax.clip_by_global_norm(1.0),
                        optax.sgd(0.1, momentum=0.5)),
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.sgd(0.1, momentum=0.5)))}[name]
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    for step in range(3):
        scale = 3.0 if step == 1 else 0.3
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        pu, ps = ptx.update({k: torch.from_numpy(v)
                             for k, v in grads.items()}, ps, pp)
        for k in shapes:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-6)
        jp = optax.apply_updates(jp, ju)
        pp = optim.apply_updates(pp, pu)
        for k in shapes:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def _port_setup(lr=0.1):
    _m, _tx, state, den, batch = _setup(lr)
    model, params, stats, pden, pbatch = port_inputs(state, den, batch)
    tx = optim.sgd(lr)
    return model, tx, ptrainer.ChainTrainState(params, stats, tx.init(params),
                                               0), pden, pbatch


def test_backstitch_matches_manual_two_step():
    lr, alpha = 0.1, 0.3
    model, tx, state, den, batch = _port_setup(lr)
    opts = ChainTrainingOptions(leaky_hmm_coefficient=LEAKY)
    new, _ = ptrainer.make_sharded_train_step(
        model, tx, opts, den, backstitch_scale=alpha)(state, batch)
    from kaldi_tpu_torch.chain.objective import chain_loss

    def grad(params):
        def fn(outputs):
            objf, aux = chain_loss(opts, den, batch["num_graphs"], *outputs)
            return -objf, aux
        return ptrainer.value_and_grad(model, params, state.batch_stats,
                                       batch["feats"], fn)[3]
    g1 = grad(state.params)
    mid = {k: p + alpha * lr * g1[k] for k, p in state.params.items()}
    g2 = grad(mid)
    for k, p in mid.items():
        np.testing.assert_allclose(new.params[k].numpy(),
                                   (p - (1 + alpha) * lr * g2[k]).numpy(),
                                   atol=1e-6)


def test_backstitch_zero_is_plain_sgd():
    model, tx, state, den, batch = _port_setup()
    opts = ChainTrainingOptions(leaky_hmm_coefficient=LEAKY)
    s1, _ = ptrainer.make_sharded_train_step(model, tx, opts, den)(state,
                                                                   batch)
    s2, _ = ptrainer.make_sharded_train_step(
        model, tx, opts, den, backstitch_scale=0.0)(state, batch)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k])


def test_mesh_raises_naming_the_roadmap():
    model, tx, _state, den, _batch = _port_setup()
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        ptrainer.make_sharded_train_step(model, tx, ChainTrainingOptions(),
                                         den, mesh=object())


# -- DivergenceGuard: the cases of tests/test_divergence_guard.py ----------

def _params_finite(state) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in state.params.values())


def _run(poison_step=None, n_steps=14, guard=None):
    model, tx, state, den, batch = _port_setup(lr=0.05)
    step_fn = ptrainer.make_sharded_train_step(
        model, tx, ChainTrainingOptions(leaky_hmm_coefficient=LEAKY), den)
    objfs = []
    for i in range(n_steps):
        b = dict(batch)
        if i == poison_step:
            b["feats"] = batch["feats"] * float("nan")
        if guard is not None:
            b["lr_scale"] = guard.lr_scale
        state, metrics = step_fn(state, b)
        objf = float(metrics["objf"])
        if guard is not None:
            state, ok = guard.observe(state, objf,
                                      float(metrics["grad_norm"]))
            if not ok:
                continue
        objfs.append(objf)
    return state, objfs


@pytest.mark.parametrize("to_host", [False, True])
def test_guard_healthy_training_untouched(to_host):
    guard = DivergenceGuard(snapshot_every=5, to_host=to_host)
    _state, objfs = _run(guard=guard)
    assert guard.rejects == 0 and guard.lr_scale == 1.0
    assert all(np.isfinite(objfs))
    _s, plain = _run()
    assert objfs == plain


@pytest.mark.parametrize("to_host", [False, True])
def test_guard_poisoned_batch_rolls_back_and_recovers(to_host):
    guard = DivergenceGuard(snapshot_every=2, collapse_tol=5.0,
                            to_host=to_host)
    state_ok, objfs_ok = _run(poison_step=6, guard=guard)
    assert guard.rejects >= 1
    assert _params_finite(state_ok)
    assert all(np.isfinite(objfs_ok))
    _state_ref, objfs_ref = _run()
    assert abs(objfs_ok[-1] - objfs_ref[-1]) < 2.0
    # the unguarded run is broken by the same batch
    state_bad, objfs_bad = _run(poison_step=6)
    assert not _params_finite(state_bad) or \
        not all(np.isfinite(objfs_bad[7:]))


def test_guard_too_many_rejects_raises():
    guard = DivergenceGuard(snapshot_every=1, max_rejects=3)
    model, tx, state, den, batch = _port_setup(lr=0.05)
    step_fn = ptrainer.make_sharded_train_step(
        model, tx, ChainTrainingOptions(leaky_hmm_coefficient=LEAKY), den)
    state, metrics = step_fn(state, dict(batch, lr_scale=1.0))
    state, ok = guard.observe(state, float(metrics["objf"]))
    assert ok
    with pytest.raises(RuntimeError, match="cannot recover"):
        for _ in range(10):
            state, _ok = guard.observe(state, float("nan"))


# -- the egs trainers from carried weights ---------------------------------

@pytest.fixture(scope="module")
def chain_egs(tmp_path_factory):
    """den.fst over a chain monophone system and 8 chain egs of 30 input
    frames (contexts 2 and 3) with exact numerators, written by the JAX
    package."""
    from kaldi_tpu.chain.supervision import (alignment_to_numerator_graph,
                                             make_denominator_graph)
    from kaldi_tpu.hmm.topology import HmmTopology
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.nnet3.egs import ChainExampleHolder, NnetChainExample
    from kaldi_tpu.tree import monophone_context_dependency
    from kaldi_tpu.util.table import TableWriter
    from kaldi_tpu_torch.chain.graphs import den_graph_to_fsts
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    d = tmp_path_factory.mktemp("trainer_egs")
    phones = list(range(1, 5))
    tree = monophone_context_dependency(phones, {p: 2 for p in phones})
    tm = TransitionModel(HmmTopology.chain_topology(phones), tree)
    rng = np.random.default_rng(2)
    seqs = [list(rng.integers(1, 5, size=6)) for _ in range(12)]
    den = make_denominator_graph(seqs, tm, tree)
    pden = DenominatorGraph(PackedGraph(*(np.asarray(a) for a in (
        den.graph.src, den.graph.dst, den.graph.pdf, den.graph.log_prob,
        den.graph.initial, den.graph.final))))
    den_fst, _norm = den_graph_to_fsts(pden)
    with open(d / "den.fst", "wb") as f:
        write_fst(f, den_fst)
    with TableWriter(ChainExampleHolder(), f"ark:{d}/egs.ark") as w:
        for i in range(8):
            ali = []
            while len(ali) < 30:
                ts = int(rng.integers(1, tm.num_transition_states + 1))
                fwd = next(tm.pair_to_transition_id(ts, j) for j in range(
                    tm.num_transition_indices(ts))
                    if not tm.is_self_loop(tm.pair_to_transition_id(ts, j)))
                ali += [fwd] + [tm.self_loop_of(ts)] * int(rng.integers(2, 6))
            w.write(f"e{i}", NnetChainExample(
                rng.normal(size=(35, 6)).astype(np.float32),
                alignment_to_numerator_graph(ali[:30], tm, 3), 2, 3))
    return d


def jax_variables(cfg_kw, T, seed=0):
    v = JModel(JCfg(**cfg_kw), train=True).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, T, cfg_kw["feat_dim"])))
    return {"params": to_np(dict(v["params"])),
            "batch_stats": to_np(dict(v["batch_stats"]))}


def test_train_chain_from_egs_two_steps_match_jax(chain_egs, tmp_path,
                                                  monkeypatch):
    d = chain_egs
    size = dict(hidden_dim=32, bottleneck_dim=16, num_layers=2)
    cfg_kw = dict(feat_dim=6, num_pdfs=8, prefinal_dim=16,
                  subsample_layer=1, frame_subsampling_factor=3, **size)
    monkeypatch.setattr(ptrainer, "chain_tdnnf_init",
                        lambda cfg, gen: jax_variables(cfg_kw, 30))
    args = dict(num_epochs=1, minibatch_size=4, learning_rate=1e-3, **size)
    j_steps, j_objf = jtrainer.train_chain_from_egs(
        str(d / "den.fst"), f"ark:{d}/egs.ark", str(tmp_path / "j.raw"),
        **args)
    stats = {}
    p_steps, p_objf = ptrainer.train_chain_from_egs(
        str(d / "den.fst"), f"ark:{d}/egs.ark", str(tmp_path / "p.raw"),
        device="cpu", stats=stats, **args)
    assert (p_steps, j_steps) == (2, 2)
    assert stats["rejects"] == 0 and len(stats["step_objf"]) == 2
    assert abs(p_objf - j_objf) <= 1e-4 * abs(j_objf), (p_objf, j_objf)
    from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3
    a, b = (read_raw_nnet3(str(tmp_path / n)) for n in ("p.raw", "j.raw"))
    assert list(a.components) == list(b.components)


def test_train_xent_from_egs_two_steps_match_jax(tmp_path, monkeypatch):
    from kaldi_tpu.nnet3.egs import ExampleHolder, NnetExample
    from kaldi_tpu.util.table import TableWriter
    rng = np.random.default_rng(4)
    with TableWriter(ExampleHolder(), f"ark:{tmp_path}/egs.ark") as w:
        for i in range(8):
            w.write(f"e{i}", NnetExample(
                rng.normal(size=(11, 5)).astype(np.float32),
                [[(int(rng.integers(0, 6)), 1.0)] for _ in range(8)], 1, 2))
    size = dict(hidden_dim=24, bottleneck_dim=8, num_layers=2)
    cfg_kw = dict(feat_dim=5, num_pdfs=6, prefinal_dim=12,
                  subsample_layer=10 ** 9, frame_subsampling_factor=1, **size)
    monkeypatch.setattr(ptrainer, "chain_tdnnf_init",
                        lambda cfg, gen: jax_variables(cfg_kw, 11))
    args = dict(num_epochs=1, minibatch_size=4, learning_rate=1e-3,
                num_pdfs=6, **size)
    j_steps, j_objf = jtrainer.train_xent_from_egs(
        f"ark:{tmp_path}/egs.ark", str(tmp_path / "j.raw"), **args)
    p_steps, p_objf = ptrainer.train_xent_from_egs(
        f"ark:{tmp_path}/egs.ark", str(tmp_path / "p.raw"), device="cpu",
        **args)
    assert (p_steps, j_steps) == (2, 2)
    assert abs(p_objf - j_objf) <= 1e-4 * abs(j_objf), (p_objf, j_objf)


# -- recompute_batch_stats against independent computations -----------------

RECOMPUTE_KW = dict(feat_dim=6, num_pdfs=8, hidden_dim=32, bottleneck_dim=16,
                    prefinal_dim=16, num_layers=3, subsample_layer=1,
                    frame_subsampling_factor=3)


def _recompute_batches(dtype):
    """Three minibatches of other sizes and lengths, so that a pooling
    that weighs batches instead of frames shows."""
    rng = np.random.default_rng(5)
    return [rng.normal(size=(b, t, 6)).astype(dtype)
            for b, t in ((4, 30), (3, 27), (2, 33))]


def _port_recompute(variables, dtype, batches):
    """The port's recompute_batch_stats over `batches`, the model in eval
    mode before (the function sets the training mode itself) -> (model,
    params, new statistics)."""
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**RECOMPUTE_KW),
                                  variables, dtype, "cpu")
    model.eval()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: b.detach().clone() for k, b in model.named_buffers()}
    got = ptrainer.recompute_batch_stats(
        model, params, stats, [torch.from_numpy(f) for f in batches])
    assert not model.training
    return model, params, got


def test_recompute_batch_stats_every_batchnorm_matches_float64():
    """Every BatchNorm's recomputed mean and variance against a plain
    float64 reference: a forward pass of another copy of the model in
    training mode, each BatchNorm's input recorded, then numpy's mean and
    variance over all the frames of all the batches (within 1e-6)."""
    from kaldi_tpu_torch.nnet3.components import BatchNorm
    variables = jax_variables(RECOMPUTE_KW, 30)
    batches = _recompute_batches(np.float64)
    _, _, got = _port_recompute(variables, torch.float64, batches)
    ref = chain_tdnnf_from_flax(ChainTdnnfConfig(**RECOMPUTE_KW), variables,
                                torch.float64, "cpu")
    ref.train()
    seen: dict = {}
    for name, m in ref.named_modules():
        if isinstance(m, BatchNorm):
            def record(x, name=name, forward=m.forward):
                seen.setdefault(name, []).append(
                    x.detach().reshape(-1, x.shape[-1]).numpy().copy())
                return forward(x)
            m.forward = record
    with torch.no_grad():
        for f in batches:
            ref(torch.from_numpy(f))
    # the input BatchNorm, one a TDNN-F layer, the prefinal layers'
    assert len(seen) >= 1 + RECOMPUTE_KW["num_layers"]
    assert {k[:-len(".mean")] for k in got if k.endswith(".mean")} == set(seen)
    for name, xs in seen.items():
        x = np.concatenate(xs)
        assert len(xs) == len(batches)
        mean, var = got[f"{name}.mean"].numpy(), got[f"{name}.var"].numpy()
        np.testing.assert_allclose(mean, x.mean(0), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(var, x.var(0), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert max(float(np.abs(got[f"{n}.mean"].numpy()).max())
               for n in seen) > 0.1


def test_recompute_batch_stats_matches_jax_models_batchnorm_inputs():
    """The same in float32 against the JAX model: each flax BatchNorm's
    input over the same batches in training mode (nn.intercept_methods),
    pooled over all frames in float64, in flax's layout: each variance
    within 1e-5 of its largest value, each mean within 1e-5 of the largest
    standard deviation (a mean may be ~0; float32 forward passes of two
    packages)."""
    import flax.linen as nn
    from kaldi_tpu.nnet3.components import BatchNorm as JBatchNorm
    variables = jax_variables(RECOMPUTE_KW, 30)
    batches = _recompute_batches(np.float32)
    model, params, got = _port_recompute(variables, torch.float32, batches)
    seen: dict = {}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JBatchNorm) and \
                context.method_name == "__call__":
            x = np.asarray(args[0], np.float64)
            seen.setdefault(context.module.scope.path, []).append(
                x.reshape(-1, x.shape[-1]))
        return next_fun(*args, **kwargs)

    jmodel = JModel(JCfg(**RECOMPUTE_KW), train=True)
    with nn.intercept_methods(intercept):
        for f in batches:
            jmodel.apply(variables, jnp.asarray(f), mutable=["batch_stats"])
    port = flax_of(model, params, got)["batch_stats"]
    assert len(seen) >= 1 + RECOMPUTE_KW["num_layers"]
    assert len(seen) == len(dict(leaves(port))) // 2
    for path, xs in seen.items():
        node = port
        for k in path:
            node = node[k]
        x = np.concatenate(xs)
        mean, var = x.mean(0), x.var(0)
        spread = float(np.sqrt(var.max()))
        assert np.abs(node["bn"]["mean"] - mean).max() <= 1e-5 * spread, path
        assert np.abs(node["bn"]["var"] - var).max() <= 1e-5 * var.max(), \
            path
