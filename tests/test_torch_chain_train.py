"""Port parity: chain training of kaldi_tpu_torch against the JAX
package's, on the CPU, at small sizes: ChainTdnnf in training mode (4
layers, width 64: outputs, the new batch statistics and every
parameter's gradient against flax's within 1e-4 relative); the optimizer
and its schedule against optax's over 30 steps (within 1e-6); three
`_fit_chain` steps from the JAX package's initial variables with the
semi-orthogonal constraint running (each step's objective within 1e-4
relative, the parameters within 1e-4); `train_system` end to end on a
tiny bench corpus, and with ctx=True and with i-vector inputs; and the
saved weights read back by the JAX package's `load_params`."""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kaldi_tpu.chain import supervision as jsup
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.nnet3.components import constrain_orthonormal as j_constrain
from kaldi_tpu.nnet3.models import ChainTdnnf as JModel
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.recipes import chain as jchain
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.chain.objective import ChainTrainingOptions
from kaldi_tpu_torch.nnet3.components import constrain_orthonormal
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax,
                                          chain_tdnnf_to_flax)
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.recipes import mono as tmono
from kaldi_tpu_torch.recipes import train_bench

SMALL = dict(feat_dim=12, num_pdfs=14, hidden_dim=64, bottleneck_dim=16,
             prefinal_dim=32, num_layers=4, subsample_layer=2,
             frame_subsampling_factor=3)


def walk_pairs(a, b, path=""):
    """(path, a leaf, b leaf) over two nested dicts of equal keys."""
    if isinstance(a, dict) or hasattr(a, "keys"):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in sorted(a):
            yield from walk_pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def assert_trees_close(got, want, rtol, atol_frac=None, atol=None):
    for path, a, b in walk_pairs(got, want):
        assert a.shape == b.shape, path
        tol = atol if atol is not None else \
            atol_frac * max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=path)


def jax_init(cfg_kw, T, seed=0):
    v = JModel(JCfg(**cfg_kw), train=True).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, T, cfg_kw["feat_dim"])))
    return jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                     "batch_stats": dict(v["batch_stats"])})


@pytest.mark.parametrize("layers,sub", [(4, 2), (6, 3)])
def test_training_mode_matches_flax(layers, sub):
    """Outputs, updated batch statistics and the gradient of every
    parameter (the xent head's too) of one training-mode forward and
    backward pass."""
    kw = dict(SMALL, num_layers=layers, subsample_layer=sub)
    B, T = 3, 21
    variables = jax_init(kw, T, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T, kw["feat_dim"])).astype(np.float32)
    T_out = -(-T // 3)
    w_chain = rng.normal(size=(B, T_out, kw["num_pdfs"])).astype(np.float32)
    w_xent = rng.normal(size=(B, T_out, kw["num_pdfs"])).astype(np.float32)
    jm = JModel(JCfg(**kw), train=True)

    def loss_fn(params):
        (c, x), upd = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(feats), mutable=["batch_stats"])
        loss = jnp.sum(c * w_chain) + jnp.sum(x * w_xent)
        return loss, (c, x, upd["batch_stats"])
    (j_loss, (j_c, j_x, j_bs)), j_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**kw), variables,
                                  device="cpu")
    model.train()
    model.requires_grad_(True)
    c, x = model(torch.tensor(feats))
    loss = (c * torch.tensor(w_chain)).sum() + (x * torch.tensor(w_xent)).sum()
    loss.backward()
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(j_c),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(j_x),
                               rtol=1e-4, atol=1e-4)
    got = chain_tdnnf_to_flax(model)
    assert_trees_close(got["batch_stats"], jax.tree.map(np.asarray, j_bs),
                       rtol=1e-4, atol=1e-5)
    grad_model = copy.deepcopy(model)
    for p, q in zip(grad_model.parameters(), model.parameters()):
        p.data = q.grad.clone()
    assert_trees_close(chain_tdnnf_to_flax(grad_model)["params"],
                       jax.tree.map(np.asarray, j_grads), rtol=1e-4,
                       atol_frac=1e-4)


def test_constrain_orthonormal_matches():
    rng = np.random.default_rng(5)
    for shape in ((16, 128), (40, 24)):
        m = rng.normal(size=shape).astype(np.float32) * 0.3
        for scale in (1.0, -1.0):
            got = constrain_orthonormal(torch.tensor(m), scale).numpy()
            want = np.asarray(j_constrain(jnp.asarray(m), scale))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_optimizer_and_schedule_match_optax():
    """chain(clip_by_global_norm, adam(join_schedules(...))) on a toy
    tree over 30 steps, a parameter without gradient included, the
    gradients large enough that clipping triggers on some steps."""
    lr, final, total, warmup = 7e-4, 1e-4, 30, 10
    sched = optax.join_schedules(
        [optax.linear_schedule(lr * 0.1, lr, warmup),
         optax.linear_schedule(lr, final, max(total - warmup, 1))],
        [warmup])
    ours = tchain.lr_schedule(lr, final, warmup, total)
    for n in range(total + 3):
        assert float(ours(n)) == pytest.approx(float(sched(n)), rel=1e-6)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(sched))
    j_params = jax.tree.map(jnp.asarray, params)
    state = tx.init(j_params)
    t_params = [torch.tensor(params[k]) for k in sorted(shapes)]
    opt = tchain.ChainOptimizer(t_params, ours, 2.0)
    clipped = 0
    for step in range(total):
        scale = 3.0 if step % 3 == 0 else 0.2
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        grads["c"] = np.zeros(shapes["c"], np.float32)
        clipped += np.sqrt(sum((g * g).sum() for g in grads.values())) > 2.0
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.step([torch.tensor(grads["a"]), torch.tensor(grads["b"]), None])
        for k, t in zip(sorted(shapes), t_params):
            np.testing.assert_allclose(t.numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-6)
    assert 0 < clipped < total


def fit_inputs(cw=30, n_chunks=4, seed=0):
    """A den graph, n_chunks chunks of cw random feature frames with
    tolerance numerators, and the numbers `_fit_chain` takes."""
    phones = list(range(1, 7))
    topo = JTopo.three_state(phones, sil_phones=[1])
    tm = JTm(topo, jmono(phones, {p: topo.num_pdf_classes(p)
                                  for p in phones}))
    ctree = jmono(phones, {p: 2 for p in phones})
    ctm = JTm(JTopo.chain_topology(phones), ctree)
    rng = np.random.default_rng(seed)
    seqs = [list(rng.integers(1, 7, size=8)) for _ in range(20)]
    den = jsup.make_denominator_graph(seqs, ctm, ctree)
    chunks, nums = [], []
    for c in range(n_chunks):
        ali = []
        while len(ali) < cw:
            phone = int(rng.integers(1, 7))
            entry = topo.topology_for_phone(phone)
            for j in range(topo.num_pdf_classes(phone)):
                ts = next(s for s in range(1, tm.num_transition_states + 1)
                          if tm.tuples[s - 1][:2] == (phone, j))
                idx = next(i for i, (k, _) in enumerate(entry[j].transitions)
                           if k != j)
                ali += [tm.self_loop_of(ts)] * int(rng.integers(0, 3))
                ali.append(tm.pair_to_transition_id(ts, idx))
        ali = ali[:cw]
        nums.append(jsup.alignment_to_tolerance_numerator(ali, tm, ctm))
        feats = rng.normal(size=(cw, SMALL["feat_dim"])).astype(np.float32)
        chunks.append((feats, None, None))
    kw = dict(SMALL, num_pdfs=ctm.num_pdfs)
    return den, chunks, nums, kw


def test_fit_chain_three_steps_match_jax(monkeypatch):
    den, chunks, nums, kw = fit_inputs()
    opts_kw = dict(num_epochs=3, learning_rate=2e-3, final_learning_rate=1e-4,
                   minibatch_size=4, chunk_width=30, orthonormal_interval=2,
                   left_tolerance=5, right_tolerance=5)
    j_objf = []
    orig = jchain.log

    def log(msg):
        m = re.match(r"chain epoch \d+: objf/frame (\S+)", msg)
        if m:
            j_objf.append(float(m.group(1)))
        orig(msg)
    monkeypatch.setattr(jchain, "log", log)
    # one step an epoch, so each epoch's logged mean is that step's
    # objective (the JAX package logs it to 4 decimals)
    _, j_vars = jchain._fit_chain(
        JCfg(**kw), den, chunks, nums, jchain.ChainTrainOptions(
            chain=jchain.ChainTrainingOptions(
                l2_regularize=5e-5, leaky_hmm_coefficient=0.1,
                xent_regularize=0.1), **opts_kw), 30, kw["feat_dim"])
    init = jax_init(kw, 30, seed=0)
    stats = {}
    _, t_vars = tchain._fit_chain(
        ChainTdnnfConfig(**kw), den, chunks, nums, tchain.ChainTrainOptions(
            chain=ChainTrainingOptions(l2_regularize=5e-5,
                                       leaky_hmm_coefficient=0.1,
                                       xent_regularize=0.1), **opts_kw),
        30, kw["feat_dim"], variables=init, device="cpu", stats=stats)
    assert len(stats["step_objf"]) == len(j_objf) == 3
    for a, b in zip(stats["step_objf"], j_objf):
        assert abs(a - b) <= max(1e-4 * abs(b), 5e-5)
    j_vars = jax.tree.map(np.asarray, {k: dict(v) for k, v in
                                       j_vars.items()})
    assert_trees_close(t_vars["params"], j_vars["params"], rtol=1e-4,
                       atol=1e-4)
    assert_trees_close(t_vars["batch_stats"], j_vars["batch_stats"],
                       rtol=1e-4, atol=1e-4)
    # the parameters moved, and the constraint ran on the factors
    moved = [np.abs(a - b).max() for _, a, b in
             walk_pairs(t_vars["params"], init["params"])]
    assert max(moved) > 1e-3


TINY = dict(vocab=30, num_phone_groups=5, phones_per_group=2,
            words_per_utt=8, num_train=24, num_test=6, num_lm_sents=200,
            noise=850.0, f2_gap=120.0, seed=11)


def test_train_system_and_decode_end_to_end(tmp_path):
    """train_bench's path on the tiny corpus: one epoch of a 4-layer,
    width-64 TDNN-F, the weights saved and read back by the JAX
    package's load_params, the test set decoded."""
    spec = tbc.BenchCorpusSpec(**TINY)
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=2 * (spec.num_phones + 1),
                           hidden_dim=64, bottleneck_dim=16,
                           prefinal_dim=32, num_layers=4, subsample_layer=2,
                           frame_subsampling_factor=3)
    stats = {}
    meta = train_bench.train_and_decode(str(tmp_path), epochs=1,
                                        device="cpu", spec=spec, cfg=cfg,
                                        stats=stats)
    sysd = stats.pop("system")
    assert stats["aligner"] == tmono.NATIVE
    assert len(stats["mono_avg_loglikes"]) == 8
    # one epoch of minibatches of 32 chunks
    assert len(stats["step_objf"]) == stats["chunks"] // 32 >= 1
    assert np.isfinite(stats["step_objf"]).all()
    assert stats["decode"]["lanes_decoded"] == TINY["num_test"]
    assert np.isfinite(meta["wer"])
    assert meta["corpus_hash"] == jbc.corpus_fingerprint(
        jbc.BenchCorpusSpec(**TINY), sysd["lexicon"], sysd["test_txt"],
        sysd["test_wav"], sysd["lm_text"])
    assert set(sysd["alignments"]) == set(sysd["feats"])
    # the saved weights, through both packages' loaders
    path = os.path.join(tmp_path, "params.npz")
    for loaded in (jbc.load_params(path), tbc.load_params(path)):
        for p, a, b in walk_pairs(loaded, sysd["variables"]):
            want = b.astype(np.float16).astype(np.float32) \
                if b.dtype == np.float32 and b.size > 1024 else b
            np.testing.assert_array_equal(a, want, err_msg=p)


def test_train_system_trains_ctx_and_ivectors():
    """The calls the port refused before the --scale recipe came: the
    triphone system (ctx=True, the default small TDNN-F) and i-vector
    inputs over the monophone chain topology each train one epoch."""
    spec = tbc.BenchCorpusSpec(**TINY)
    opts = tchain.ChainTrainOptions(num_epochs=1, minibatch_size=16,
                                    chunk_width=150, left_tolerance=5,
                                    right_tolerance=5)
    stats = {}
    sysd = tbc.train_system(spec, chain_opts=opts, ctx=True, max_leaves=30,
                            min_gain=5.0, device="cpu", stats=stats)
    assert sysd["chain_tm"].num_pdfs == stats["leaves"] == 30
    assert sysd["ivector_extractor"] is None and sysd["ivectors"] is None
    assert np.isfinite(stats["step_objf"]).all() and stats["step_objf"]
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=32,
                           num_pdfs=2 * (spec.num_phones + 1), hidden_dim=32,
                           bottleneck_dim=8, prefinal_dim=16, num_layers=3,
                           subsample_layer=2, frame_subsampling_factor=3)
    stats = {}
    sysd = tbc.train_system(spec, cfg=cfg, chain_opts=opts, ivector_dim=32,
                            device="cpu", stats=stats)
    assert sysd["ivector_extractor"].R == 32
    assert {u: v.shape for u, v in sysd["ivectors"].items()} == {
        u: (32,) for u in sysd["feats"]}
    assert np.isfinite(stats["step_objf"]).all() and stats["step_objf"]
    assert sysd["variables"]["params"]["input_affine"]["kernel"].shape[0] \
        == 40 + 32
