"""What the JAX package's chain tool chain does that a Kaldi user might
not expect, shown on the JAX package and held in the port (ROADMAP §3):

  * an eg's stored context is trimmed in training (the model pads inside)
    but read by nnet3-chain-compute-prob (the exported graph clamps at
    the chunk's edges), so the two score chunk edges differently;
  * nnet3-chain-compute-prob takes an eg's frame count from its
    numerator's states less one, which for a flat-start (e2e) eg is not
    its frame count;
  * max-param-change is a clip of the global gradient norm;
  * the xent head is not trained: no tool feeds num_posteriors;
  * the first minibatch raises on an objective below -1e9;
  * merged_minibatches yields the leftover groups in the order their
    shapes first appeared;

and a fault of the JAX package that the port repairs: the trainers write
their BatchNorm moving averages, which lag the weights; the port writes
the statistics of the final weights (Kaldi's RecomputeStats)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kaldi_tpu.nnet3.models import ChainTdnnf as JModel
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.nnet3 import egs as jegs
from kaldi_tpu.parallel import trainer as jtrainer
from kaldi_tpu_torch.nnet3 import egs as pegs
from kaldi_tpu_torch.parallel import trainer as ptrainer
from tests.test_backstitch import _setup
from tests.test_torch_trainer import chain_egs  # noqa: F401 (the fixture)

CFG = dict(feat_dim=6, num_pdfs=8, hidden_dim=32, bottleneck_dim=16,
           prefinal_dim=16, num_layers=6, subsample_layer=3,
           frame_subsampling_factor=3)


def test_compute_prob_reads_context_training_trims(tmp_path):
    """The exported graph over an eg's stored context, trimmed and
    subsampled as nnet3-chain-compute-prob does, against the training
    model over the trimmed chunk: equal away from the chunk's edges,
    different at them, in both packages."""
    from kaldi_tpu.nnet3.mdl_io import chain_tdnnf_to_nnet3 as jexport
    from kaldi_tpu.nnet3.mdl_io import write_raw_nnet3 as jwrite
    from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3
    from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                              chain_tdnnf_from_flax)
    model = JModel(JCfg(**CFG), train=False)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 60, 6)))
    lc = rc = 6
    x = np.random.default_rng(0).normal(size=(150 + lc + rc, 6)) \
        .astype(np.float32)
    trained_view = np.asarray(model.apply(v, jnp.asarray(x[None, lc:-rc]))
                              [0][0])
    graph = jexport(model, v)
    diag = graph.forward(x)[lc:-rc][::3]
    err = np.abs(diag - trained_view).max(axis=1)
    assert err[15:-15].max() < 1e-4
    assert err[0] > 1e-2 and err[-1] > 1e-2
    # the port: its model and its reading of the same graph
    jwrite(graph, str(tmp_path / "m.raw"))
    pdiag = read_raw_nnet3(str(tmp_path / "m.raw")).forward(x)[lc:-rc][::3]
    vars_np = jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                        "batch_stats": dict(v["batch_stats"])})
    pmodel = chain_tdnnf_from_flax(ChainTdnnfConfig(**CFG), vars_np,
                                   device="cpu")
    with torch.no_grad():
        pview = pmodel.chain(torch.from_numpy(x[None, lc:-rc]))[0].numpy()
    perr = np.abs(pdiag - pview).max(axis=1)
    assert perr[15:-15].max() < 1e-4
    assert perr[0] > 1e-2 and perr[-1] > 1e-2


def test_e2e_frame_count_is_numerator_states_less_one():
    """A flat-start numerator has a state a phone (and one a boundary
    with optional silence), not a frame: compute-prob's T_sup is not the
    eg's output frame count."""
    from kaldi_tpu.chain.supervision import transcript_to_e2e_numerator as j
    from kaldi_tpu.hmm.topology import HmmTopology
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.tree import monophone_context_dependency
    from kaldi_tpu_torch.chain.supervision import \
        transcript_to_e2e_numerator as p
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel as PTm
    phones = [1, 2, 3]
    tm = TransitionModel(HmmTopology.chain_topology(phones),
                         monophone_context_dependency(
                             phones, {q: 2 for q in phones}))
    import io
    buf = io.BytesIO()
    tm.write(buf, True)
    buf.seek(0)
    ptm = PTm.read(buf, True)
    for sil in (None, 1):
        jg, pg = j([2, 3, 2], tm, sil), p([2, 3, 2], ptm, sil)
        for f in ("src", "dst", "pdf", "log_prob", "initial", "final"):
            np.testing.assert_array_equal(getattr(pg, f), getattr(jg, f))
        # 3 phones: 4 states, or 8 with the boundary silences, whatever
        # the utterance's length
        assert jg.num_states - 1 == (3 if sil is None else 7)


def test_max_param_change_is_a_global_norm_clip():
    """make_chain_train_state's max_param_change scales the whole
    gradient to that norm (SGD with momentum: the first update is -lr
    times the clipped gradient), in both packages."""
    lr, max_change = 0.1, 2.0
    state, _m, tx = jtrainer.make_chain_train_state(
        JCfg(**CFG), jax.random.PRNGKey(0), learning_rate=lr,
        momentum=0.5, max_param_change=max_change, example_T=12)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 3.0), state.params)
    upd, _ = tx.update(grads, state.opt_state, state.params)
    assert float(optax.global_norm(upd)) == pytest.approx(lr * max_change,
                                                          rel=1e-5)
    # every element moved by the same amount: one scale for the whole
    vals = np.concatenate([np.asarray(u).ravel()
                           for u in jax.tree.leaves(upd)])
    assert np.ptp(vals) < 1e-9
    from kaldi_tpu_torch.nnet3.models import ChainTdnnfConfig
    from kaldi_tpu_torch.parallel import optim
    pstate, _pm, ptx = ptrainer.make_chain_train_state(
        ChainTdnnfConfig(**CFG), torch.Generator().manual_seed(0),
        learning_rate=lr, momentum=0.5, max_param_change=max_change,
        device="cpu")
    pupd, _ = ptx.update({k: torch.full_like(p, 3.0)
                          for k, p in pstate.params.items()},
                         pstate.opt_state, pstate.params)
    assert float(optim.global_norm(pupd)) == pytest.approx(lr * max_change,
                                                           rel=1e-5)


def test_xent_head_is_not_trained():
    """The step with xent_regularize=0.1 and no num_posteriors: no xent
    term, and the xent head's gradient is 0, in both packages."""
    from kaldi_tpu.chain.objective import ChainTrainingOptions as JOpts
    from kaldi_tpu_torch.chain.objective import ChainTrainingOptions
    from tests.test_torch_trainer import CFG as BCFG, port_inputs
    _m, _tx, state, den, batch = _setup()
    tx = optax.sgd(0.1)
    state = jtrainer.ChainTrainState(state.params, state.batch_stats,
                                     tx.init(state.params), 0)
    new, met = jtrainer.make_sharded_train_step(
        JModel(BCFG, train=True), tx, JOpts(xent_regularize=0.1), den,
        donate=False)(state, batch)
    assert "xent" not in met
    for a, b in zip(jax.tree.leaves(state.params["output_xent_affine"]),
                    jax.tree.leaves(new.params["output_xent_affine"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model, params, stats, pden, pbatch = port_inputs(state, den, batch)
    from kaldi_tpu_torch.parallel import optim
    ptx = optim.sgd(0.1)
    pnew, pmet = ptrainer.make_sharded_train_step(
        model, ptx, ChainTrainingOptions(xent_regularize=0.1), pden)(
        ptrainer.ChainTrainState(params, stats, ptx.init(params)), pbatch)
    assert "xent" not in pmet
    for k in params:
        if k.startswith("output_xent_affine") or \
                k.startswith("prefinal_xent"):
            assert torch.equal(pnew.params[k], params[k]), k


def test_first_minibatch_raises_on_a_rate_mismatch(chain_egs,  # noqa: F811
                                                   tmp_path):
    """Egs cut for subsampling 3 trained at subsampling 1: the numerator
    cannot cover the model's frames, and both trainers raise on the
    first minibatch."""
    d = chain_egs
    args = dict(num_epochs=1, minibatch_size=4, hidden_dim=16,
                bottleneck_dim=8, num_layers=2, frame_subsampling_factor=1)
    with pytest.raises(ValueError, match="first minibatch"):
        jtrainer.train_chain_from_egs(str(d / "den.fst"), f"ark:{d}/egs.ark",
                                      str(tmp_path / "j.raw"), **args)
    with pytest.raises(ValueError, match="first minibatch"):
        ptrainer.train_chain_from_egs(str(d / "den.fst"), f"ark:{d}/egs.ark",
                                      str(tmp_path / "p.raw"), device="cpu",
                                      **args)


def test_leftover_groups_in_first_seen_order(tmp_path):
    """Shapes seen in the order B, A, C with minibatches of 2: the full
    group of A first, then the leftovers of B, A and C as B, A, C."""
    from tests.test_torch_egs import graph
    from kaldi_tpu_torch.chain.graphs import PackedGraph
    from kaldi_tpu_torch.util.table import TableWriter
    rng = np.random.default_rng(0)
    lengths = [12, 10, 10, 14, 10]          # B, A, A, C, A
    with TableWriter(pegs.ChainExampleHolder(), f"ark:{tmp_path}/e.ark") as w:
        for i, T in enumerate(lengths):
            w.write(f"e{i}", pegs.NnetChainExample(
                rng.normal(size=(T, 2)).astype(np.float32),
                graph(rng, PackedGraph, S=4, A=5), 0, 0))
    for mod in (jegs, pegs):
        got = [b["feats"].shape[:2] for b in mod.merged_minibatches(
            f"ark:{tmp_path}/e.ark", 2, drop_last=False)]
        assert got == [(2, 10), (1, 12), (1, 10), (1, 14)], mod.__name__


def test_jax_trainer_writes_moving_averages(chain_egs, tmp_path,  # noqa: F811
                                            monkeypatch):
    """A reference fault the port repairs: the JAX trainer's raw holds its
    BatchNorm moving averages (momentum 0.99), which after 2 steps from
    the initial statistics (mean 0, variance 1) are still 98% the initial
    values: the input BatchNorm's mean is 0.0199 of the batches'.  The
    port's raw holds the statistics of the final weights over the egs
    (recompute_batch_stats, Kaldi's RecomputeStats)."""
    from kaldi_tpu.nnet3.mdl_io import read_raw_nnet3 as jread
    from tests.test_torch_trainer import jax_variables
    d = chain_egs
    size = dict(hidden_dim=32, bottleneck_dim=16, num_layers=2)
    cfg_kw = dict(feat_dim=6, num_pdfs=8, prefinal_dim=16,
                  subsample_layer=1, frame_subsampling_factor=3, **size)
    monkeypatch.setattr(ptrainer, "chain_tdnnf_init",
                        lambda cfg, gen: jax_variables(cfg_kw, 30))
    args = dict(num_epochs=1, minibatch_size=4, **size)
    jtrainer.train_chain_from_egs(str(d / "den.fst"), f"ark:{d}/egs.ark",
                                  str(tmp_path / "j.raw"), **args)
    ptrainer.train_chain_from_egs(str(d / "den.fst"), f"ark:{d}/egs.ark",
                                  str(tmp_path / "p.raw"), device="cpu",
                                  **args)
    j, p = (jread(str(tmp_path / f"{n}.raw")).components["input.batchnorm"]
            .fields for n in ("j", "p"))
    j_mean, p_mean = (np.asarray(f["StatsMean"]) for f in (j, p))
    j_var, p_var = (np.asarray(f["StatsVar"]) for f in (j, p))
    assert p_mean.mean() > 0.1          # a ReLU's output: positive
    np.testing.assert_allclose(j_mean, 0.0199 * p_mean, rtol=0.3,
                               atol=1e-3 * p_mean.max())
    assert np.all(j_var >= 0.98) and np.all(j_var <= 0.9801 + 0.03 * p_var
                                            + 1e-3)
