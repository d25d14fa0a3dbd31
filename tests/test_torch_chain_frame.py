"""Port parity: the frame-rate chain trainer (`make_chunks`, `train_chain`
of kaldi_tpu_torch/recipes/chain.py) from the JAX package's initial
variables, `union_graphs` and `lattice_to_tolerance_numerator`
(chain/supervision.py), and the training-time draws: dropout in the
ChainTdnnf (nnet3/models.py) and `spec_augment` (nnet3/components.py).

The JAX package draws its masks from its PRNG, the port from a
torch.Generator, so the draws are held by their structure (bounds, keep
rate, scaling, eval identity) and the arithmetic by feeding both
packages the same masks.

Tolerances: chunks, graphs and masked features equal; each step's
objective within 1e-4 relative (float32, other summation orders); the
trained parameters on average within 1e-6 and each within a quarter of
the learning rate (Adam turns a gradient at rounding noise, that of a
unit a ReLU and a BatchNorm silence, into a step of the learning rate's
size: 2.1e-4 of 2e-3 in one element here); the dropout forward within
1e-5 of flax's.
"""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from kaldi_tpu.chain import supervision as jsup
from kaldi_tpu.fstext import fst as jfst
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.nnet3 import components as jcomp
from kaldi_tpu.nnet3.models import ChainTdnnf as JModel
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.recipes import chain as jchain
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.chain import supervision as tsup
from kaldi_tpu_torch.fstext import fst as tfst
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.nnet3 import components as tcomp
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

PHONES = list(range(1, 7))
FIELDS = ("src", "dst", "pdf", "log_prob", "initial", "final")


def systems():
    """The same three-state monophone system in each package (as
    MonoSystem-like objects: a tm and a tree)."""
    jt = JTopo.three_state(PHONES, sil_phones=[1])
    jtree = jmono(PHONES, {p: jt.num_pdf_classes(p) for p in PHONES})
    tt = HmmTopology.three_state(PHONES, sil_phones=[1])
    ttree = monophone_context_dependency(
        PHONES, {p: tt.num_pdf_classes(p) for p in PHONES})
    return (types.SimpleNamespace(tm=JTm(jt, jtree), tree=jtree),
            types.SimpleNamespace(tm=TransitionModel(tt, ttree), tree=ttree))


def random_alignment(tm, topo_of, T, rng):
    """A left-to-right alignment of T frames over random phones."""
    ali = []
    while len(ali) < T:
        phone = int(rng.integers(1, 7))
        entry = topo_of(phone)
        for j in range(len(entry) - 1):
            ts = next(s for s in range(1, tm.num_transition_states + 1)
                      if tm.tuples[s - 1][:2] == (phone, j))
            idx = next(i for i, (k, _) in enumerate(entry[j].transitions)
                       if k != j)
            ali += [tm.self_loop_of(ts)] * int(rng.integers(0, 4))
            ali.append(tm.pair_to_transition_id(ts, idx))
    return ali[:T]


@pytest.fixture(scope="module")
def data():
    jsys, tsys = systems()
    rng = np.random.default_rng(0)
    jt = JTopo.three_state(PHONES, sil_phones=[1])
    feats, alis = {}, {}
    for i, T in enumerate((71, 95, 64, 88, 40)):
        u = f"utt{i}"
        feats[u] = rng.normal(size=(T + 2, 12)).astype(np.float32)
        alis[u] = random_alignment(jsys.tm, jt.topology_for_phone, T, rng)
    alis.pop("utt2")          # an utterance without an alignment
    return jsys, tsys, feats, alis


@pytest.mark.parametrize("cw", [30, 17, 200])
def test_make_chunks_equal(data, cw):
    _, _, feats, alis = data
    got = tchain.make_chunks(feats, alis, cw, 1)
    want = jchain.make_chunks(feats, alis, cw, 1)
    assert len(got) == len(want)
    for (gf, ga), (wf, wa) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        assert list(ga) == list(wa)
    if cw == 200:
        assert got == []


class _NumpySpy:
    """numpy whose `mean` keeps each list it averages: the JAX package's
    train_chain logs each epoch's mean of its step objectives."""

    def __init__(self):
        self.lists = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, a, *args, **kw):
        self.lists.append([float(x) for x in a])
        return np.mean(a, *args, **kw)


OPTS = dict(num_epochs=2, learning_rate=2e-3, final_learning_rate=1e-4,
            minibatch_size=3, chunk_width=30, orthonormal_interval=2)


def leaves(a, b, path=""):
    if hasattr(a, "keys"):
        assert set(a) == set(b), path
        for k in sorted(a):
            yield from leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def test_train_chain_matches_jax(data, monkeypatch):
    """The default config (5 TDNN-F layers of 128 at the frame rate), 2
    epochs of 2 steps from JAX's initial variables: each step's objective
    and the trained variables."""
    jsys, tsys, feats, alis = data
    spy = _NumpySpy()
    monkeypatch.setattr(jchain, "np", spy)
    _jmodel, j_vars, j_den = jchain.train_chain(
        jsys, feats, alis, opts=jchain.ChainTrainOptions(**OPTS))
    monkeypatch.undo()
    j_steps = [x for epoch in spy.lists for x in epoch]
    cfg = tchain.ChainTdnnfConfig(
        feat_dim=12, num_pdfs=tsys.tm.num_pdfs, hidden_dim=128,
        bottleneck_dim=32, prefinal_dim=64, num_layers=5, subsample_layer=3,
        frame_subsampling_factor=1)
    v = JModel(JCfg(**dataclasses.asdict(cfg)), train=True).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 30, 12)))
    init = jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                     "batch_stats": dict(v["batch_stats"])})
    stats = {}
    model, t_vars, t_den = tchain.train_chain(
        tsys, feats, alis, opts=tchain.ChainTrainOptions(**OPTS),
        variables=init, device="cpu", stats=stats)
    assert model.cfg == cfg
    # 4 utterances of 71, 95, 88, 40 frames: 2 + 3 + 2 + 1 chunks of 30
    assert stats["chunks"] == 8
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(t_den.graph, name),
                                      np.asarray(getattr(j_den.graph, name)))
    assert len(stats["step_objf"]) == len(j_steps) == 4
    for a, b in zip(stats["step_objf"], j_steps):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    assert stats["epoch_objf"] == pytest.approx(
        [np.mean(j_steps[:2]), np.mean(j_steps[2:])], rel=1e-4)
    j_vars = jax.tree.map(np.asarray, {k: dict(v) for k, v in
                                       j_vars.items()})
    diffs = []
    for group in ("params", "batch_stats"):
        for path, a, b in leaves(t_vars[group], j_vars[group]):
            assert a.shape == b.shape, path
            assert np.abs(a - b).max() <= OPTS["learning_rate"] / 4, path
            diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() <= 1e-6
    moved = max(float(np.abs(a - b).max()) for _, a, b in
                leaves(t_vars["params"], init["params"]))
    assert moved > 1e-3


def test_linear_schedule_is_optax():
    import optax
    want = optax.linear_schedule(1e-3, 1e-4, 7)
    got = tchain.linear_schedule(1e-3, 1e-4, 7)
    for c in range(10):
        assert got(c) == np.float32(want(c))


def test_train_chain_with_dropout_runs(data):
    """dropout=0.1: the masks come from the trainer's generator (one seed,
    one model), and the objective stays finite."""
    _, tsys, feats, alis = data
    cfg = ChainTdnnfConfig(feat_dim=12, num_pdfs=tsys.tm.num_pdfs,
                           hidden_dim=32, bottleneck_dim=8, prefinal_dim=16,
                           num_layers=3, subsample_layer=2,
                           frame_subsampling_factor=1, dropout=0.1)
    runs = []
    for _ in range(2):
        stats = {}
        _, v, _ = tchain.train_chain(tsys, feats, alis, cfg,
                                     tchain.ChainTrainOptions(**OPTS),
                                     device="cpu", stats=stats)
        runs.append((stats["step_objf"], v))
    assert np.isfinite(runs[0][0]).all() and runs[0][0] == runs[1][0]
    no_drop = {}
    tchain.train_chain(tsys, feats, alis,
                       dataclasses.replace(cfg, dropout=0.0),
                       tchain.ChainTrainOptions(**OPTS), device="cpu",
                       stats=no_drop)
    assert no_drop["step_objf"] != runs[0][0]


# ---- the supervision helpers ----------------------------------------------

def convert(lat, mod):
    out = mod.VectorFst(mod.LatticeWeight)
    out.add_states(lat.num_states)
    out.set_start(lat.start)
    for s, arcs in enumerate(lat.arcs):
        for a in arcs:
            out.add_arc(s, mod.Arc(a.ilabel, a.olabel, tuple(a.weight),
                                   a.nextstate))
        out.finals[s] = lat.finals[s]
    return out


def ali_lattice(alis, costs):
    """A lattice of alternative alignment paths (JAX VectorFst), one
    branch per (alignment, (graph, acoustic) cost of its first arc)."""
    lat = jfst.VectorFst(jfst.LatticeWeight)
    start = lat.add_state()
    lat.set_start(start)
    for ali, cost in zip(alis, costs):
        s = start
        for i, tid in enumerate(ali):
            ns = lat.add_state()
            lat.add_arc(s, jfst.Arc(tid, 7 if i == 0 else 0,
                                    cost if i == 0 else (0.0, 0.0), ns))
            s = ns
        lat.set_final(s, (0.0, 0.0))
    return lat


def test_union_graphs_equal(data):
    jsys, tsys, _, alis = data
    chain_j = JTm(JTopo.chain_topology(PHONES), jmono(PHONES, {
        p: 2 for p in PHONES}))
    chain_t = TransitionModel(HmmTopology.chain_topology(PHONES),
                              monophone_context_dependency(
                                  PHONES, {p: 2 for p in PHONES}))
    utts = sorted(alis)[:3]
    jg = [jsup.alignment_to_tolerance_numerator(alis[u], jsys.tm, chain_j)
          for u in utts]
    tg = [tsup.alignment_to_tolerance_numerator(alis[u], tsys.tm, chain_t)
          for u in utts]
    for weights in (None, [-0.5, -1.25, -2.0]):
        got = tsup.union_graphs(tg, weights)
        want = jsup.union_graphs(jg, weights)
        for name in FIELDS:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tsup.union_graphs(tg[:1]) is tg[0]


@pytest.mark.parametrize("costs", [
    [(1.0, 2.0), (0.5, 2.5), (3.0, 0.0), (0.2, 4.0)],
    # two branches of one segmentation at one cost: the first stays
    [(1.0, 1.0), (1.0, 1.0), (2.0, 0.0), (0.0, 9.0)]])
def test_lattice_to_tolerance_numerator_equal(data, costs):
    jsys, tsys, _, alis = data
    chain_j = JTm(JTopo.chain_topology(PHONES), jmono(PHONES, {
        p: 2 for p in PHONES}))
    chain_t = TransitionModel(HmmTopology.chain_topology(PHONES),
                              monophone_context_dependency(
                                  PHONES, {p: 2 for p in PHONES}))
    base = alis["utt0"][:45]
    # the second path: the same phone segments, other self-loop counts
    other = list(base)
    for i in range(1, len(other) - 1):
        if (jsys.tm.is_self_loop(other[i]) and other[i + 1] != other[i]
                and not jsys.tm.is_self_loop(other[i - 1])):
            other[i], other[i - 1] = other[i - 1], other[i]
            break
    paths = [base, other, alis["utt1"][:45], alis["utt3"][:45]]
    lat = ali_lattice(paths, costs)
    for sub, n_paths in ((3, 4), (1, 2)):
        got = tsup.lattice_to_tolerance_numerator(
            convert(lat, tfst), tsys.tm, chain_t, subsample=sub,
            num_paths=n_paths, acoustic_scale=0.5)
        want = jsup.lattice_to_tolerance_numerator(
            lat, jsys.tm, chain_j, subsample=sub, num_paths=n_paths,
            acoustic_scale=0.5)
        for name in FIELDS:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError, match="empty lattice"):
        empty = tfst.VectorFst(tfst.LatticeWeight)
        empty.set_start(empty.add_state())
        tsup.lattice_to_tolerance_numerator(empty, tsys.tm, chain_t)


# ---- dropout and SpecAugment ----------------------------------------------

DROP_CFG = dict(feat_dim=6, num_pdfs=10, hidden_dim=16, bottleneck_dim=4,
                prefinal_dim=8, num_layers=4, subsample_layer=2,
                frame_subsampling_factor=3, dropout=0.3)


def test_dropout_config_loads_from_a_jax_meta():
    jcfg = JCfg(**DROP_CFG)
    cfg = ChainTdnnfConfig(**dataclasses.asdict(jcfg))
    assert cfg.dropout == 0.3 and dataclasses.asdict(cfg) == \
        dataclasses.asdict(jcfg)


def test_jax_train_chain_step_cannot_draw_dropout():
    """The JAX package's train_chain applies its model with no "dropout"
    key (kaldi_tpu/recipes/chain.py:122): a config with dropout raises
    there, so the port's dropout runs have no JAX counterpart."""
    import flax
    model = JModel(JCfg(**DROP_CFG), train=True)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 24, 6)))
    with pytest.raises(flax.errors.InvalidRngError):
        model.apply(v, jnp.zeros((2, 24, 6)), mutable=["batch_stats"])


def test_dropout_forward_matches_flax_with_the_same_masks(monkeypatch):
    """Training mode, the same Bernoulli masks fed to flax's nn.Dropout and
    to the port's: outputs and batch statistics equal to flax's."""
    from flax.linen import stochastic
    cfg = JCfg(**DROP_CFG)
    v = JModel(cfg, train=True).init(jax.random.PRNGKey(2),
                                     jnp.zeros((2, 24, 6)))
    variables = jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                          "batch_stats": dict(
                                              v["batch_stats"])})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, 6)).astype(np.float32)
    # the second layer subsamples by 3
    shapes = [(2, 24, 16)] + [(2, 8, 16)] * 3
    masks = [rng.random(s) < 0.7 for s in shapes]
    fed = iter(masks)
    monkeypatch.setattr(stochastic, "random", types.SimpleNamespace(
        bernoulli=lambda key, p, shape: jnp.asarray(next(fed))))
    (j_chain, j_xent), upd = JModel(cfg, train=True).apply(
        v, jnp.asarray(x), mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    assert next(fed, None) is None
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**DROP_CFG), variables,
                                  device="cpu")
    model.train()
    model.dropout_gen = torch.Generator()
    fed = iter(masks)
    keeps = []

    def mask(shape, keep, gen):
        keeps.append(keep)
        m = next(fed)
        assert tuple(shape) == m.shape
        return torch.from_numpy(m)
    monkeypatch.setattr(tcomp, "dropout_mask", mask)
    import kaldi_tpu_torch.nnet3.models as tmodels
    assert tmodels.dropout is tcomp.dropout
    with torch.no_grad():
        t_chain, t_xent = model(torch.from_numpy(x))
    assert next(fed, None) is None and keeps == [pytest.approx(0.7)] * 4
    for a, b in ((t_chain, j_chain), (t_xent, j_xent)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    got_stats = dict(model.tdnnf[0].norm.flax()[1]["bn"])
    want_stats = upd["batch_stats"]["tdnnf1"]["BatchNorm_0"]["bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_stats[k], np.asarray(want_stats[k]),
                                   rtol=1e-5, atol=1e-6)


def test_dropout_structure_and_eval_identity():
    model = chain_tdnnf_from_flax(
        ChainTdnnfConfig(**DROP_CFG),
        jax.tree.map(np.asarray, dict(JModel(JCfg(**DROP_CFG), train=False)
                                      .init(jax.random.PRNGKey(2),
                                            jnp.zeros((1, 24, 6))))),
        device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 24, 6)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        model.train()
        from kaldi_tpu_torch.base.logging import KaldiTpuError
        with pytest.raises(KaldiTpuError, match="dropout_gen"):
            model(x)
        model.eval()
        model.dropout_gen = torch.Generator().manual_seed(0)
        again = model(x)            # eval mode: the identity, no draw
    for a, b in zip(ref, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert model.dropout_gen.initial_seed() == 0
    # the keep rate and the scaling of the function itself
    gen = torch.Generator().manual_seed(3)
    y = tcomp.dropout(torch.ones(400, 500), 0.1, gen)
    kept = y != 0
    rate = float(kept.float().mean())
    sigma = (0.9 * 0.1 / kept.numel()) ** 0.5
    assert abs(rate - 0.9) < 3 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))


def jax_draws(key, shape, w=10, nf=2, frac=0.1, nt=2):
    """The draws of kaldi_tpu's spec_augment under `key`, in its order."""
    B, T, D = shape
    keys = jax.random.split(key, 4)
    max_w = max(int(T * frac), 1)
    return (jax.random.randint(keys[0], (B, nf), 0, max(D - w, 1)),
            jax.random.randint(keys[1], (B, nf), 0, w + 1),
            jax.random.randint(keys[2], (B, nt), 0, max(T - max_w, 1)),
            jax.random.randint(keys[3], (B, nt), 0, max_w + 1))


@pytest.mark.parametrize("shape,kw", [((4, 50, 40), {}),
                                      ((3, 7, 8), dict(freq_mask_width=12,
                                                       time_mask_frac=0.5))])
def test_spec_augment_matches_jax_with_the_same_draws(shape, kw):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32) + 5.0
    key = jax.random.PRNGKey(9)
    want = np.asarray(jcomp.spec_augment(jnp.asarray(x), key, **kw))
    names = dict(freq_mask_width="w", time_mask_frac="frac")
    draws = jax_draws(key, shape, **{names[k]: v for k, v in kw.items()})
    got = tcomp.apply_spec_augment(torch.from_numpy(x),
                                   *(np.array(d) for d in draws))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8, 300, 40), (2, 5, 3)])
def test_spec_augment_draws_within_bounds(shape):
    B, T, D = shape
    gen = torch.Generator().manual_seed(1)
    f0, widths, t0, tw = tcomp.spec_augment_draws(shape, gen)
    max_w = max(int(T * 0.1), 1)
    assert f0.shape == widths.shape == (B, 2) and t0.shape == (B, 2)
    assert (f0 >= 0).all() and (f0 < max(D - 10, 1)).all()
    assert (widths >= 0).all() and (widths <= 10).all()
    assert (t0 >= 0).all() and (t0 < max(T - max_w, 1)).all()
    assert (tw >= 0).all() and (tw <= max_w).all()
    x = torch.ones(shape)
    y = tcomp.spec_augment(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(y, tcomp.apply_spec_augment(
        x, f0, widths, t0, tw))
    # what is zeroed is whole bands and spans: a row that is not masked
    # in time keeps each band that is not masked in frequency
    zero_cols = (y == 0).all(dim=1)
    zero_rows = (y == 0).all(dim=2)
    assert torch.equal((y == 0), zero_cols[:, None, :] | zero_rows[:, :, None])
