"""Port parity: the sequence-discriminative objectives
(kaldi_tpu_torch/nnet3/discriminative.py, MMI, MPFE and sMBR), the MPFE /
sMBR forward-backward of lat/functions.py, the lattice rescoring and
`train_discriminative` (nnet3/discriminative_train.py) against the JAX
package's, on the constructed lattices of tests/test_discriminative.py
and on a lattice of the JAX package's lattice decoder.

Tolerances: objectives and gradients within 1e-9 (float64 host
arithmetic in the same order); the rescored lattice equal; the trainer
(float32 forward and backward, a small xconfig model from JAX's initial
variables) per-epoch objectives within 1e-5 relative and parameters
within 1e-4 of their largest magnitude.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_discriminative import make_den_lattice
from test_hmm_gmm import mono_system

from kaldi_tpu.fstext import fst as jfst
from kaldi_tpu.lat import functions as jlat
from kaldi_tpu.nnet3 import discriminative as jdisc
from kaldi_tpu.nnet3 import discriminative_train as jtrain
from kaldi_tpu_torch.fstext import fst as tfst
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lat import functions as tlat
from kaldi_tpu_torch.nnet3 import discriminative as tdisc
from kaldi_tpu_torch.nnet3 import discriminative_train as ttrain


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


def port_tm(jtm):
    buf = io.BytesIO()
    jtm.write(buf, True)
    buf.seek(0)
    return TransitionModel.read(buf, True)


def decoder_lattice(jtm, T=9, seed=0):
    """The raw lattice of the JAX lattice decoder over a one-state loop of
    every transition-id (words on the first pdf class's arcs, random
    graph costs), on random loglikes, and a numerator alignment of the
    same length."""
    from kaldi_tpu.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    rng = np.random.default_rng(seed)
    g = jfst.VectorFst(jfst.TropicalWeight)
    g.add_state()
    g.set_start(0)
    for tid in range(1, jtm.num_transition_ids + 1):
        word = jtm.transition_id_to_phone(tid) \
            if jtm.transition_id_to_hmm_state(tid) == 0 else 0
        g.add_arc(0, jfst.Arc(tid, word, float(rng.uniform(0, 2)), 0))
    g.set_final(0, 0.0)
    ll = rng.normal(size=(T, jtm.num_pdfs)).astype(np.float32) * 2.0
    lat = LatticeFasterDecoder(g, LatticeFasterDecoderOptions(
        beam=8.0, lattice_beam=3.0)).decode(ll, jtm.id2pdf_id)
    ali = rng.integers(1, jtm.num_transition_ids + 1, T).tolist()
    return lat, ali


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX tm, port tm, JAX lattice, numerator alignment)."""
    _topo, _tree, jtm = mono_system()
    ptm = port_tm(jtm)
    sl1, sl2, sl3 = jtm.self_loop_of(1), jtm.self_loop_of(6), \
        jtm.self_loop_of(3)
    out = {
        "two_paths": (make_den_lattice(jtm, [sl1] * 6, [sl2] * 6, 0.5),
                      [sl1] * 6),
        "equal_cost": (make_den_lattice(jtm, [sl1] * 4, [sl2] * 4, 0.0),
                       [sl1] * 4),
        "perfect": (make_den_lattice(jtm, [sl3] * 5, [sl3] * 5), [sl3] * 5),
        "wrong_preferred": (make_den_lattice(jtm, [sl2] * 8, [sl1] * 8,
                                             0.3), [sl1] * 8),
    }
    out["decoder"] = decoder_lattice(jtm)
    assert out["decoder"][0].num_arcs() > 100
    return {k: (jtm, ptm, lat, ali) for k, (lat, ali) in out.items()}


CASES = ("two_paths", "equal_cost", "perfect", "wrong_preferred", "decoder")
SIL = {"none": (False, ()), "sil1": (False, (1,)), "one_class": (True, (1,))}


@pytest.mark.parametrize("sil", sorted(SIL))
@pytest.mark.parametrize("criterion", ["mmi", "mpfe", "smbr"])
@pytest.mark.parametrize("case", CASES)
def test_objf_and_grad_match_jax(cases, case, criterion, sil):
    jtm, ptm, lat, ali = cases[case]
    one, phones = SIL[sil]
    got = tdisc.compute_discriminative_objf_and_grad(
        tdisc.DiscriminativeOptions(criterion, 0.7, one, list(phones)), ptm,
        ali, convert(lat, tfst), ptm.num_pdfs)
    want = jdisc.compute_discriminative_objf_and_grad(
        jdisc.DiscriminativeOptions(criterion, 0.7, one, list(phones)), jtm,
        ali, lat, jtm.num_pdfs)
    assert abs(got[0] - want[0]) <= 1e-9
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)


@pytest.mark.parametrize("one_class", [False, True])
@pytest.mark.parametrize("criterion", ["mpfe", "smbr"])
@pytest.mark.parametrize("case", CASES)
def test_mpe_variants_match_jax(cases, case, criterion, one_class):
    jtm, ptm, lat, ali = cases[case]
    got = tlat.lattice_forward_backward_mpe_variants(
        ptm, [1], convert(lat, tfst), ali, criterion, one_class)
    want = jlat.lattice_forward_backward_mpe_variants(
        jtm, [1], lat, ali, criterion, one_class)
    assert abs(got[0] - want[0]) <= 1e-9
    assert len(got[1]) == len(want[1]) == len(ali)
    for g_row, w_row in zip(got[1], want[1]):
        assert [t for t, _ in g_row] == [t for t, _ in w_row]
        np.testing.assert_allclose([w for _, w in g_row],
                                   [w for _, w in w_row], rtol=0, atol=1e-9)


def test_mpe_variants_refusals_match_jax(cases):
    from kaldi_tpu.base.logging import KaldiTpuError as JErr
    from kaldi_tpu_torch.base.logging import KaldiTpuError
    jtm, ptm, lat, ali = cases["two_paths"]
    with pytest.raises(KaldiTpuError, match="bad criterion"):
        tlat.lattice_forward_backward_mpe_variants(
            ptm, [], convert(lat, tfst), ali, "mmi")
    # the alignment one frame short: the finals are not at its end
    with pytest.raises(KaldiTpuError, match="max_time"):
        tlat.lattice_forward_backward_mpe_variants(
            ptm, [], convert(lat, tfst), ali[:-1])
    with pytest.raises(JErr, match="max_time"):
        jlat.lattice_forward_backward_mpe_variants(jtm, [], lat, ali[:-1])


@pytest.mark.parametrize("case", CASES)
def test_rescore_lattice_acoustics_equal(cases, case):
    jtm, ptm, lat, ali = cases[case]
    rng = np.random.default_rng(3)
    ll = rng.normal(size=(len(ali) - 1, jtm.num_pdfs)).astype(np.float32)
    got = ttrain.rescore_lattice_acoustics(convert(lat, tfst), ptm, ll)
    want = jtrain.rescore_lattice_acoustics(lat, jtm, ll)
    assert got.start == want.start and got.finals == want.finals
    assert [[tuple(a) for a in arcs] for arcs in got.arcs] == \
        [[tuple(a) for a in arcs] for arcs in want.arcs]


XCONFIG = """
input dim=5 name=input
relu-batchnorm-layer name=tdnn1 dim=12 input=Append(-1,0,1)
output-layer name=output dim=$pdfs include-log-softmax=false
"""


@pytest.mark.parametrize("criterion", ["smbr", "mmi"])
def test_train_discriminative_matches_jax(cases, criterion):
    """Two utterances, 3 epochs: the JAX trainer over a flax xconfig model
    and the port's over the same model built from JAX's variables."""
    import jax
    import jax.numpy as jnp

    from kaldi_tpu.nnet3.xconfig import build_xconfig_model
    from kaldi_tpu_torch.nnet3.xconfig import (xconfig_from_flax,
                                               xconfig_to_flax)
    jtm, ptm, _, _ = cases["two_paths"]
    lats = {"a": cases["decoder"][2], "b": cases["wrong_preferred"][2]}
    alis = {"a": cases["decoder"][3], "b": cases["wrong_preferred"][3]}
    rng = np.random.default_rng(5)
    feats = {u: rng.normal(size=(len(alis[u]), 5)).astype(np.float32)
             for u in alis}
    text = XCONFIG.replace("$pdfs", str(jtm.num_pdfs))
    jmodel = build_xconfig_model(text, train=False)
    variables = jmodel.init(jax.random.PRNGKey(1),
                            {"input": jnp.zeros((1, 9, 5))})

    def apply_fn(p, f):
        vs = dict(variables)
        vs["params"] = p
        return jmodel.apply(vs, {"input": f})["output"]

    opts = dict(num_epochs=3, learning_rate=0.01, acoustic_scale=0.5,
                criterion=criterion)
    j_params, j_objfs = jtrain.train_discriminative(
        apply_fn, variables["params"], jtm, feats, alis, lats, jtm.num_pdfs,
        jtrain.DiscTrainOptions(**opts))
    np_vars = jax.tree.map(np.asarray, {"params": dict(variables["params"]),
                                        "batch_stats": dict(
                                            variables["batch_stats"])})
    model = xconfig_from_flax(text, np_vars, device="cpu")
    stats = {}
    _, t_objfs = ttrain.train_discriminative(
        lambda f: model({"input": f})["output"], ptm, feats, alis,
        {u: convert(lat, tfst) for u, lat in lats.items()}, ptm.num_pdfs,
        ttrain.DiscTrainOptions(**opts), params=dict(model.named_parameters()),
        device="cpu", stats=stats)
    assert len(t_objfs) == len(j_objfs) == 3
    for a, b in zip(t_objfs, j_objfs):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (t_objfs, j_objfs)
    assert stats["host_s"] > 0 and stats["forward_ms"] == []
    got = xconfig_to_flax(model)["params"]
    want = jax.tree.map(np.asarray, dict(j_params))

    def leaves(a, b, path=""):
        if hasattr(a, "keys"):
            assert set(a) == set(b), path
            for k in sorted(a):
                yield from leaves(a[k], b[k], f"{path}/{k}")
        else:
            yield path, np.asarray(a), np.asarray(b)
    pairs = list(leaves(got, want))
    largest = max(np.abs(b).max() for _, _, b in pairs)
    moved = 0.0
    for path, a, b in pairs:
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-4 * largest, path
    for path, a, b in leaves(got, np_vars["params"]):
        moved = max(moved, float(np.abs(a - b).max()))
    assert moved > 1e-3
    # the l2 sum reads the parameters only: BatchNorm's statistics stay
    stats_now = xconfig_to_flax(model)["batch_stats"]
    for path, a, b in leaves(stats_now, np_vars["batch_stats"]):
        np.testing.assert_array_equal(a, b)


def test_step_loss_reads_parameters_only():
    """-kappa * sum(ll * G) + l2 * sum(|p|^2) over the given tensors."""
    p = [torch.tensor([1.0, 2.0]), torch.tensor([[3.0]])]
    ll = torch.tensor([[1.0, -1.0]])
    g = torch.tensor([[0.5, 2.0]])
    loss = ttrain.step_loss(ll, g, p, 0.1, 0.01)
    assert float(loss) == pytest.approx(-0.1 * (0.5 - 2.0) + 0.01 * 14.0)
