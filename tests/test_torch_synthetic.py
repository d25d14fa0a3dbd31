"""Port parity: the synthetic demo recipe (`recipes/synthetic_run.py`, a
port of egs/synthetic/run.py) against the JAX package, on the CPU.

- its corpus synthesizer is a copy of tests/test_mono_e2e.py's: the same
  texts and the same samples from the same seeds;
- stage 6's `[::3]`: the exported chain .mdl's network is evaluated at
  every input frame by nnet3-compute in both packages (the same rows), so
  one subsampling by 3 gives the chain model's output rate;
- the reference fault of stage 6 (ROADMAP.md §3): the reference's
  latgen-faster-mapped determinizes without pruning, and on the chain
  model's lattices (tests/data/synthetic_chain_raw.lat: one of the
  recipe's, 415 states, 699 arcs) the subset construction passes any
  state limit; the pruned determinization keeps the best path;
- stages 0-7 through the port's tools on the CPU from the reference
  recipe's initial chain weights (tests/data/synthetic_chain_init.npz;
  about 10 s): the GMM stage at the JAX recipe's 0%, the chain stages'
  word errors within 1 of tools/mmi_synthetic_jax_bar.py's (the port
  reads 0, 0 and 4 errors, on the CPU and on an H100 alike, where JAX
  reads 0, 1 and 4), and the pruned determinization of stage 6's raw
  lattices at the recipe's lattice beam keeping each best path."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_mono_e2e import make_corpus as jax_corpus  # noqa: E402
from test_mono_e2e import unigram_g as jax_unigram  # noqa: E402

from kaldi_tpu.cli import get_tool as jtool  # noqa: E402
from kaldi_tpu_torch.cli import get_tool as ttool  # noqa: E402
from kaldi_tpu_torch.recipes import synthetic_run  # noqa: E402
from kaldi_tpu_torch.util.table import SequentialTableReader  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# tools/mmi_synthetic_jax_bar.py: the JAX recipe's word errors of 16
SYNTHETIC_JAX_ERRORS = dict(gmm=0, chain=1, online=4)


@pytest.mark.parametrize("sizes", [(10, 4), (12, 4), (3, 2)])
def test_corpus_is_the_reference_tests(sizes):
    got = synthetic_run.make_corpus(*sizes)
    want = jax_corpus(*sizes)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                assert np.array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def test_unigram_g_is_the_reference_tests():
    from kaldi_tpu.decoder.graph import Lang as JLang
    from kaldi_tpu_torch.decoder.graph import Lang
    lex = {"YES": [["Y"]], "NO": [["N"]]}
    got = synthetic_run.unigram_g(Lang(lex, sil_phone="SIL"))
    want = jax_unigram(JLang(lex, sil_phone="SIL"))
    assert (got.start, got.num_states) == (want.start, want.num_states)
    assert [(a.ilabel, a.olabel, float(a.weight), a.nextstate)
            for a in got.arcs[0]] == \
        [(a.ilabel, a.olabel, float(a.weight), a.nextstate)
         for a in want.arcs[0]]


def test_nnet3_compute_rows_are_the_input_frames(tmp_path):
    """The recipe's chain TDNN-F (frame subsampling 3) exported as a
    .mdl: both packages' nnet3-compute give one row an input frame (the
    same rows within 1e-4), so the recipe's [::3] subsamples once."""
    import torch

    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.nnet3 import mdl_io as PM
    from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                              chain_tdnnf_from_flax,
                                              chain_tdnnf_init)
    from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
    from kaldi_tpu_torch.util.table import TableWriter
    cfg = ChainTdnnfConfig(feat_dim=13, num_pdfs=6, hidden_dim=64,
                           bottleneck_dim=16, prefinal_dim=32, num_layers=4,
                           subsample_layer=2, frame_subsampling_factor=3)
    model = chain_tdnnf_from_flax(cfg, chain_tdnnf_init(
        cfg, torch.Generator().manual_seed(0)), device="cpu")
    topo = HmmTopology.chain_topology([1, 2, 3])
    tm = TransitionModel(topo, monophone_context_dependency(
        [1, 2, 3], {p: topo.num_pdf_classes(p) for p in (1, 2, 3)}))
    PM.write_nnet3_am(str(tmp_path / "final.mdl"), tm,
                      PM.chain_tdnnf_to_nnet3(model), left_context=9,
                      right_context=9)
    rng = np.random.default_rng(0)
    lens = (76, 91, 60)
    with TableWriter("matrix", f"ark:{tmp_path}/feats.ark") as w:
        for i, T in enumerate(lens):
            w.write(f"u{i}", rng.normal(size=(T, 13)).astype(np.float32))
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    for side, get, extra in (("torch", ttool, ["--use-gpu=no"]),
                             ("jax", jtool, [])):
        with contextlib.redirect_stdout(out):
            assert get("nnet3-compute")(
                ["nnet3-compute", *extra, str(tmp_path / "final.mdl"),
                 f"ark:{tmp_path}/feats.ark",
                 f"ark:{tmp_path}/{side}.ark"]) == 0
    got, want = (dict(SequentialTableReader("matrix", f"ark:{tmp_path}/{s}"
                                            ".ark")) for s in ("torch", "jax"))
    for i, T in enumerate(lens):
        assert got[f"u{i}"].shape == want[f"u{i}"].shape == (T, 6)
        np.testing.assert_allclose(got[f"u{i}"], want[f"u{i}"], atol=1e-4,
                                   rtol=0)


def test_reference_unpruned_determinization_blows_up():
    from kaldi_tpu.fstext.ops import determinize_star, invert
    from kaldi_tpu.lat.kaldi_lattice import LatticeHolder as JHolder
    from kaldi_tpu.util.table import SequentialTableReader as JReader
    from kaldi_tpu_torch.lat.functions import (determinize_lattice_pruned,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    path = os.path.join(DATA, "synthetic_chain_raw.lat")
    _, jlat = next(iter(JReader(JHolder(), f"ark:{path}")))
    assert (jlat.num_states, jlat.num_arcs()) == (415, 699)
    with pytest.raises(RuntimeError, match="blowup"):
        determinize_star(invert(jlat.copy()), max_states=500,
                         functional=False)
    _, lat = next(iter(SequentialTableReader(LatticeHolder(),
                                             f"ark:{path}")))
    det = determinize_lattice_pruned(lat, 4.0)
    assert det is not lat and det.num_states > 0
    assert lattice_best_path(det)[1] == lattice_best_path(lat)[1]


@pytest.fixture(scope="module")
def recipe(tmp_path_factory) -> dict:
    """stages 0-7 on the CPU from the reference recipe's initial chain
    weights -> the run's report."""
    report: dict = {"dir": str(tmp_path_factory.mktemp("synthetic"))}
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        synthetic_run.main(
            ["--dir", report["dir"], "--use-gpu=no", "--chain-init",
             os.path.join(DATA, "synthetic_chain_init.npz")], report=report)
    return report


def test_recipe_gmm_stages(recipe):
    assert recipe["gmm"]["word_errors"] == SYNTHETIC_JAX_ERRORS["gmm"]
    assert recipe["gmm"]["ref_words"] == 16
    assert set(recipe["stage_s"]) == {str(k) for k in range(8)}


@pytest.mark.parametrize("stage", ["chain", "online"])
def test_recipe_chain_stages_from_the_reference_draw(recipe, stage):
    assert abs(recipe[stage]["word_errors"] -
               SYNTHETIC_JAX_ERRORS[stage]) <= 1, recipe[stage]
    if stage == "chain":
        from kaldi_tpu_torch.lat.functions import lattice_best_path
        from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
        assert recipe["chain"]["decoded"] == 4
        chain = os.path.join(recipe["dir"], "exp", "chain")
        assert ttool("lattice-determinize-pruned")(
            ["lattice-determinize-pruned", "--beam=4",
             f"ark:{chain}/lat.ark", f"ark:{chain}/det.lat"]) == 0
        raw, det = (dict(SequentialTableReader(LatticeHolder(),
                                               f"ark:{chain}/{name}"))
                    for name in ("lat.ark", "det.lat"))
        assert list(det) == list(raw)
        for u in raw:
            assert lattice_best_path(det[u])[1] == \
                lattice_best_path(raw[u])[1]
