"""Port parity, end to end on the CPU (--use-gpu=no): the port's
nnet3-align-compiled and the eight nnet3-discriminative-* tools against
the JAX package's tools, on the monophone YES/NO fixture of
tests/test_torch_lattice_decoder.py (its trans.mdl, HCLG.fst and xconfig
checkpoints, JAX's and the port's), with training graphs of the test
transcripts, a small TDNN-F as an nnet3 .mdl for the alignments, and
the port's lattices of the same utterances (both packages' tools read
the same archives).

Tolerances: alignments equal; whole-utterance egs archives, their copies,
shuffles, subsets and merges byte for byte; compute-objf's objective and
compute-from-egs's matrices within 1e-5 (float32 forwards in other
orders); the trained checkpoint within 1e-4 of the largest weight.

The chunked examples: the JAX tool attaches the whole utterance's
lattice to every chunk, and its compute-objf cannot score them (shown
below on the JAX package); the port cuts the lattice to each chunk's
frames (`den_lattice_range`), which keeps the utterance's total
log-probability, and scores the chunk against its own output rows.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_lattice_decoder import build_mono_fixture

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.util import table as JT
from kaldi_tpu_torch.cli import get_tool as port_tool
from kaldi_tpu_torch.util import table as PT

TDNNF = dict(feat_dim=13, hidden_dim=24, bottleneck_dim=6, prefinal_dim=12,
             num_layers=3, subsample_layer=2, frame_subsampling_factor=3)


def run(get, tool, *args):
    rc = get(tool)([tool] + [str(a) for a in args])
    assert rc == 0, f"{tool} failed with {rc}"


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """build_mono_fixture's directory, plus graphs.ark (the test
    transcripts compiled by the JAX package's TrainingGraphCompiler over
    the fixture's monophone system), final.mdl (a random 3-layer TDNN-F
    of the port with trans.mdl's transition model), lat.ark (the port's
    nnet3-latgen-faster) and ali.ark (JAX's nnet3-align-compiled)."""
    from kaldi_tpu.decoder.graph import Lang, TrainingGraphCompiler
    from kaldi_tpu.fstext.fst import VectorFst
    from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
    from kaldi_tpu.util import kaldi_io as jio
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    from kaldi_tpu_torch.nnet3 import mdl_io as PM
    from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                              chain_tdnnf_from_flax,
                                              chain_tdnnf_init)
    d = str(tmp_path_factory.mktemp("cli_disc"))
    env = build_mono_fixture(d)
    jtm = jio.read_kaldi_object(JTm.read, f"{d}/trans.mdl")
    from kaldi_tpu.tree import monophone_context_dependency as jmono
    lang = Lang({"YES": [["Y"]], "NO": [["N"]]}, sil_phone="SIL",
                sil_prob=0.5)
    lang.make_topology()
    phones = sorted(jtm.get_phones())
    tree = jmono(phones, {p: lang.topo.num_pdf_classes(p) for p in phones})
    compiler = TrainingGraphCompiler(jtm, tree, lang)
    with JT.TableWriter(VectorFst, f"ark:{d}/graphs.ark") as w:
        for u in env["utts"]:
            w.write(u, compiler.compile(env["test_txt"][u]))
    ptm = read_kaldi_object(TransitionModel.read, f"{d}/trans.mdl")
    cfg = ChainTdnnfConfig(num_pdfs=ptm.num_pdfs, **TDNNF)
    model = chain_tdnnf_from_flax(cfg, chain_tdnnf_init(
        cfg, torch.Generator().manual_seed(3)), device="cpu")
    PM.write_nnet3_am(f"{d}/final.mdl", ptm, PM.chain_tdnnf_to_nnet3(model),
                      left_context=12, right_context=12)
    # the port's search: the JAX package's keeps its link-pruning fault
    # (ROADMAP.md section 3), which can cut a lattice's last frames
    run(port_tool, "nnet3-latgen-faster", "--use-gpu=no",
        "--acoustic-scale=1.0", "--beam=12", "--lattice-beam=4",
        f"{d}/trans.mdl", f"{d}/nnet_port", f"{d}/HCLG.fst",
        f"ark:{d}/feats.ark", f"ark:{d}/lat.ark")
    run(jax_tool, "nnet3-align-compiled", "--acoustic-scale=0.1",
        f"{d}/final.mdl",
        f"ark:{d}/graphs.ark", f"ark:{d}/feats.ark", f"ark:{d}/ali.ark")
    env["d"] = d
    return env


def alignments(path):
    return {k: list(v) for k, v in
            PT.SequentialTableReader("int-vector", f"ark:{path}")}


@pytest.mark.parametrize("sub", [1, 3])
def test_align_compiled_equal_jax(env, tmp_path, sub):
    d = env["d"]
    args = [f"--frame-subsampling-factor={sub}", "--beam=10",
            "--acoustic-scale=0.1",
            f"{d}/final.mdl", f"ark:{d}/graphs.ark", f"ark:{d}/feats.ark"]
    run(jax_tool, "nnet3-align-compiled", *args, f"ark:{tmp_path}/j.ali")
    run(port_tool, "nnet3-align-compiled", "--use-gpu=no", *args,
        f"ark:{tmp_path}/p.ali")
    got, want = alignments(f"{tmp_path}/p.ali"), alignments(
        f"{tmp_path}/j.ali")
    assert sorted(got) == env["utts"] and got == want
    # at the output rate
    for u in got:
        assert len(got[u]) == -(-env["feats"][u].shape[0] // sub)


def test_align_compiled_refuses_a_raw_model(env, tmp_path):
    from kaldi_tpu_torch.nnet3 import mdl_io as PM
    d = env["d"]
    _tm, graph, _ = PM.read_nnet3_any(f"{d}/final.mdl")
    PM.write_raw_nnet3(graph, f"{tmp_path}/final.raw")
    rc = port_tool("nnet3-align-compiled")([
        "nnet3-align-compiled", "--use-gpu=no", f"{tmp_path}/final.raw",
        f"ark:{d}/graphs.ark", f"ark:{d}/feats.ark", f"ark:{tmp_path}/a"])
    assert rc == 1


def get_egs(get, d, out, *opts):
    run(get, "nnet3-discriminative-get-egs", *opts,
        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark", f"ark:{d}/lat.ark",
        f"ark:{out}")


def test_egs_tools_write_jax_bytes(env, tmp_path):
    """Whole-utterance examples, then copy (two archives, round robin),
    shuffle, subset and merge: each archive equal to the JAX tool's."""
    d = env["d"]
    for who, get in (("p", port_tool), ("j", jax_tool)):
        get_egs(get, d, f"{tmp_path}/{who}.egs", "--num-frames=300")
        run(get, "nnet3-discriminative-copy-egs", f"ark:{tmp_path}/{who}.egs",
            f"ark:{tmp_path}/{who}.c1", f"ark:{tmp_path}/{who}.c2")
        run(get, "nnet3-discriminative-shuffle-egs", "--srand=5",
            f"ark:{tmp_path}/{who}.egs", f"ark:{tmp_path}/{who}.shuf")
        run(get, "nnet3-discriminative-subset-egs", "--n=2",
            f"ark:{tmp_path}/{who}.shuf", f"ark:{tmp_path}/{who}.sub")
        run(get, "nnet3-discriminative-merge-egs", "--minibatch-size=2",
            f"ark:{tmp_path}/{who}.shuf", f"ark:{tmp_path}/{who}.merged")
    for name in ("egs", "c1", "c2", "shuf", "sub", "merged"):
        assert read_bytes(f"{tmp_path}/p.{name}") == \
            read_bytes(f"{tmp_path}/j.{name}"), name
    egs = list(PT.SequentialTableReader("degs", f"ark:{tmp_path}/p.egs"))
    assert [k for k, _ in egs] == env["utts"]
    for k, eg in egs:
        np.testing.assert_array_equal(eg.feats, env["feats"][k])
        assert eg.left_context == eg.right_context == 0
    assert len(list(PT.SequentialTableReader(
        "degs", f"ark:{tmp_path}/p.sub"))) == 2


def test_egs_keep_all_features_of_a_subsampled_utterance(env, tmp_path):
    """An alignment at a third of the feature rate: the port's example
    holds all of the utterance's features, the JAX tool's the first
    third."""
    from kaldi_tpu.nnet3.egs import DiscriminativeExampleHolder as JHolder
    d = env["d"]
    ali3 = {k: v[::3] for k, v in alignments(f"{d}/ali.ark").items()}
    with PT.TableWriter("int-vector", f"ark:{tmp_path}/ali3.ark") as w:
        for k in sorted(ali3):
            w.write(k, ali3[k])
    for who, get in (("p", port_tool), ("j", jax_tool)):
        run(get, "nnet3-discriminative-get-egs", "--num-frames=300",
            f"ark:{d}/feats.ark", f"ark:{tmp_path}/ali3.ark",
            f"ark:{d}/lat.ark", f"ark:{tmp_path}/{who}.egs")
    got = dict(PT.SequentialTableReader("degs", f"ark:{tmp_path}/p.egs"))
    want = dict(JT.SequentialTableReader(JHolder(), f"ark:{tmp_path}/j.egs"))
    for k in env["utts"]:
        T = env["feats"][k].shape[0]
        assert got[k].feats.shape[0] == T and len(got[k].num_ali) == 76
        assert want[k].feats.shape[0] == 76


def objf_line(out):
    line = [ln for ln in out.splitlines() if "objective per frame" in ln]
    assert len(line) == 1, out
    parts = line[0].split()
    return float(parts[parts.index("is") + 1]), float(parts[-2])


@pytest.mark.parametrize("criterion", ["smbr", "mpfe"])
def test_compute_objf_and_from_egs_match_jax(env, tmp_path, capsys,
                                             criterion):
    d = env["d"]
    get_egs(jax_tool, d, f"{tmp_path}/e.egs", "--num-frames=300")
    args = [f"--criterion={criterion}", "--acoustic-scale=0.5", f"{d}/nnet",
            f"{d}/trans.mdl", f"ark:{tmp_path}/e.egs"]
    run(jax_tool, "nnet3-discriminative-compute-objf", *args)
    want = objf_line(capsys.readouterr().out)
    args[2] = f"{d}/nnet_port"
    run(port_tool, "nnet3-discriminative-compute-objf", "--use-gpu=no", *args)
    got = objf_line(capsys.readouterr().out)
    assert got[1] == want[1] == 3 * 228
    assert abs(got[0] - want[0]) <= 1e-5 and 0.0 <= got[0] <= 1.0
    if criterion == "smbr":
        run(jax_tool, "nnet3-discriminative-compute-from-egs", f"{d}/nnet",
            f"ark:{tmp_path}/e.egs", f"ark:{tmp_path}/j.mat")
        run(port_tool, "nnet3-discriminative-compute-from-egs",
            "--use-gpu=no", f"{d}/nnet_port", f"ark:{tmp_path}/e.egs",
            f"ark:{tmp_path}/p.mat")
        got = dict(PT.SequentialTableReader("matrix",
                                            f"ark:{tmp_path}/p.mat"))
        want = dict(PT.SequentialTableReader("matrix",
                                             f"ark:{tmp_path}/j.mat"))
        assert sorted(got) == sorted(want) == env["utts"]
        for k in got:
            assert got[k].shape == want[k].shape == (228, env["num_pdfs"])
            assert np.abs(got[k] - want[k]).max() <= \
                1e-5 * max(1.0, np.abs(want[k]).max())


def test_chunked_egs_fault_shown_on_jax_and_repaired(env, tmp_path, capsys):
    """228-frame utterances in chunks of 100 with 3 frames of context."""
    from kaldi_tpu.base.logging import KaldiTpuError as JErr
    from kaldi_tpu.nnet3.egs import DiscriminativeExampleHolder as JHolder
    from kaldi_tpu_torch.lat.functions import lattice_state_times
    from kaldi_tpu_torch.nnet3.egs import den_lattice_range
    d = env["d"]
    opts = ["--num-frames=100", "--left-context=3", "--right-context=3"]
    get_egs(jax_tool, d, f"{tmp_path}/j.egs", *opts)
    get_egs(port_tool, d, f"{tmp_path}/p.egs", *opts)
    jegs = list(JT.SequentialTableReader(JHolder(), f"ark:{tmp_path}/j.egs"))
    pegs = list(PT.SequentialTableReader("degs", f"ark:{tmp_path}/p.egs"))
    lats = dict(PT.SequentialTableReader("lattice", f"ark:{d}/lat.ark"))
    assert [k for k, _ in pegs] == [k for k, _ in jegs]
    assert len(pegs) == 2 * 3
    for (k, p), (_, j) in zip(pegs, jegs):
        # the same features, alignment and contexts
        np.testing.assert_array_equal(p.feats, j.feats)
        assert p.num_ali == j.num_ali and len(p.num_ali) == 100
        assert (p.left_context, p.right_context) == (j.left_context,
                                                    j.right_context)
        # JAX's lattice is the whole utterance's, 228 frames long
        assert max(JT_times(j.den_lat)) == 228
        # the port's is the chunk's: its finals at frame 100
        times = lattice_state_times(p.den_lat)
        finals = {times[s] for s in range(p.den_lat.num_states)
                  if p.den_lat.is_final(s)}
        assert finals == {100}
        utt, start = k.rsplit("-", 1)
        want = den_lattice_range(lats[utt], int(start), int(start) + 100)
        assert total_logprob(p.den_lat) == pytest.approx(
            total_logprob(want), abs=1e-3)
        # ... whose total log-probability is the utterance's
        assert total_logprob(p.den_lat) == pytest.approx(
            total_logprob(lats[utt]), abs=1e-3)
    args = ["--criterion=smbr", "--acoustic-scale=0.5"]
    with pytest.raises(JErr, match="max_time"):
        jax_tool("nnet3-discriminative-compute-objf")([
            "nnet3-discriminative-compute-objf", *args, f"{d}/nnet",
            f"{d}/trans.mdl", f"ark:{tmp_path}/j.egs"])
    capsys.readouterr()
    run(port_tool, "nnet3-discriminative-compute-objf", "--use-gpu=no",
        *args, f"{d}/nnet_port", f"{d}/trans.mdl", f"ark:{tmp_path}/p.egs")
    objf, frames = objf_line(capsys.readouterr().out)
    assert frames == 600 and 0.0 <= objf <= 1.0


def JT_times(lat):
    from kaldi_tpu.lat.functions import lattice_state_times
    return lattice_state_times(lat)


def total_logprob(lat):
    """log of the sum over paths of exp(-(graph + acoustic cost))."""
    from kaldi_tpu_torch.lat.functions import _logadd, _topsort
    alpha = [-1e30] * lat.num_states
    alpha[lat.start] = 0.0
    tot = -1e30
    for s in _topsort(lat):
        for a in lat.arcs[s]:
            alpha[a.nextstate] = _logadd(alpha[a.nextstate],
                                         alpha[s] - sum(a.weight))
        if lat.is_final(s):
            tot = _logadd(tot, alpha[s] - sum(lat.finals[s]))
    return tot


def test_den_lattice_range_of_the_whole_is_the_whole(env):
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.nnet3.egs import den_lattice_range
    lats = dict(PT.SequentialTableReader("lattice",
                                         f"ark:{env['d']}/lat.ark"))
    for lat in lats.values():
        whole = den_lattice_range(lat, 0, 228)
        assert total_logprob(whole) == pytest.approx(total_logprob(lat),
                                                     abs=1e-6)
        assert lattice_best_path(whole)[:2] == lattice_best_path(lat)[:2]


def test_discriminative_train_matches_jax(env, tmp_path, capfd):
    """2 epochs of sMBR over the 3 utterances from the same checkpoint:
    the port's trained checkpoint against JAX's (converted)."""
    import importlib.util
    import json

    from kaldi_tpu_torch.parallel.checkpoint import restore_checkpoint
    d = env["d"]
    args = ["--criterion=smbr", "--num-epochs=2", "--learning-rate=0.01",
            "--acoustic-scale=0.5"]
    tail = [f"{d}/trans.mdl", f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
            f"ark:{d}/lat.ark"]
    run(jax_tool, "nnet3-discriminative-train", *args, f"{d}/nnet", *tail,
        f"{tmp_path}/j_out")
    run(port_tool, "nnet3-discriminative-train", "--use-gpu=no", *args,
        f"{d}/nnet_port", *tail, f"{tmp_path}/p_out")
    err = capfd.readouterr().err
    line = [ln for ln in err.splitlines()
            if "nnet3-discriminative-train stats " in ln]
    assert len(line) == 1
    stats = json.loads(line[0].split("stats ", 1)[1])
    assert stats["utterances"] == 3 and stats["steps"] == 6
    assert len(stats["epoch_objf"]) == 2 and stats["host_s"] > 0
    assert not any(stats["kernel_launches"].values())
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "jax_checkpoint_to_torch.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    conv.convert(f"{tmp_path}/j_out", f"{tmp_path}/j_conv")
    got, meta, _ = restore_checkpoint(f"{tmp_path}/p_out")
    want, jmeta, _ = restore_checkpoint(f"{tmp_path}/j_conv")
    init, _, _ = restore_checkpoint(f"{d}/nnet_port")
    assert meta == jmeta and "xconfig" in meta
    flat = {}

    def walk(a, b, c, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], c[k], f"{path}/{k}")
        else:
            flat[path] = (np.asarray(a), np.asarray(b), np.asarray(c))
    walk(got, want, init)
    largest = max(np.abs(b).max() for _, b, _ in flat.values())
    for path, (a, b, c) in flat.items():
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-4 * largest, path
        if path.startswith("/batch_stats"):
            np.testing.assert_array_equal(a, c)
    assert max(np.abs(a - c).max() for a, _, c in flat.values()) > 1e-3
