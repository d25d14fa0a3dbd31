"""Port parity of nnet3/torch_bridge.py: compile_graph of an imported
Nnet3Graph against the JAX package's compile_graph (jitted on the CPU)
and against the port's host evaluator (Nnet3Graph.forward, a lane at a
time), on the CPU.

Each mapped component type in a one-node graph; the acyclic TDNN and the
lstmp graphs of tests/test_mdl_recurrent.py, its projected-GRU graph,
attention, an x-vector style conv + statistics-pooling graph,
chip_smoke.py's tdnn_lstm_graph at a small width; a 5-layer TDNN-F
exported from the port's ChainTdnnf with and without i-vectors, against
the native model on interior frames.  Tolerances: 1e-4 relative plus
1e-5 absolute against JAX and the host (float32, other summation
orders); 2e-4 absolute against the native model, as tests/test_mdl_io.py
holds the JAX exporter.  Component types without a mapping raise at
compile time.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet3 import mdl_io as JM
from kaldi_tpu.nnet3.jax_bridge import compile_graph as jax_compile
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.nnet3 import mdl_io as PM
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from test_mdl_recurrent import make_lstmp_graph
from test_torch_nnet3_mdl_io import (COMPONENTS, TDNNF, graph_bytes, make,
                                     read_graph, seeded_variables)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import tdnn_lstm_graph  # noqa: E402

import kaldi_tpu.base.io_funcs as jiof  # noqa: E402
import kaldi_tpu_torch.base.io_funcs as piof  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
UNMAPPED = ("DropoutMaskComponent", "ConvolutionComponent")


def to_port(jg):
    return read_graph(PM, piof, graph_bytes(jg, True))


def to_jax(pg):
    return read_graph(JM, jiof, graph_bytes(pg, True))


def check(jg, x, ivector=None, output="output", host=True):
    """The port's module on the CPU against JAX's jitted function and, a
    lane at a time, against the port's host evaluator."""
    pg = to_port(jg)
    net = compile_graph(pg, output, device="cpu")
    got = net(torch.from_numpy(x), None if ivector is None
              else torch.from_numpy(ivector)).numpy()
    fn = jax.jit(jax_compile(jg, output_name=output))
    want = np.asarray(fn(x) if ivector is None else fn(x, ivector))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if host:
        for b in range(x.shape[0]):
            np.testing.assert_allclose(
                got[b], pg.forward(x[b], None if ivector is None
                                   else ivector[b], output_name=output),
                rtol=RTOL, atol=ATOL)
    return got


def one_node_graph(comp, dim):
    nodes = [JM.Node("input", "input", dim=dim),
             JM.Node("component", "c", component="c",
                     desc=JM.parse_descriptor("input")),
             JM.Node("output", "output", desc=JM.parse_descriptor("c"))]
    return JM.Nnet3Graph(nodes, {"c": comp})


MAPPED = [(i, n, f) for i, (n, f) in enumerate(COMPONENTS)
          if n not in UNMAPPED]


@pytest.mark.parametrize("i,name,fields", MAPPED,
                         ids=[f"{n}-{i}" for i, n, _f in MAPPED])
def test_each_mapped_component(i, name, fields):
    comp = make(JM, name, fields)
    dim = comp.input_dim or 4
    x = np.random.default_rng(i).normal(size=(2, 9, dim)).astype(np.float32)
    if name == "StatisticsPoolingComponent":
        x[..., 0] = np.abs(x[..., 0]) + 1.0          # counts
    check(one_node_graph(comp, dim), x)


@pytest.mark.parametrize("name", UNMAPPED)
def test_unmapped_component_raises_at_compile_time(name):
    fields = dict(COMPONENTS)[name]
    g = to_port(one_node_graph(make(JM, name, fields), 8))
    with pytest.raises(KaldiTpuError, match="no torch mapping"):
        compile_graph(g, device="cpu")


def acyclic_tdnn_graph():
    """TestJaxBridge.test_tdnn_acyclic_jitted_matches_numpy's graph."""
    rng = np.random.default_rng(2)
    D, H = 6, 8
    comps = {
        "tdnn": JM.TdnnComponent(
            TimeOffsets=[-1, 0, 1],
            LinearParams=rng.normal(size=(H, 3 * D)).astype(np.float32)
            * 0.3, BiasParams=rng.normal(size=H).astype(np.float32),
            OrthonormalConstraint=0.0, UseNaturalGradient=True),
        "relu": JM.RectifiedLinearComponent(Dim=H),
        "bn": JM.BatchNormComponent(
            Dim=H, BlockDim=H, Epsilon=1e-3, TargetRms=1.0, TestMode=True,
            Count=100.0,
            StatsMean=rng.normal(size=H).astype(np.float32) * 0.1,
            StatsVar=np.abs(rng.normal(size=H)).astype(np.float32) + 0.5),
        "out_aff": JM.NaturalGradientAffineComponent(
            LearningRate=0.001,
            LinearParams=rng.normal(size=(5, 3 * H)).astype(np.float32)
            * 0.2, BiasParams=np.zeros(5, np.float32), RankIn=20,
            RankOut=80, UpdatePeriod=4, NumSamplesHistory=2000.0,
            Alpha=4.0),
    }
    nodes = [
        JM.Node("input", "input", dim=D),
        JM.Node("component", "tdnn", component="tdnn",
                desc=JM.parse_descriptor("input")),
        JM.Node("component", "relu", component="relu",
                desc=JM.parse_descriptor("tdnn")),
        JM.Node("component", "bn", component="bn",
                desc=JM.parse_descriptor("relu")),
        JM.Node("component", "out_aff", component="out_aff",
                desc=JM.parse_descriptor(
                    "Append(Offset(bn, -3), bn, Offset(bn, 3))")),
        JM.Node("output", "output", desc=JM.parse_descriptor("out_aff")),
    ]
    return JM.Nnet3Graph(nodes, comps), D


def gru_graph():
    """TestGru.test_gru_graph_recurrence's projected GRU."""
    D, C, R = 4, 6, 3
    rng = np.random.default_rng(1)
    comps = {
        "zr": JM.NaturalGradientAffineComponent(
            LearningRate=0.001,
            LinearParams=rng.normal(size=(2 * C + R, D + R)).astype(
                np.float32) * 0.3,
            BiasParams=rng.normal(size=2 * C + R).astype(np.float32) * 0.1,
            RankIn=20, RankOut=80, UpdatePeriod=4,
            NumSamplesHistory=2000.0, Alpha=4.0),
        "gru": JM.GruNonlinearityComponent(
            LearningRate=0.001, CellDim=C, RecurrentDim=R,
            w_h=rng.normal(size=(C, R)).astype(np.float32) * 0.3,
            ValueAvg=np.zeros(C, np.float32),
            DerivAvg=np.zeros(C, np.float32), SelfRepairTotal=0.0,
            Count=0.0, SelfRepairThreshold=0.2, SelfRepairScale=1e-5,
            Alpha=4.0, RankIn=20, RankOut=80, UpdatePeriod=4),
        "proj": JM.LinearComponent(
            Params=rng.normal(size=(R + 2, C)).astype(np.float32) * 0.4,
            OrthonormalConstraint=0.0, UseNaturalGradient=True),
        "sig_z": JM.SigmoidComponent(Dim=C),
        "sig_r": JM.SigmoidComponent(Dim=R),
    }
    nodes = [
        JM.Node("input", "input", dim=D),
        JM.Node("component", "zr", component="zr",
                desc=JM.parse_descriptor(
                    "Append(input, IfDefined(Offset(s_prev, -1)))")),
        JM.Node("dim-range", "z_pre", dim=C, dim_offset=0,
                desc=JM.Desc("node", ["zr"])),
        JM.Node("dim-range", "r_pre", dim=R, dim_offset=C,
                desc=JM.Desc("node", ["zr"])),
        JM.Node("dim-range", "hpart", dim=C, dim_offset=C + R,
                desc=JM.Desc("node", ["zr"])),
        JM.Node("component", "z", component="sig_z",
                desc=JM.parse_descriptor("z_pre")),
        JM.Node("component", "r", component="sig_r",
                desc=JM.parse_descriptor("r_pre")),
        JM.Node("component", "gru", component="gru",
                desc=JM.parse_descriptor(
                    "Append(z, r, hpart, IfDefined(Offset(c_prev, -1)), "
                    "IfDefined(Offset(s_prev, -1)))")),
        JM.Node("dim-range", "c_prev", dim=C, dim_offset=C,
                desc=JM.Desc("node", ["gru"])),
        JM.Node("component", "proj", component="proj",
                desc=JM.parse_descriptor("c_prev")),
        JM.Node("dim-range", "s_prev", dim=R, dim_offset=0,
                desc=JM.Desc("node", ["proj"])),
        JM.Node("output", "output", desc=JM.parse_descriptor("proj")),
    ]
    return JM.Nnet3Graph(nodes, comps), D


def attention_graph():
    H, kd, vd, L, R = 2, 3, 4, 1, 1
    ctx = L + 1 + R
    comps = {"attn": JM.RestrictedAttentionComponent(
        NumHeads=H, KeyDim=kd, ValueDim=vd, NumLeftInputs=L,
        NumRightInputs=R, TimeStride=1, NumLeftInputsRequired=0,
        NumRightInputsRequired=0, OutputContext=True, KeyScale=0.5,
        StatsCount=0.0, EntropyStats=np.zeros(H, np.float32),
        PosteriorStats=np.zeros((H, ctx), np.float32))}
    dim = H * (2 * kd + ctx + vd)
    nodes = [JM.Node("input", "input", dim=dim),
             JM.Node("component", "attn", component="attn",
                     desc=JM.parse_descriptor("input")),
             JM.Node("output", "output", desc=JM.parse_descriptor("attn"))]
    return JM.Nnet3Graph(nodes, comps), dim


def xvector_graph():
    """TestGraphIntegration.test_xvector_style_graph's conv + ReLU +
    statistics extraction + pooling + affine."""
    rng = np.random.default_rng(5)
    m = dict(num_filters_in=1, num_filters_out=2, height_in=4, height_out=4,
             height_subsample_out=1, offsets=[(0, 0), (0, 1), (1, 0)],
             required_time_offsets=[0])
    comps = {
        "conv": JM.TimeHeightConvolutionComponent(
            LearningRate=0.01, Model=m,
            LinearParams=rng.normal(size=(2, 3)).astype(np.float32),
            BiasParams=np.zeros(2, np.float32), MaxMemoryMb=200.0,
            UseNaturalGradient=False, NumMinibatchesHistory=4.0,
            AlphaInOut=(4.0, 4.0), RankInOut=(40, 40)),
        "relu": JM.RectifiedLinearComponent(Dim=8),
        "stats": JM.StatisticsExtractionComponent(
            InputDim=8, InputPeriod=1, OutputPeriod=1,
            IncludeVarinance=True),
        "pool": JM.StatisticsPoolingComponent(
            InputDim=17, InputPeriod=1, LeftContext=3, RightContext=2,
            NumLogCountFeatures=1, OutputStddevs=True, VarianceFloor=1e-10),
        "embed": JM.NaturalGradientAffineComponent(
            LearningRate=0.001,
            LinearParams=rng.normal(size=(5, 17)).astype(np.float32),
            BiasParams=np.zeros(5, np.float32), RankIn=20, RankOut=80,
            UpdatePeriod=4, NumSamplesHistory=2000.0, Alpha=4.0),
    }
    order = ["conv", "relu", "stats", "pool", "embed"]
    nodes = [JM.Node("input", "input", dim=4)]
    prev = "input"
    for name in order:
        nodes.append(JM.Node("component", name, component=name,
                             desc=JM.parse_descriptor(prev)))
        prev = name
    nodes.append(JM.Node("output", "output", desc=JM.parse_descriptor(prev)))
    return JM.Nnet3Graph(nodes, comps), 4


def small_tdnn_lstm():
    pg = tdnn_lstm_graph(feat_dim=5, tdnn_dim=12, cell_dim=8, rec_proj=4,
                         nonrec_proj=3, delay=-3, layers=3, num_pdfs=7,
                         seed=1)
    return to_jax(pg), 5


GRAPHS = {
    "acyclic_tdnn": acyclic_tdnn_graph,
    "lstmp": lambda: (make_lstmp_graph(seed=7)[0], 5),
    "gru": gru_graph,
    "attention": attention_graph,
    "xvector_conv_statspool": xvector_graph,
    "tdnn_lstm": small_tdnn_lstm,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_against_jax_and_host(name):
    jg, dim = GRAPHS[name]()
    x = np.random.default_rng(3).normal(size=(3, 13, dim)).astype(
        np.float32)
    check(jg, x)


def test_recurrent_group_and_memory_plan():
    """The TDNN-LSTM's group holds the LSTM nodes and the TDNN layers
    between them (not the first), and the program frees every value but
    the output after its last use."""
    pg = tdnn_lstm_graph(feat_dim=5, tdnn_dim=12, cell_dim=8, rec_proj=4,
                         nonrec_proj=3, delay=-3, layers=3, num_pdfs=7)
    net = compile_graph(pg, device="cpu")
    assert "tdnn2.affine" in net._group and "lstm3.rp" in net._group
    assert "tdnn1.affine" not in net._group
    assert net._max_delay["lstm1.r_trunc"] == 3
    assert [s[1] for s in net._steps].count("scan") == 1
    # the exported TDNN-F: each bypass Sum is computed once a call
    kw = dict(TDNNF, ivector_dim=0)
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**kw),
                                  seeded_variables(ChainTdnnfConfig(**kw)),
                                  device="cpu")
    net = compile_graph(PM.chain_tdnnf_to_nnet3(model), device="cpu")
    outs = [s[0] for s in net._steps]
    assert len(outs) == len(set(outs))
    assert sum(op == "sum" for _o, op, _p, _a in net._steps) == \
        kw["num_layers"]
    assert net._uses[net._out_slot] == 1


def test_lookahead_between_recurrent_layers_raises_everywhere():
    """run_tdnn_lstm_1a's Append(-3, 0, 3) between LSTM layers puts a
    future frame inside the frame loop's group: the port refuses it at
    compile time, as JAX's bridge and the host evaluator refuse it."""
    pg = tdnn_lstm_graph(feat_dim=5, tdnn_dim=12, cell_dim=8, rec_proj=4,
                         nonrec_proj=3, delay=-3, layers=2, num_pdfs=7,
                         later_taps=(-3, 0, 3))
    with pytest.raises(KaldiTpuError, match="non-causal"):
        compile_graph(pg, device="cpu")
    x = np.zeros((1, 9, 5), np.float32)
    with pytest.raises(Exception, match="non-causal"):
        jax_compile(to_jax(pg))(x)
    with pytest.raises(KaldiTpuError, match="non-causal"):
        pg.forward(x[0])


@pytest.mark.parametrize("ivector_dim", [0, 5])
def test_tdnnf_export_against_native_and_jax(ivector_dim):
    """The port's 5-layer ChainTdnnf exported by the port and compiled:
    t in {0, 3, ...} of the full-rate graph equals the native model away
    from the edges (2e-4, as tests/test_mdl_io.py holds JAX's exporter),
    both heads; the whole output against JAX's compile_graph of JAX's
    export of the same weights."""
    kw = dict(TDNNF, ivector_dim=ivector_dim)
    cfg = ChainTdnnfConfig(**kw)
    variables = seeded_variables(cfg, seed=4)
    model = chain_tdnnf_from_flax(cfg, variables, device="cpu")
    pg = PM.chain_tdnnf_to_nnet3(model)
    rng = np.random.default_rng(6)
    B, T = 2, 45
    x = rng.normal(size=(B, T, cfg.feat_dim)).astype(np.float32)
    iv = (rng.normal(size=(B, ivector_dim)).astype(np.float32)
          if ivector_dim else None)
    with torch.inference_mode():
        chain, xent = model(torch.from_numpy(x),
                            None if iv is None else torch.from_numpy(iv))
    interior = slice(4, chain.shape[1] - 4)
    for head, native in (("output", chain), ("output-xent", xent)):
        got = check(to_jax(pg), x, iv, output=head, host=False)
        np.testing.assert_allclose(got[:, ::3][:, interior],
                                   native.numpy()[:, interior], atol=2e-4)
    if ivector_dim:
        with pytest.raises(KaldiTpuError, match="ivector"):
            compile_graph(pg, device="cpu")(torch.from_numpy(x))


def test_device_defaults_to_cuda():
    g = to_port(acyclic_tdnn_graph()[0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_graph(g)
