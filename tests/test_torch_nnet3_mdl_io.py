"""Port parity of the nnet3 model files: kaldi_tpu_torch/nnet3/mdl_io.py
against kaldi_tpu/nnet3/mdl_io.py.

Every component of tests/test_mdl_io.py, tests/test_mdl_recurrent.py and
tests/test_components_zoo.py, built with the same fields by each package:
the binary bytes each writes are equal, each reads what the other wrote
with every field equal (arrays exactly), and the text form read back
gives the same fields (text floats are the shortest strings that read
back as the same float32, so exactly too).  Whole graphs and .mdl files
likewise, and chain_tdnnf_to_nnet3 of the port's ChainTdnnf against the
JAX exporter on the same weights: the same bytes.
"""

import io

import numpy as np
import pytest
import torch

import kaldi_tpu.base.io_funcs as jiof
from kaldi_tpu.nnet3 import mdl_io as JM
from kaldi_tpu.nnet3.models import ChainTdnnf as FlaxTdnnf
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as FlaxConfig
import kaldi_tpu_torch.base.io_funcs as piof
from kaldi_tpu_torch.nnet3 import mdl_io as PM
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig, chain_tdnnf_init,
                                          chain_tdnnf_from_flax)
from test_mdl_io import REFERENCE_TEXT_RAW


def _w(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3
            ).astype(np.float32)


def _conv_model(hin=4, hout=4, sub=1, offsets=((0, 0), (0, 1), (1, 0))):
    return dict(num_filters_in=2, num_filters_out=3, height_in=hin,
                height_out=hout, height_subsample_out=sub,
                offsets=[tuple(o) for o in offsets],
                required_time_offsets=[0])


_NG = dict(RankIn=20, RankOut=80, UpdatePeriod=4, NumSamplesHistory=2000.0,
           Alpha=4.0)
_GRU_NG = dict(SelfRepairTotal=0.0, Count=0.0, SelfRepairThreshold=0.2,
               SelfRepairScale=1e-5, Alpha=4.0)

# (class name, fields) of every component the JAX package's tests build
COMPONENTS = [
    ("NaturalGradientAffineComponent",
     dict(LearningRate=0.001, LinearParams=_w(0, 2, 9),
          BiasParams=_w(1, 2), **_NG)),
    ("AffineComponent", dict(LearningRate=0.01, LinearParams=_w(2, 3, 4),
                             BiasParams=_w(3, 3))),
    ("FixedAffineComponent", dict(LinearParams=_w(4, 3, 4),
                                  BiasParams=_w(5, 3))),
    ("LinearComponent", dict(Params=_w(6, 6, 8), OrthonormalConstraint=0.0,
                             UseNaturalGradient=True)),
    ("TdnnComponent", dict(TimeOffsets=[-1, 0, 1], LinearParams=_w(7, 8, 18),
                           BiasParams=_w(8, 8), OrthonormalConstraint=0.0,
                           UseNaturalGradient=True)),
    ("TdnnComponent", dict(TimeOffsets=[-3, 0], LinearParams=_w(9, 4, 16),
                           BiasParams=np.zeros(0, np.float32),
                           OrthonormalConstraint=-1.0,
                           UseNaturalGradient=True)),
    ("RectifiedLinearComponent", dict(Dim=2, ValueAvg=np.zeros(0, np.float32),
                                      DerivAvg=np.zeros(0, np.float32),
                                      Count=0.0)),
    ("SigmoidComponent", dict(Dim=5)),
    ("TanhComponent", dict(Dim=5)),
    ("LogSoftmaxComponent", dict(Dim=12, Count=0.0)),
    ("SoftmaxComponent", dict(Dim=4)),
    ("NoOpComponent", dict(Dim=4)),
    ("BatchNormComponent",
     dict(Dim=8, BlockDim=8, Epsilon=1e-3, TargetRms=1.0, TestMode=True,
          Count=100.0, StatsMean=_w(10, 8),
          StatsVar=np.abs(_w(11, 8)) + 0.5)),
    ("ScaleAndOffsetComponent", dict(Dim=3, Scales=_w(12, 3),
                                     Offsets=_w(13, 3))),
    ("NormalizeComponent", dict(InputDim=8, BlockDim=8, TargetRms=0.7,
                                AddLogStddev=False)),
    ("NormalizeComponent", dict(InputDim=6, BlockDim=3, TargetRms=1.0,
                                AddLogStddev=True)),
    ("PerElementScaleComponent",
     dict(LearningRate=0.01, Params=np.arange(1, 5, dtype=np.float32))),
    ("PerElementOffsetComponent",
     dict(LearningRate=0.01, Offsets=np.ones(2, np.float32), Dim=4,
          UseNaturalGradient=True)),
    ("PermuteComponent", dict(ColumnMap=[2, 0, 1, 3])),
    ("SumGroupComponent", dict(Sizes=[2, 3, 1])),
    ("ClipGradientComponent",
     dict(Dim=5, ClippingThreshold=1.0, NormBasedClipping=True,
          NumElementsClipped=0.0, NumElementsProcessed=0.0,
          NumSelfRepaired=0.0, NumBackpropped=0.0)),
    ("BackpropTruncationComponent",
     dict(Dim=5, Scale=0.5, ClippingThreshold=30.0, ZeroingThreshold=15.0,
          ZeroingInterval=20, RecurrenceInterval=1, NumElementsClipped=0.0,
          NumElementsZeroed=0.0, NumElementsProcessed=0.0,
          NumZeroingBoundaries=0.0)),
    ("ElementwiseProductComponent", dict(InputDim=6, OutputDim=3)),
    ("PnormComponent", dict(InputDim=6, OutputDim=3)),
    ("SumBlockComponent", dict(InputDim=6, OutputDim=3, Scale=2.0)),
    ("FixedScaleComponent", dict(Scales=np.full(4, 2.0, np.float32))),
    ("FixedBiasComponent", dict(Bias=np.full(4, -1.0, np.float32))),
    ("ConstantComponent",
     dict(LearningRate=0.001, Output=np.arange(3, dtype=np.float32),
          IsUpdatable=True, UseNaturalGradient=True)),
    ("ConstantFunctionComponent",
     dict(LearningRate=0.001, InputDim=4,
          Output=np.arange(2, dtype=np.float32), IsUpdatable=False,
          UseNaturalGradient=False)),
    ("BlockAffineComponent", dict(LearningRate=0.01, NumBlocks=2,
                                  LinearParams=_w(14, 4, 3),
                                  BiasParams=_w(15, 4))),
    ("RepeatedAffineComponent", dict(LearningRate=0.01, NumRepeats=2,
                                     LinearParams=_w(16, 2, 3),
                                     BiasParams=_w(17, 2))),
    ("StatisticsExtractionComponent",
     dict(InputDim=3, InputPeriod=1, OutputPeriod=1, IncludeVarinance=True)),
    ("StatisticsPoolingComponent",
     dict(InputDim=7, InputPeriod=1, LeftContext=3, RightContext=1,
          NumLogCountFeatures=1, OutputStddevs=True, VarianceFloor=1e-10)),
    ("TimeHeightConvolutionComponent",
     dict(LearningRate=0.01, Model=_conv_model(), LinearParams=_w(18, 3, 6),
          BiasParams=_w(19, 3), MaxMemoryMb=200.0, UseNaturalGradient=True,
          NumMinibatchesHistory=4.0, AlphaInOut=(4.0, 4.0),
          RankInOut=(40, 40))),
    ("SpecAugmentTimeMaskComponent",
     dict(Dim=5, ZeroedProportion=0.2, TimeMaskMaxFrames=10, TestMode=True)),
    ("DropoutMaskComponent", dict(OutputDim=3, DropoutProportion=0.5,
                                  TestMode=True, Continuous=False)),
    ("LstmNonlinearityComponent",
     dict(LearningRate=0.001, Params=_w(20, 3, 8),
          ValueAvg=np.zeros((5, 8), np.float32),
          DerivAvg=np.zeros((5, 8), np.float32),
          SelfRepairConfig=np.asarray([0.05, 0.05, 0.2, 0.05, 0.2]
                                      + [1e-5] * 5, np.float32),
          SelfRepairProb=np.zeros(5, np.float32), Count=0.0)),
    ("LstmNonlinearityComponent",
     dict(LearningRate=0.001, Params=_w(21, 3, 4),
          ValueAvg=np.zeros((5, 4), np.float32),
          DerivAvg=np.zeros((5, 4), np.float32),
          SelfRepairConfig=np.zeros(10, np.float32),
          SelfRepairProb=np.zeros(5, np.float32), UseDropout=True,
          Count=0.0)),
    ("GruNonlinearityComponent",
     dict(LearningRate=0.001, CellDim=6, RecurrentDim=3, w_h=_w(22, 6, 3),
          ValueAvg=np.zeros(6, np.float32), DerivAvg=np.zeros(6, np.float32),
          RankIn=20, RankOut=80, UpdatePeriod=4, **_GRU_NG)),
    ("OutputGruNonlinearityComponent",
     dict(LearningRate=0.001, CellDim=5, w_h=_w(23, 5),
          ValueAvg=np.zeros(5, np.float32), DerivAvg=np.zeros(5, np.float32),
          Rank=8, UpdatePeriod=4, **_GRU_NG)),
    ("RestrictedAttentionComponent",
     dict(NumHeads=2, KeyDim=3, ValueDim=4, NumLeftInputs=2,
          NumRightInputs=1, TimeStride=1, NumLeftInputsRequired=0,
          NumRightInputsRequired=0, OutputContext=True,
          KeyScale=float(1 / np.sqrt(3)), StatsCount=0.0,
          EntropyStats=np.zeros(2, np.float32),
          PosteriorStats=np.zeros((2, 4), np.float32))),
    ("MaxpoolingComponent",
     dict(InputXDim=4, InputYDim=3, InputZDim=2, PoolXSize=2, PoolYSize=2,
          PoolZSize=1, PoolXStep=2, PoolYStep=1, PoolZStep=1)),
    ("ConvolutionComponent",
     dict(LearningRate=0.01, InputXDim=4, InputYDim=4, InputZDim=2,
          FiltXDim=2, FiltYDim=2, FiltXStep=1, FiltYStep=1,
          InputVectorization=0, FilterParams=_w(24, 3, 8),
          BiasParams=_w(25, 3))),
    ("DistributeComponent", dict(InputDim=6, OutputDim=6)),
]


def make(module, name, fields):
    if name == "CompositeComponent":
        subs = [make(module, n, f) for n, f in fields["subs"]]
        return module.CompositeComponent(
            sub_components=subs, **{k: v for k, v in fields.items()
                                    if k != "subs"})
    return getattr(module, name)(**fields)


COMPONENTS.append(("CompositeComponent", dict(
    subs=[COMPONENTS[0], ("RectifiedLinearComponent", dict(Dim=2))],
    LearningRate=0.001, MaxRowsProcess=2048)))


def same_fields(a, b):
    """Recursive equality of read fields: arrays exactly, with dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            same_fields(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_fields(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def same_component(a, b):
    assert type(a).TYPE == type(b).TYPE
    same_fields(a.fields, b.fields)
    if type(a).TYPE == "CompositeComponent":
        assert len(a.sub_components) == len(b.sub_components)
        for x, y in zip(a.sub_components, b.sub_components):
            same_component(x, y)


def comp_bytes(comp, binary):
    buf = io.BytesIO()
    comp.write(buf, binary)
    return buf.getvalue()


def read_comp(module, iof, data, binary):
    buf = io.BytesIO(data)
    tok = iof.read_token(buf, binary)
    return module.COMPONENT_TYPES[tok[1:-1]].read(buf, binary)


@pytest.mark.parametrize("name,fields", COMPONENTS,
                         ids=[f"{n}-{i}" for i, (n, _f) in
                              enumerate(COMPONENTS)])
def test_component_bytes_and_fields_cross_read(name, fields):
    jc, pc = make(JM, name, fields), make(PM, name, fields)
    for binary in (True, False):
        jb, pb = comp_bytes(jc, binary), comp_bytes(pc, binary)
        assert jb == pb
        # the port reads JAX's bytes, JAX reads the port's
        from_j = read_comp(PM, piof, jb, binary)
        from_p = read_comp(JM, jiof, pb, binary)
        same_component(from_j, from_p)
        # and each agrees with what its own package reads back
        same_component(from_j, read_comp(JM, jiof, jb, binary))
    assert sorted(PM.COMPONENT_TYPES) == sorted(JM.COMPONENT_TYPES)


@pytest.mark.parametrize("text", [
    "tdnn1.batchnorm",
    "Sum(Scale(0.66, prev.bn), tdnnf3.batchnorm)",
    "Append(Offset(input, -1), input, Offset(input, 1))",
    "Append(input, ReplaceIndex(ivector, t, 0))",
    "Append(W_all, IfDefined(Offset(c_trunc, -3)))",
    "Failover(Offset(x, -1), Const(0.5, 7))",
    "Switch(a, b)",
    "Round(Offset(x, 2), 3)",
    "Sum(Scale(0.66, Sum(Scale(0.66, a), b)), c)",
])
def test_descriptor_parse_repr_round_trip(text):
    d = PM.parse_descriptor(text)
    assert repr(d) == repr(JM.parse_descriptor(text))
    assert repr(PM.parse_descriptor(repr(d))) == repr(d)
    assert PM._desc_refs(d) == JM._desc_refs(JM.parse_descriptor(text))


def recurrent_graphs():
    """The graphs of tests/test_mdl_recurrent.py and test_mdl_io.py, built
    by the JAX package."""
    from test_mdl_recurrent import make_lstmp_graph
    lstmp, _ = make_lstmp_graph(seed=3)
    ref = JM.Nnet3Graph.read(io.BytesIO(REFERENCE_TEXT_RAW.encode()),
                             binary=False)
    return {"lstmp": lstmp, "reference_text": ref}


def graph_bytes(graph, binary):
    buf = io.BytesIO()
    if binary:
        buf.write(b"\x00B")
    graph.write(buf, binary)
    return buf.getvalue()


def read_graph(module, iof, data):
    buf = io.BytesIO(data)
    binary = iof.init_input_stream(buf)
    return module.Nnet3Graph.read(buf, binary)


def same_graph(a, b):
    assert [n.config_line() for n in a.nodes] == \
        [n.config_line() for n in b.nodes]
    assert list(a.components) == list(b.components)
    for k in a.components:
        same_component(a.components[k], b.components[k])


@pytest.mark.parametrize("which", ["lstmp", "reference_text"])
def test_graph_round_trip_both_ways(which, tmp_path):
    jg = recurrent_graphs()[which]
    for binary in (True, False):
        jb = graph_bytes(jg, binary)
        pg = read_graph(PM, piof, jb)
        pb = graph_bytes(pg, binary)
        assert pb == jb
        same_graph(read_graph(JM, jiof, pb), pg)
    # the .raw front doors: each package reads the other's file
    JM.write_raw_nnet3(jg, str(tmp_path / "j.raw"))
    pg = PM.read_raw_nnet3(str(tmp_path / "j.raw"))
    PM.write_raw_nnet3(pg, str(tmp_path / "p.raw"))
    assert (tmp_path / "p.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    x = np.random.default_rng(1).normal(
        size=(7, jg.node_of["input"].dim)).astype(np.float32)
    np.testing.assert_array_equal(pg.forward(x), jg.forward(x))


def test_mdl_round_trip_with_transition_model(tmp_path):
    from kaldi_tpu.hmm.topology import HmmTopology
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.tree import monophone_context_dependency
    topo = HmmTopology.chain_topology([1, 2])
    npc = {p: topo.num_pdf_classes(p) for p in (1, 2)}
    tm = TransitionModel(topo, monophone_context_dependency([1, 2], npc))
    jg = recurrent_graphs()["reference_text"]
    priors = np.array([0.25, 0.75], np.float32)
    for binary in (True, False):
        jpath, ppath = str(tmp_path / "j.mdl"), str(tmp_path / "p.mdl")
        JM.write_nnet3_am(jpath, tm, jg, left_context=1, right_context=2,
                          priors=priors, binary=binary)
        ptm, pg, info = PM.read_nnet3_am(jpath)
        assert ptm.num_pdfs == tm.num_pdfs
        assert info["left_context"] == 1 and info["right_context"] == 2
        np.testing.assert_array_equal(info["priors"], priors)
        same_graph(pg, read_graph(PM, piof, graph_bytes(jg, binary)))
        PM.write_nnet3_am(ppath, ptm, pg, left_context=1, right_context=2,
                          priors=info["priors"], binary=binary)
        assert open(ppath, "rb").read() == open(jpath, "rb").read()
        tm_any, g_any, _ = PM.read_nnet3_any(ppath)
        assert tm_any is not None and list(g_any.components) == \
            list(jg.components)
    # a .raw through read_nnet3_any has no transition model
    PM.write_raw_nnet3(pg, str(tmp_path / "p.raw"))
    assert PM.read_nnet3_any(str(tmp_path / "p.raw"))[0] is None


TDNNF = dict(feat_dim=8, num_pdfs=6, hidden_dim=16, bottleneck_dim=4,
             prefinal_dim=8, num_layers=5, subsample_layer=3,
             frame_subsampling_factor=3)


def seeded_variables(cfg, seed=0):
    """The port's flax-layout init, batch statistics made non-trivial."""
    v = chain_tdnnf_init(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for stats in v["batch_stats"].values():
        for leaf in ([stats["bn"]] if "bn" in stats else
                     [s["bn"] for s in stats.values()]):
            leaf["mean"] = (rng.normal(size=leaf["mean"].shape) * 0.3
                            ).astype(np.float32)
            leaf["var"] = rng.uniform(0.5, 2.0, size=leaf["var"].shape
                                      ).astype(np.float32)
    return v


@pytest.mark.parametrize("ivector_dim", [0, 5])
def test_chain_tdnnf_export_equals_jax(ivector_dim):
    """The port's exporter on its own ChainTdnnf (through
    chain_tdnnf_to_flax) against the JAX exporter on the same flax-layout
    weights: the same graph, byte for byte."""
    kw = dict(TDNNF, ivector_dim=ivector_dim)
    variables = seeded_variables(ChainTdnnfConfig(**kw))
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**kw), variables,
                                  device="cpu")
    pg = PM.chain_tdnnf_to_nnet3(model)
    jg = JM.chain_tdnnf_to_nnet3(FlaxTdnnf(FlaxConfig(**kw), train=False),
                                 variables)
    for binary in (True, False):
        assert graph_bytes(pg, binary) == graph_bytes(jg, binary)
    assert ("ivector" in pg.node_of) == bool(ivector_dim)
    # explicit variables give the same graph as the model's own
    assert graph_bytes(PM.chain_tdnnf_to_nnet3(model, variables), True) == \
        graph_bytes(pg, True)


@pytest.mark.parametrize("name", ["compressed-matrix", "sparse-matrix"])
def test_unported_holders_raise_naming_their_module(name):
    from kaldi_tpu_torch.util.table import SequentialTableReader
    with pytest.raises(NotImplementedError, match="kaldi_tpu/"):
        SequentialTableReader(name, "ark:x.ark")


@pytest.mark.parametrize("binary", [True, False])
def test_io_funcs_bytes_equal_jax(binary):
    """The io_funcs writers the model files use, byte for byte, and each
    package's reader on the other's bytes."""
    rng = np.random.default_rng(0)
    mat = rng.normal(size=(3, 4)).astype(np.float32)
    mat64 = rng.normal(size=(2, 2))
    pairs = [(0, -1), (3, 2)]
    out = []
    for iof in (jiof, piof):
        buf = io.BytesIO()
        iof.write_bool(buf, binary, True)
        iof.write_double(buf, binary, 0.1)
        iof.write_int_pair_vector(buf, binary, pairs)
        iof.write_matrix(buf, binary, mat)
        iof.write_matrix(buf, binary, mat64)
        iof.write_matrix(buf, binary, np.zeros((2, 0), np.float32))
        out.append(buf.getvalue())
    assert out[0] == out[1]
    for iof in (jiof, piof):
        buf = piof.PeekableReader(io.BytesIO(out[0]))
        assert iof.read_bool(buf, binary) is True
        assert iof.read_float(buf, binary) == 0.1
        assert iof.read_int_pair_vector(buf, binary) == pairs
        np.testing.assert_array_equal(iof.read_matrix(buf, binary), mat)
        m64 = iof.read_matrix(buf, binary)
        if binary:
            np.testing.assert_array_equal(m64, mat64)
        else:
            np.testing.assert_array_equal(m64, mat64.astype(np.float32))
        assert iof.read_matrix(buf, binary).size == 0
