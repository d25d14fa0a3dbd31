"""Reference nnet3 model files: import + export (numpy copy of
`kaldi_tpu/nnet3/mdl_io.py`).

Parity: nnet3/nnet-nnet.cc Nnet::Read/Write (the <Nnet3> container:
config lines for nodes, then serialized components),
nnet3/nnet-simple-component.cc + nnet-convolutional-component.cc
(component serialization), nnet3/am-nnet-simple.cc (.mdl =
<TransitionModel> + <Nnet3> + left/right context + priors),
nnet3/nnet-descriptor.cc (the descriptor grammar on component-node
input= fields).

The import target is an executable `Nnet3Graph`: a topologically
evaluated node DAG over (T, dim) arrays with edge-clamped time
offsets — enough to run inference for the TDNN(-F) family the chain
recipes produce (nnet3-compute equivalence on interior frames).
Component readers are token-driven so field order / optional natural-
gradient bookkeeping tokens don't break parsing.
"""

from __future__ import annotations

import re
from typing import BinaryIO, Dict, List, Optional, Sequence

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import KaldiTpuError

# --------------------------------------------------------------------------
# descriptors


class Desc:
    """Descriptor AST node."""

    def __init__(self, op: str, args: Sequence = ()):  # noqa: D401
        self.op = op          # 'node' | 'Append' | 'Offset' | 'Sum' |
        self.args = list(args)  # 'Scale' | 'Const' | 'ReplaceIndex' |
        #                         'IfDefined' | 'Round' | 'Failover'

    def __repr__(self):
        if self.op == "node":
            return self.args[0]
        if self.op == "Offset":
            return f"Offset({self.args[0]!r}, {self.args[1]})"
        if self.op == "Scale":
            return f"Scale({self.args[0]}, {self.args[1]!r})"
        if self.op == "Const":
            return f"Const({self.args[0]}, {self.args[1]})"
        if self.op == "ReplaceIndex":
            return (f"ReplaceIndex({self.args[0]!r}, {self.args[1]}, "
                    f"{self.args[2]})")
        inner = ", ".join(repr(a) for a in self.args)
        return f"{self.op}({inner})"


def _tokenize_descriptor(s: str) -> List[str]:
    return [t for t in re.findall(r"[A-Za-z_][-\w.]*|-?\d+\.?\d*|[(),]", s)]


def parse_descriptor(s: str) -> Desc:
    toks = _tokenize_descriptor(s)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def eat(t=None):
        tok = toks[pos[0]]
        if t is not None and tok != t:
            raise KaldiTpuError(f"descriptor parse: expected {t}, got {tok}"
                                f" in {s!r}")
        pos[0] += 1
        return tok

    OPS = {"Append", "Offset", "Sum", "Scale", "Const", "ReplaceIndex",
           "IfDefined", "Round", "Failover", "Switch"}

    def parse():
        tok = eat()
        if tok in OPS and peek() == "(":
            eat("(")
            args: List = []
            if tok == "Scale":
                args.append(float(eat()))
                eat(",")
                args.append(parse())
            elif tok == "Const":
                args.append(float(eat()))
                eat(",")
                args.append(int(eat()))
            elif tok == "Offset":
                args.append(parse())
                eat(",")
                args.append(int(eat()))
                if peek() == ",":   # optional x-offset, ignored
                    eat(",")
                    eat()
            elif tok == "ReplaceIndex":
                args.append(parse())
                eat(",")
                args.append(eat())      # "t" or "x"
                eat(",")
                args.append(int(eat()))
            elif tok == "Round":
                args.append(parse())
                eat(",")
                args.append(int(eat()))
            else:  # Append, Sum, IfDefined, Failover, Switch
                args.append(parse())
                while peek() == ",":
                    eat(",")
                    args.append(parse())
            eat(")")
            return Desc(tok, args)
        return Desc("node", [tok])

    d = parse()
    if pos[0] != len(toks):
        raise KaldiTpuError(f"descriptor parse: trailing tokens in {s!r}")
    return d


# --------------------------------------------------------------------------
# components (inference behavior only; training state tokens are parsed
# and kept for round-tripping but unused)

_TOKEN_KINDS = {
    # scalar bookkeeping across component types
    "<LearningRateFactor>": "float", "<LearningRate>": "float",
    "<MaxChange>": "float", "<L2Regularize>": "float",
    "<OrthonormalConstraint>": "float", "<NumSamplesHistory>": "float",
    "<Alpha>": "float", "<AlphaInOut>": "float2",
    "<Epsilon>": "float", "<TargetRms>": "float",
    "<SelfRepairScale>": "float", "<SelfRepairLowerThreshold>": "float",
    "<SelfRepairUpperThreshold>": "float", "<SelfRepairTarget>": "float",
    "<DropoutProportion>": "float", "<DimOffset>": "int",
    "<RankIn>": "int", "<RankOut>": "int", "<Rank>": "int",
    "<UpdatePeriod>": "int", "<Dim>": "int", "<BlockDim>": "int",
    "<InputDim>": "int", "<OutputDim>": "int",
    "<IsGradient>": "bool", "<UseNaturalGradient>": "bool",
    "<TestMode>": "bool", "<IsUpdatable>": "bool",
    "<Count>": "double", "<OderivCount>": "double",
    "<OderivRms>": "vector",
    "<NumDimsProcessed>": "double", "<NumDimsSelfRepaired>": "double",
    "<TimeOffsets>": "ints", "<Context>": "ints",
    "<LinearParams>": "matrix", "<Params>": "matrix",
    "<BiasParams>": "vector", "<ValueAvg>": "vector",
    "<DerivAvg>": "vector", "<OderivSumsq>": "vector",
    "<StatsMean>": "vector", "<StatsVar>": "vector",
    "<Scales>": "vector", "<Offsets>": "vector",
    # component-zoo tail (round 2)
    "<AddLogStddev>": "bool", "<ColumnMap>": "ints", "<Sizes>": "ints",
    "<Scale>": "float", "<ClippingThreshold>": "float",
    "<NormBasedClipping>": "bool",
    "<SelfRepairClippedProportionThreshold>": "float",
    "<NumElementsClipped>": "double", "<NumElementsProcessed>": "double",
    "<NumSelfRepaired>": "double", "<NumBackpropped>": "double",
    "<ZeroingThreshold>": "float", "<ZeroingInterval>": "int",
    "<RecurrenceInterval>": "int", "<NumElementsZeroed>": "double",
    "<NumZeroingBoundaries>": "double",
    "<InputPeriod>": "int", "<OutputPeriod>": "int",
    "<IncludeVarinance>": "bool",  # sic — reference's own spelling
    "<LeftContext>": "int", "<RightContext>": "int",
    "<NumLogCountFeatures>": "int", "<OutputStddevs>": "bool",
    "<VarianceFloor>": "float", "<NumBlocks>": "int",
    "<NumRepeats>": "int", "<Output>": "vector", "<Bias>": "vector",
    "<MaxMemoryMb>": "float", "<NumMinibatchesHistory>": "float",
    "<RankInOut>": "int2", "<Model>": "convmodel",
    "<ZeroedProportion>": "float", "<TimeMaskMaxFrames>": "int",
    "<Continuous>": "bool", "<MaxRowsProcess>": "int",
    # recurrent / attention / legacy-conv tail (round 3)
    "<SelfRepairConfig>": "vector", "<SelfRepairProb>": "vector",
    "<UseDropout>": "bool", "<CellDim>": "int", "<RecurrentDim>": "int",
    "<SelfRepairTotal>": "double", "<SelfRepairThreshold>": "float",
    "<NumHeads>": "int", "<KeyDim>": "int", "<ValueDim>": "int",
    "<NumLeftInputs>": "int", "<NumRightInputs>": "int",
    "<TimeStride>": "int", "<NumLeftInputsRequired>": "int",
    "<NumRightInputsRequired>": "int", "<OutputContext>": "bool",
    "<KeyScale>": "float", "<StatsCount>": "double",
    "<EntropyStats>": "vector", "<PosteriorStats>": "matrix",
    "<InputXDim>": "int", "<InputYDim>": "int", "<InputZDim>": "int",
    "<PoolXSize>": "int", "<PoolYSize>": "int", "<PoolZSize>": "int",
    "<PoolXStep>": "int", "<PoolYStep>": "int", "<PoolZStep>": "int",
    "<FiltXDim>": "int", "<FiltYDim>": "int",
    "<FiltXStep>": "int", "<FiltYStep>": "int",
    "<InputVectorization>": "int", "<FilterParams>": "matrix",
}


def _read_conv_model(stream, binary) -> Dict[str, object]:
    """convolution.cc ConvolutionModel::Read (the <ConvolutionModel>
    block nested inside TimeHeightConvolutionComponent)."""
    iof.expect_token(stream, binary, "<ConvolutionModel>")
    m: Dict[str, object] = {}
    for tok, key in (("<NumFiltersIn>", "num_filters_in"),
                     ("<NumFiltersOut>", "num_filters_out"),
                     ("<HeightIn>", "height_in"),
                     ("<HeightOut>", "height_out"),
                     ("<HeightSubsampleOut>", "height_subsample_out")):
        iof.expect_token(stream, binary, tok)
        m[key] = iof.read_int32(stream, binary)
    iof.expect_token(stream, binary, "<Offsets>")
    m["offsets"] = iof.read_int_pair_vector(stream, binary)
    iof.expect_token(stream, binary, "<RequiredTimeOffsets>")
    m["required_time_offsets"] = iof.read_int_vector(stream, binary)
    iof.expect_token(stream, binary, "</ConvolutionModel>")
    return m


def _write_conv_model(stream, binary, m: Dict[str, object]) -> None:
    iof.write_token(stream, binary, "<ConvolutionModel>")
    for tok, key in (("<NumFiltersIn>", "num_filters_in"),
                     ("<NumFiltersOut>", "num_filters_out"),
                     ("<HeightIn>", "height_in"),
                     ("<HeightOut>", "height_out"),
                     ("<HeightSubsampleOut>", "height_subsample_out")):
        iof.write_token(stream, binary, tok)
        iof.write_int32(stream, binary, int(m[key]))
    iof.write_token(stream, binary, "<Offsets>")
    iof.write_int_pair_vector(stream, binary, list(m["offsets"]))
    iof.write_token(stream, binary, "<RequiredTimeOffsets>")
    iof.write_int_vector(stream, binary,
                         list(m["required_time_offsets"]))
    iof.write_token(stream, binary, "</ConvolutionModel>")


def _read_fields(stream, binary, end_token,
                 overrides: Optional[Dict[str, str]] = None
                 ) -> Dict[str, object]:
    """Token-driven field reader until end_token."""
    fields: Dict[str, object] = {}
    while True:
        tok = iof.read_token(stream, binary)
        if tok == end_token:
            return fields
        kind = (overrides or {}).get(tok) or _TOKEN_KINDS.get(tok)
        key = tok[1:-1]
        if kind == "float" or kind == "double":
            fields[key] = iof.read_float(stream, binary)
        elif kind == "float2":
            fields[key] = (iof.read_float(stream, binary),
                           iof.read_float(stream, binary))
        elif kind == "int2":
            fields[key] = (iof.read_int32(stream, binary),
                           iof.read_int32(stream, binary))
        elif kind == "int":
            fields[key] = iof.read_int32(stream, binary)
        elif kind == "bool":
            fields[key] = iof.read_bool(stream, binary)
        elif kind == "ints":
            fields[key] = iof.read_int_vector(stream, binary)
        elif kind == "vector":
            fields[key] = iof.read_vector(stream, binary)
        elif kind == "matrix":
            fields[key] = iof.read_matrix(stream, binary)
        elif kind == "convmodel":
            fields[key] = _read_conv_model(stream, binary)
        elif tok.startswith("<Components"):  # nested NG state blocks
            continue
        else:
            raise KaldiTpuError(
                f"nnet3 import: unknown token {tok} before {end_token} "
                f"(extend _TOKEN_KINDS)")


class Component:
    TYPE = "Component"
    # per-class token-kind overrides (e.g. <Params> is a vector for
    # per-element components but a matrix for LinearComponent)
    TOKEN_OVERRIDES: Dict[str, str] = {}

    def __init__(self, **fields):
        self.fields = fields

    # -- shared serialization helpers --
    @classmethod
    def read(cls, stream, binary):
        return cls(**_read_fields(stream, binary, f"</{cls.TYPE}>",
                                  cls.TOKEN_OVERRIDES))

    def _write_fields(self, stream, binary, order: Sequence[str]):
        for key in order:
            if key not in self.fields:
                continue
            val = self.fields[key]
            tok = f"<{key}>"
            kind = self.TOKEN_OVERRIDES.get(tok) or _TOKEN_KINDS[tok]
            iof.write_token(stream, binary, tok)
            if kind == "float":
                iof.write_float(stream, binary, float(val))
            elif kind == "double":
                iof.write_double(stream, binary, float(val))
            elif kind == "int":
                iof.write_int32(stream, binary, int(val))
            elif kind == "bool":
                iof.write_bool(stream, binary, bool(val))
            elif kind == "ints":
                iof.write_int_vector(stream, binary, list(val))
            elif kind == "float2":
                iof.write_float(stream, binary, float(val[0]))
                iof.write_float(stream, binary, float(val[1]))
            elif kind == "int2":
                iof.write_int32(stream, binary, int(val[0]))
                iof.write_int32(stream, binary, int(val[1]))
            elif kind == "vector":
                iof.write_vector(stream, binary,
                                 np.asarray(val, np.float32))
            elif kind == "matrix":
                iof.write_matrix(stream, binary,
                                 np.asarray(val, np.float32))
            elif kind == "convmodel":
                _write_conv_model(stream, binary, val)

    WRITE_ORDER: Sequence[str] = ()

    def write(self, stream, binary):
        iof.write_token(stream, binary, f"<{self.TYPE}>")
        self._write_fields(stream, binary, self.WRITE_ORDER)
        iof.write_token(stream, binary, f"</{self.TYPE}>")

    # -- inference --
    def forward(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def input_dim(self) -> int:
        raise NotImplementedError


class AffineComponent(Component):
    TYPE = "AffineComponent"
    WRITE_ORDER = ("LearningRate", "LinearParams", "BiasParams")

    def forward(self, x):
        return x @ np.asarray(self.fields["LinearParams"]).T \
            + np.asarray(self.fields["BiasParams"])

    @property
    def input_dim(self):
        return np.asarray(self.fields["LinearParams"]).shape[1]


class NaturalGradientAffineComponent(AffineComponent):
    TYPE = "NaturalGradientAffineComponent"
    WRITE_ORDER = ("LearningRate", "LinearParams", "BiasParams",
                   "RankIn", "RankOut", "UpdatePeriod",
                   "NumSamplesHistory", "Alpha")


class FixedAffineComponent(AffineComponent):
    TYPE = "FixedAffineComponent"
    WRITE_ORDER = ("LinearParams", "BiasParams")


class LinearComponent(Component):
    TYPE = "LinearComponent"
    WRITE_ORDER = ("Params", "OrthonormalConstraint", "UseNaturalGradient")

    def forward(self, x):
        return x @ np.asarray(self.fields["Params"]).T

    @property
    def input_dim(self):
        return np.asarray(self.fields["Params"]).shape[1]


class TdnnComponent(Component):
    """nnet-convolutional-component.h TdnnComponent: y[t] =
    sum_k W_k x[t + offset_k] (+ bias) — the factored-TDNN workhorse."""
    TYPE = "TdnnComponent"
    WRITE_ORDER = ("TimeOffsets", "LinearParams", "BiasParams",
                   "OrthonormalConstraint", "UseNaturalGradient")

    def forward(self, x):
        offsets = list(self.fields["TimeOffsets"])
        W = np.asarray(self.fields["LinearParams"])
        T, D = x.shape
        K = len(offsets)
        assert W.shape[1] == K * D, (W.shape, K, D)
        t = np.arange(T)
        out = np.zeros((T, W.shape[0]), x.dtype)
        for k, off in enumerate(offsets):
            xk = x[np.clip(t + off, 0, T - 1)]
            out = out + xk @ W[:, k * D:(k + 1) * D].T
        bias = self.fields.get("BiasParams")
        if bias is not None and np.asarray(bias).size:
            out = out + np.asarray(bias)
        return out

    @property
    def input_dim(self):
        return (np.asarray(self.fields["LinearParams"]).shape[1]
                // len(self.fields["TimeOffsets"]))


class RectifiedLinearComponent(Component):
    TYPE = "RectifiedLinearComponent"
    WRITE_ORDER = ("Dim", "ValueAvg", "DerivAvg", "Count")

    def forward(self, x):
        return np.maximum(x, 0.0)

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class SigmoidComponent(RectifiedLinearComponent):
    TYPE = "SigmoidComponent"

    def forward(self, x):
        return 1.0 / (1.0 + np.exp(-x))


class TanhComponent(RectifiedLinearComponent):
    TYPE = "TanhComponent"

    def forward(self, x):
        return np.tanh(x)


class LogSoftmaxComponent(RectifiedLinearComponent):
    TYPE = "LogSoftmaxComponent"

    def forward(self, x):
        m = x.max(axis=-1, keepdims=True)
        e = np.exp(x - m)
        return x - m - np.log(e.sum(axis=-1, keepdims=True))


class SoftmaxComponent(RectifiedLinearComponent):
    TYPE = "SoftmaxComponent"

    def forward(self, x):
        m = x.max(axis=-1, keepdims=True)
        e = np.exp(x - m)
        return e / e.sum(axis=-1, keepdims=True)


class NoOpComponent(RectifiedLinearComponent):
    TYPE = "NoOpComponent"
    WRITE_ORDER = ("Dim",)

    def forward(self, x):
        return x


class GeneralDropoutComponent(RectifiedLinearComponent):
    TYPE = "GeneralDropoutComponent"
    WRITE_ORDER = ("Dim", "DropoutProportion")

    def forward(self, x):    # inference: identity
        return x


class DropoutComponent(GeneralDropoutComponent):
    TYPE = "DropoutComponent"


class BatchNormComponent(Component):
    TYPE = "BatchNormComponent"
    WRITE_ORDER = ("Dim", "BlockDim", "Epsilon", "TargetRms", "TestMode",
                   "Count", "StatsMean", "StatsVar")

    def forward(self, x):
        mean = np.asarray(self.fields["StatsMean"])
        var = np.asarray(self.fields["StatsVar"])
        eps = float(self.fields.get("Epsilon", 1e-3))
        target_rms = float(self.fields.get("TargetRms", 1.0))
        scale = target_rms / np.sqrt(var + eps)
        return (x - mean) * scale

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class ScaleAndOffsetComponent(Component):
    TYPE = "ScaleAndOffsetComponent"
    WRITE_ORDER = ("Dim", "Scales", "Offsets")

    def forward(self, x):
        return x * np.asarray(self.fields["Scales"]) \
            + np.asarray(self.fields["Offsets"])

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class NormalizeComponent(Component):
    """nnet-normalize-component.h:63: scale each row to target-rms,
    optionally appending log(rms) as an extra output dim."""
    TYPE = "NormalizeComponent"
    WRITE_ORDER = ("InputDim", "BlockDim", "TargetRms", "AddLogStddev")

    def forward(self, x):
        d = int(self.fields.get("BlockDim",
                                self.fields["InputDim"]))
        target_rms = float(self.fields.get("TargetRms", 1.0))
        xb = x.reshape(x.shape[0], -1, d)
        ss = np.maximum((xb * xb).sum(-1), 2.0 ** -66)
        scale = target_rms / np.sqrt(ss / d)
        scaled = xb * scale[..., None]
        if self.fields.get("AddLogStddev", False):
            # per-block interleave [block_dim values, log_stddev]
            # (nnet-normalize-component.cc:137-147: output_block_dim =
            # block_dim + 1, concatenated per block)
            log_stddev = 0.5 * np.log(ss / d)[..., None]
            return np.concatenate([scaled, log_stddev],
                                  axis=-1).reshape(x.shape[0], -1)
        return scaled.reshape(x.shape[0], -1)

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class PerElementScaleComponent(Component):
    TYPE = "PerElementScaleComponent"
    TOKEN_OVERRIDES = {"<Params>": "vector"}
    WRITE_ORDER = ("LearningRate", "Params")

    def forward(self, x):
        return x * np.asarray(self.fields["Params"])

    @property
    def input_dim(self):
        return np.asarray(self.fields["Params"]).size


class NaturalGradientPerElementScaleComponent(PerElementScaleComponent):
    TYPE = "NaturalGradientPerElementScaleComponent"
    WRITE_ORDER = ("LearningRate", "Params", "Rank", "UpdatePeriod",
                   "NumSamplesHistory", "Alpha")


class PerElementOffsetComponent(Component):
    """Offsets may be block-repeated: dim a multiple of offsets size
    (nnet-simple-component.h:1377)."""
    TYPE = "PerElementOffsetComponent"
    WRITE_ORDER = ("LearningRate", "Offsets", "Dim", "UseNaturalGradient")

    def forward(self, x):
        off = np.asarray(self.fields["Offsets"])
        if x.shape[-1] != off.size:
            off = np.tile(off, x.shape[-1] // off.size)
        return x + off

    @property
    def input_dim(self):
        return int(self.fields.get("Dim",
                                   np.asarray(self.fields["Offsets"]).size))


class PermuteComponent(Component):
    TYPE = "PermuteComponent"
    WRITE_ORDER = ("ColumnMap",)

    def forward(self, x):
        return x[:, np.asarray(self.fields["ColumnMap"], np.int64)]

    @property
    def input_dim(self):
        return len(self.fields["ColumnMap"])


class SumGroupComponent(Component):
    TYPE = "SumGroupComponent"
    WRITE_ORDER = ("Sizes",)

    def forward(self, x):
        sizes = list(self.fields["Sizes"])
        idx = np.repeat(np.arange(len(sizes)), sizes)
        out = np.zeros((x.shape[0], len(sizes)), x.dtype)
        np.add.at(out, (slice(None), idx), x)
        return out

    @property
    def input_dim(self):
        return int(sum(self.fields["Sizes"]))


class ClipGradientComponent(Component):
    """Gradient clipping only affects backprop; inference = identity."""
    TYPE = "ClipGradientComponent"
    WRITE_ORDER = ("Dim", "ClippingThreshold", "NormBasedClipping",
                   "SelfRepairClippedProportionThreshold",
                   "SelfRepairTarget", "SelfRepairScale",
                   "NumElementsClipped", "NumElementsProcessed",
                   "NumSelfRepaired", "NumBackpropped")

    def forward(self, x):
        return x

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class BackpropTruncationComponent(Component):
    """nnet-general-component.h:466: forward is y = scale * x; the
    truncation/zeroing applies to gradients only."""
    TYPE = "BackpropTruncationComponent"
    WRITE_ORDER = ("Dim", "Scale", "ClippingThreshold", "ZeroingThreshold",
                   "ZeroingInterval", "RecurrenceInterval",
                   "NumElementsClipped", "NumElementsZeroed",
                   "NumElementsProcessed", "NumZeroingBoundaries")

    def forward(self, x):
        return x * float(self.fields.get("Scale", 1.0))

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class ElementwiseProductComponent(Component):
    TYPE = "ElementwiseProductComponent"
    WRITE_ORDER = ("InputDim", "OutputDim")

    def forward(self, x):
        od = int(self.fields["OutputDim"])
        xb = x.reshape(x.shape[0], -1, od)
        return np.prod(xb, axis=1)

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class PnormComponent(Component):
    """Group 2-norm (the reference hardcodes p=2 on GPU)."""
    TYPE = "PnormComponent"
    WRITE_ORDER = ("InputDim", "OutputDim")

    def forward(self, x):
        od = int(self.fields["OutputDim"])
        xb = x.reshape(x.shape[0], od, -1)
        return np.sqrt((xb * xb).sum(-1))

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class SumBlockComponent(Component):
    TYPE = "SumBlockComponent"
    WRITE_ORDER = ("InputDim", "OutputDim", "Scale")

    def forward(self, x):
        od = int(self.fields["OutputDim"])
        scale = float(self.fields.get("Scale", 1.0))
        return x.reshape(x.shape[0], -1, od).sum(1) * scale

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class FixedScaleComponent(Component):
    TYPE = "FixedScaleComponent"
    WRITE_ORDER = ("Scales",)

    def forward(self, x):
        return x * np.asarray(self.fields["Scales"])

    @property
    def input_dim(self):
        return np.asarray(self.fields["Scales"]).size


class FixedBiasComponent(Component):
    TYPE = "FixedBiasComponent"
    WRITE_ORDER = ("Bias",)

    def forward(self, x):
        return x + np.asarray(self.fields["Bias"])

    @property
    def input_dim(self):
        return np.asarray(self.fields["Bias"]).size


class ConstantComponent(Component):
    """Output is a learned constant vector, input-independent."""
    TYPE = "ConstantComponent"
    WRITE_ORDER = ("LearningRate", "Output", "IsUpdatable",
                   "UseNaturalGradient")

    def forward(self, x):
        out = np.asarray(self.fields["Output"])
        return np.broadcast_to(out, (x.shape[0], out.size)).copy()

    @property
    def input_dim(self):
        return 0


class ConstantFunctionComponent(ConstantComponent):
    TYPE = "ConstantFunctionComponent"
    WRITE_ORDER = ("LearningRate", "InputDim", "Output", "IsUpdatable",
                   "UseNaturalGradient")

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class BlockAffineComponent(Component):
    """Block-diagonal affine: LinearParams is (output_dim,
    input_dim/num_blocks), rows grouped per block."""
    TYPE = "BlockAffineComponent"
    WRITE_ORDER = ("LearningRate", "NumBlocks", "LinearParams",
                   "BiasParams")

    def forward(self, x):
        nb = int(self.fields["NumBlocks"])
        W = np.asarray(self.fields["LinearParams"])  # (od, id/nb)
        b = np.asarray(self.fields["BiasParams"])
        od, bin_ = W.shape[0] // nb, W.shape[1]
        xb = x.reshape(x.shape[0], nb, bin_)
        Wb = W.reshape(nb, od, bin_)
        out = np.einsum("tnb,nob->tno", xb, Wb)
        return out.reshape(x.shape[0], -1) + b

    @property
    def input_dim(self):
        return np.asarray(self.fields["LinearParams"]).shape[1] * \
            int(self.fields["NumBlocks"])


class RepeatedAffineComponent(Component):
    """One small affine applied to each of num_repeats input blocks."""
    TYPE = "RepeatedAffineComponent"
    WRITE_ORDER = ("LearningRate", "NumRepeats", "LinearParams",
                   "BiasParams")

    def forward(self, x):
        nr = int(self.fields["NumRepeats"])
        W = np.asarray(self.fields["LinearParams"])  # (od, id) per block
        b = np.asarray(self.fields["BiasParams"])
        xb = x.reshape(x.shape[0], nr, W.shape[1])
        out = np.einsum("tnb,ob->tno", xb, W) + b
        return out.reshape(x.shape[0], -1)

    @property
    def input_dim(self):
        return np.asarray(self.fields["LinearParams"]).shape[1] * \
            int(self.fields["NumRepeats"])


class NaturalGradientRepeatedAffineComponent(RepeatedAffineComponent):
    TYPE = "NaturalGradientRepeatedAffineComponent"


class StatisticsExtractionComponent(Component):
    """nnet-general-component.h:163: per output frame, [count, sum x,
    (sum x^2)] over the input frames it covers."""
    TYPE = "StatisticsExtractionComponent"
    WRITE_ORDER = ("InputDim", "InputPeriod", "OutputPeriod",
                   "IncludeVarinance")

    def forward(self, x):
        T, D = x.shape
        ip = int(self.fields.get("InputPeriod", 1))
        op = int(self.fields.get("OutputPeriod", 1))
        k = max(op // ip, 1)
        var = bool(self.fields.get("IncludeVarinance", True))
        out_dim = 1 + D + (D if var else 0)
        out = np.zeros((T, out_dim), x.dtype)
        for t in range(T):
            sel = x[t:min(t + k, T)]
            out[t, 0] = sel.shape[0]
            out[t, 1:1 + D] = sel.sum(0)
            if var:
                out[t, 1 + D:] = (sel * sel).sum(0)
        return out

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class StatisticsPoolingComponent(Component):
    """nnet-general-component.h:276: aggregate extraction stats over
    [t-left, t+right] -> [log-count x n, mean, (stddev)].  The
    reference stores LeftContext >= 0 (nnet-general-component.cc:595)
    and pools t_start = t - left_context (cc:685)."""
    TYPE = "StatisticsPoolingComponent"
    WRITE_ORDER = ("InputDim", "InputPeriod", "LeftContext",
                   "RightContext", "NumLogCountFeatures", "OutputStddevs",
                   "VarianceFloor")

    def forward(self, x):
        T, SD = x.shape
        ip = int(self.fields.get("InputPeriod", 1))
        left = int(self.fields["LeftContext"])
        right = int(self.fields["RightContext"])
        nlog = int(self.fields.get("NumLogCountFeatures", 0))
        stddevs = bool(self.fields.get("OutputStddevs", True))
        floor = float(self.fields.get("VarianceFloor", 1e-10))
        D = (SD - 1) // 2 if stddevs else SD - 1
        out_dim = nlog + D + (D if stddevs else 0)
        out = np.zeros((T, out_dim), x.dtype)
        for t in range(T):
            lo, hi = max(0, t - left), min(T - 1, t + right)
            ts = [tt for tt in range(lo, hi + 1) if tt % ip == 0]
            if not ts:
                ts = [min(max(lo, 0), T - 1)]
            stats = x[ts].sum(0)
            count = max(stats[0], 1e-10)
            mean = stats[1:1 + D] / count
            cols = [np.full(nlog, np.log(count))] if nlog else []
            cols.append(mean)
            if stddevs:
                var = stats[1 + D:1 + 2 * D] / count - mean * mean
                cols.append(np.sqrt(np.maximum(var, floor)))
            out[t] = np.concatenate(cols)
        return out

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


class TimeHeightConvolutionComponent(Component):
    """nnet-convolutional-component.h:212: general 2-D convolution over
    (time, height) with explicit (time-offset, height-offset) taps.
    LinearParams rows = filters-out; columns grouped per tap as
    filters-in. Out-of-range height taps contribute zero; time is
    edge-clamped (the reference arranges real context via the
    compiler's t-range bookkeeping)."""
    TYPE = "TimeHeightConvolutionComponent"
    WRITE_ORDER = ("LearningRate", "Model", "LinearParams", "BiasParams",
                   "MaxMemoryMb", "UseNaturalGradient",
                   "NumMinibatchesHistory", "AlphaInOut", "RankInOut")

    def forward(self, x):
        m = self.fields["Model"]
        fin, fout = m["num_filters_in"], m["num_filters_out"]
        hin, hout = m["height_in"], m["height_out"]
        sub = m["height_subsample_out"]
        offsets = m["offsets"]
        W = np.asarray(self.fields["LinearParams"])
        b = np.asarray(self.fields["BiasParams"])
        T = x.shape[0]
        xb = x.reshape(T, hin, fin)
        t_idx = np.arange(T)
        h_out = np.arange(hout)
        out = np.zeros((T, hout, fout), x.dtype)
        for k, (dt, dh) in enumerate(offsets):
            Wk = W[:, k * fin:(k + 1) * fin]          # (fout, fin)
            h_src = h_out * sub + dh
            valid = (h_src >= 0) & (h_src < hin)
            if not valid.any():
                continue
            xt = xb[np.clip(t_idx + dt, 0, T - 1)]    # (T, hin, fin)
            src = xt[:, np.clip(h_src, 0, hin - 1), :]
            src = np.where(valid[None, :, None], src, 0.0)
            out += np.einsum("thf,of->tho", src, Wk)
        if b.size == fout:
            out = out + b.reshape(1, 1, -1)
        elif b.size:
            out = out + b.reshape(1, hout, fout)
        return out.reshape(T, hout * fout)

    @property
    def input_dim(self):
        m = self.fields["Model"]
        return m["height_in"] * m["num_filters_in"]


class SpecAugmentTimeMaskComponent(Component):
    """Training-time augmentation; inference = identity
    (nnet-general-component.h SpecAugmentTimeMaskComponent)."""
    TYPE = "SpecAugmentTimeMaskComponent"
    WRITE_ORDER = ("Dim", "ZeroedProportion", "TimeMaskMaxFrames",
                   "TestMode")

    def forward(self, x):
        return x

    @property
    def input_dim(self):
        return int(self.fields["Dim"])


class DropoutMaskComponent(Component):
    """Outputs a dropout mask; in test mode (inference) all ones."""
    TYPE = "DropoutMaskComponent"
    WRITE_ORDER = ("OutputDim", "DropoutProportion", "TestMode",
                   "Continuous")

    def forward(self, x):
        return np.ones((x.shape[0], int(self.fields["OutputDim"])),
                       np.float32)

    @property
    def input_dim(self):
        return 0


class CompositeComponent(Component):
    """Sequence of sub-components applied as one
    (nnet-simple-component.h CompositeComponent)."""
    TYPE = "CompositeComponent"

    def __init__(self, sub_components=None, **fields):
        super().__init__(**fields)
        self.sub_components = sub_components or []

    @classmethod
    def read(cls, stream, binary):
        fields: Dict[str, object] = {}
        # WriteUpdatableCommon emits <LearningRate> etc. first
        while True:
            tok = iof.read_token(stream, binary)
            if tok == "<MaxRowsProcess>":
                fields["MaxRowsProcess"] = iof.read_int32(stream, binary)
                break
            kind = _TOKEN_KINDS.get(tok)
            if kind == "float":
                fields[tok[1:-1]] = iof.read_float(stream, binary)
            elif kind == "bool":
                fields[tok[1:-1]] = iof.read_bool(stream, binary)
            else:
                raise KaldiTpuError(
                    f"CompositeComponent: unexpected token {tok}")
        iof.expect_token(stream, binary, "<NumComponents>")
        n = iof.read_int32(stream, binary)
        subs = []
        for _ in range(n):
            type_tok = iof.read_token(stream, binary)
            ctor = COMPONENT_TYPES.get(type_tok[1:-1])
            if ctor is None:
                raise KaldiTpuError(
                    f"CompositeComponent: unsupported sub-component "
                    f"{type_tok}")
            subs.append(ctor.read(stream, binary))
        iof.expect_token(stream, binary, "</CompositeComponent>")
        return cls(sub_components=subs, **fields)

    def write(self, stream, binary):
        iof.write_token(stream, binary, f"<{self.TYPE}>")
        if "LearningRate" in self.fields:
            iof.write_token(stream, binary, "<LearningRate>")
            iof.write_float(stream, binary,
                            float(self.fields["LearningRate"]))
        iof.write_token(stream, binary, "<MaxRowsProcess>")
        iof.write_int32(stream, binary,
                        int(self.fields.get("MaxRowsProcess", 4096)))
        iof.write_token(stream, binary, "<NumComponents>")
        iof.write_int32(stream, binary, len(self.sub_components))
        for c in self.sub_components:
            c.write(stream, binary)
        iof.write_token(stream, binary, f"</{self.TYPE}>")

    def forward(self, x):
        for c in self.sub_components:
            x = c.forward(x)
        return x

    @property
    def input_dim(self):
        return self.sub_components[0].input_dim


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class LstmNonlinearityComponent(Component):
    """nnet-combined-component.h:335 / cu-math.h ComputeLstmNonlinearity:
    input (T, 5C [+3 dropout masks]) interpreted as
    (i_part, f_part, c_part, o_part, c_{t-1}) -> output (T, 2C) =
    (c_t, m_t):
        i_t = Sigmoid(i_part + w_ic * c_{t-1})
        f_t = Sigmoid(f_part + w_fc * c_{t-1})
        c_t = f_t * c_{t-1} + i_t * Tanh(c_part)
        o_t = Sigmoid(o_part + w_oc * c_t)
        m_t = o_t * Tanh(c_t)
    Params is (3, C): rows w_ic, w_fc, w_oc.  The recurrence on
    c_{t-1} is resolved by the surrounding graph (IfDefined/Offset
    descriptors), so this forward is per-frame."""
    TYPE = "LstmNonlinearityComponent"
    TOKEN_OVERRIDES = {"<Params>": "matrix", "<ValueAvg>": "matrix",
                       "<DerivAvg>": "matrix"}
    WRITE_ORDER = ("LearningRate", "Params", "ValueAvg", "DerivAvg",
                   "SelfRepairConfig", "SelfRepairProb", "UseDropout",
                   "Count")

    def forward(self, x):
        W = np.asarray(self.fields["Params"])        # (3, C)
        C = W.shape[1]
        use_dropout = bool(self.fields.get("UseDropout", False))
        expect = 5 * C + (3 if use_dropout else 0)
        if x.shape[1] != expect:
            raise KaldiTpuError(
                f"LstmNonlinearity: input dim {x.shape[1]} != {expect}")
        i_part, f_part, c_part, o_part, c_prev = (
            x[:, k * C:(k + 1) * C] for k in range(5))
        i_t = _sigmoid(i_part + W[0] * c_prev)
        f_t = _sigmoid(f_part + W[1] * c_prev)
        if use_dropout:
            i_t = i_t * x[:, 5 * C:5 * C + 1]
            f_t = f_t * x[:, 5 * C + 1:5 * C + 2]
        c_t = f_t * c_prev + i_t * np.tanh(c_part)
        o_t = _sigmoid(o_part + W[2] * c_t)
        if use_dropout:
            o_t = o_t * x[:, 5 * C + 2:5 * C + 3]
        m_t = o_t * np.tanh(c_t)
        return np.concatenate([c_t, m_t], axis=-1)

    @property
    def input_dim(self):
        C = np.asarray(self.fields["Params"]).shape[1]
        return 5 * C + (3 if self.fields.get("UseDropout", False) else 0)


class GruNonlinearityComponent(Component):
    """nnet-combined-component.h:713 (projected GRU inner function):
    input (z_t, r_t, hpart_t, c_{t-1}, s_{t-1}) of dims
    (C, R, C, C, R) -> output (h_t, c_t) of dims (C, C):
        h_t = tanh(hpart_t + W^h (s_{t-1} . r_t))
        c_t = (1 - z_t) . h_t + z_t . c_{t-1}
    Non-projected GRU is the special case R == C with s == c == y."""
    TYPE = "GruNonlinearityComponent"
    TOKEN_OVERRIDES = {"<w_h>": "matrix"}
    WRITE_ORDER = ("LearningRate", "CellDim", "RecurrentDim", "w_h",
                   "ValueAvg", "DerivAvg", "SelfRepairTotal", "Count",
                   "SelfRepairThreshold", "SelfRepairScale", "Alpha",
                   "RankIn", "RankOut", "UpdatePeriod")

    def forward(self, x):
        C = int(self.fields["CellDim"])
        R = int(self.fields["RecurrentDim"])
        W = np.asarray(self.fields["w_h"])           # (C, R)
        if x.shape[1] != 3 * C + 2 * R:
            raise KaldiTpuError(
                f"GruNonlinearity: input dim {x.shape[1]} != "
                f"{3 * C + 2 * R}")
        z = x[:, :C]
        r = x[:, C:C + R]
        hpart = x[:, C + R:2 * C + R]
        c_prev = x[:, 2 * C + R:3 * C + R]
        s_prev = x[:, 3 * C + R:]
        h = np.tanh(hpart + (s_prev * r) @ W.T)
        c = (1.0 - z) * h + z * c_prev
        return np.concatenate([h, c], axis=-1)

    @property
    def input_dim(self):
        return 3 * int(self.fields["CellDim"]) + \
            2 * int(self.fields["RecurrentDim"])


class OutputGruNonlinearityComponent(Component):
    """nnet-combined-component.h:979: input (z_t, hpart_t, c_{t-1})
    -> (h_t, c_t) with DIAGONAL w_h:
        h_t = tanh(hpart_t + w_h . c_{t-1})
        c_t = (1 - z_t) . h_t + z_t . c_{t-1}"""
    TYPE = "OutputGruNonlinearityComponent"
    TOKEN_OVERRIDES = {"<w_h>": "vector"}
    WRITE_ORDER = ("LearningRate", "CellDim", "w_h", "ValueAvg",
                   "DerivAvg", "SelfRepairTotal", "Count",
                   "SelfRepairThreshold", "SelfRepairScale", "Alpha",
                   "Rank", "UpdatePeriod")

    def forward(self, x):
        C = int(self.fields["CellDim"])
        w = np.asarray(self.fields["w_h"])
        if x.shape[1] != 3 * C:
            raise KaldiTpuError(
                f"OutputGruNonlinearity: input dim {x.shape[1]} != "
                f"{3 * C}")
        z, hpart, c_prev = x[:, :C], x[:, C:2 * C], x[:, 2 * C:]
        h = np.tanh(hpart + w * c_prev)
        c = (1.0 - z) * h + z * c_prev
        return np.concatenate([h, c], axis=-1)

    @property
    def input_dim(self):
        return 3 * int(self.fields["CellDim"])


class RestrictedAttentionComponent(Component):
    """nnet-attention-component.h:106 + attention.cc AttentionForward.
    Per head, input block = (key, value, query) with query_dim =
    key_dim + context_dim; scores over positions m in
    [-num_left_inputs, num_right_inputs] at time_stride spacing:
        b_m = key_scale * q[:key_dim] . k_{t+m*stride} + q[key_dim+m']
        c = softmax(b);  out = sum_m c_m * v_{t+m*stride} [, c]
    Time indexes are edge-clamped (this importer's convention for
    boundary context; interior frames match the reference)."""
    TYPE = "RestrictedAttentionComponent"
    WRITE_ORDER = ("NumHeads", "KeyDim", "ValueDim", "NumLeftInputs",
                   "NumRightInputs", "TimeStride",
                   "NumLeftInputsRequired", "NumRightInputsRequired",
                   "OutputContext", "KeyScale", "StatsCount",
                   "EntropyStats", "PosteriorStats")

    def forward(self, x):
        f = self.fields
        H = int(f["NumHeads"])
        kd = int(f["KeyDim"])
        vd = int(f["ValueDim"])
        L = int(f["NumLeftInputs"])
        R = int(f["NumRightInputs"])
        stride = int(f["TimeStride"])
        out_ctx = bool(f.get("OutputContext", False))
        key_scale = float(f.get("KeyScale", 1.0))
        ctx = L + 1 + R
        qd = kd + ctx
        T = x.shape[0]
        blk = kd + vd + qd
        if x.shape[1] != H * blk:
            raise KaldiTpuError(
                f"RestrictedAttention: input dim {x.shape[1]} != "
                f"{H * blk}")
        t_idx = np.arange(T)
        outs = []
        for h in range(H):
            xb = x[:, h * blk:(h + 1) * blk]
            keys = xb[:, :kd]
            values = xb[:, kd:kd + vd]
            query = xb[:, kd + vd:]
            q_key, q_ctx = query[:, :kd], query[:, kd:]
            scores = np.empty((T, ctx), x.dtype)
            for m in range(ctx):
                src = np.clip(t_idx + (m - L) * stride, 0, T - 1)
                scores[:, m] = key_scale * (q_key * keys[src]).sum(-1) \
                    + q_ctx[:, m]
            mmax = scores.max(axis=1, keepdims=True)
            e = np.exp(scores - mmax)
            c = e / e.sum(axis=1, keepdims=True)
            out = np.zeros((T, vd), x.dtype)
            for m in range(ctx):
                src = np.clip(t_idx + (m - L) * stride, 0, T - 1)
                out += c[:, m:m + 1] * values[src]
            outs.append(np.concatenate([out, c], -1) if out_ctx else out)
        return np.concatenate(outs, axis=-1)

    @property
    def input_dim(self):
        f = self.fields
        ctx = int(f["NumLeftInputs"]) + 1 + int(f["NumRightInputs"])
        return int(f["NumHeads"]) * (2 * int(f["KeyDim"]) + ctx
                                     + int(f["ValueDim"]))


class DistributeComponent(Component):
    """nnet-general-component.h:56: splits an n*output_dim input
    across n different 'x' indexes.  This importer's evaluator has no
    x axis; the n == 1 case (identity) is supported, larger n raises
    (the component only appears in multi-stream e2e setups)."""
    TYPE = "DistributeComponent"
    WRITE_ORDER = ("InputDim", "OutputDim")

    def forward(self, x):
        din = int(self.fields["InputDim"])
        dout = int(self.fields["OutputDim"])
        if din == dout:
            return x
        raise KaldiTpuError(
            "DistributeComponent with input_dim != output_dim needs "
            "x-index routing, which this evaluator does not model")

    @property
    def input_dim(self):
        return int(self.fields["InputDim"])


def _zyx_index(xx, yy, zz, ydim, zdim):
    return (ydim * zdim) * xx + zdim * yy + zz


class MaxpoolingComponent(Component):
    """nnet-combined-component.h:488: 3-D max pooling over a zyx-
    vectorized (x, y, z) tensor per frame."""
    TYPE = "MaxpoolingComponent"
    WRITE_ORDER = ("InputXDim", "InputYDim", "InputZDim",
                   "PoolXSize", "PoolYSize", "PoolZSize",
                   "PoolXStep", "PoolYStep", "PoolZStep")

    def _dims(self):
        f = self.fields
        return tuple(int(f[k]) for k in self.WRITE_ORDER)

    def forward(self, x):
        ix, iy, iz, px, py, pz, sx, sy, sz = self._dims()
        nx = 1 + (ix - px) // sx
        ny = 1 + (iy - py) // sy
        nz = 1 + (iz - pz) // sz
        T = x.shape[0]
        xt = x.reshape(T, ix, iy, iz)
        out = np.full((T, nx, ny, nz), -1e20, x.dtype)
        for dx in range(px):
            for dy in range(py):
                for dz in range(pz):
                    sub = xt[:,
                             dx:dx + nx * sx:sx,
                             dy:dy + ny * sy:sy,
                             dz:dz + nz * sz:sz]
                    out = np.maximum(out, sub)
        return out.reshape(T, nx * ny * nz)

    @property
    def input_dim(self):
        ix, iy, iz = self._dims()[:3]
        return ix * iy * iz


class ConvolutionComponent(Component):
    """nnet-combined-component.h ConvolutionComponent (legacy 2-D conv
    over (x, y) with z input channels; zyx or yzx vectorization).
    Output is zyx-vectorized (x_step, y_step, filter)."""
    TYPE = "ConvolutionComponent"
    WRITE_ORDER = ("LearningRate", "InputXDim", "InputYDim", "InputZDim",
                   "FiltXDim", "FiltYDim", "FiltXStep", "FiltYStep",
                   "InputVectorization", "FilterParams", "BiasParams")

    def forward(self, x):
        f = self.fields
        ix, iy, iz = (int(f[k]) for k in
                      ("InputXDim", "InputYDim", "InputZDim"))
        fx, fy = int(f["FiltXDim"]), int(f["FiltYDim"])
        sx, sy = int(f["FiltXStep"]), int(f["FiltYStep"])
        vec = int(f.get("InputVectorization", 0))  # 0=zyx, 1=yzx
        W = np.asarray(f["FilterParams"])          # (nf, fx*fy*iz)
        bias = np.asarray(f["BiasParams"])
        nf = W.shape[0]
        nx = 1 + (ix - fx) // sx
        ny = 1 + (iy - fy) // sy
        T = x.shape[0]
        if vec == 0:
            xt = x.reshape(T, ix, iy, iz)
        else:                                       # yzx: idx = x*(y*z)
            # YzxVectorIndex = (iy*iz)*x + iy*z + y
            xt = x.reshape(T, ix, iz, iy).transpose(0, 1, 3, 2)
        out = np.empty((T, nx, ny, nf), x.dtype)
        for xs in range(nx):
            for ys in range(ny):
                patch = xt[:, xs * sx:xs * sx + fx,
                           ys * sy:ys * sy + fy, :].reshape(T, -1)
                out[:, xs, ys, :] = patch @ W.T + bias
        return out.reshape(T, nx * ny * nf)

    @property
    def input_dim(self):
        f = self.fields
        return int(f["InputXDim"]) * int(f["InputYDim"]) * \
            int(f["InputZDim"])


COMPONENT_TYPES = {c.TYPE: c for c in [
    AffineComponent, NaturalGradientAffineComponent, FixedAffineComponent,
    LinearComponent, TdnnComponent, RectifiedLinearComponent,
    SigmoidComponent, TanhComponent, LogSoftmaxComponent, SoftmaxComponent,
    NoOpComponent, BatchNormComponent, GeneralDropoutComponent,
    DropoutComponent, ScaleAndOffsetComponent,
    NormalizeComponent, PerElementScaleComponent,
    NaturalGradientPerElementScaleComponent, PerElementOffsetComponent,
    PermuteComponent, SumGroupComponent, ClipGradientComponent,
    BackpropTruncationComponent, ElementwiseProductComponent,
    PnormComponent, SumBlockComponent, FixedScaleComponent,
    FixedBiasComponent, ConstantComponent, ConstantFunctionComponent,
    BlockAffineComponent, RepeatedAffineComponent,
    NaturalGradientRepeatedAffineComponent,
    StatisticsExtractionComponent, StatisticsPoolingComponent,
    TimeHeightConvolutionComponent, SpecAugmentTimeMaskComponent,
    DropoutMaskComponent, CompositeComponent,
    LstmNonlinearityComponent, GruNonlinearityComponent,
    OutputGruNonlinearityComponent, RestrictedAttentionComponent,
    DistributeComponent, MaxpoolingComponent, ConvolutionComponent,
]}


# --------------------------------------------------------------------------
# the network container


class Node:
    def __init__(self, kind: str, name: str, dim: int = 0,
                 component: str = "", desc: Optional[Desc] = None,
                 dim_offset: int = 0, objective: str = "linear"):
        self.kind = kind            # input | component | output | dim-range
        self.name = name
        self.dim = dim
        self.component = component
        self.desc = desc
        self.dim_offset = dim_offset
        self.objective = objective

    def config_line(self) -> str:
        if self.kind == "input":
            return f"input-node name={self.name} dim={self.dim}"
        if self.kind == "component":
            return (f"component-node name={self.name} "
                    f"component={self.component} input={self.desc!r}")
        if self.kind == "output":
            return (f"output-node name={self.name} input={self.desc!r} "
                    f"objective={self.objective}")
        return (f"dim-range-node name={self.name} input-node="
                f"{self.desc!r} dim={self.dim} dim-offset={self.dim_offset}")


def _desc_refs(d: Desc) -> List[str]:
    """Node names referenced by a descriptor."""
    if d.op == "node":
        return [d.args[0]]
    out: List[str] = []
    for a in d.args:
        if isinstance(a, Desc):
            out.extend(_desc_refs(a))
    return out


# components whose forward() is a pure per-frame function (safe to
# call row-by-row inside a recurrent loop)
_PER_FRAME_SAFE = {
    "AffineComponent", "NaturalGradientAffineComponent",
    "FixedAffineComponent", "LinearComponent",
    "RectifiedLinearComponent", "SigmoidComponent", "TanhComponent",
    "LogSoftmaxComponent", "SoftmaxComponent", "NoOpComponent",
    "BatchNormComponent", "GeneralDropoutComponent", "DropoutComponent",
    "ScaleAndOffsetComponent", "NormalizeComponent",
    "PerElementScaleComponent", "NaturalGradientPerElementScaleComponent",
    "PerElementOffsetComponent", "PermuteComponent", "SumGroupComponent",
    "ClipGradientComponent", "BackpropTruncationComponent",
    "ElementwiseProductComponent", "PnormComponent", "SumBlockComponent",
    "FixedScaleComponent", "FixedBiasComponent", "ConstantComponent",
    "ConstantFunctionComponent", "BlockAffineComponent",
    "RepeatedAffineComponent", "NaturalGradientRepeatedAffineComponent",
    "LstmNonlinearityComponent", "GruNonlinearityComponent",
    "OutputGruNonlinearityComponent", "DistributeComponent",
    "MaxpoolingComponent",
}


class Nnet3Graph:
    """Executable nnet3 network (nodes + components).

    Supports RECURRENT graphs (TDNN-LSTM/GRU: cycles through
    IfDefined(Offset(..., -k)) descriptors): nodes on cycles are
    evaluated frame-by-frame with zero initial state (the reference's
    t < 0 undefined -> zero of IfDefined), everything else is
    evaluated as whole (T, dim) arrays in condensation order."""

    def __init__(self, nodes: List[Node],
                 components: Dict[str, Component]):
        self.nodes = nodes
        self.node_of = {n.name: n for n in nodes}
        self.components = components

    # -- evaluation -------------------------------------------------------

    def _recurrent_nodes(self) -> set:
        """Names of nodes on dependency cycles (Tarjan SCC)."""
        names = [n.name for n in self.nodes]
        edges = {}
        for n in self.nodes:
            refs = _desc_refs(n.desc) if n.desc is not None else []
            edges[n.name] = [r for r in refs if r in self.node_of]
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        onstack: Dict[str, bool] = {}
        stack: List[str] = []
        counter = [0]
        result: set = set()

        def strongconnect(v):
            # iterative Tarjan (configs can be deep)
            work = [(v, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    onstack[node] = True
                recurse = False
                deps = edges.get(node, [])
                for i in range(pi, len(deps)):
                    w = deps[i]
                    if w not in index:
                        work[-1] = (node, i + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    elif onstack.get(w):
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack[w] = False
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1 or node in edges.get(node, []):
                        result.update(scc)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for v in names:
            if v not in index:
                strongconnect(v)
        return result

    def forward(self, feats: np.ndarray,
                ivector: Optional[np.ndarray] = None,
                output_name: str = "output") -> np.ndarray:
        """(T, D) features -> (T, out_dim). Time offsets are edge-
        clamped (equivalent to the reference's replicated extra
        context at utterance boundaries); recurrent references before
        t=0 are zero (IfDefined semantics)."""
        recurrent = self._recurrent_nodes()
        if recurrent:
            return self._forward_recurrent(feats, ivector, output_name,
                                           recurrent)
        cache: Dict[str, np.ndarray] = {}
        eval_node = self._make_array_evaluator(feats, ivector, cache)
        return eval_node(output_name)

    def _make_array_evaluator(self, feats, ivector,
                              cache: Dict[str, np.ndarray]):
        """Whole-(T, dim) lazy node evaluator over a shared cache."""
        T = feats.shape[0]

        def eval_node(name: str) -> np.ndarray:
            if name in cache:
                return cache[name]
            node = self.node_of.get(name)
            if node is None:
                raise KaldiTpuError(f"nnet3 forward: no node {name!r}")
            if node.kind == "input":
                if name == "input":
                    val = feats
                elif name == "ivector":
                    if ivector is None:
                        raise KaldiTpuError("model needs an ivector input")
                    val = np.broadcast_to(
                        np.atleast_2d(ivector)[0], (T, node.dim))
                else:
                    raise KaldiTpuError(f"unknown input node {name!r}")
            elif node.kind == "component":
                x = eval_desc(node.desc)
                val = self.components[node.component].forward(x)
            elif node.kind == "dim-range":
                x = eval_node(node.desc.args[0])
                val = x[:, node.dim_offset:node.dim_offset + node.dim]
            else:  # output
                val = eval_desc(node.desc)
            cache[name] = val
            return val

        t_idx = np.arange(T)

        def eval_desc(d: Desc) -> np.ndarray:
            if d.op == "node":
                return eval_node(d.args[0])
            if d.op == "Append":
                return np.concatenate([eval_desc(a) for a in d.args],
                                      axis=-1)
            if d.op == "Offset":
                arr = eval_desc(d.args[0])
                return arr[np.clip(t_idx + d.args[1], 0, T - 1)]
            if d.op == "Sum":
                out = eval_desc(d.args[0])
                for a in d.args[1:]:
                    out = out + eval_desc(a)
                return out
            if d.op == "Scale":
                return d.args[0] * eval_desc(d.args[1])
            if d.op == "Const":
                return np.full((T, d.args[1]), d.args[0], np.float32)
            if d.op == "ReplaceIndex":
                arr = eval_desc(d.args[0])
                return np.broadcast_to(
                    arr[np.clip(d.args[2], 0, T - 1)], arr.shape)
            if d.op in ("IfDefined", "Failover", "Switch"):
                return eval_desc(d.args[0])
            if d.op == "Round":
                arr = eval_desc(d.args[0])
                return arr[(t_idx // d.args[1]) * d.args[1]]
            raise KaldiTpuError(f"unsupported descriptor op {d.op}")

        return eval_node

    # -- recurrent evaluation ----------------------------------------

    def _forward_recurrent(self, feats, ivector, output_name,
                           recurrent: set) -> np.ndarray:
        """Frame-by-frame evaluation of the recurrent node group with
        zero initial state; everything else whole-array."""
        T = feats.shape[0]
        # the per-frame group: recurrent nodes plus acyclic nodes
        # sandwiched between recurrent ones (depend on AND feed them)
        deps = {n.name: [r for r in (_desc_refs(n.desc)
                                     if n.desc is not None else [])
                         if r in self.node_of]
                for n in self.nodes}

        def reachable(starts, graph):
            seen = set(starts)
            work = list(starts)
            while work:
                v = work.pop()
                for w in graph.get(v, []):
                    if w not in seen:
                        seen.add(w)
                        work.append(w)
            return seen

        rev = {}
        for v, ws in deps.items():
            for w in ws:
                rev.setdefault(w, []).append(v)
        depends_on_r = reachable(recurrent, rev)     # nodes fed by R
        feeds_r = reachable(recurrent, deps)         # nodes feeding R
        group = recurrent | (depends_on_r & feeds_r)

        cache: Dict[str, np.ndarray] = {}
        array_eval = self._make_array_evaluator(feats, ivector, cache)
        group_done = [False]

        def array_of(name: str) -> np.ndarray:
            if name in group and not group_done[0]:
                raise KaldiTpuError(
                    f"nnet3 recurrent eval: node {name!r} both feeds "
                    f"and follows the recurrence in an unsupported way")
            return array_eval(name)

        # output dims + per-frame-safety check for group nodes
        dims: Dict[str, int] = {}
        for name in group:
            node = self.node_of[name]
            if node.kind == "component":
                comp = self.components[node.component]
                if type(comp).TYPE not in _PER_FRAME_SAFE:
                    raise KaldiTpuError(
                        f"component {node.component} of type "
                        f"{type(comp).TYPE} is on a recurrence cycle "
                        f"but is not a per-frame function")
                probe = np.zeros((1, comp.input_dim), np.float32)
                dims[name] = comp.forward(probe).shape[1]
            elif node.kind == "dim-range":
                dims[name] = node.dim
            elif node.kind == "input":
                dims[name] = node.dim
            else:
                raise KaldiTpuError(
                    f"output node {name!r} on a recurrence cycle")
        buffers = {name: np.zeros((T, dims[name]), np.float32)
                   for name in group}

        cur_t = [0]
        frame_cache: Dict[str, np.ndarray] = {}
        in_progress: set = set()

        def row_of(name: str, t: int):
            """-> (row (dim,), defined: bool)."""
            if name in group:
                if t < 0 or t >= T:
                    return np.zeros(dims[name], np.float32), False
                if t < cur_t[0]:
                    return buffers[name][t], True
                if t > cur_t[0]:
                    raise KaldiTpuError(
                        f"non-causal recurrence: {name} needed at "
                        f"t={t} while computing t={cur_t[0]}")
                if name in frame_cache:
                    return frame_cache[name], True
                if name in in_progress:
                    raise KaldiTpuError(
                        f"zero-delay recurrence cycle at {name!r}")
                in_progress.add(name)
                node = self.node_of[name]
                if node.kind == "component":
                    x, _ = desc_row(node.desc, t)
                    val = self.components[node.component].forward(
                        x[None])[0]
                elif node.kind == "dim-range":
                    src, _ = row_of(node.desc.args[0], t)
                    val = src[node.dim_offset:
                              node.dim_offset + node.dim]
                else:                      # input node inside group
                    val = array_of(name)[min(max(t, 0), T - 1)]
                in_progress.discard(name)
                frame_cache[name] = val
                return val, True
            # non-group refs use the importer's edge-clamp convention
            # (same as the acyclic evaluator); only recurrent refs
            # zero-fill before t=0
            arr = array_of(name)
            return arr[min(max(t, 0), T - 1)], True

        def desc_row(d: Desc, t: int):
            if d.op == "node":
                return row_of(d.args[0], t)
            if d.op == "Offset":
                return desc_row(d.args[0], t + d.args[1])
            if d.op == "Append":
                parts = [desc_row(a, t) for a in d.args]
                return (np.concatenate([p[0] for p in parts]),
                        all(p[1] for p in parts))
            if d.op == "Sum":
                parts = [desc_row(a, t) for a in d.args]
                out = parts[0][0]
                for p in parts[1:]:
                    out = out + p[0]
                return out, all(p[1] for p in parts)
            if d.op == "Scale":
                v, ok = desc_row(d.args[1], t)
                return d.args[0] * v, ok
            if d.op == "Const":
                return (np.full(d.args[1], d.args[0], np.float32),
                        True)
            if d.op == "ReplaceIndex":
                return desc_row(d.args[0], int(d.args[2]))
            if d.op == "Round":
                k = d.args[1]
                return desc_row(d.args[0], (t // k) * k)
            if d.op == "IfDefined":
                v, ok = desc_row(d.args[0], t)
                return (v if ok else np.zeros_like(v)), True
            if d.op == "Failover":
                v, ok = desc_row(d.args[0], t)
                if ok:
                    return v, True
                return desc_row(d.args[1], t)
            if d.op == "Switch":
                return desc_row(d.args[0], t)
            raise KaldiTpuError(f"unsupported descriptor op {d.op}")

        for t in range(T):
            cur_t[0] = t
            frame_cache.clear()
            for name in group:
                buffers[name][t], _ = row_of(name, t)
        group_done[0] = True
        cache.update(buffers)
        return array_eval(output_name)

    @property
    def output_dim(self) -> int:
        for n in self.nodes:
            if n.kind == "output" and n.name == "output":
                d = n.desc
                while d.op != "node":
                    d = d.args[-1] if d.op != "Scale" else d.args[1]
                src = self.node_of[d.args[0]]
                if src.kind == "component":
                    comp = self.components[src.component]
                    probe = np.zeros((3, comp.input_dim), np.float32)
                    return comp.forward(probe).shape[1]
                return src.dim
        raise KaldiTpuError("no output node")

    # -- serialization ------------------------------------------------------

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<Nnet3>")
        stream.write(b"\n")
        for n in self.nodes:
            stream.write(n.config_line().encode() + b"\n")
        stream.write(b"\n")
        iof.write_token(stream, binary, "<NumComponents>")
        iof.write_int32(stream, binary, len(self.components))
        for name, comp in self.components.items():
            iof.write_token(stream, binary, "<ComponentName>")
            iof.write_token(stream, binary, name)
            comp.write(stream, binary)
            if not binary:
                stream.write(b"\n")
        iof.write_token(stream, binary, "</Nnet3>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool) -> "Nnet3Graph":
        iof.expect_token(stream, binary, "<Nnet3>")
        # config lines are plain text lines (even in binary files),
        # terminated by an empty line; leading blank lines are eaten
        # (read_token may or may not have consumed the newline after
        # <Nnet3> depending on the writer's spacing)
        nodes: List[Node] = []
        while True:
            raw = stream.readline()
            if not raw:
                break
            line = raw.decode().strip()
            if not line:
                if nodes:
                    break
                continue
            nodes.append(_parse_config_line(line))
        iof.expect_token(stream, binary, "<NumComponents>")
        n = iof.read_int32(stream, binary)
        components: Dict[str, Component] = {}
        for _ in range(n):
            iof.expect_token(stream, binary, "<ComponentName>")
            name = iof.read_token(stream, binary)
            type_tok = iof.read_token(stream, binary)
            type_name = type_tok[1:-1]
            ctor = COMPONENT_TYPES.get(type_name)
            if ctor is None:
                raise KaldiTpuError(
                    f"nnet3 import: unsupported component type {type_name}"
                    f" (supported: {sorted(COMPONENT_TYPES)})")
            components[name] = ctor.read(stream, binary)
        iof.expect_token(stream, binary, "</Nnet3>")
        return cls(nodes, components)


def _parse_config_line(line: str) -> Node:
    parts = line.split()
    kind = parts[0]
    kv: Dict[str, str] = {}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        kv[k] = v
    # input= descriptors may contain spaces after commas in hand-written
    # configs; reference output has none, but be lenient by re-joining
    if "input" in kv:
        idx = line.index("input=")
        rest = line[idx + len("input="):]
        # cut trailing key=value fields (objective=...)
        m = re.search(r"\s+\w[-\w]*=", rest)
        if m:
            rest = rest[:m.start()]
        kv["input"] = rest.strip()
    if kind == "input-node":
        return Node("input", kv["name"], dim=int(kv["dim"]))
    if kind == "component-node":
        return Node("component", kv["name"], component=kv["component"],
                    desc=parse_descriptor(kv["input"]))
    if kind == "output-node":
        return Node("output", kv["name"],
                    desc=parse_descriptor(kv["input"]),
                    objective=kv.get("objective", "linear"))
    if kind == "dim-range-node":
        return Node("dim-range", kv["name"],
                    desc=Desc("node", [kv["input-node"]]),
                    dim=int(kv["dim"]), dim_offset=int(kv["dim-offset"]))
    raise KaldiTpuError(f"nnet3 import: unknown config line kind {kind}")


# --------------------------------------------------------------------------
# .raw / .mdl front doors


def read_raw_nnet3(path: str) -> Nnet3Graph:
    """nnet3 'raw' model file (final.raw / 0.raw)."""
    from kaldi_tpu_torch.util import kaldi_io
    return kaldi_io.read_kaldi_object(Nnet3Graph.read, path)


def write_raw_nnet3(graph: Nnet3Graph, path: str,
                    binary: bool = True) -> None:
    from kaldi_tpu_torch.util import kaldi_io
    kaldi_io.write_kaldi_object(graph.write, path, binary=binary)


def read_nnet3_am(path: str):
    """.mdl acoustic model (am-nnet-simple.cc): returns
    (TransitionModel, Nnet3Graph, info dict w/ left_context,
    right_context, priors)."""
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import open_input

    with open_input(path) as stream:
        binary = iof.init_input_stream(stream)
        tm = TransitionModel.read(stream, binary)
        graph = Nnet3Graph.read(stream, binary)
        info = {"left_context": 0, "right_context": 0, "priors": None}
        while True:
            try:
                tok = iof.read_token(stream, binary)
            except Exception:
                break
            if tok == "<LeftContext>":
                info["left_context"] = iof.read_int32(stream, binary)
            elif tok == "<RightContext>":
                info["right_context"] = iof.read_int32(stream, binary)
            elif tok == "<Priors>":
                info["priors"] = iof.read_vector(stream, binary)
            elif not tok:
                break
    return tm, graph, info


def write_nnet3_am(path: str, tm, graph: Nnet3Graph,
                   left_context: int = 0, right_context: int = 0,
                   priors: Optional[np.ndarray] = None,
                   binary: bool = True) -> None:
    from kaldi_tpu_torch.util.kaldi_io import output_stream
    with output_stream(path) as stream:
        iof.init_output_stream(stream, binary)
        tm.write(stream, binary)
        graph.write(stream, binary)
        iof.write_token(stream, binary, "<LeftContext>")
        iof.write_int32(stream, binary, left_context)
        iof.write_token(stream, binary, "<RightContext>")
        iof.write_int32(stream, binary, right_context)
        if priors is not None:
            iof.write_token(stream, binary, "<Priors>")
            iof.write_vector(stream, binary,
                             np.asarray(priors, np.float32))


# --------------------------------------------------------------------------
# exporter: our ChainTdnnf -> reference-format graph


def chain_tdnnf_to_nnet3(model, variables: Optional[dict] = None
                         ) -> Nnet3Graph:
    """The port's ChainTdnnf (nnet3/models.py) as the reference's
    node/component graph, so that the model can be written as a Kaldi
    .raw/.mdl file and run by reference tooling.  `variables` is the
    model's {"params", "batch_stats"} in flax's layout, by default
    `chain_tdnnf_to_flax(model)`; the fields are those of the JAX
    package's exporter on the same weights.  Mapping:

      input_affine + relu + input_bn  ->  NG-affine, ReLU, BatchNorm
      TdnnfLayer(stride s)            ->  TdnnComponent([-s,0], linear)
                                          + TdnnComponent([0,s], affine)
                                          + ReLU + BatchNorm,
                                          bypass = Sum(Scale(0.66, prev), bn)
      prefinal / output heads         ->  NG-affines (+ReLU/BatchNorm)

    The model subsamples INSIDE layer cfg.subsample_layer, and later
    strides apply at the subsampled rate; the exported graph runs at
    the full input rate, so offsets after the subsample point are
    multiplied by the subsampling factor.  Evaluating the exported
    graph at t in {0, 3, 6, ...} gives the model's outputs away from the
    edges (the model clamps offsets at the subsampled rate, the graph at
    the full rate)."""
    if variables is None:
        from kaldi_tpu_torch.nnet3.models import chain_tdnnf_to_flax
        variables = chain_tdnnf_to_flax(model)
    cfg = model.cfg
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def bn_fields(*path):
        s = stats
        for k in path:
            s = s[k]
        s = s["bn"]
        mean = np.asarray(s["mean"])
        return {"Dim": int(mean.shape[-1]), "BlockDim": int(mean.shape[-1]),
                "Epsilon": 1e-3, "TargetRms": 1.0, "TestMode": True,
                "Count": 1.0, "StatsMean": mean,
                "StatsVar": np.asarray(s["var"])}

    nodes: List[Node] = [Node("input", "input", dim=cfg.feat_dim)]
    comps: Dict[str, Component] = {}
    in_desc = "input"
    if getattr(cfg, "ivector_dim", 0):
        nodes.append(Node("input", "ivector", dim=cfg.ivector_dim))
        in_desc = "Append(input, ReplaceIndex(ivector, t, 0))"

    def add(name: str, comp: Component, input_desc: str) -> str:
        comps[name] = comp
        nodes.append(Node("component", name, component=name,
                          desc=parse_descriptor(input_desc)))
        return name

    prev = add("input.affine", NaturalGradientAffineComponent(
        LearningRate=0.001,
        LinearParams=np.asarray(params["input_affine"]["kernel"]).T,
        BiasParams=np.asarray(params["input_affine"]["bias"])), in_desc)
    prev = add("input.relu", RectifiedLinearComponent(
        Dim=cfg.hidden_dim, Count=0.0), prev)
    prev = add("input.batchnorm",
               BatchNormComponent(**bn_fields("input_bn")), prev)

    strides = cfg.time_strides()
    for i, s in enumerate(strides, start=1):
        name = f"tdnnf{i}"
        p = params[name]
        # offsets at the graph's full input rate
        rate = (cfg.frame_subsampling_factor
                if i > cfg.subsample_layer else 1)
        off = s * rate
        add(f"{name}.linear", TdnnComponent(
            TimeOffsets=[-off, 0] if s else [0],
            LinearParams=np.asarray(p["linear"]),
            BiasParams=np.zeros(0, np.float32),
            OrthonormalConstraint=-1.0,
            UseNaturalGradient=True), prev)
        add(f"{name}.affine", TdnnComponent(
            TimeOffsets=[0, off] if s else [0],
            LinearParams=np.asarray(p["affine"]),
            BiasParams=np.asarray(p["bias"]),
            OrthonormalConstraint=0.0,
            UseNaturalGradient=True), f"{name}.linear")
        add(f"{name}.relu", RectifiedLinearComponent(
            Dim=cfg.hidden_dim, Count=0.0), f"{name}.affine")
        add(f"{name}.batchnorm", BatchNormComponent(
            **bn_fields(name, "BatchNorm_0")), f"{name}.relu")
        # bypass (our layers add it whenever dims match — always, since
        # the input affine lifts to hidden_dim)
        prev = f"Sum(Scale(0.66, {prev}), {name}.batchnorm)"

    def prefinal(block: str, scope: str, source: str) -> str:
        p = params[scope]
        out = add(f"{block}.affine", NaturalGradientAffineComponent(
            LearningRate=0.001,
            LinearParams=np.asarray(p["affine"]["kernel"]).T,
            BiasParams=np.asarray(p["affine"]["bias"])), source)
        out = add(f"{block}.relu", RectifiedLinearComponent(
            Dim=cfg.hidden_dim, Count=0.0), out)
        out = add(f"{block}.batchnorm1", BatchNormComponent(
            **bn_fields(scope, "bn1")), out)
        out = add(f"{block}.linear", LinearComponent(
            Params=np.asarray(p["linear"]["kernel"]).T,
            OrthonormalConstraint=-1.0, UseNaturalGradient=True), out)
        out = add(f"{block}.batchnorm2", BatchNormComponent(
            **bn_fields(scope, "bn2")), out)
        return out

    pc = prefinal("prefinal-chain", "prefinal_chain", prev)
    add("output.affine", NaturalGradientAffineComponent(
        LearningRate=0.001,
        LinearParams=np.asarray(params["output_affine"]["kernel"]).T,
        BiasParams=np.asarray(params["output_affine"]["bias"])), pc)
    nodes.append(Node("output", "output",
                      desc=parse_descriptor("output.affine"),
                      objective="linear"))

    px = prefinal("prefinal-xent", "prefinal_xent", prev)
    add("output-xent.affine", NaturalGradientAffineComponent(
        LearningRate=0.001,
        LinearParams=np.asarray(params["output_xent_affine"]["kernel"]).T,
        BiasParams=np.asarray(params["output_xent_affine"]["bias"])), px)
    add("output-xent.log-softmax", LogSoftmaxComponent(
        Dim=cfg.num_pdfs, Count=0.0), "output-xent.affine")
    nodes.append(Node("output", "output-xent",
                      desc=parse_descriptor("output-xent.log-softmax"),
                      objective="linear"))
    return Nnet3Graph(nodes, comps)


def read_nnet3_any(path: str):
    """Dispatch on the leading token: <Nnet3> (raw model) vs
    <TransitionModel> (.mdl acoustic model). Returns
    (tm_or_None, graph, info_dict). Avoids try/except fallbacks that
    would mask real parse errors (e.g. an unsupported component in a
    raw file must not be reported as a missing TransitionModel)."""
    from kaldi_tpu_torch.util.kaldi_io import open_input
    with open_input(path) as stream:
        binary = iof.init_input_stream(stream)
        tok = iof.peek_token(stream, binary)
    if tok == "<Nnet3>":
        return None, read_raw_nnet3(path), {"left_context": 0,
                                            "right_context": 0,
                                            "priors": None}
    return read_nnet3_am(path)
