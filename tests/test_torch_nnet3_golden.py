"""The port against the reference's own C++ nnet3-compute, on the CPU:
tests/data/ref_golden/tdnn.raw (binary) and tdnn_text.raw (text), a
2-layer TDNN written by the reference's nnet3-init, on feats.ark ->
tdnn_out.ark, written by the reference's nnet3-compute
(tests/test_ref_nnet3_golden.py).  The model reads t-2..t+2; nnet3-compute
gave it that context by replicating the first and last frame, so the
inputs are padded so.  Tolerance 1e-4 absolute, the JAX package's."""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any, read_raw_nnet3
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from kaldi_tpu_torch.util.table import SequentialTableReader

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_golden")
PAD, TOL = 2, 1e-4


def arks():
    read = lambda name: dict(SequentialTableReader(  # noqa: E731
        "matrix", f"ark:{os.path.join(DATA, name)}"))
    return read("feats.ark"), read("tdnn_out.ark")


def padded(f):
    return np.concatenate([np.repeat(f[:1], PAD, 0), f,
                           np.repeat(f[-1:], PAD, 0)])


@pytest.mark.parametrize("name", ["tdnn.raw", "tdnn_text.raw"])
def test_compiled_module_matches_reference_compute(name):
    feats, ref = arks()
    graph = read_raw_nnet3(os.path.join(DATA, name))
    assert set(graph.components) == {"affine1", "relu1", "bn1", "affine2",
                                     "logsoftmax"}
    net = compile_graph(graph, device="cpu")
    batch = np.stack([padded(f) for f in feats.values()])
    out = net(torch.from_numpy(batch)).numpy()
    for i, (k, f) in enumerate(feats.items()):
        got = out[i, PAD:PAD + f.shape[0]]
        assert got.shape == ref[k].shape
        np.testing.assert_allclose(got, ref[k], atol=TOL)


@pytest.mark.parametrize("name", ["tdnn.raw", "tdnn_text.raw"])
def test_host_evaluator_matches_reference_compute(name):
    feats, ref = arks()
    tm, graph, info = read_nnet3_any(os.path.join(DATA, name))
    assert tm is None and info["priors"] is None
    for k, f in feats.items():
        got = graph.forward(padded(f))[PAD:PAD + f.shape[0]]
        np.testing.assert_allclose(got, ref[k], atol=TOL)
