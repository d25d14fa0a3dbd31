"""The compiled nnet3 module on the card against the same module on the
CPU, on the reference golden (tests/data/ref_golden/tdnn.raw,
feats.ark): within 1e-5 absolute (float32 with TF32 off on both; other
summation orders).  Needs an NVIDIA GPU, so it skips elsewhere; on a
machine with a card run
`python -m pytest tests/test_torch_cuda_nnet3.py -m cuda -q --noconftest`.
It imports no jax."""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from kaldi_tpu_torch.util.table import SequentialTableReader

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_golden")


def test_golden_module_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    graph = read_raw_nnet3(os.path.join(DATA, "tdnn.raw"))
    feats = [f for _k, f in SequentialTableReader(
        "matrix", f"ark:{os.path.join(DATA, 'feats.ark')}")]
    x = torch.from_numpy(np.stack(feats))
    cpu = compile_graph(graph, device="cpu")(x)
    card = compile_graph(graph, device="cuda")(x.cuda())
    assert card.device.type == "cuda"
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)
