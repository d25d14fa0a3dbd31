"""The dense-relaxation and beam-sparse device decoders on the card
against their CPU twins (`kaldi_tpu_torch/decoder/dense_relax.py`,
`decoder/beam_sparse.py`): the same float32 sums and the same
first-minimum and stable-sort rules, so the results are bit-equal
(costs, chosen arcs, words).  Needs a CUDA device; run on the card with
`python -m pytest tests/test_torch_cuda_decoders.py -m cuda -q
--noconftest` (tests/conftest.py imports jax, which the GPU machine
lacks).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.beam_sparse import (BeamSparseDecoder,
                                                 SparseDeviceGraph)
from kaldi_tpu_torch.decoder.dense_relax import (DenseDeviceGraph,
                                                 DenseViterbiDecoder)
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_graph(seed, S=300, P=12):
    rng = np.random.default_rng(seed)
    f = VectorFst(TropicalWeight)
    f.add_states(S)
    f.set_start(0)
    for s in range(S):
        for _ in range(int(rng.integers(1, 8))):
            if rng.uniform() < 0.15 and s < S - 1:
                f.add_arc(s, Arc(EPS, int(rng.integers(0, 5)),
                                 float(rng.uniform(0, 1.5)),
                                 int(rng.integers(s + 1, S))))
            else:
                f.add_arc(s, Arc(int(rng.integers(1, 3 * P + 1)),
                                 int(rng.integers(0, 5)),
                                 float(rng.uniform(0, 3.0)),
                                 int(rng.integers(0, S))))
    for s in rng.choice(S, 12, replace=False):
        f.finals[int(s)] = float(rng.uniform(0, 1))
    tid2pdf = np.concatenate([[0], np.arange(3 * P) % P])
    return f, tid2pdf, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_card_equals_cpu(cuda, seed):
    f, tid2pdf, rng = random_graph(seed)
    g = DenseDeviceGraph.build(f, tid2pdf)
    ll = rng.normal(size=(16, 40, 12)).astype(np.float32)
    lens = rng.integers(10, 41, 16)
    card = DenseViterbiDecoder(g, chunk=16)
    cpu = DenseViterbiDecoder(g, chunk=16, device="cpu")
    a = card.decode_batch(ll, 0.7, lengths=lens)
    b = cpu.decode_batch(ll, 0.7, lengths=lens)
    assert a == b
    assert np.array_equal(card.last_arcs, cpu.last_arcs)
    assert card.device.type == "cuda"


@pytest.mark.parametrize("beam,capacity", [(1e9, 1024), (6.0, 64)])
def test_beam_sparse_card_equals_cpu(cuda, beam, capacity):
    f, tid2pdf, rng = random_graph(3)
    g = SparseDeviceGraph.build(f, tid2pdf, max_degree=6)
    ll = rng.normal(size=(8, 30, 12)).astype(np.float32)
    a = BeamSparseDecoder(g, beam=beam, capacity=capacity).decode_batch(
        ll, 1.0)
    cpu = BeamSparseDecoder(g, beam=beam, capacity=capacity, device="cpu")
    b = cpu.decode_batch(ll, 1.0)
    assert a == b
    assert cpu.stats["traceback_failures"] == 0
