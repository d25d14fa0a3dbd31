"""Port parity: BatchedIvectorExtractor.extract_batch of kaldi_tpu_torch
against the JAX reference on the committed flagship_ng_ivec.npz, with
seeded MFCC-like features and ragged lengths.

Tolerance rtol 1e-4 with atol 3e-4.  The absolute term is float32's
own limit here: the linear term of the solve is O(1e4) over 64 frames,
its rounding moves the O(1) i-vector entries by O(1e-4), and on these
inputs both the JAX reference and the port sit about 1.3e-3 from a
float64 evaluation of the same formulas while agreeing with each other
to 1.5e-4."""

import os

import numpy as np
import torch

from kaldi_tpu.ivector.batched import BatchedIvectorExtractor as JaxIvec
from kaldi_tpu.recipes.bench_corpus import \
    load_ivector_extractor as jax_load_ivec
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor

IVEC = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus",
                    "flagship_ng_ivec.npz")


def feats_like_ubm(seed, B, T):
    """Features drawn around the UBM means, so posteriors are spread."""
    d = np.load(IVEC)
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, d["means"].shape[0], size=(B, T))
    sd = 1.0 / np.sqrt(d["inv_vars"][comp])
    return (d["means"][comp] + rng.normal(size=sd.shape) * sd).astype(
        np.float32)


def test_extract_batch_matches_jax():
    ref = JaxIvec(jax_load_ivec(IVEC))
    ex = BatchedIvectorExtractor(load_ivector_extractor(IVEC), device="cpu")
    feats = feats_like_ubm(0, 4, 64)
    lengths = [64, 50, 33, 7]
    want = np.asarray(ref.extract_batch(feats, lengths))
    got = ex.extract_batch(torch.from_numpy(feats), lengths).numpy()
    assert got.shape == (4, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-4)


def test_extract_batch_full_length_default():
    ref = JaxIvec(jax_load_ivec(IVEC))
    ex = BatchedIvectorExtractor(load_ivector_extractor(IVEC), device="cpu")
    feats = feats_like_ubm(1, 2, 40)
    want = np.asarray(ref.extract_batch(feats))
    got = ex.extract_batch(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-4)
