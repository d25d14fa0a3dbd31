"""Port parity: i-vector extractor training and extraction of
kaldi_tpu_torch against the JAX package's, on the CPU, in float64:
IvectorExtractor (initial projections) and ExtractorOnDevice (stats,
extract, with and without the offset), IvectorExtractorStats and
train_ivector_extractor from the same UBM, train_bench_extractor from
the same features (UBM and projections), each within 1e-6 relative to
the reference array's largest value; and the extractor written by
`save_ivector_extractor` read back by both packages' loaders."""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.gmm.diag_gmm import DiagGmm as JGmm
from kaldi_tpu.ivector import batched as jbatched
from kaldi_tpu.ivector import extractor as jext
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.ivector import batched as tbatched
from kaldi_tpu_torch.ivector import extractor as text
from kaldi_tpu_torch.recipes import bench_corpus as tbc

G, D, R = 8, 6, 5


def close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def ubms(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 1.5, G)
    w /= w.sum()
    means = rng.normal(size=(G, D)) * 3
    var = rng.uniform(0.5, 2.0, (G, D))
    j, t = JGmm(G, D), DiagGmm(G, D)
    j.set_from_means_and_vars(w, means, var)
    t.set_from_means_and_vars(w, means, var)
    return j, t, means


def utterances(seed, means, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = int(rng.integers(20, 60))
        comp = rng.integers(0, G, T)
        out.append((means[comp] + rng.normal(size=(T, D))
                    + rng.normal(size=D)).astype(np.float32))
    return out


def test_extractor_and_stats_match():
    jubm, tubm, means = ubms(0)
    je, te = jext.IvectorExtractor(jubm, R), text.IvectorExtractor(tubm, R)
    close(te.M, je.M, 0)
    close(te.sigma_inv, je.sigma_inv, 0)
    feats = utterances(1, means)
    on = text.ExtractorOnDevice(te, "cpu")
    gamma, x = on.utt_stats(feats)
    for i, f in enumerate(feats):
        for a, b in zip((gamma[i].numpy(), x[i].numpy()),
                        je.acc_utt_stats(f)):
            close(a, b)
    close(on.extract(feats), np.stack([je.extract(f) for f in feats]))
    close(on.extract(feats, remove_offset=True),
          np.stack([je.extract_offset_removed(f) for f in feats]))
    js, ts = jext.IvectorExtractorStats(je), text.IvectorExtractorStats(te)
    for f in feats:
        js.acc_stats(je, f)
    ts.acc_device(on, feats)
    other = text.IvectorExtractorStats(te)
    other.acc_device(on, feats[:1])
    ts.add(other)
    js.acc_stats(je, feats[0])
    assert ts.num_utts == js.num_utts == len(feats) + 1
    close(ts.A, js.A)
    close(ts.B, js.B)
    ts.update(te)
    js.update(je)
    close(te.M, je.M)


def test_train_ivector_extractor_matches():
    jubm, tubm, means = ubms(2)
    feats = utterances(3, means, 8)
    opts = dict(ivector_dim=R, num_iters=3, prior_offset=50.0)
    je = jext.train_ivector_extractor(
        jubm, feats, jext.IvectorExtractorOptions(**opts))
    te = text.train_ivector_extractor(
        tubm, feats, text.IvectorExtractorOptions(**opts), device="cpu")
    close(te.M, je.M)
    close(text.ExtractorOnDevice(te, "cpu").extract(feats,
                                                    remove_offset=True),
          np.stack([je.extract_offset_removed(f) for f in feats]))


@pytest.fixture(scope="module")
def bench_extractors():
    rng = np.random.default_rng(4)
    means = rng.normal(size=(12, D)) * 4
    feats = {}
    for i in range(10):
        comp = rng.integers(0, 12, int(rng.integers(40, 90)))
        feats[f"u{i:02d}"] = (means[comp] + rng.normal(size=(comp.size, D))
                              ).astype(np.float32)
    kw = dict(num_gauss=8, ivector_dim=R, seed=3, num_em_iters=3,
              max_frames=500)
    return (feats, jbatched.train_bench_extractor(feats, **kw),
            tbatched.train_bench_extractor(feats, device="cpu", **kw))


def test_train_bench_extractor_matches(bench_extractors):
    """The same frames drawn by default_rng(seed), the same UBM EM, the
    same projections and i-vectors."""
    feats, je, te = bench_extractors
    close(te.ubm.weights, je.ubm.weights)
    close(te.ubm.get_means(), je.ubm.get_means())
    close(te.ubm.inv_vars, je.ubm.inv_vars)
    close(te.M, je.M)
    assert te.prior_offset == je.prior_offset
    x = [np.asarray(f, np.float64) for f in feats.values()]
    close(text.ExtractorOnDevice(te, "cpu").extract(x, remove_offset=True),
          np.stack([je.extract_offset_removed(f) for f in x]))


def test_saved_extractor_reads_back(tmp_path, bench_extractors):
    """`save_ivector_extractor` writes what both packages' loaders read;
    the port's batched extractor over it and over the in-memory arrays
    agree within the file's float32 rounding of M."""
    feats, je, te = bench_extractors
    path = os.path.join(tmp_path, "ivec.npz")
    tbc.save_ivector_extractor(path, te)
    jpath = os.path.join(tmp_path, "jax_ivec.npz")
    jbc.save_ivector_extractor(jpath, je)
    got, want = tbc.load_ivector_extractor(path), jbc.load_ivector_extractor(
        jpath)
    close(got["M"], want.M)
    close(got["sigma_inv"], want.sigma_inv)
    close(got["means"], want.ubm.get_means())
    assert got["prior"] == want.prior_offset
    jread = jbc.load_ivector_extractor(path)
    close(jread.M, got["M"], 0)
    x = torch.from_numpy(np.stack([f[:40] for f in feats.values()]))
    a = tbatched.BatchedIvectorExtractor(got, device="cpu").extract_batch(x)
    b = tbatched.BatchedIvectorExtractor(te.arrays(),
                                         device="cpu").extract_batch(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
