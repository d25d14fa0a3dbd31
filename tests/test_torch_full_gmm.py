"""Port parity: `gmm/full_gmm.py` (FullGmm, AccumFullGmm, the MLE update,
the device scorer) and the extractor's model, E-step, M-step and files
(`ivector/extractor.py`) against the JAX package's, on the CPU, at small
widths.  Host arithmetic copied from the reference is equal; the device
path (torch on the CPU here) is within 1e-9 of the largest element.  A
diagonal UBM, which the reference scores in float32, is scored on the
CPU by its own numpy methods (`gmm.ubm.UbmScorer`), so its statistics
too are within 1e-9."""

import io

import numpy as np
import pytest

from ivector_fixtures import rel_err, synth_feats
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.gmm.full_gmm import AccumFullGmm as JAcc
from kaldi_tpu.gmm.full_gmm import FullGmm as JFull
from kaldi_tpu.gmm.full_gmm import MleFullGmmOptions as JOpts
from kaldi_tpu.gmm.full_gmm import mle_full_gmm_update as jupdate
from kaldi_tpu.ivector.extractor import IvectorExtractor as JEx
from kaldi_tpu.ivector.extractor import IvectorExtractorStats as JStats
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import (AccumFullGmm, FullGmm,
                                          MleFullGmmOptions,
                                          mle_full_gmm_update)
from kaldi_tpu_torch.gmm.mle import AccumDiagGmm
from kaldi_tpu_torch.gmm.ubm import UbmScorer
from kaldi_tpu_torch.ivector.extractor import (ExtractorOnDevice,
                                               IvectorExtractor,
                                               IvectorExtractorStats)

M, D, R = 8, 6, 4


def _bytes(obj) -> bytes:
    buf = io.BytesIO()
    obj.write(buf, True)
    return buf.getvalue()


def _ubms(seed=0):
    """(JAX DiagGmm, port DiagGmm, JAX FullGmm, port FullGmm) with the
    same parameters: random means, variances and weights, the full
    covariances with off-diagonal terms."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(M))
    means = rng.normal(scale=2.0, size=(M, D))
    var = rng.uniform(0.5, 2.0, size=(M, D))
    jd, td = JDiag(M, D), DiagGmm(M, D)
    jd.set_from_means_and_vars(w, means, var)
    td.set_from_means_and_vars(w, means, var)
    A = rng.normal(scale=0.3, size=(M, D, D))
    cov = np.einsum("mde,mfe->mdf", A, A) + np.eye(D)[None] * var[:, :, None]
    jf, tf = JFull(M, D), FullGmm(M, D)
    jf.set_from_means_and_covars(w, means, cov)
    tf.set_from_means_and_covars(w, means, cov)
    return jd, td, jf, tf


@pytest.fixture(scope="module")
def feats():
    return list(synth_feats(10, D, seed=1).values())


def test_full_gmm_host_equal():
    """The copied host methods give the reference's numbers bit for bit;
    the files are byte-equal and read back into either package."""
    jd, td, jf, tf = _ubms()
    np.testing.assert_array_equal(tf.gconsts, jf.gconsts)
    np.testing.assert_array_equal(tf.get_means(), jf.get_means())
    np.testing.assert_array_equal(tf.get_covars(), jf.get_covars())
    assert _bytes(tf) == _bytes(jf)
    assert _bytes(FullGmm.from_diag(td)) == _bytes(JFull.from_diag(jd))
    assert _bytes(tf.to_diag()) == _bytes(jf.to_diag())
    back = FullGmm.read(io.BytesIO(_bytes(jf)), True)
    assert _bytes(back) == _bytes(jf)
    x = np.random.default_rng(2).normal(size=(30, D))
    np.testing.assert_array_equal(tf.component_log_likes(x),
                                  jf.component_log_likes(x))
    np.testing.assert_array_equal(tf.component_posteriors(x),
                                  jf.component_posteriors(x))


@pytest.mark.parametrize("full", [True, False])
def test_scorer_against_reference(full):
    """UbmScorer: a full UBM's log-likelihoods and posteriors within 1e-9
    in float64, a diagonal one's equal (float32, scored on the CPU by
    the reference's own products)."""
    jd, td, jf, tf = _ubms(1)
    x = np.random.default_rng(3).normal(scale=2.0, size=(200, D))
    sc = UbmScorer(tf if full else td, "cpu")
    xt = sc.frames(x.astype(np.float32))
    ref = jf if full else jd
    want = ref.component_log_likes(x.astype(np.float32))
    tol = 1e-9 if full else 0.0
    assert rel_err(sc.log_likes(xt).numpy(), want) <= tol
    assert rel_err(sc.posteriors(xt).numpy(),
                   ref.component_posteriors(x.astype(np.float32))) <= tol
    assert rel_err(sc.log_likelihood(xt).numpy(),
                   ref.log_likelihood(x.astype(np.float32))) <= tol


def test_full_accumulation_and_update(feats):
    """AccumFullGmm on the device path within 1e-9 of the reference's
    per-utterance accumulation; the update of equal stats equal."""
    _, _, jf, tf = _ubms(2)
    ja = JAcc(M, D)
    like = sum(ja.accumulate_from_full(jf, f.astype(np.float64))
               for f in feats)
    ta = AccumFullGmm(M, D)
    tlike, n = ta.accumulate_device(UbmScorer(tf, "cpu"), feats)
    assert n == sum(f.shape[0] for f in feats)
    assert abs(tlike - like) / abs(like) < 1e-9
    for a in ("occupancy", "mean_accs", "covar_accs"):
        assert rel_err(getattr(ta, a), getattr(ja, a)) < 1e-9, a
    ta.occupancy, ta.mean_accs, ta.covar_accs = (
        ja.occupancy.copy(), ja.mean_accs.copy(), ja.covar_accs.copy())
    for opts in ({}, {"min_gaussian_occupancy": 100.0,
                      "remove_low_count_gaussians": False}):
        j2, t2 = JFull.read(io.BytesIO(_bytes(jf)), True), \
            FullGmm.read(io.BytesIO(_bytes(jf)), True)
        jupdate(JOpts(**opts), ja, j2)
        mle_full_gmm_update(MleFullGmmOptions(**opts), ta, t2)
        assert _bytes(t2) == _bytes(j2)


def test_diag_accumulation(feats):
    """AccumDiagGmm.accumulate_device within 1e-9 (the reference's
    float32 posteriors, float64 statistics)."""
    from kaldi_tpu.gmm.mle import AccumDiagGmm as JAccDiag
    jd, td, _, _ = _ubms(4)
    ja = JAccDiag(M, D)
    for f in feats:
        ja.accumulate_from_gmm(jd, f)
    ta = AccumDiagGmm(M, D)
    ta.accumulate_device(UbmScorer(td, "cpu"), feats)
    for a in ("occupancy", "mean_accs", "var_accs"):
        assert rel_err(getattr(ta, a), getattr(ja, a)) < 1e-9, a


def _extractors(full: bool, seed=5):
    jd, td, jf, tf = _ubms(seed)
    jex = JEx(jf if full else jd, R, prior_offset=30.0, seed=seed)
    tex = IvectorExtractor(tf if full else td, R, prior_offset=30.0,
                           seed=seed)
    return jex, tex


@pytest.mark.parametrize("full", [True, False])
def test_extractor_files(full):
    """ivector-extractor files byte-equal both ways; the stats files
    too."""
    jex, tex = _extractors(full)
    assert _bytes(tex) == _bytes(jex)
    back = IvectorExtractor.read(io.BytesIO(_bytes(jex)), True)
    assert back.full_cov == full and _bytes(back) == _bytes(jex)
    assert JEx.read(io.BytesIO(_bytes(tex)), True).full_cov == full
    js, ts = JStats(jex), IvectorExtractorStats(tex)
    rng = np.random.default_rng(6)
    js.A = rng.normal(size=js.A.shape)
    js.B = rng.normal(size=js.B.shape)
    js.num_utts = 7
    back = IvectorExtractorStats.read(io.BytesIO(_bytes(js)), True)
    assert _bytes(back) == _bytes(js)
    ts.A, ts.B, ts.num_utts = js.A, js.B, 7
    assert _bytes(ts) == _bytes(js)


@pytest.mark.parametrize("full", [True, False])
def test_extractor_e_and_m_step(feats, full):
    """The batched E-step (stats, i-vectors, A and B) and the batched
    M-step within 1e-9 of the reference's per-utterance loops, with a full
    UBM and with a diagonal one (whose float32 posteriors the CPU computes
    with the reference's products)."""
    jex, tex = _extractors(full)
    tol = 1e-9
    on = ExtractorOnDevice(tex, "cpu")
    gamma, x = on.utt_stats(feats)
    for i, f in enumerate(feats):
        jg, jx = jex.acc_utt_stats(f)
        assert rel_err(gamma[i].numpy(), jg) < tol
        assert rel_err(x[i].numpy(), jx) < tol
    want = np.stack([jex.extract(f) for f in feats])
    assert rel_err(on.extract(feats), want) < tol
    js, ts = JStats(jex), IvectorExtractorStats(tex)
    for f in feats:
        js.acc_stats(jex, f)
    ts.acc_device(on, feats)
    assert ts.num_utts == js.num_utts
    assert rel_err(ts.A, js.A) < tol and rel_err(ts.B, js.B) < tol
    ts.A, ts.B = js.A.copy(), js.B.copy()
    js.update(jex)
    ts.update(tex)
    assert rel_err(tex.M, jex.M) < 1e-9


def test_from_arrays_matches_reference_loader(tmp_path):
    """IvectorExtractor.from_arrays builds the extractor the reference
    package's load_ivector_extractor builds from the same npz."""
    from kaldi_tpu.recipes.bench_corpus import load_ivector_extractor
    from kaldi_tpu_torch.recipes.bench_corpus import (
        load_ivector_extractor as tload, save_ivector_extractor)
    _, tex = _extractors(False)
    path = str(tmp_path / "ivec.npz")
    save_ivector_extractor(path, tex)
    assert _bytes(IvectorExtractor.from_arrays(tload(path))) == \
        _bytes(load_ivector_extractor(path))
