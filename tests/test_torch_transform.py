"""Port parity: the feature-transform statistics of kaldi_tpu_torch
(`transform/lda.py`, `transform/mllt.py`, `transform/fmllr.py`) against
the JAX package's on the CPU, from numpy inputs made from a seed: each
accumulator's sums and each estimate within 1e-9 relative of the
reference's, the accumulators' files byte for byte, `apply_affine_transform`
equal in float32, and the device argument's rules."""

import io

import numpy as np
import pytest
import torch

from kaldi_tpu.gmm.am_diag_gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JGmm
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.transform import fmllr as jfmllr
from kaldi_tpu.transform import lda as jlda
from kaldi_tpu.transform import mllt as jmllt
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.transform import fmllr, lda, mllt
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

D = 7
RTOL = 1e-9


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def gmm_pair(rng, n, dim=D):
    w = rng.random(n) + 0.1
    mu = rng.normal(size=(n, dim)) * 2.0
    var = rng.random((n, dim)) + 0.3
    j, t = JGmm(n, dim), DiagGmm(n, dim)
    j.set_from_means_and_vars(w / w.sum(), mu, var)
    t.set_from_means_and_vars(w / w.sum(), mu, var)
    return j, t


@pytest.fixture(scope="module")
def system():
    """A monophone system of 4 phones (3 states each) with GMMs of 1-5
    Gaussians, in both packages, and 3 utterances of frames near its
    means with equal-length alignments."""
    rng = np.random.default_rng(3)
    phones = [1, 2, 3, 4]
    jtopo = JTopo.three_state(phones, sil_phones=[1])
    ttopo = HmmTopology.three_state(phones, sil_phones=[1])
    npc = {p: jtopo.num_pdf_classes(p) for p in phones}
    jtm = JTm(jtopo, jmono(phones, npc))
    ttm = TransitionModel(ttopo, monophone_context_dependency(phones, npc))
    jam, tam = JAm(), AmDiagGmm(device="cpu")
    for pdf in range(jtm.num_pdfs):
        j, t = gmm_pair(rng, 1 + pdf % 5)
        jam.add_pdf(j)
        tam.add_pdf(t)
    utts = []
    for _ in range(3):
        T = int(rng.integers(40, 70))
        ali = [int(x) for x in rng.integers(1, jtm.num_transition_ids + 1,
                                            size=T)]
        feats = (rng.normal(size=(T, D)) * 1.5).astype(np.float32)
        utts.append((feats, ali))
    return jtm, ttm, jam, tam, utts


def test_apply_affine_transform_equal_in_float32():
    rng = np.random.default_rng(0)
    for T, Din, Dout in ((7, 13, 13), (500, 65, 20), (228, 20, 20)):
        x = rng.normal(size=(T, Din)).astype(np.float32) * 5
        W = rng.normal(size=(Dout, Din + 1))
        got = fmllr.apply_affine_transform(x, W, device="cpu")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jfmllr.apply_affine_transform(x, W))


def test_lda_accumulate_estimate_and_io():
    rng = np.random.default_rng(1)
    C, Dl = 12, 9
    cls = rng.integers(0, C - 1, size=600)   # class C-1 stays empty
    x = (rng.normal(size=(600, Dl))
         + rng.normal(size=(C, Dl))[cls] * 0.7).astype(np.float32)
    j = jlda.LdaEstimate(C, Dl)
    for c in range(C):
        if (cls == c).any():
            j.accumulate(x[cls == c], c, weight=0.5)
    t = lda.LdaEstimate(C, Dl, device="cpu")
    t.accumulate_batch(x, cls, weight=0.5)
    t1 = lda.LdaEstimate(C, Dl, device="cpu")
    t1.accumulate(x[cls == 0], 0, weight=0.5)
    np.testing.assert_array_equal(t1.first_acc[1:], 0.0)
    assert rel(t1.first_acc[0], j.first_acc[0]) <= RTOL
    for name in ("zero_acc", "first_acc", "total_second_acc"):
        assert rel(getattr(t, name), getattr(j, name)) <= RTOL, name
    for opts in (dict(dim=5), dict(dim=4, within_class_factor=0.5),
                 dict(dim=6, remove_offset=False)):
        for k in (0, 1):
            assert rel(t.estimate(lda.LdaOptions(**opts))[k],
                       j.estimate(jlda.LdaOptions(**opts))[k]) <= 1e-8
    t.add(t1)
    j.accumulate(x[cls == 0], 0, weight=0.5)
    assert rel(t.first_acc, j.first_acc) <= RTOL
    # the file: the reference's bytes from the same numbers
    t.zero_acc, t.first_acc = j.zero_acc.copy(), j.first_acc.copy()
    t.total_second_acc = j.total_second_acc.copy()
    for binary in (True, False):
        a, b = io.BytesIO(), io.BytesIO()
        t.write(a, binary)
        j.write(b, binary)
        assert a.getvalue() == b.getvalue()
        back = lda.LdaEstimate.read(io.BytesIO(a.getvalue()), binary,
                                    device="cpu")
        assert rel(back.total_second_acc, j.total_second_acc) <= \
            (0 if binary else 1e-6)


def groups_of(rng, pairs, n_groups):
    out_j, out_t = [], []
    for g in range(n_groups):
        jg, tg = pairs[g % len(pairs)]
        x = (rng.normal(size=(int(rng.integers(5, 30)), D)) * 2
             ).astype(np.float32)
        post = jg.component_posteriors(x)
        np.testing.assert_array_equal(post, tg.component_posteriors(x))
        if g == 1:
            post[:, 0] = 1e-12     # below both skip thresholds
        out_j.append((jg, x, post))
        out_t.append((tg, x, post))
    return out_j, out_t


def test_mllt_accumulate_update_and_io():
    rng = np.random.default_rng(2)
    pairs = [gmm_pair(rng, n) for n in (1, 3, 4)]
    gj, gt = groups_of(rng, pairs, 6)
    j = jmllt.MlltAccs(D)
    for g in gj:
        j.accumulate_from_posteriors(*g)
    t = mllt.MlltAccs(D, device="cpu")
    t.accumulate_groups(gt[:4])
    for g in gt[4:]:
        t.accumulate_from_posteriors(*g)
    assert abs(t.beta - j.beta) <= RTOL * j.beta
    assert rel(t.G, j.G) <= RTOL
    M, impr = t.update()
    Mj, imprj = j.update()
    assert rel(M, Mj) <= 1e-8 and abs(impr - imprj) <= 1e-8 * abs(imprj)
    t2 = mllt.MlltAccs(D, device="cpu")
    t2.add(t)
    t2.add(t)
    assert t2.beta == 2 * t.beta
    t.beta, t.G = j.beta, j.G.copy()
    for binary in (True, False):
        a, b = io.BytesIO(), io.BytesIO()
        t.write(a, binary)
        j.write(b, binary)
        assert a.getvalue() == b.getvalue()
    back = mllt.MlltAccs.read(io.BytesIO(a.getvalue()), False, device="cpu")
    assert rel(back.G, j.G) <= 1e-6


def test_fmllr_accumulate_and_update():
    rng = np.random.default_rng(4)
    pairs = [gmm_pair(rng, n) for n in (2, 5)]
    gj, gt = groups_of(rng, pairs, 5)
    j = jfmllr.FmllrDiagGmmAccs(D)
    for g in gj:
        j.accumulate_from_posteriors(*g)
    t = fmllr.FmllrDiagGmmAccs(D, device="cpu")
    t.accumulate_groups(gt)
    assert abs(t.beta - j.beta) <= RTOL * j.beta
    assert rel(t.K, j.K) <= RTOL and rel(t.G, j.G) <= RTOL
    for min_count in (10.0, 1e9):
        W, impr = t.update(min_count=min_count)
        Wj, imprj = j.update(min_count=min_count)
        assert rel(W, Wj) <= 1e-8 and abs(impr - imprj) <= 1e-8 + \
            1e-8 * abs(imprj)
    W, _ = t.update(min_count=10.0)
    assert not np.allclose(W[:, :D], np.eye(D))


def test_fmllr_from_alignment_posterior_and_gauss_post(system):
    jtm, ttm, jam, tam, utts = system
    j = jfmllr.FmllrDiagGmmAccs(D)
    t = fmllr.FmllrDiagGmmAccs(D, device="cpu")
    for feats, ali in utts:
        j.accumulate_from_alignment(jam, jtm, feats, ali)
        t.accumulate_from_alignment(tam, ttm, feats, ali)
    assert rel(t.G, j.G) <= RTOL and rel(t.K, j.K) <= RTOL
    rng = np.random.default_rng(5)
    jp = jfmllr.FmllrDiagGmmAccs(D)
    tp = fmllr.FmllrDiagGmmAccs(D, device="cpu")
    jg = jfmllr.FmllrDiagGmmAccs(D)
    tg = fmllr.FmllrDiagGmmAccs(D, device="cpu")
    for feats, ali in utts:
        # two weighted entries a frame, one zero; the list runs past the
        # frames by 3
        post = [[(a, 0.7), (int(b), 0.3), (a, 0.0)]
                for a, b in zip(ali + ali[:3],
                                rng.integers(1, jtm.num_transition_ids + 1,
                                             size=len(ali) + 3))]
        jp.accumulate_from_posterior(jam, jtm, feats.astype(np.float64),
                                     post)
        tp.accumulate_from_posterior(tam, ttm, feats.astype(np.float64),
                                     post)
        gpost = [[(jtm.transition_id_to_pdf(a),
                   rng.random(jam.get_pdf(jtm.transition_id_to_pdf(a))
                              .num_gauss))] for a in ali]
        jg.accumulate_from_gauss_post(jam, feats, gpost)
        tg.accumulate_from_gauss_post(tam, feats, gpost)
    for a, b in ((tp, jp), (tg, jg)):
        assert abs(a.beta - b.beta) <= RTOL * b.beta
        assert rel(a.G, b.G) <= RTOL and rel(a.K, b.K) <= RTOL
    feats, ali = utts[0]
    assert rel(fmllr.estimate_fmllr(tam, ttm, feats, ali, min_count=10.0,
                                    device="cpu"),
               jfmllr.estimate_fmllr(jam, jtm, feats, ali,
                                     min_count=10.0)) <= 1e-8


def test_the_card_is_required_unless_declined():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for make in (lambda: lda.LdaEstimate(3, 2), lambda: mllt.MlltAccs(2),
                 lambda: fmllr.FmllrDiagGmmAccs(2),
                 lambda: fmllr.apply_affine_transform(
                     np.zeros((1, 2)), np.zeros((2, 3)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
