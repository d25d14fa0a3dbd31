"""Port parity: the monophone GMM system of kaldi_tpu_torch against the
JAX package's, on the CPU: `AmDiagGmm.log_likes_batch` (within 1e-4
relative), the statistics and update of `accumulate_alignment` +
`mle_am_diag_gmm_update` with mixing-up (within 1e-5 relative), and
`train_mono` at 3 iterations and 40 Gaussians on a tiny bench corpus
(equal alignments; where a Viterbi tie flips, the two paths' costs equal
within 1e-4 relative)."""

import numpy as np
import pytest

from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.gmm import AccumAmDiagGmm as JAcc
from kaldi_tpu.gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm import DiagGmm as JGmm
from kaldi_tpu.gmm import MleDiagGmmOptions as JOpts
from kaldi_tpu.gmm import mle_am_diag_gmm_update as jupdate
from kaldi_tpu.native import NativeViterbi as JNat
from kaldi_tpu.recipes import mono as jmono
from kaldi_tpu_torch.decoder import graph as tgraph
from kaldi_tpu_torch.decoder.native_viterbi import NativeViterbi as TNat
from kaldi_tpu_torch.decoder.viterbi import align_equal
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm as TAm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm as TGmm
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm as TAcc
from kaldi_tpu_torch.gmm.mle import MleDiagGmmOptions as TOpts
from kaldi_tpu_torch.gmm.mle import mle_am_diag_gmm_update as tupdate
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.recipes import mono as tmono

from jax_native_private import private_jax_native_build  # noqa: F401

TINY = dict(vocab=30, num_phone_groups=5, phones_per_group=2,
            words_per_utt=8, num_train=16, num_test=2, num_lm_sents=60,
            noise=850.0, f2_gap=120.0, seed=11)


@pytest.fixture(scope="module")
def corpus():
    """(lexicon, transcripts, 13-cepstra MFCC features) of 16 training
    utterances, the features from the port's frontend on the CPU."""
    spec = tbc.BenchCorpusSpec(**TINY)
    lexicon, train_txt, train_wav, _, _, _ = tbc.make_corpus(spec)
    fe = OfflineFeature(tbc.mfcc_options(spec, num_ceps=13), device="cpu")
    f, n = fe.compute_batch_device(list(train_wav.values()))
    feats = {u: f[i, :n[i]].numpy().copy() for i, u in enumerate(train_wav)}
    return lexicon, train_txt, feats


def random_am_pair(num_pdfs=7, dim=5, seed=0):
    """The same random GMMs (1 to 4 Gaussians a pdf) as a port and a JAX
    AmDiagGmm."""
    rng = np.random.default_rng(seed)
    t_am, j_am = TAm(device="cpu"), JAm()
    for _ in range(num_pdfs):
        n = int(rng.integers(1, 5))
        w = rng.random(n) + 0.1
        mean = rng.normal(size=(n, dim))
        var = rng.random((n, dim)) + 0.2
        for am, G in ((t_am, TGmm), (j_am, JGmm)):
            g = G(n, dim)
            g.set_from_means_and_vars(w / w.sum(), mean, var)
            am.add_pdf(g)
    return t_am, j_am


def assert_ams_close(t_am, j_am, rtol):
    assert t_am.num_pdfs == j_am.num_pdfs
    for tg, jg in zip(t_am.densities, j_am.densities):
        assert tg.num_gauss == jg.num_gauss
        for name in ("weights", "gconsts", "means_invvars", "inv_vars"):
            a, b = getattr(tg, name), getattr(jg, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol,
                                       err_msg=name)


@pytest.mark.parametrize("shape", [(9, 5), (3, 11, 5)])
def test_log_likes_batch_matches(shape):
    t_am, j_am = random_am_pair()
    feats = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got, want = t_am.log_likes_batch(feats), j_am.log_likes_batch(feats)
    assert got.shape == want.shape == shape[:-1] + (7,)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_accumulate_and_update_with_mixup_match(corpus):
    """One EM step from the flat start on equal alignments, mixing up to
    40 Gaussians: the statistics, the updated GMMs and the transition
    model agree within 1e-5 relative."""
    lexicon, txt, feats = corpus
    systems = []
    for graph, mono, Acc, Opts, update in (
            (tgraph, tmono, TAcc, TOpts, tupdate),
            (jgraph, jmono, JAcc, JOpts, jupdate)):
        lang = graph.Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
        kw = {"device": "cpu"} if mono is tmono else {}
        sys_ = mono.init_mono(lang, list(feats.values()), **kw)
        comp = graph.TrainingGraphCompiler(sys_.tm, sys_.tree, lang)
        acc = Acc(sys_.am, num_transition_ids=sys_.tm.num_transition_ids)
        for i, u in enumerate(feats):
            ali = align_equal(comp.compile(txt[u]), feats[u].shape[0],
                              sys_.tm, seed=i)
            acc.accumulate_alignment(sys_.am, sys_.tm, feats[u], ali)
        update(Opts(min_gaussian_occupancy=3.0), acc, sys_.am, sys_.tm,
               mixup=40)
        systems.append((sys_, acc))
    (t, t_acc), (j, j_acc) = systems
    np.testing.assert_array_equal(t_acc.transition_accs, j_acc.transition_accs)
    assert t_acc.total_frames == j_acc.total_frames
    np.testing.assert_allclose(t_acc.total_loglike, j_acc.total_loglike,
                               rtol=1e-5)
    for a, b in zip(t_acc.accs, j_acc.accs):
        np.testing.assert_allclose(a.occupancy, b.occupancy, rtol=1e-5)
        np.testing.assert_allclose(a.mean_accs, b.mean_accs, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(a.var_accs, b.var_accs, rtol=1e-5)
    assert t.am.num_gauss() == j.am.num_gauss() >= 40
    assert_ams_close(t.am, j.am, 1e-5)
    np.testing.assert_allclose(t.tm.log_probs, j.tm.log_probs, rtol=1e-5)


def _tie_or_equal(t, j, tgs, jgs, feats, ta, ja) -> list:
    """Utterances whose alignments differ; each must be a flipped
    Viterbi tie: the port's path under its model costs what the JAX
    package's path costs under its model, within 1e-4 relative."""
    differ = [u for u in feats if ta[u] != ja[u]]
    for u in differ:
        ct = TNat(tgs[u]).decode(t.am.log_likes_batch(feats[u]),
                                 t.tm.id2pdf_id, 0.1, beam=10.0)[2]
        cj = JNat(jgs[u]).decode(j.am.log_likes_batch(feats[u]),
                                 j.tm.id2pdf_id, 0.1, beam=10.0)[2]
        assert abs(ct - cj) <= 1e-4 * abs(cj), u
    return differ


def test_train_mono_lockstep_matches(corpus):
    """train_mono's loop at 3 iterations and 40 Gaussians, one step at a
    time: each realignment (`_align_all`) equal to the JAX package's or a
    tie, then both systems estimate (`_estimate`, with mixing-up) from
    the JAX package's alignments, so that one flipped tie does not carry
    into the next iteration; the GMMs then agree within 1e-5."""
    lexicon, txt, feats = corpus
    opts = dict(num_iters=3, totgauss=40)
    systems = []
    for graph, mono, kw in ((tgraph, tmono, {"device": "cpu"}),
                            (jgraph, jmono, {})):
        lang = graph.Lang(lexicon, "SIL", 0.5)
        sys_ = mono.init_mono(lang, list(feats.values()), **kw)
        comp = graph.TrainingGraphCompiler(sys_.tm, sys_.tree, lang)
        systems.append((sys_, {u: comp.compile(txt[u]) for u in feats},
                        mono, mono.TrainMonoOptions(**opts)))
    (t, tgs, _, t_opts), (j, jgs, _, j_opts) = systems
    alis = {u: align_equal(tgs[u], feats[u].shape[0], t.tm, seed=i)
            for i, u in enumerate(feats)}
    tmono._estimate(t, feats, alis, t_opts, mixup=None)
    jmono._estimate(j, feats, alis, j_opts, mixup=None, first_iter=True)
    assert_ams_close(t.am, j.am, 1e-5)
    num_gauss = j.am.num_gauss()
    inc = max((40 - num_gauss) // t_opts.max_iter_inc, 1)
    flips = 0
    for it in (1, 2):
        beam = t_opts.initial_beam if it == 1 else t_opts.beam
        ta = tmono._align_all(t, tgs, feats, beam, 0.1, 1.0, prev=alis)
        ja = jmono._align_all(j, jgs, feats, beam, 0.1, 1.0, prev=alis)
        assert t.aligner == tmono.NATIVE
        flips += len(_tie_or_equal(t, j, tgs, jgs, feats, ta, ja))
        alis = ja
        num_gauss = min(40, num_gauss + inc)
        tmono._estimate(t, feats, alis, t_opts, mixup=num_gauss)
        jmono._estimate(j, feats, alis, j_opts, mixup=num_gauss)
        assert t.am.num_gauss() == j.am.num_gauss()
        assert_ams_close(t.am, j.am, 1e-5)
        np.testing.assert_allclose(t.tm.log_probs, j.tm.log_probs,
                                   rtol=1e-5)
    assert len(t.avg_loglikes) == 3
    assert flips <= len(feats) // 4


def _jax_avg_loglikes(monkeypatch) -> list:
    """The JAX package reports each _estimate's average loglike only
    through `log`: collect them."""
    seen = []
    orig = jmono.log

    def log(msg):
        if msg.startswith("avg loglike/frame "):
            seen.append(float(msg.split()[2]))
        orig(msg)
    monkeypatch.setattr(jmono, "log", log)
    return seen


def test_train_mono_end_to_end(corpus, monkeypatch):
    """train_mono itself, 3 iterations and 40 Gaussians: where a tie
    flips, the two systems part (see the lockstep test), so the bar is
    the same Gaussian count, average loglikes within 1e-3 relative and
    most final alignments equal, the rest ties."""
    lexicon, txt, feats = corpus
    opts = dict(num_iters=3, totgauss=40)
    j_avg = _jax_avg_loglikes(monkeypatch)
    t = tmono.train_mono(tgraph.Lang(lexicon, "SIL", 0.5), feats, txt,
                         tmono.TrainMonoOptions(**opts), device="cpu")
    j = jmono.train_mono(jgraph.Lang(lexicon, "SIL", 0.5), feats, txt,
                         jmono.TrainMonoOptions(**opts))
    assert t.aligner == tmono.NATIVE
    assert t.am.num_gauss() == j.am.num_gauss()
    # the JAX package logs its averages rounded to 4 decimals
    assert len(t.avg_loglikes) == len(j_avg) == 3
    np.testing.assert_allclose(t.avg_loglikes, j_avg, rtol=1e-3)
    tc = tgraph.TrainingGraphCompiler(t.tm, t.tree, t.lang)
    jc = jgraph.TrainingGraphCompiler(j.tm, j.tree, j.lang)
    tgs = {u: tc.compile(txt[u]) for u in feats}
    jgs = {u: jc.compile(txt[u]) for u in feats}
    ta = tmono._align_all(t, tgs, feats, 10.0, 0.1, 1.0)
    ja = jmono._align_all(j, jgs, feats, 10.0, 0.1, 1.0)
    assert set(ta) == set(ja) == set(feats)
    differ = [u for u in feats if ta[u] != ja[u]]
    assert len(differ) <= len(feats) // 4
