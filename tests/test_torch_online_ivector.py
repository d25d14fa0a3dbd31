"""Port parity: the online i-vector state (`ivector/extractor.py`
OnlineIvectorEstimationStats) and the streaming i-vector feature with
silence weighting and speaker adaptation state
(`online/ivector_feature.py`) against the JAX package's, on the CPU, at
small widths.  Both are float64; every frame is held within 1e-6 (the
port computes Sigma^-1 M and U once where the reference recomputes them
for every chunk)."""

import numpy as np
import pytest

from ivector_fixtures import synth_feats
from kaldi_tpu.gmm.full_gmm import FullGmm as JFull
from kaldi_tpu.ivector.extractor import IvectorExtractor as JEx
from kaldi_tpu.ivector.extractor import \
    OnlineIvectorEstimationStats as JStats
from kaldi_tpu.online import ivector_feature as jif
from kaldi_tpu.online.features import OnlineFeatureInterface as JIface
from kaldi_tpu_torch.gmm.full_gmm import FullGmm
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               OnlineIvectorEstimationStats)
from kaldi_tpu_torch.online import ivector_feature as tif
from kaldi_tpu_torch.online.features import OnlineFeatureInterface as TIface

D, R, G = 6, 4, 5


def _extractors(full: bool):
    from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    rng = np.random.default_rng(11)
    w = rng.dirichlet(np.ones(G))
    means = rng.normal(scale=2.0, size=(G, D))
    var = rng.uniform(0.5, 2.0, size=(G, D))
    if full:
        A = rng.normal(scale=0.3, size=(G, D, D))
        cov = np.einsum("mde,mfe->mdf", A, A) + np.eye(D)[None]
        j, t = JFull(G, D), FullGmm(G, D)
        j.set_from_means_and_covars(w, means, cov)
        t.set_from_means_and_covars(w, means, cov)
    else:
        j, t = JDiag(G, D), DiagGmm(G, D)
        j.set_from_means_and_vars(w, means, var)
        t.set_from_means_and_vars(w, means, var)
    return JEx(j, R, 20.0, seed=2), IvectorExtractor(t, R, 20.0, seed=2)


def _src(base, feats):
    class Mat(base):
        def __init__(self):
            self.ready = 0

        def dim(self):
            return feats.shape[1]

        def num_frames_ready(self):
            return self.ready

        def is_last_frame(self, f):
            return f == feats.shape[0] - 1

        def get_frame(self, f):
            return feats[f]
    return Mat()


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("max_count", [0.0, 60.0])
def test_estimation_stats(full, max_count):
    jex, tex = _extractors(full)
    js, ts = JStats(jex, max_count), OnlineIvectorEstimationStats(
        tex, max_count, device="cpu")
    x = synth_feats(1, D, seed=12, min_len=150)["u000"]
    w = np.random.default_rng(13).uniform(0.0, 1.0, size=len(x))
    for t0 in range(0, len(x), 17):
        js.acc_frames(x[t0:t0 + 17], w[t0:t0 + 17])
        ts.acc_frames(x[t0:t0 + 17], w[t0:t0 + 17])
        np.testing.assert_allclose(ts.ivector(), js.ivector(), rtol=1e-6,
                                   atol=1e-6)
    js.scale(0.4)
    ts.scale(0.4)
    np.testing.assert_allclose(ts.ivector(), js.ivector(), rtol=1e-6,
                               atol=1e-6)
    assert ts.num_frames == pytest.approx(js.num_frames, rel=1e-12)


class _Tm:
    """A transition model's phone lookup: transition-id t is phone t % 4
    (phone 0 is silence here)."""

    def transition_id_to_phone(self, tid):
        return tid % 4


@pytest.mark.parametrize("most_recent", [True, False])
def test_online_ivector_feature(most_recent):
    """Two utterances of one speaker through OnlineIvectorFeature:
    frames as they become ready, silence weighting from a traceback, the
    second utterance primed with the first's adaptation state."""
    jex, tex = _extractors(True)
    utts = list(synth_feats(2, D, seed=14, min_len=90).values())
    opts = dict(ivector_period=7, max_count=80.0,
                use_most_recent_ivector=most_recent, silence_weight=0.1)
    states = [None, None]
    for x in utts:
        feats = []
        for k, (mod, base, ex) in enumerate(((jif, JIface, jex),
                                             (tif, TIface, tex))):
            src = _src(base, x)
            f = mod.OnlineIvectorFeature(
                ex, src, mod.OnlineIvectorExtractionOptions(**opts),
                states[k], **({"device": "cpu"} if mod is tif else {}))
            sw = mod.OnlineSilenceWeighting(_Tm(), [0], 0.1)
            feats.append((src, f, sw))
        ali = np.random.default_rng(15).integers(1, 40, size=len(x))
        out = [[], []]
        for ready in range(10, len(x) + 10, 13):
            for k, (src, f, sw) in enumerate(feats):
                src.ready = min(ready, len(x))
                f.update_frame_weights(sw.compute_from_traceback(
                    ali[:max(0, src.ready - 5)]))
                out[k].extend(f.get_frame(t) for t in
                              range(max(0, src.ready - 13), src.ready))
        np.testing.assert_allclose(np.stack(out[1]), np.stack(out[0]),
                                   rtol=1e-6, atol=1e-6)
        states = [f.get_adaptation_state() for _, f, _ in feats]
    assert feats[1][1].dim() == R
