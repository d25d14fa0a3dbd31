"""The card paths of this slice against --use-gpu=no / device="cpu": the
logistic regression's float32 training, warped MFCC (one warp and a
batch of mixed warps), the global GMM's twofeats statistics and the
fMLLR statistics against a global GMM, over seeded data.  These tests
need an NVIDIA GPU, so they skip elsewhere; on a machine with a card run
them with `python -m pytest tests/test_torch_cuda_backend.py -m cuda -q
--noconftest`.  They import no jax."""

import contextlib
import io

import numpy as np
import pytest
import torch

from ivector_fixtures import rel_err, synth_feats, write_set
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.util import kaldi_io

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def run(tool, *args):
    with contextlib.redirect_stderr(io.StringIO()):
        assert get_tool(tool)([tool, *[str(a) for a in args]]) == 0


def test_card_logistic_regression_against_cpu(cuda):
    """200 float32 Adam steps: the weights within 1e-5 of the largest
    weight, the CPU port's tolerance against JAX."""
    from kaldi_tpu_torch.ivector.logistic_regression import (
        LogisticRegressionConfig, train_logistic_regression)
    rng = np.random.default_rng(1)
    means = rng.normal(size=(6, 16))
    y = rng.integers(0, 6, 200)
    x = means[y] + 0.8 * rng.normal(size=(200, 16))
    for mix in (0, 14):
        cfg = LogisticRegressionConfig(mix_up=mix)
        card = train_logistic_regression(x, y, cfg, device=cuda)
        cpu = train_logistic_regression(x, y, cfg, device="cpu")
        assert np.array_equal(card.class_of, cpu.class_of)
        assert rel_err(card.weights, cpu.weights) < 1e-5


def test_card_warped_mfcc_against_cpu(cuda):
    """atol 2e-3 / rtol 1e-4, the feature tolerance."""
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.feat.window import FrameExtractionOptions
    rng = np.random.default_rng(0)
    waves = [(3000 * rng.normal(size=n)).astype(np.int16)
             for n in (12000, 16000, 9000)]
    opts = MfccOptions(frame_opts=FrameExtractionOptions(
        samp_freq=16000.0, dither=0.0))
    card = OfflineFeature(opts, device=cuda)
    cpu = OfflineFeature(opts, device="cpu")
    for warp in (0.87, 1.12, [0.9, 1.0, 1.1]):
        a, n = card.compute_batch_device(waves, vtln_warp=warp)
        b, _ = cpu.compute_batch_device(waves, vtln_warp=warp)
        for i in range(len(waves)):
            np.testing.assert_allclose(a[i, :n[i]].cpu().numpy(),
                                       b[i, :n[i]].numpy(), atol=2e-3,
                                       rtol=1e-4)


@pytest.fixture(scope="module")
def ubm(tmp_path_factory):
    d = tmp_path_factory.mktemp("cuda_vtln")
    feats = synth_feats(12, 6, seed=5)
    write_set(d / "a", feats)
    write_set(d / "b", {u: (1.1 * f + 0.3).astype(np.float32)
                        for u, f in feats.items()})
    run("gmm-global-init-from-feats", "--use-gpu=no", "--num-gauss=8",
        "--num-iters=2", f"ark:{d}/a/feats.ark", d / "ubm")
    return d


def test_card_twofeats_stats_against_cpu(ubm, tmp_path, cuda):
    """float64 statistics of float32 posteriors: within 1e-6 (the card's
    float32 products against numpy's, as the i-vector tools' diagonal
    UBM)."""
    from kaldi_tpu_torch.gmm.mle import AccumDiagGmm
    d = ubm
    for g in ("yes", "no"):
        run("gmm-global-acc-stats-twofeats", f"--use-gpu={g}", d / "ubm",
            f"ark:{d}/a/feats.ark", f"ark:{d}/b/feats.ark", tmp_path / g)
    card, cpu = (kaldi_io.read_kaldi_object(AccumDiagGmm.read,
                                            str(tmp_path / g))
                 for g in ("yes", "no"))
    for name in ("occupancy", "mean_accs", "var_accs"):
        assert rel_err(getattr(card, name), getattr(cpu, name)) < 1e-6


def test_card_global_fmllr_stats_against_cpu(ubm, cuda):
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.ubm import UbmScorer
    from kaldi_tpu_torch.transform.fmllr import FmllrDiagGmmAccs
    from kaldi_tpu_torch.util.table import SequentialTableReader
    d = ubm
    gmm = kaldi_io.read_kaldi_object(DiagGmm.read, str(d / "ubm"))
    feats = [np.asarray(m) for _, m in SequentialTableReader(
        "matrix", f"ark:{d}/b/feats.ark")]
    accs = {}
    for dev in (cuda, torch.device("cpu")):
        acc = FmllrDiagGmmAccs(gmm.dim, device=dev)
        scorer = UbmScorer(gmm, dev)
        for f in feats:
            acc.accumulate_from_ubm(scorer, gmm, f)
        accs[dev.type] = acc
    for name in ("K", "G"):
        assert rel_err(getattr(accs["cuda"], name),
                       getattr(accs["cpu"], name)) < 1e-6
    assert accs["cuda"].beta == pytest.approx(accs["cpu"].beta, rel=1e-9)
