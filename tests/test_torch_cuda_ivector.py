"""The i-vector tools on the card against --use-gpu=no: the extractor's
E-step (ivector-extractor-acc-stats, full and diagonal UBM), the full
UBM's statistics (fgmm-global-acc-stats) and ivector-extract, at small
widths over seeded features.  These tests need an NVIDIA GPU, so they
skip elsewhere; on a machine with a card run them with
`python -m pytest tests/test_torch_cuda_ivector.py -m cuda -q
--noconftest`.  They import no jax."""

import contextlib
import io

import numpy as np
import pytest
import torch

from ivector_fixtures import rel_err, synth_feats, write_set
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.ivector.extractor import IvectorExtractorStats
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.table import SequentialTableReader

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def run(tool, *args):
    with contextlib.redirect_stderr(io.StringIO()):
        assert get_tool(tool)([tool, *[str(a) for a in args]]) == 0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A diagonal and a full UBM of 16 Gaussians and an extractor (R=8)
    of each, trained on the CPU by the tools."""
    d = tmp_path_factory.mktemp("cuda_ivec")
    write_set(d / "train", synth_feats(24, 6, seed=21))
    tr = f"ark:{d}/train/feats.ark"
    run("gmm-global-init-from-feats", "--use-gpu=no", "--num-gauss=16",
        "--num-iters=3", tr, d / "dubm")
    run("gmm-global-to-fgmm", d / "dubm", d / "0.ubm")
    run("fgmm-global-acc-stats", "--use-gpu=no", d / "0.ubm", tr, d / "facc")
    run("fgmm-global-est", "--min-gaussian-occupancy=3", d / "0.ubm",
        d / "facc", d / "ubm")
    run("ivector-extractor-init", "--use-full-ubm", "--ivector-dim=8",
        d / "ubm", d / "full.ie")
    run("ivector-extractor-init", "--ivector-dim=8", d / "dubm", d / "diag.ie")
    return d, tr


def _stats(path):
    return kaldi_io.read_kaldi_object(IvectorExtractorStats.read, str(path))


@pytest.mark.parametrize("ie", ["full.ie", "diag.ie"])
def test_card_e_step_against_cpu(models, tmp_path, cuda, ie):
    """A and B within 1e-9 of their largest element with the full UBM
    (float64 throughout); with the diagonal UBM the posteriors are
    float32 (torch's products on the card, the reference's numpy
    products on the CPU), within 1e-6."""
    d, tr = models
    for g in ("yes", "no"):
        run("ivector-extractor-acc-stats", f"--use-gpu={g}", d / ie, tr,
            tmp_path / g)
    card, cpu = _stats(tmp_path / "yes"), _stats(tmp_path / "no")
    tol = 1e-9 if ie == "full.ie" else 1e-6
    assert rel_err(card.A, cpu.A) < tol and rel_err(card.B, cpu.B) < tol


def test_card_full_ubm_stats_against_cpu(models, tmp_path, cuda):
    d, tr = models
    for g in ("yes", "no"):
        run("fgmm-global-acc-stats", f"--use-gpu={g}", d / "ubm", tr,
            tmp_path / g)
    with np.load(tmp_path / "yes") as a, np.load(tmp_path / "no") as b:
        for k in b.files:
            assert rel_err(a[k], b[k]) < 1e-9, k


def test_card_ivectors_against_cpu(models, tmp_path, cuda):
    d, tr = models
    for g in ("yes", "no"):
        run("ivector-extract", f"--use-gpu={g}", d / "full.ie", tr,
            f"ark:{tmp_path}/{g}")
    card, cpu = ({k: np.asarray(v) for k, v in SequentialTableReader(
        "vector", f"ark:{tmp_path}/{g}")} for g in ("yes", "no"))
    assert list(card) == list(cpu)
    assert max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu) < 1e-6


def test_card_m_step_singular_raises(models, tmp_path, cuda):
    """A Gaussian with no occupancy makes A_g singular: the card's batched
    solve raises, as on the CPU (numpy's solve raises in the
    reference), instead of writing inf or NaN into the extractor."""
    from kaldi_tpu_torch.base.logging import KaldiTpuError
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    d, tr = models
    run("ivector-extractor-acc-stats", "--use-gpu=no", d / "full.ie", tr,
        tmp_path / "acc")
    ex = kaldi_io.read_kaldi_object(IvectorExtractor.read, str(d / "full.ie"))
    st = _stats(tmp_path / "acc")
    st.A[3] = 0.0
    with pytest.raises(KaldiTpuError):
        st.update(ex, cuda)
