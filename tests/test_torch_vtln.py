"""Port parity: VTLN (the warped mel banks of `feat/mel.py`, the
frontend's per-warp banks, compute-mfcc-feats' VTLN options), linear
VTLN (`transform/lvtln.py`) and the global-GMM transform tools of
`cli/vtln_tools.py` against the JAX package's, on the CPU, over the
generic recipe's fabricated corpus (6 training utterances, 3 speakers,
13-dim MFCC).

Tolerances: the mel matrices are equal (the same float32 numpy
arithmetic); MFCC within atol 2e-3 / rtol 1e-4 (the reference's own
tolerance against Kaldi); the float64 statistics, least-squares
transforms and fMLLR/LVTLN transforms within 1e-9 of their largest
element (1e-7 for the fMLLR update's 20 row iterations); files whose
bytes come from the same numbers byte for byte."""

import contextlib
import io

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.feat import mel as jmel
from kaldi_tpu.feat.window import FrameExtractionOptions as JFrame
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.cli.vtln_tools import DEVICE_TOOLS
from kaldi_tpu_torch.feat import mel as tmel
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.gmm.mle import AccumDiagGmm
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.transform.lvtln import LinearVtln, read_lvtln_file
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.table import SequentialTableReader

MFCC = ["--sample-frequency=8000", "--dither=0"]
GPU_TOOLS = DEVICE_TOOLS + ("compute-mfcc-feats",)


def run(side, tool, *args):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and tool in GPU_TOOLS \
        else []
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exited {rc}"


def table(spec, holder="matrix"):
    return {k: np.asarray(v) for k, v in SequentialTableReader(holder, spec)}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("warp", [0.85, 0.94, 1.0, 1.07, 1.15])
@pytest.mark.parametrize("vtln_high", [-500.0, 3400.0])
def test_mel_banks_equal_jax(warp, vtln_high):
    for fs, bins in ((8000.0, 23), (16000.0, 40)):
        want = jmel.mel_banks_matrix(
            jmel.MelBanksOptions(bins, vtln_high=vtln_high),
            JFrame(samp_freq=fs), warp)
        got = tmel.mel_banks_matrix(
            tmel.MelBanksOptions(bins, vtln_high=vtln_high),
            FrameExtractionOptions(samp_freq=fs), warp)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus; JAX's unwarped and 0.9-warped MFCC of the train set;
    a speaker warp map; JAX's 8-Gaussian diagonal UBM."""
    root = tmp_path_factory.mktemp("vtln")
    make_standard_corpus(str(root), 6, 2)
    d = root / "train"
    run("jax", "compute-mfcc-feats", *MFCC, f"scp:{d}/wav.scp",
        f"ark:{root}/unwarped.ark")
    run("jax", "compute-mfcc-feats", *MFCC, "--vtln-warp=0.9",
        f"scp:{d}/wav.scp", f"ark:{root}/warped.ark")
    (root / "spk2warp").write_text("spk0 0.88\nspk1 1.0\nspk2 1.12\n")
    by = {}
    for line in (d / "utt2spk").read_text().splitlines():
        u, s = line.split()
        by.setdefault(s, []).append(u)
    (root / "spk2utt").write_text("".join(
        f"{s} {' '.join(us)}\n" for s, us in sorted(by.items())))
    run("jax", "gmm-global-init-from-feats", "--num-gauss=8",
        "--num-iters=3", f"ark:{root}/unwarped.ark", root / "ubm")
    return root


@pytest.mark.parametrize("opts", [["--vtln-warp=0.88"], ["--vtln-warp=1.12"],
                                  ["--vtln-warp=0.95", "--vtln-low=200",
                                   "--vtln-high=-300"],
                                  ["--vtln-map=ark:SPK2WARP",
                                   "--utt2spk=ark:UTT2SPK"]])
def test_mfcc_vtln_options_match_jax(corpus, tmp_path, opts):
    d = corpus / "train"
    opts = [o.replace("SPK2WARP", str(corpus / "spk2warp"))
            .replace("UTT2SPK", str(d / "utt2spk")) for o in opts]
    for side in ("jax", "torch"):
        run(side, "compute-mfcc-feats", *MFCC, *opts, f"scp:{d}/wav.scp",
            f"ark:{tmp_path}/{side}.ark")
    got, want = table(f"ark:{tmp_path}/torch.ark"), \
        table(f"ark:{tmp_path}/jax.ark")
    assert list(got) == list(want) and len(got) == 6
    plain = table(f"ark:{corpus}/unwarped.ark")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, rtol=1e-4)
    # a warp moves the features (the mapped speaker spk1 keeps 1.0)
    moved = [k for k in want if not np.allclose(want[k], plain[k],
                                                atol=1e-3)]
    assert len(moved) == (4 if "--utt2spk" in " ".join(opts) else 6)


def test_mixed_warp_batch_equals_one_warp_a_batch(corpus):
    """One batch of three warps gives each lane what a batch of its own
    warp gives it."""
    from kaldi_tpu_torch.feat.wave import WaveData
    d = corpus / "train"
    waves = []
    for line in (d / "wav.scp").read_text().splitlines()[:3]:
        with open(line.split()[1], "rb") as f:
            waves.append(WaveData.read(f).channel(0))
    fe = OfflineFeature(MfccOptions(frame_opts=FrameExtractionOptions(
        samp_freq=8000.0, dither=0.0)), device="cpu")
    warps = [0.9, 1.1, 1.0]
    mixed, n = fe.compute_batch_device(waves, vtln_warp=warps)
    for i, w in enumerate(warps):
        alone, _ = fe.compute_batch_device(waves, vtln_warp=w)
        np.testing.assert_allclose(mixed[i, :n[i]].numpy(),
                                   alone[i, :n[i]].numpy(), atol=1e-5,
                                   rtol=0)
    with pytest.raises(ValueError):
        fe.compute_batch_device(waves, vtln_warp=[0.9, 1.0])
    assert sorted(fe._mel_cache) == [0.9, 1.0, 1.1]


@pytest.mark.parametrize("opts", [[], ["--binary=false"],
                                  ["--dim=13", "--num-classes=5",
                                   "--default-class=2"]])
def test_init_lvtln_bytes(tmp_path, opts):
    for side in ("jax", "torch"):
        run(side, "gmm-init-lvtln", *opts, tmp_path / side)
    assert (tmp_path / "torch").read_bytes() == (tmp_path / "jax").read_bytes()


def _lvtln(path) -> LinearVtln:
    with kaldi_io.input_stream(str(path)) as f:
        from kaldi_tpu_torch.base import io_funcs as iof
        return read_lvtln_file(f, iof.init_input_stream(f))


@pytest.fixture(scope="module")
def lvtln(corpus):
    """Both packages' LVTLN: 31 classes, class 5 (warp 0.9) trained on the
    parallel features."""
    run("jax", "gmm-init-lvtln", "--dim=13", corpus / "init.lvtln")
    for side in ("jax", "torch"):
        run(side, "gmm-train-lvtln-special", "--warp=0.9", 5,
            corpus / "init.lvtln", corpus / f"{side}.lvtln",
            f"ark:{corpus}/unwarped.ark", f"ark:{corpus}/warped.ark")
    return corpus


def test_train_lvtln_special_matches_jax(lvtln):
    got, want = _lvtln(lvtln / "torch.lvtln"), _lvtln(lvtln / "jax.lvtln")
    assert got.warps == want.warps and got.warps[5] == 0.9
    assert rel(got.A, want.A) < 1e-9
    assert not np.allclose(got.A[5], np.eye(13))
    assert np.array_equal(got.A[4], np.eye(13))


def test_train_lvtln_in_process_matches_the_tool(lvtln):
    from kaldi_tpu_torch.transform.lvtln import train_lvtln
    un, wa = table(f"ark:{lvtln}/unwarped.ark"), \
        table(f"ark:{lvtln}/warped.ark")
    keys = sorted(un)
    lv = train_lvtln([un[k] for k in keys], [[wa[k] for k in keys]], [0.9],
                     device="cpu")
    assert rel(lv.A[0], _lvtln(lvtln / "jax.lvtln").A[5]) < 1e-9


def test_lvtln_object_io_round_trip(tmp_path):
    lv = LinearVtln(3, [0.9, 1.0])
    lv.set_transform(0, np.arange(9.0).reshape(3, 3))
    for binary in (True, False):
        kaldi_io.write_kaldi_object(lv.write, str(tmp_path / "x"), binary)
        back = kaldi_io.read_kaldi_object(LinearVtln.read,
                                          str(tmp_path / "x"))
        assert np.allclose(back.warps, lv.warps)
        assert np.array_equal(back.A, lv.A)


def test_global_acc_stats_twofeats_matches_jax(corpus):
    for side in ("jax", "torch"):
        run(side, "gmm-global-acc-stats-twofeats", corpus / "ubm",
            f"ark:{corpus}/unwarped.ark", f"ark:{corpus}/warped.ark",
            corpus / f"{side}.tacc")
    got, want = (kaldi_io.read_kaldi_object(AccumDiagGmm.read,
                                            str(corpus / f"{s}.tacc"))
                 for s in ("torch", "jax"))
    for name in ("occupancy", "mean_accs", "var_accs"):
        assert rel(getattr(got, name), getattr(want, name)) < 1e-9, name


@pytest.mark.parametrize("spk", [True, False])
def test_global_est_lvtln_trans_matches_jax(lvtln, tmp_path, spk):
    opts = [f"--spk2utt=ark:{lvtln}/spk2utt"] if spk else []
    for side in ("jax", "torch"):
        run(side, "gmm-global-est-lvtln-trans", *opts, lvtln / "ubm",
            lvtln / "jax.lvtln", f"ark:{lvtln}/warped.ark",
            f"ark:{tmp_path}/{side}.trans", f"ark,t:{tmp_path}/{side}.warp")
    assert (tmp_path / "torch.warp").read_text() == \
        (tmp_path / "jax.warp").read_text()
    got, want = table(f"ark:{tmp_path}/torch.trans"), \
        table(f"ark:{tmp_path}/jax.trans")
    assert list(got) == list(want) and len(got) == (3 if spk else 6)
    for k in want:
        assert rel(got[k], want[k]) < 1e-9, k


@pytest.mark.parametrize("spk", [True, False])
def test_global_est_fmllr_matches_jax(corpus, tmp_path, spk):
    opts = [f"--spk2utt=ark:{corpus}/spk2utt"] if spk else []
    for side in ("jax", "torch"):
        run(side, "gmm-global-est-fmllr", *opts, corpus / "ubm",
            f"ark:{corpus}/warped.ark", f"ark:{tmp_path}/{side}")
    got, want = table(f"ark:{tmp_path}/torch"), table(f"ark:{tmp_path}/jax")
    assert list(got) == list(want)
    for k in want:
        assert rel(got[k], want[k]) < 1e-7, k


def test_vtln_tools_need_the_card_unless_declined(corpus, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    tool = ttool("gmm-global-acc-stats-twofeats")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool(["gmm-global-acc-stats-twofeats", str(corpus / "ubm"),
              f"ark:{corpus}/unwarped.ark", f"ark:{corpus}/warped.ark",
              str(tmp_path / "x")])
