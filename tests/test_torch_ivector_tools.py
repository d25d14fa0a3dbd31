"""Port parity: the i-vector tool chain (`cli/ivector_tools.py`: the
global UBM, Gaussian-selection, extractor and extraction tools) against
the JAX package's tools, on the CPU, at small widths (8 Gaussians, 6
dimensions, i-vectors of 4) over seeded features of 4 speakers.

Each port tool reads the files the JAX ladder wrote at the same step.
Files whose arithmetic is the reference's host numpy come out byte for
byte (the GMM and extractor updates' inputs, copies, sums, conversions,
ivector-extractor-init's seeded draw); the full-covariance statistics,
the extractor's E-step and M-step agree within 1e-9 of their largest
element (float64 on both sides), and so does the diagonal UBM's EM
(float32 scores and posteriors, which the CPU computes with the
reference's own numpy products); i-vectors within 1e-6.  The tool ladder
also equals the main path's in-process `train_bench_extractor`, which
runs the same code."""

import contextlib
import io

import numpy as np
import pytest

from ivector_fixtures import read_table, rel_err, synth_feats, write_set
from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.gmm.mle import AccumDiagGmm as JAccDiag
from kaldi_tpu.ivector.extractor import IvectorExtractor as JEx
from kaldi_tpu.ivector.extractor import IvectorExtractorStats as JStats
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.cli.ivector_tools import DEVICE_TOOLS
from kaldi_tpu_torch.ivector.batched import train_bench_extractor
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               IvectorExtractorStats)
from kaldi_tpu_torch.util import kaldi_io as tio

G, D, R = 8, 6, 4

def run(side, tool, *args, use_gpu="no") -> str:
    """Run a tool of the JAX package or of the port -> its stdout."""
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = [f"--use-gpu={use_gpu}"] if side == "torch" and \
        tool in DEVICE_TOOLS else []
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    out.flush()
    assert rc == 0, f"{side} {tool} exited {rc}"
    return buf.getvalue().decode()


@pytest.fixture(scope="module")
def lad(tmp_path_factory):
    """The JAX ladder: UBM init, 2 diagonal and 2 full EM iterations,
    full and diagonal extractors, 2 extractor iterations over 2 splits."""
    root = tmp_path_factory.mktemp("ivec")
    feats = synth_feats(24, D, seed=3)
    write_set(root / "train", feats)
    keys = sorted(feats)
    for j in range(2):
        write_set(root / f"split{j}", {u: feats[u] for u in keys[j::2]})
    write_set(root / "test", synth_feats(8, D, seed=4))
    j = root / "jax"
    j.mkdir()
    tr = f"ark:{root}/train/feats.ark"
    run("jax", "gmm-global-init-from-feats", f"--num-gauss={G}",
        "--num-iters=3", "--num-frames=2500", tr, j / "0.dubm")
    for it in range(2):
        run("jax", "gmm-global-acc-stats", j / f"{it}.dubm", tr,
            j / f"{it}.dacc")
        run("jax", "gmm-global-est", "--min-gaussian-occupancy=3",
            j / f"{it}.dubm", j / f"{it}.dacc", j / f"{it + 1}.dubm")
    run("jax", "gmm-global-to-fgmm", j / "2.dubm", j / "0.ubm")
    for it in range(2):
        run("jax", "fgmm-global-acc-stats", j / f"{it}.ubm", tr,
            j / f"{it}.facc")
        run("jax", "fgmm-global-est", "--min-gaussian-occupancy=3",
            j / f"{it}.ubm", j / f"{it}.facc", j / f"{it + 1}.ubm")
    run("jax", "ivector-extractor-init", "--use-full-ubm",
        f"--ivector-dim={R}", j / "2.ubm", j / "0.ie")
    run("jax", "ivector-extractor-init", f"--ivector-dim={R}",
        j / "2.dubm", j / "d.ie")
    for it in range(2):
        for s in range(2):
            run("jax", "ivector-extractor-acc-stats", j / f"{it}.ie",
                f"ark:{root}/split{s}/feats.ark", j / f"{it}.{s}.iacc")
        run("jax", "ivector-extractor-sum-accs", j / f"{it}.iacc",
            j / f"{it}.0.iacc", j / f"{it}.1.iacc")
        run("jax", "ivector-extractor-est", j / f"{it}.ie", j / f"{it}.iacc",
            j / f"{it + 1}.ie")
    run("jax", "ivector-extractor-acc-stats", j / "d.ie", tr, j / "d.iacc")
    run("jax", "gmm-gselect", "--n=3", j / "2.dubm", tr, f"ark:{j}/d.gs")
    run("jax", "fgmm-gselect", "--n=3", j / "2.ubm", tr, f"ark:{j}/f.gs")
    run("jax", "gmm-global-get-post", "--n=3", j / "2.dubm", tr,
        f"ark:{j}/d.post")
    return {"root": root, "j": j, "feats": feats, "tr": tr}


def _fill(args, lad, out):
    return [str(a).format(root=lad["root"], j=lad["j"], out=out,
                          tr=lad["tr"]) for a in args]


def _both(lad, tmp_path, tool, args):
    outs = []
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.out"
        run(side, tool, *_fill(args, lad, out))
        outs.append(out)
    return outs


BYTE_EQUAL = {
    "gmm-global-est": ["{j}/0.dubm", "{j}/0.dacc", "{out}"],
    "gmm-global-to-fgmm": ["{j}/2.dubm", "{out}"],
    "fgmm-global-est": ["{j}/0.ubm", "{j}/0.facc", "{out}"],
    "fgmm-global-to-gmm": ["{j}/2.ubm", "{out}"],
    "gmm-global-sum-accs": ["{out}", "{j}/0.dacc", "{j}/1.dacc"],
    "fgmm-global-sum-accs": ["{out}", "{j}/0.facc", "{j}/1.facc"],
    "ivector-extractor-sum-accs": ["{out}", "{j}/0.0.iacc", "{j}/0.1.iacc"],
    "gmm-global-copy": ["--binary=false", "{j}/2.dubm", "{out}"],
    "fgmm-global-copy": ["--binary=false", "{j}/2.ubm", "{out}"],
    "ivector-extractor-copy": ["{j}/2.ie", "{out}"],
    "ivector-extractor-init": ["--use-full-ubm", f"--ivector-dim={R}",
                               "{j}/2.ubm", "{out}"],
    "ivector-extractor-init-diag": [f"--ivector-dim={R}", "--prior-offset=50",
                                    "{j}/2.dubm", "{out}"],
    "fgmm-global-merge": ["{out}", "{out}.sizes", "{j}/1.ubm", "{j}/2.ubm"],
    "fgmm-global-init-from-accs": ["{j}/1.facc", G, "{out}"],
    "copy-gselect": ["--n=2", "ark:{j}/f.gs", "ark:{out}"],
    "ivector-randomize": ["--randomize-prob=0.4", "--srand=3",
                          "ark:{j}/online.ark", "ark:{out}"],
}


@pytest.mark.parametrize("name", sorted(BYTE_EQUAL))
def test_files_byte_equal(lad, tmp_path, name):
    if name == "ivector-randomize":
        run("jax", "ivector-extract-online", lad["j"] / "2.ie", lad["tr"],
            f"ark:{lad['j']}/online.ark")
    tool = name.replace("-diag", "")
    jout, tout = _both(lad, tmp_path, tool, BYTE_EQUAL[name])
    assert jout.read_bytes() == tout.read_bytes()


def test_diag_ubm_em(lad, tmp_path):
    """gmm-global-init-from-feats (3 EM iterations) and one
    gmm-global-acc-stats within 1e-9 of the JAX tools'."""
    out = tmp_path / "0.dubm"
    run("torch", "gmm-global-init-from-feats", f"--num-gauss={G}",
        "--num-iters=3", "--num-frames=2500", lad["tr"], out)
    got = tio.read_kaldi_object(JDiag.read, str(out))
    want = jio.read_kaldi_object(JDiag.read, str(lad["j"] / "0.dubm"))
    for a in ("weights", "means_invvars", "inv_vars", "gconsts"):
        assert rel_err(getattr(got, a), getattr(want, a)) < 1e-9, a
    run("torch", "gmm-global-acc-stats", lad["j"] / "1.dubm", lad["tr"],
        tmp_path / "acc")
    got = jio.read_kaldi_object(JAccDiag.read, str(tmp_path / "acc"))
    want = jio.read_kaldi_object(JAccDiag.read, str(lad["j"] / "1.dacc"))
    for a in ("occupancy", "mean_accs", "var_accs"):
        assert rel_err(getattr(got, a), getattr(want, a)) < 1e-9, a


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_full_ubm_stats(lad, tmp_path):
    run("torch", "fgmm-global-acc-stats", lad["j"] / "1.ubm", lad["tr"],
        tmp_path / "acc")
    got, want = _npz(tmp_path / "acc"), _npz(lad["j"] / "1.facc")
    for k in want:
        assert rel_err(got[k], want[k]) < 1e-9, k


def _stats(path):
    return jio.read_kaldi_object(JStats.read, str(path))


@pytest.mark.parametrize("ie,acc,tol", [("1.ie", "1.0.iacc", 1e-9),
                                        ("d.ie", "d.iacc", 1e-6)])
def test_extractor_e_step(lad, tmp_path, ie, acc, tol):
    """ivector-extractor-acc-stats of a full-UBM and a diagonal-UBM
    extractor: A and B within 1e-9 of their largest element with the
    full UBM (float64 posteriors); the bound is 1e-6 with the diagonal
    one, whose posteriors the reference computes in float32 (the CPU
    computes them with the reference's products: about 3e-16 measured)."""
    feats = ("ark:{root}/split0/feats.ark" if acc == "1.0.iacc"
             else "{tr}")
    run("torch", "ivector-extractor-acc-stats",
        *_fill([lad["j"] / ie, feats, tmp_path / "acc"], lad, None))
    got, want = _stats(tmp_path / "acc"), _stats(lad["j"] / acc)
    assert got.num_utts == want.num_utts
    assert rel_err(got.A, want.A) < tol
    assert rel_err(got.B, want.B) < tol


def test_extractor_m_step(lad, tmp_path):
    run("torch", "ivector-extractor-est", lad["j"] / "1.ie",
        lad["j"] / "1.iacc", tmp_path / "2.ie")
    got = tio.read_kaldi_object(IvectorExtractor.read, str(tmp_path / "2.ie"))
    want = jio.read_kaldi_object(JEx.read, str(lad["j"] / "2.ie"))
    assert rel_err(got.M, want.M) < 1e-9


def test_m_step_singular_raises(lad):
    """A Gaussian with no occupancy makes A_g singular: numpy's solve
    raises in the reference, the port's batched solve raises too."""
    jex = jio.read_kaldi_object(JEx.read, str(lad["j"] / "1.ie"))
    jst = _stats(lad["j"] / "1.iacc")
    jst.A[3] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        jst.update(jex)
    ex = tio.read_kaldi_object(IvectorExtractor.read, str(lad["j"] / "1.ie"))
    st = tio.read_kaldi_object(IvectorExtractorStats.read,
                               str(lad["j"] / "1.iacc"))
    st.A[3] = 0.0
    with pytest.raises(KaldiTpuError):
        st.update(ex)


@pytest.mark.parametrize("ie", ["2.ie", "d.ie"])
def test_ivector_extract(lad, tmp_path, ie):
    outs = _both(lad, tmp_path, "ivector-extract",
                 [f"{{j}}/{ie}", "ark:{root}/test/feats.ark", "ark:{out}"])
    want, got = (read_table("vector", f"ark:{o}") for o in outs)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


ONLINE = {
    "online": ("ivector-extract-online",
               ["{j}/2.ie", "ark:{root}/test/feats.ark", "ark:{out}"]),
    "online-period7-maxcount": (
        "ivector-extract-online",
        ["--ivector-period=7", "--max-count=40", "{j}/2.ie",
         "ark:{root}/test/feats.ark", "ark:{out}"]),
    "online2-carry": ("ivector-extract-online2",
                      ["ark:{root}/train/spk2utt", "{j}/2.ie", "{tr}",
                       "ark:{out}"]),
    "online2-carry-maxcount": (
        "ivector-extract-online2",
        ["--max-count=150", "--ivector-period=5", "ark:{root}/train/spk2utt",
         "{j}/d.ie", "{tr}", "ark:{out}"]),
    "online2-repeat": ("ivector-extract-online2",
                       ["--repeat", "ark:{root}/test/spk2utt", "{j}/2.ie",
                        "ark:{root}/test/feats.ark", "ark:{out}"]),
}


@pytest.mark.parametrize("name", sorted(ONLINE))
def test_online_extraction(lad, tmp_path, name):
    tool, args = ONLINE[name]
    outs = _both(lad, tmp_path, tool, args)
    want, got = (read_table("matrix", f"ark:{o}") for o in outs)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_online2_skips_empty_utterance(lad, tmp_path):
    """ivector-extract-online2 warns about an utterance of 0 frames and
    writes no rows for it; the speaker's other utterances carry their
    statistics on as the JAX tool does without it (which fails on one)."""
    feats = read_table("matrix", "ark:{}/test/feats.ark".format(lad["root"]))
    keys = sorted(feats)
    with_empty = dict(feats)
    # u0008 is speaker 0's (8 % 4) and sorts between u000 and u004
    with_empty["u0008"] = np.zeros((0, D), np.float32)
    write_set(tmp_path / "e", with_empty)
    run("jax", "ivector-extract-online2",
        "ark:{}/test/spk2utt".format(lad["root"]), lad["j"] / "2.ie",
        "ark:{}/test/feats.ark".format(lad["root"]),
        f"ark:{tmp_path}/want.ark")
    run("torch", "ivector-extract-online2", f"ark:{tmp_path}/e/spk2utt",
        lad["j"] / "2.ie", f"ark:{tmp_path}/e/feats.ark",
        f"ark:{tmp_path}/got.ark")
    want = read_table("matrix", f"ark:{tmp_path}/want.ark")
    got = read_table("matrix", f"ark:{tmp_path}/got.ark")
    assert sorted(got) == sorted(want) == keys
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tool,model", [("gmm-gselect", "2.dubm"),
                                        ("fgmm-gselect", "2.ubm")])
def test_gselect(lad, tmp_path, tool, model):
    outs = _both(lad, tmp_path, tool,
                 ["--n=3", f"{{j}}/{model}", "{tr}", "ark:{out}"])
    want, got = (read_table("int-vector-vector", f"ark:{o}") for o in outs)
    assert got == want


def _posts_close(got, want, tol):
    assert list(got) == list(want)
    for k in want:
        for fg, fw in zip(got[k], want[k]):
            assert [i for i, _ in fg] == [i for i, _ in fw]
            np.testing.assert_allclose([p for _, p in fg],
                                       [p for _, p in fw], atol=tol)


POSTS = {
    "gmm-global-get-post": (["--n=3", "--min-post=0.01", "{j}/2.dubm",
                             "{tr}", "ark:{out}"], 1e-9),
    "gmm-global-gselect-to-post": (["{j}/2.dubm", "{tr}", "ark:{j}/d.gs",
                                    "ark:{out}"], 1e-9),
    "fgmm-global-gselect-to-post": (["--min-post=0.001", "{j}/2.ubm", "{tr}",
                                     "ark:{j}/f.gs", "ark:{out}"], 1e-9),
}


@pytest.mark.parametrize("tool", sorted(POSTS))
def test_posteriors(lad, tmp_path, tool):
    args, tol = POSTS[tool]
    outs = _both(lad, tmp_path, tool, args)
    want, got = (read_table("posterior", f"ark:{o}") for o in outs)
    _posts_close(got, want, tol)


def test_full_stats_from_posteriors(lad, tmp_path):
    outs = _both(lad, tmp_path, "fgmm-global-acc-stats-post",
                 ["{j}/2.ubm", "ark:{j}/d.post", "{tr}", "{out}"])
    want, got = (_npz(o) for o in outs)
    for k in want:
        assert rel_err(got[k], want[k]) < 1e-9, k


@pytest.mark.parametrize("tool,model,average,tol", [
    ("gmm-global-get-frame-likes", "2.dubm", False, 1e-5),
    ("gmm-global-get-frame-likes", "2.dubm", True, 1e-5),
    ("fgmm-global-get-frame-likes", "2.ubm", False, 1e-9),
    ("fgmm-global-get-frame-likes", "2.ubm", True, 1e-9)])
def test_frame_likes(lad, tmp_path, tool, model, average, tol):
    kind = "float" if average else "vector"
    outs = _both(lad, tmp_path, tool,
                 [f"--average={str(average).lower()}", f"{{j}}/{model}",
                  "{tr}", "ark:{out}"])
    want, got = (read_table(kind, f"ark:{o}") for o in outs)
    assert list(got) == list(want)
    for k in want:
        assert rel_err(got[k], want[k]) < tol


@pytest.mark.parametrize("tool,model", [("gmm-global-info", "2.dubm"),
                                        ("fgmm-global-info", "2.ubm")])
def test_info(lad, tool, model):
    assert run("torch", tool, lad["j"] / model) == \
        run("jax", tool, lad["j"] / model)


def test_port_ladder(lad, tmp_path):
    """The whole ladder through the port's tools alone, from the
    features: the final full-UBM extractor within 1e-9 of the JAX
    ladder's (the diagonal EM's float32 posteriors are the reference's
    own products on the CPU; every later step is float64)."""
    t = tmp_path
    tr = lad["tr"]
    run("torch", "gmm-global-init-from-feats", f"--num-gauss={G}",
        "--num-iters=3", "--num-frames=2500", tr, t / "0.dubm")
    for it in range(2):
        run("torch", "gmm-global-acc-stats", t / f"{it}.dubm", tr,
            t / f"{it}.dacc")
        run("torch", "gmm-global-est", "--min-gaussian-occupancy=3",
            t / f"{it}.dubm", t / f"{it}.dacc", t / f"{it + 1}.dubm")
    run("torch", "gmm-global-to-fgmm", t / "2.dubm", t / "0.ubm")
    for it in range(2):
        run("torch", "fgmm-global-acc-stats", t / f"{it}.ubm", tr,
            t / f"{it}.facc")
        run("torch", "fgmm-global-est", "--min-gaussian-occupancy=3",
            t / f"{it}.ubm", t / f"{it}.facc", t / f"{it + 1}.ubm")
    run("torch", "ivector-extractor-init", "--use-full-ubm",
        f"--ivector-dim={R}", t / "2.ubm", t / "0.ie")
    for it in range(2):
        for s in range(2):
            run("torch", "ivector-extractor-acc-stats", t / f"{it}.ie",
                f"ark:{lad['root']}/split{s}/feats.ark", t / f"{it}.{s}.iacc")
        run("torch", "ivector-extractor-sum-accs", t / f"{it}.iacc",
            t / f"{it}.0.iacc", t / f"{it}.1.iacc")
        run("torch", "ivector-extractor-est", t / f"{it}.ie",
            t / f"{it}.iacc", t / f"{it + 1}.ie")
    got = tio.read_kaldi_object(IvectorExtractor.read, str(t / "2.ie"))
    want = jio.read_kaldi_object(JEx.read, str(lad["j"] / "2.ie"))
    assert rel_err(got.M, want.M) < 1e-9
    assert rel_err(got.sigma_inv, want.sigma_inv) < 1e-9


def test_ladder_equals_train_bench_extractor(tmp_path):
    """gmm-global-init-from-feats, ivector-extractor-init and 5 x
    (acc-stats, est) with `train_bench_extractor`'s settings (64
    Gaussians, 4 EM iterations, R=32, features in sorted order) give the
    main path's in-process extractor, number for number: both run
    `gmm.ubm.init_diag_ubm` and the extractor's batched E-step and
    M-step (the UBM file's float32 weights change nothing, the scores
    read the float32 gconsts)."""
    feats = synth_feats(40, D, seed=5)
    write_set(tmp_path / "d", feats)
    ark = f"ark:{tmp_path}/d/feats.ark"
    t = tmp_path
    run("torch", "gmm-global-init-from-feats", "--num-gauss=64",
        "--num-iters=4", "--num-frames=200000", "--srand=0", ark, t / "ubm")
    run("torch", "ivector-extractor-init", "--ivector-dim=32", t / "ubm",
        t / "0.ie")
    for it in range(5):
        run("torch", "ivector-extractor-acc-stats", t / f"{it}.ie", ark,
            t / f"{it}.acc")
        run("torch", "ivector-extractor-est", t / f"{it}.ie",
            t / f"{it}.acc", t / f"{it + 1}.ie")
    got = tio.read_kaldi_object(IvectorExtractor.read, str(t / "5.ie"))
    want = train_bench_extractor(feats, num_gauss=64, ivector_dim=32,
                                 device="cpu")
    assert np.array_equal(got.ubm.means_invvars, want.ubm.means_invvars)
    assert np.array_equal(got.ubm.inv_vars, want.ubm.inv_vars)
    assert np.array_equal(got.M, want.M)
