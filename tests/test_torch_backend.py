"""Port parity: the speaker and language back ends
(`ivector/logistic_regression.py`, `ivector/cluster.py` and their tools
logistic-regression-train, -eval, -copy and agglomerative-cluster)
against the JAX package's, on the CPU, over seeded vectors.

The regression's float32 Adam runs in optax's order of operations on
both sides; 200 steps at a rate of 0.5 keep the weights within 1e-5 of
JAX's (about 1e-6 measured) and the float64 evaluation within 1e-4.
Files whose bytes come from the same numbers (a copy, the evaluation of
one model file, the clustering's labels) are compared byte for byte."""

import contextlib
import io

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.ivector.cluster import agglomerative_cluster as j_cluster
from kaldi_tpu.ivector.logistic_regression import (
    LogisticRegressionConfig as JConfig)
from kaldi_tpu.ivector.logistic_regression import (
    train_logistic_regression as j_train)
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.ivector.cluster import agglomerative_cluster
from kaldi_tpu_torch.ivector.logistic_regression import (
    LogisticRegression, LogisticRegressionConfig, train_logistic_regression)
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

WEIGHT_ATOL = 1e-5


def run(side, tool, *args, use_gpu=True):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if (side == "torch" and use_gpu and tool ==
                                 "logistic-regression-train") else []
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exited {rc}"


def classes(n=90, num_classes=5, dim=7, seed=1):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim))
    y = rng.integers(0, num_classes, n)
    return means[y] + 0.8 * rng.normal(size=(n, dim)), y


@pytest.mark.parametrize("mix_up", [0, 13])
def test_training_matches_jax(mix_up):
    x, y = classes()
    want = j_train(x, y, JConfig(mix_up=mix_up))
    got = train_logistic_regression(x, y, LogisticRegressionConfig(
        mix_up=mix_up), device="cpu")
    assert np.array_equal(got.class_of, want.class_of)
    # the mix-up target is spread floored: 13 over 5 classes gives 2 each
    assert len(got.class_of) == (5 if mix_up == 0 else 10)
    np.testing.assert_allclose(got.weights, want.weights, atol=WEIGHT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.log_posteriors(x),
                               want.log_posteriors(x), atol=1e-4, rtol=0)


def test_training_raises_without_a_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    x, y = classes(n=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_logistic_regression(x, y)


@pytest.fixture(scope="module")
def lr_files(tmp_path_factory):
    """Train and test vector archives, utt2class, and both tools'
    models at the defaults and with --mix-up."""
    d = tmp_path_factory.mktemp("lr")
    x, y = classes(n=120, seed=3)
    keys = [f"utt{i:03d}" for i in range(len(x))]
    with TableWriter("vector", f"ark:{d}/train.ark") as w:
        for k, v in zip(keys[:100], x[:100]):
            w.write(k, v)
        w.write("no_class", x[0])
    with TableWriter("vector", f"ark:{d}/test.ark") as w:
        for k, v in zip(keys[100:], x[100:]):
            w.write(k, v)
    (d / "utt2class").write_text("".join(
        f"{k} {c}\n" for k, c in zip(keys[:100], y[:100])))
    for side in ("jax", "torch"):
        for mix, name in ((0, "plain"), (15, "mix")):
            run(side, "logistic-regression-train", f"--mix-up={mix}",
                f"ark:{d}/train.ark", f"ark:{d}/utt2class",
                d / f"{side}.{name}.mdl")
    return d


def _model(path) -> LogisticRegression:
    return kaldi_io.read_kaldi_object(LogisticRegression.read, str(path))


@pytest.mark.parametrize("name", ["plain", "mix"])
def test_train_tool_matches_jax(lr_files, name):
    d = lr_files
    got, want = _model(d / f"torch.{name}.mdl"), _model(d / f"jax.{name}.mdl")
    assert np.array_equal(got.class_of, want.class_of)
    np.testing.assert_allclose(got.weights, want.weights, atol=WEIGHT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("apply_log", ["true", "false"])
def test_eval_tool_bytes_from_one_model(lr_files, apply_log):
    d = lr_files
    for side in ("jax", "torch"):
        run(side, "logistic-regression-eval", f"--apply-log={apply_log}",
            d / "jax.mix.mdl", f"ark:{d}/test.ark",
            f"ark:{d}/{side}.{apply_log}.post")
    assert (d / f"torch.{apply_log}.post").read_bytes() == \
        (d / f"jax.{apply_log}.post").read_bytes()


@pytest.mark.parametrize("opts", [[], ["--binary=false"],
                                  ["--scale-priors=1:2:0.5:1:3"]])
def test_copy_tool_bytes(lr_files, tmp_path, opts):
    d = lr_files
    for side in ("jax", "torch"):
        run(side, "logistic-regression-copy", *opts, d / "jax.mix.mdl",
            tmp_path / side)
    assert (tmp_path / "torch").read_bytes() == (tmp_path / "jax").read_bytes()


def test_model_io_round_trip(lr_files, tmp_path):
    m = _model(lr_files / "jax.mix.mdl")
    for binary in (True, False):
        out = tmp_path / f"m{binary}"
        kaldi_io.write_kaldi_object(m.write, str(out), binary)
        back = _model(out)
        assert np.array_equal(back.class_of, m.class_of)
        assert np.array_equal(back.weights, m.weights.astype(np.float32))


# -- agglomerative clustering ---------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [{"threshold": 0.0}, {"threshold": -0.4},
                                {"num_clusters": 3}, {}])
def test_cluster_labels_equal_jax_on_random_scores(seed, kw):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 24))
    scores = rng.normal(size=(n, n))
    assert np.array_equal(agglomerative_cluster(scores, **kw),
                          j_cluster(scores, **kw))


def test_cluster_tie_rule():
    """Equal means: the first pair in sorted-key order merges, a merged
    cluster taking the next new key (so it sorts after the singletons);
    labels follow each cluster's smallest member."""
    scores = np.ones((6, 6))
    # rounds: (0,1)->6, (2,3)->7, (4,5)->8, then (6,7)
    assert agglomerative_cluster(scores, num_clusters=3).tolist() == \
        [0, 0, 1, 1, 2, 2]
    assert agglomerative_cluster(scores, num_clusters=2).tolist() == \
        [0, 0, 0, 0, 1, 1]
    assert j_cluster(scores, num_clusters=2).tolist() == [0, 0, 0, 0, 1, 1]
    s = np.array([[0, 5, 1, 5], [5, 0, 1, 1], [1, 1, 0, 1], [5, 1, 1, 0.]])
    assert agglomerative_cluster(s, num_clusters=3).tolist() == \
        j_cluster(s, num_clusters=3).tolist() == [0, 0, 1, 2]


def test_cluster_threshold_binds_only_without_a_count():
    s = np.full((4, 4), -5.0)
    assert agglomerative_cluster(s, threshold=0.0).tolist() == [0, 1, 2, 3]
    for kw, want in (({"threshold": 0.0, "num_clusters": 2}, [0, 0, 1, 1]),
                     ({}, [0, 0, 0, 0])):
        assert agglomerative_cluster(s, **kw).tolist() == want
        assert j_cluster(s, **kw).tolist() == want


@pytest.fixture(scope="module")
def score_files(tmp_path_factory):
    """Two recordings' dense score matrices, reco2utt, reco2num-spk."""
    d = tmp_path_factory.mktemp("diar")
    rng = np.random.default_rng(7)
    lines, nums = [], []
    with TableWriter("matrix", f"ark:{d}/scores.ark") as w:
        for r, n in (("recA", 9), ("recB", 14)):
            spk = rng.integers(0, 3, n)
            s = np.where(spk[:, None] == spk[None, :], 2.0, -2.0) \
                + rng.normal(size=(n, n))
            w.write(r, s.astype(np.float32))
            lines.append(f"{r} " + " ".join(f"{r}-{i:02d}" for i in range(n)))
            nums.append(f"{r} {len(set(spk.tolist()))}")
    (d / "reco2utt").write_text("\n".join(lines) + "\n")
    (d / "reco2num").write_text("\n".join(nums) + "\n")
    return d


@pytest.mark.parametrize("opts", [[], ["--threshold=0.5"],
                                  ["--num-speakers=2"],
                                  ["--reco2num-spk-rspecifier=ark:RECO2NUM"]])
@pytest.mark.parametrize("reco2utt", [True, False])
def test_cluster_tool_bytes(score_files, tmp_path, opts, reco2utt):
    d = score_files
    opts = [o.replace("RECO2NUM", str(d / "reco2num")) for o in opts]
    r2u = f"ark:{d}/reco2utt" if reco2utt else f"ark:{tmp_path}/none"
    if not reco2utt:
        (tmp_path / "none").write_text("")
    for side in ("jax", "torch"):
        run(side, "agglomerative-cluster", *opts, f"ark:{d}/scores.ark",
            r2u, f"ark,t:{tmp_path}/{side}")
    got = (tmp_path / "torch").read_text()
    assert got == (tmp_path / "jax").read_text()
    assert len(got.splitlines()) == (23 if reco2utt else 2)


def test_reference_cluster_labels_are_int_vectors(score_files, tmp_path):
    """Kept from the reference (ROADMAP.md §3): agglomerative-cluster
    writes its labels as an int-vector table, where upstream's
    agglomerative-cluster writes an int32 table (one label an
    utterance).  In text form the two read alike; in binary an int32
    reader refuses the reference's archive, so the labels stay
    int-vectors in both packages."""
    d = score_files
    for side in ("jax", "torch"):
        run(side, "agglomerative-cluster", f"ark:{d}/scores.ark",
            f"ark:{d}/reco2utt", f"ark:{tmp_path}/{side}")
    assert (tmp_path / "torch").read_bytes() == (tmp_path / "jax").read_bytes()
    labels = dict(SequentialTableReader("int-vector", f"ark:{tmp_path}/jax"))
    assert all(len(v) == 1 and v[0] >= 1 for v in labels.values())
    with pytest.raises(Exception):
        dict(SequentialTableReader("int", f"ark:{tmp_path}/jax"))
