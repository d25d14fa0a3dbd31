"""Port parity: the feature tools (`cli/feat_tools.py`) and the feature
functions they run (`feat/functions.py`) against the JAX package's, on
the CPU, over the fabricated corpus of the generic recipe: MFCC within
atol 2e-3 / rtol 1e-4 (the reference's own tolerance against Kaldi,
tests/test_ref_feat_golden.py), every other archive byte for byte from
the same input archive, and the ark,scp pair's keys and offsets."""

import os

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.feat import functions as jff
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.feat import functions as tff
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.util.table import SequentialTableReader

MFCC = ["--sample-frequency=8000", "--dither=0"]


def _run(side, tool, *args):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and tool == \
        "compute-mfcc-feats" else []
    return fn([tool, *extra, *[str(a) for a in args]])


def _read(spec, holder="matrix"):
    return dict(SequentialTableReader(holder, spec))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, both tools' MFCC of its train split, and JAX's
    features as the common input of the other tools."""
    root = tmp_path_factory.mktemp("feat")
    make_standard_corpus(str(root), 8, 2)
    d = root / "train"
    for side in ("jax", "torch"):
        assert _run(side, "compute-mfcc-feats", *MFCC, f"scp:{d}/wav.scp",
                    f"ark,scp:{root}/{side}.ark,{root}/{side}.scp") == 0
    return root


def test_mfcc_matches_within_tolerance(corpus):
    a = _read(f"ark:{corpus}/torch.ark")
    b = _read(f"ark:{corpus}/jax.ark")
    assert sorted(a) == sorted(b) and len(a) == 8
    for k in b:
        assert a[k].shape == b[k].shape and a[k].shape[1] == 13
        np.testing.assert_allclose(a[k], b[k], atol=2e-3, rtol=1e-4)


def test_mfcc_scp_keys_and_offsets(corpus):
    def entries(side):
        with open(corpus / f"{side}.scp") as f:
            return [(k, v.rsplit(":", 1)[1]) for k, v in
                    (line.split() for line in f)]
    assert entries("torch") == entries("jax")
    a = _read(f"scp:{corpus}/torch.scp")
    b = _read(f"ark:{corpus}/torch.ark")
    assert all(np.array_equal(a[k], b[k]) for k in b)


def test_mfcc_batch_size_does_not_change_features(corpus, tmp_path):
    d = corpus / "train"
    assert _run("torch", "compute-mfcc-feats", *MFCC, "--batch-size=3",
                f"scp:{d}/wav.scp", f"ark:{tmp_path}/b3.ark") == 0
    a = _read(f"ark:{tmp_path}/b3.ark")
    b = _read(f"ark:{corpus}/torch.ark")
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("bad", ["--subtract-mean=true",
                                 "--no-such-option=1"])
def test_mfcc_options_not_carried_raise(corpus, tmp_path, bad):
    d = corpus / "train"
    args = ["compute-mfcc-feats", "--use-gpu=no", "--sample-frequency=8000",
            "--dither=0", bad, f"scp:{d}/wav.scp", f"ark:{tmp_path}/x.ark"]
    with pytest.raises(Exception):
        ttool("compute-mfcc-feats")(args)


@pytest.mark.parametrize("opt", ["--snip-edges=false", "--dither=1.0"])
def test_mfcc_options_now_carried(corpus, tmp_path, opt):
    """--snip-edges=false matches JAX's tool within the MFCC tolerance;
    --dither=1.0 (JAX's noise bits are not the port's) moves each
    utterance's features off the undithered ones as far as JAX's does:
    the mean absolute change within 15% of JAX's, the largest within
    twice JAX's (this corpus's quiet frames move them by about 1)."""
    d = corpus / "train"
    outs = {}
    for side in ("jax", "torch"):
        mfcc = [m for m in MFCC if not (opt.startswith("--dither")
                                        and m.startswith("--dither"))]
        assert _run(side, "compute-mfcc-feats", *mfcc, opt,
                    f"scp:{d}/wav.scp", f"ark:{tmp_path}/{side}.ark") == 0
        outs[side] = _read(f"ark:{tmp_path}/{side}.ark")
    plain = _read(f"ark:{corpus}/torch.ark")
    jax_plain = _read(f"ark:{corpus}/jax.ark")
    for k in outs["jax"]:
        a, b = outs["torch"][k], outs["jax"][k]
        assert a.shape == b.shape
        if opt == "--snip-edges=false":
            assert a.shape[0] > plain[k].shape[0]
            np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-4)
        else:
            ours, theirs = np.abs(a - plain[k]), np.abs(b - jax_plain[k])
            assert abs(ours.mean() - theirs.mean()) < 0.15 * theirs.mean()
            assert 0 < ours.max() < 2 * theirs.max()


def test_mfcc_on_the_card_raises_without_one(corpus, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    d = corpus / "train"
    with pytest.raises(RuntimeError, match="CUDA"):
        ttool("compute-mfcc-feats")(["compute-mfcc-feats", *MFCC,
                                     f"scp:{d}/wav.scp",
                                     f"ark:{tmp_path}/x.ark"])


def _spk2utt(corpus, path):
    by = {}
    with open(corpus / "train" / "utt2spk") as f:
        for line in f:
            u, s = line.split()
            by.setdefault(s, []).append(u)
    with open(path, "w") as f:
        for s in sorted(by):
            f.write(f"{s} {' '.join(by[s])}\n")


# (tool, options, the table's input) -> output archive; each run by both
# packages on JAX's features
TOOLS = [
    ("compute-cmvn-stats", []),
    ("compute-cmvn-stats", ["--spk2utt=ark:{spk2utt}"]),
    ("add-deltas", []),
    ("add-deltas", ["--order=1", "--window=3"]),
    ("splice-feats", []),
    ("splice-feats", ["--left-context=2", "--right-context=1"]),
    ("copy-feats", []),
    ("copy-feats", ["ark,t:"]),
]


@pytest.mark.parametrize("tool,opts", TOOLS)
def test_feature_tool_bytes(corpus, tmp_path, tool, opts):
    spk2utt = tmp_path / "spk2utt"
    _spk2utt(corpus, spk2utt)
    text_out = opts == ["ark,t:"]
    opts = [o.format(spk2utt=spk2utt) for o in opts if o != "ark,t:"]
    outs = {}
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.ark"
        kind = "ark,t" if text_out else "ark"
        assert _run(side, tool, *opts, f"ark:{corpus}/jax.ark",
                    f"{kind}:{out}") == 0
        outs[side] = out.read_bytes()
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("opts", [[], ["--norm-vars=true"],
                                  ["--utt2spk=ark:{utt2spk}"],
                                  ["--norm-means=false"],
                                  ["--reverse=true", "--norm-vars=true"]])
def test_apply_cmvn_bytes(corpus, tmp_path, opts):
    utt2spk = corpus / "train" / "utt2spk"
    spk2utt = tmp_path / "spk2utt"
    _spk2utt(corpus, spk2utt)
    per_spk = any("utt2spk" in o for o in opts)
    stats = f"ark:{tmp_path}/cmvn.ark"
    args = ([f"--spk2utt=ark:{spk2utt}"] if per_spk else []) + \
        [f"ark:{corpus}/jax.ark", stats]
    assert _run("jax", "compute-cmvn-stats", *args) == 0
    opts = [o.format(utt2spk=utt2spk) for o in opts]
    outs = {}
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.ark"
        assert _run(side, "apply-cmvn", *opts, stats, f"ark:{corpus}/jax.ark",
                    f"ark:{out}") == 0
        outs[side] = out.read_bytes()
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("tool", ["feat-to-dim", "feat-to-len"])
def test_feat_to_dim_and_len(corpus, tmp_path, tool):
    outs = {}
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.ark"
        assert _run(side, tool, f"ark:{corpus}/jax.ark", f"ark,t:{out}") == 0
        outs[side] = out.read_bytes()
    assert outs["torch"] == outs["jax"] and outs["jax"]
    if tool == "feat-to-dim":
        for side in ("jax", "torch"):
            assert _run(side, tool, f"ark:{corpus}/jax.ark",
                        tmp_path / f"{side}.txt") == 0
        assert (tmp_path / "torch.txt").read_text() == "13\n" == \
            (tmp_path / "jax.txt").read_text()


def test_wav_to_duration_and_extract_segments(corpus, tmp_path):
    d = corpus / "train"
    segs = tmp_path / "segments"
    segs.write_text("s0 tr00 0.1 0.9\ns1 tr01 0.5 2.2 0\n"
                    "bad tr02 1.0 1.02\nlong tr03 0.0 9.0\n")
    outs = {}
    for side in ("jax", "torch"):
        assert _run(side, "wav-to-duration", f"scp:{d}/wav.scp",
                    f"ark,t:{tmp_path}/{side}.dur") == 0
        assert _run(side, "extract-segments", f"scp:{d}/wav.scp", segs,
                    f"ark:{tmp_path}/{side}.wav.ark") == 0
        outs[side] = ((tmp_path / f"{side}.dur").read_bytes(),
                      (tmp_path / f"{side}.wav.ark").read_bytes())
    assert outs["torch"] == outs["jax"]
    assert b"s0" in outs["torch"][1] and b"bad" not in outs["torch"][1]


def _feats(seed, T=37, D=5):
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmvn_functions(seed):
    f = _feats(seed) * 3 + 1
    w = np.random.default_rng(seed + 10).uniform(size=f.shape[0])
    for kw in ({}, {"weights": w}):
        a = tff.acc_cmvn_stats(f, **kw)
        b = jff.acc_cmvn_stats(f, **kw)
        np.testing.assert_array_equal(a, b)
    a = tff.acc_cmvn_stats(f[:10], stats=tff.acc_cmvn_stats(f[10:]))
    np.testing.assert_array_equal(a, jff.acc_cmvn_stats(
        f[:10], stats=jff.acc_cmvn_stats(f[10:])))
    for norm_vars in (False, True):
        for reverse in (False, True):
            np.testing.assert_array_equal(
                tff.apply_cmvn(f, a, norm_vars, reverse),
                jff.apply_cmvn(f, a, norm_vars, reverse))


@pytest.mark.parametrize("order,window,T", [(2, 2, 37), (1, 3, 5), (3, 1, 1),
                                            (2, 2, 0)])
def test_compute_deltas(order, window, T):
    f = _feats(order, T=T)
    opts_t = tff.DeltaFeaturesOptions(order=order, window=window)
    opts_j = jff.DeltaFeaturesOptions(order=order, window=window)
    np.testing.assert_array_equal(tff.compute_deltas(f, opts_t),
                                  jff.compute_deltas(f, opts_j))


@pytest.mark.parametrize("left,right", [(4, 4), (2, 0), (0, 3)])
def test_splice_frames(left, right):
    f = _feats(left + right, T=11)
    np.testing.assert_array_equal(tff.splice_frames(f, left, right),
                                  jff.splice_frames(f, left, right))


def test_copy_feats_compress_gives_jax_bytes(corpus, tmp_path):
    """copy-feats --compress=true writes JAX's CompressedMatrix bytes."""
    outs = {}
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.ark"
        assert _run(side, "copy-feats", "--compress=true",
                    f"ark:{corpus}/jax.ark", f"ark:{out}") == 0
        outs[side] = out.read_bytes()
    assert outs["torch"] == outs["jax"] and b"CM " in outs["jax"]
