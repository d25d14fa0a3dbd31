"""Port parity: the 35 feature, pitch, matrix and wave tools of this
slice outside `cli/tail15_tools.py` (the rest of `cli/feat_tools.py`,
and those of `cli/tail9_tools.py`, `cli/tail14_tools.py`,
`cli/misc_tools.py` and `cli/tail7_tools.py`) against the JAX package's
tools on the CPU, over the generic recipe's fabricated corpus (8 kHz):
each tool is run by both packages on the same inputs (JAX's MFCC archive,
posteriors, vectors and statistics written once), and its outputs are
compared byte for byte; the feature computers' archives within
tests/feat_tolerance.py's bars (atol 2e-3 / rtol 1e-4, PLP 5e-3 / 1e-3,
the spectrogram's bins also their float32 FFT rounding), their keys and
shapes equal."""

import os

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

from feat_tolerance import assert_features_close

FS = "--sample-frequency=8000"
GPU_TOOLS = ("compute-mfcc-feats", "compute-fbank-feats",
             "compute-spectrogram-feats", "compute-plp-feats")


def _run(side, tool, *args):
    extra = ["--use-gpu=no"] if side == "torch" and tool in GPU_TOOLS \
        else []
    fn = (jtool if side == "jax" else ttool)(tool)
    return fn([tool, *extra, *[str(a) for a in args]])


def _read(spec, holder="matrix"):
    return dict(SequentialTableReader(holder, spec))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus; JAX's MFCC of its train split; a vector per
    utterance, posteriors, CMVN statistics and a spk2utt, the common
    inputs of the tools."""
    root = tmp_path_factory.mktemp("feat2")
    make_standard_corpus(str(root), 8, 2)
    d = root / "train"
    assert _run("jax", "compute-mfcc-feats", FS, "--dither=0",
                f"scp:{d}/wav.scp", f"ark:{root}/feats.ark") == 0
    feats = _read(f"ark:{root}/feats.ark")
    rng = np.random.default_rng(0)
    with TableWriter("vector", f"ark:{root}/vec.ark") as w:
        for k in sorted(feats):
            w.write(k, rng.normal(size=5).astype(np.float32))
    with TableWriter("posterior", f"ark:{root}/post.ark") as w:
        for k in sorted(feats):
            w.write(k, [[(int(rng.integers(6)), 0.75),
                         (int(rng.integers(6)), 0.25)]
                        for _ in range(feats[k].shape[0])])
    by = {}
    with open(d / "utt2spk") as f:
        for line in f:
            u, s = line.split()
            by.setdefault(s, []).append(u)
    with open(root / "spk2utt", "w") as f:
        for s in sorted(by):
            f.write(f"{s} {' '.join(by[s])}\n")
    assert _run("jax", "compute-cmvn-stats", f"ark:{root}/feats.ark",
                f"ark:{root}/cmvn.ark") == 0
    stats = sum(_read(f"ark:{root}/cmvn.ark").values())
    kaldi_io.write_kaldi_object(lambda s, b: iof.write_matrix(s, b, stats),
                                str(root / "global.mat"))
    keys = sorted(feats)
    with open(root / "reco2file", "w") as f:
        for i, k in enumerate(keys):
            f.write(f"{k} call{i // 2} {'AB'[i % 2]}\n")
    with open(root / "segments", "w") as f:
        for k in keys[:4]:
            f.write(f"{k}-a {k} 0.05 0.40\n{k}-b {k} 0.30 0.72\n")
    with open(root / "include", "w") as f:
        f.write(f"{keys[1]}\n{keys[4]} x\n")
    wavs = [line.split()[1] for line in open(d / "wav.scp")]
    for name, seconds in (("rir", 0.05), ("noise", 0.3)):
        from kaldi_tpu_torch.feat.wave import WaveData
        x = rng.normal(size=int(8000 * seconds))
        if name == "rir":
            x *= np.exp(-np.arange(len(x)) / 40.0)
        with open(root / f"{name}.wav", "wb") as f:
            WaveData(8000.0, (1000 * x)[None, :].astype(np.float32)).write(f)
    for i, k in enumerate(keys[:4]):
        kaldi_io.write_kaldi_object(
            lambda s, b, m=feats[k]: iof.write_matrix(s, b, m),
            str(root / f"m{i}.mat"))
    return {"root": root, "wav": f"scp:{d}/wav.scp", "wav0": wavs[0],
            "feats": f"ark:{root}/feats.ark", "keys": keys}


# (tool, arguments, outputs): "{r}" is the corpus root, "{o}" the side's
# output prefix; each output is compared byte for byte
CASES = [
    ("copy-matrix", ["{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("copy-matrix", ["--compress=true", "--compression-method=3",
                     "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("paste-feats", ["{feats}", "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("select-feats", ["0,2-4,12-10", "{feats}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("subset-feats", ["--n=3", "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("subset-feats", ["--include={r}/include", "{feats}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("matrix-sum", ["ark:{r}/cmvn.ark", "{o}.mat"], ["{o}.mat"]),
    ("matrix-sum", ["--average=true", "{o}.mat", "{r}/m0.mat",
                    "{r}/m0.mat"], ["{o}.mat"]),
    ("vector-sum", ["--average=true", "ark:{r}/vec.ark", "{o}.vec"],
     ["{o}.vec"]),
    ("shift-feats", ["--shift=2", "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("shift-feats", ["--shift=-3", "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("subsample-feats", ["--n=3", "--offset=1", "{feats}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("subsample-feats", ["--n=-2", "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("concat-feats", ["{r}/m0.mat", "{r}/m1.mat", "{r}/m2.mat", "{o}.mat"],
     ["{o}.mat"]),
    ("append-vector-to-feats", ["{feats}", "ark:{r}/vec.ark",
                                "ark:{o}.ark"], ["{o}.ark"]),
    ("post-to-feats", ["--post-dim=6", "ark:{r}/post.ark", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("wav-copy", ["{wav}", "ark:{o}.ark"], ["{o}.ark"]),
    ("extract-feature-segments", ["{feats}", "{r}/segments",
                                  "ark:{o}.ark"], ["{o}.ark"]),
    ("compute-kaldi-pitch-feats", [FS, "{wav}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("process-kaldi-pitch-feats", ["ark:{r}/pitch.ark", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("process-kaldi-pitch-feats", ["--add-raw-log-pitch=true",
                                   "--delay=2", "ark:{r}/pitch.ark",
                                   "ark:{o}.ark"], ["{o}.ark"]),
    ("modify-cmvn-stats", ["--norm-vars=false", "ark:{r}/cmvn.ark",
                           "ark:{o}.ark"], ["{o}.ark"]),
    ("modify-cmvn-stats", ["--skip-dims=0:2", "ark:{r}/cmvn.ark",
                           "ark:{o}.ark"], ["{o}.ark"]),
    ("interpolate-pitch", ["--pov-threshold=0.3", "ark:{r}/pitch.ark",
                           "ark:{o}.ark"], ["{o}.ark"]),
    ("add-deltas-sdc", ["{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("add-deltas-sdc", ["--num-cepstra=5", "--delta-spread=2",
                        "--block-shift=2", "--num-blocks=3", "{feats}",
                        "ark:{o}.ark"], ["{o}.ark"]),
    ("compute-and-process-kaldi-pitch-feats", [FS, "{wav}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("wav-perturb-speed", ["--utt-prefix=sp0.9-", "0.9", "{wav}",
                           "ark:{o}.ark"], ["{o}.ark"]),
    ("wav-perturb-speed", ["1.1", "{wav}", "ark:{o}.ark"], ["{o}.ark"]),
    ("wav-perturb-volume", ["--srand=3", "{wav}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("wav-perturb-volume", ["--factor=0.5", "{wav}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("append-post-to-feats", ["--post-dim=6", "{feats}", "ark:{r}/post.ark",
                              "ark:{o}.ark"], ["{o}.ark"]),
    ("apply-cmvn-online", ["{r}/global.mat", "{feats}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("apply-cmvn-online", ["--spk2utt=ark:{r}/spk2utt",
                           "--normalize-variance=true", "{r}/global.mat",
                           "{feats}", "ark:{o}.ark"], ["{o}.ark"]),
    ("matrix-max", ["ark:{r}/spk2utt", "{feats}", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("post-to-smat", ["--dim=6", "ark:{r}/post.ark", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("process-pitch-feats", ["ark:{r}/pitch.ark", "ark:{o}.ark"],
     ["{o}.ark"]),
    ("compute-cmvn-stats-two-channel", ["{r}/reco2file", "{feats}",
                                        "ark:{o}.ark"], ["{o}.ark"]),
    ("copy-feats-to-sphinx", ["--output-dir={o}", "{feats}"],
     ["{o}/{k0}.mfc", "{o}/{k1}.mfc"]),
    ("copy-feats-to-htk", ["--output-dir={o}", "--output-ext=plp",
                           "--sample-period=50000", "{feats}"],
     ["{o}/{k0}.plp", "{o}/{k1}.plp"]),
    ("wav-reverberate", ["--impulse-response={r}/rir.wav",
                         "--additive-signals={r}/noise.wav", "--snrs=10",
                         "{wav0}", "{o}.wav"], ["{o}.wav"]),
    ("wav-reverberate", ["--volume=0.5", "{wav0}", "{o}.wav"], ["{o}.wav"]),
    ("extend-wav-with-silence", ["--extra-silence-length=0.2", "{wav}",
                                 "ark:{o}.ark"], ["{o}.ark"]),
    ("extend-wav-with-silence", ["--prepend=true", "{wav}", "ark:{o}.ark"],
     ["{o}.ark"]),
]


def _fill(s, corpus, o):
    keys = corpus["keys"]
    return s.format(r=corpus["root"], o=o, feats=corpus["feats"],
                    wav=corpus["wav"], wav0=corpus["wav0"], k0=keys[0],
                    k1=keys[1])


@pytest.mark.parametrize("tool,args,outs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_tool_bytes_equal_jax(corpus, tmp_path, tool, args, outs):
    if "{r}/pitch.ark" in " ".join(args) and \
            not os.path.exists(corpus["root"] / "pitch.ark"):
        assert _run("jax", "compute-kaldi-pitch-feats", FS, corpus["wav"],
                    f"ark:{corpus['root']}/pitch.ark") == 0
    got = {}
    for side in ("jax", "torch"):
        o = str(tmp_path / side)
        rc = _run(side, tool, *[_fill(a, corpus, o) for a in args])
        assert rc == 0, f"{side} {tool} exit {rc}"
        got[side] = []
        for out in outs:
            with open(_fill(out, corpus, o), "rb") as f:
                got[side].append(f.read())
    assert all(got["jax"]), "empty outputs"
    assert got["torch"] == got["jax"]


FEATURES = [
    ("compute-fbank-feats", []),
    ("compute-fbank-feats", ["--snip-edges=false", "--use-energy=true"]),
    ("compute-spectrogram-feats", []),
    ("compute-spectrogram-feats", ["--snip-edges=false"]),
    ("compute-plp-feats", []),
    ("compute-plp-feats", ["--snip-edges=false", "--htk-compat=true"]),
]


@pytest.mark.parametrize("tool,opts", FEATURES)
def test_feature_computers_match_jax(corpus, tmp_path, tool, opts):
    out = {}
    for side in ("jax", "torch"):
        assert _run(side, tool, FS, "--dither=0", *opts, corpus["wav"],
                    f"ark:{tmp_path}/{side}.ark") == 0
        out[side] = _read(f"ark:{tmp_path}/{side}.ark")
    assert sorted(out["torch"]) == sorted(out["jax"]) == corpus["keys"]
    kind = tool.split("-")[1]
    for k, ref in out["jax"].items():
        assert_features_close(kind, out["torch"][k], ref, k)


@pytest.mark.parametrize("threshold", ["0.99", "1.5"])
def test_compare_feats_status_equal(corpus, threshold):
    """compare-feats' exit status: the same archive passes 0.99 and
    fails an unreachable threshold in both packages."""
    rcs = [_run(side, "compare-feats", f"--threshold={threshold}",
                corpus["feats"], corpus["feats"])
           for side in ("jax", "torch")]
    assert rcs[0] == rcs[1] == (0 if threshold == "0.99" else 1)
