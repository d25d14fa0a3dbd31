"""Port parity: the 11 cudafeat and cudadecoder tools of
`cli/tail15_tools.py` at --use-gpu=no against the JAX package's tools, on
the tiny mono model, graph and test waves of tests/test_cli_tail15.py:

  compute-{mfcc,fbank}-feats-cuda, compute-{mfcc,fbank}-online-batched-cuda:
      within tests/feat_tolerance.py's bars of JAX's tool at --dither=0,
      and equal to the port's plain tool at the same batch size (with
      dither too: one seed a batch from the same stream); a wave at
      another rate than --sample-frequency skipped;
  apply-cmvn-online-cuda, apply-batched-cmvn-online-cuda: JAX's bytes,
      and the port's apply-cmvn-online's;
  compute-online-feats-cuda, compute-online-feats-batched-cuda: the
      features within the MFCC bar of JAX's, the i-vectors within rtol
      1e-4 / atol 3e-4 of JAX's (tests/test_torch_ivector.py's float32
      bar) and equal to `BatchedIvectorExtractor` run directly on the
      tool's own features;
  batched-wav-nnet3-cuda2, batched-wav-nnet3-cuda: at
      --frame-subsampling-factor=1 the best paths of JAX's lattices and
      costs within 1e-4; the alias's lattices byte for byte the -cuda2
      ones; the RealTimeX and stats lines; at factor 3, every third frame
      of the model's output (the reference takes the first third: a fault
      shown on JAX);
  batched-wav-nnet3-cuda-online: the words of JAX's tool."""

import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.util.table import SequentialTableReader

from feat_tolerance import assert_features_close
from test_cli_tail15 import env  # noqa: F401  (the module's fixture)

GPU_TOOLS = ("compute-mfcc-feats", "compute-fbank-feats",
             "compute-mfcc-feats-cuda", "compute-fbank-feats-cuda",
             "compute-mfcc-online-batched-cuda",
             "compute-fbank-online-batched-cuda",
             "compute-online-feats-cuda",
             "compute-online-feats-batched-cuda",
             "batched-wav-nnet3-cuda2", "batched-wav-nnet3-cuda",
             "batched-wav-nnet3-cuda-online")


def _run(side, tool, *args):
    extra = ["--use-gpu=no"] if side == "torch" and tool in GPU_TOOLS \
        else []
    rc = (jtool if side == "jax" else ttool)(tool)(
        [tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exit {rc}"


def _read(spec, holder="matrix"):
    return dict(SequentialTableReader(holder, spec))


FEATS = [("compute-mfcc-feats-cuda", "compute-mfcc-feats", "mfcc"),
         ("compute-fbank-feats-cuda", "compute-fbank-feats", "fbank"),
         ("compute-mfcc-online-batched-cuda", "compute-mfcc-feats", "mfcc"),
         ("compute-fbank-online-batched-cuda", "compute-fbank-feats",
          "fbank")]


@pytest.mark.parametrize("cuda,plain,kind", FEATS)
def test_batched_feats_match_jax_and_the_plain_tool(env, tmp_path, cuda,
                                                   plain, kind):
    d, fs = env["d"], f"--sample-frequency={env['fs']}"
    wav = f"scp:{d}/wav.scp"
    for side in ("jax", "torch"):
        _run(side, cuda, fs, "--dither=0", "--batch-size=2", wav,
             f"ark:{tmp_path}/{side}.ark")
    ours, theirs = (_read(f"ark:{tmp_path}/{s}.ark")
                    for s in ("torch", "jax"))
    assert sorted(ours) == sorted(theirs) == sorted(env["test_wav"])
    for u in theirs:
        assert_features_close(kind, ours[u], theirs[u], u)
    # dither on: the cuda tool and the plain tool at one batch size
    for tool, name in ((cuda, "cuda"), (plain, "plain")):
        _run("torch", tool, fs, "--batch-size=1", wav,
             f"ark:{tmp_path}/{name}.ark")
    a, b = (_read(f"ark:{tmp_path}/{n}.ark") for n in ("cuda", "plain"))
    assert all(np.array_equal(a[u], b[u]) for u in b)
    assert not all(np.array_equal(a[u], ours[u]) for u in b)


@pytest.mark.parametrize("cuda", [c for c, _p, _k in FEATS])
def test_batched_feats_skip_a_wrong_sample_rate(env, tmp_path, cuda):
    """The cuda tools are the plain computers' runner: a wave whose rate
    is not --sample-frequency is skipped, not framed at the wrong rate."""
    from kaldi_tpu_torch.feat.wave import WaveData
    from kaldi_tpu_torch.util.table import TableWriter
    key, wave = next(iter(SequentialTableReader(
        "wave", f"scp:{env['d']}/wav.scp")))
    wav = f"ark:{tmp_path}/wav.ark"
    with TableWriter("wave", wav) as w:
        w.write("bad", WaveData(2 * env["fs"], wave.channel(0)))
        w.write(key, wave)
    _run("torch", cuda, f"--sample-frequency={env['fs']}", "--dither=0",
         wav, f"ark:{tmp_path}/out.ark")
    assert sorted(_read(f"ark:{tmp_path}/out.ark")) == [key]


@pytest.fixture(scope="module")
def global_stats(env, tmp_path_factory):
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.feat.functions import acc_cmvn_stats
    from kaldi_tpu_torch.util import kaldi_io
    path = tmp_path_factory.mktemp("cmvn") / "global.mat"
    stats = acc_cmvn_stats(np.concatenate(list(env["tf"].values())))
    kaldi_io.write_kaldi_object(lambda s, b: iof.write_matrix(s, b, stats),
                                str(path))
    return str(path)


@pytest.mark.parametrize("tool", ["apply-cmvn-online-cuda",
                                  "apply-batched-cmvn-online-cuda"])
def test_apply_cmvn_online_cuda_bytes(env, global_stats, tmp_path, tool):
    d = env["d"]
    for side in ("jax", "torch"):
        _run(side, tool, "--normalize-variance=true", global_stats,
             f"ark:{d}/feats.ark", f"ark:{tmp_path}/{side}.ark")
    _run("torch", "apply-cmvn-online", "--normalize-variance=true",
         global_stats, f"ark:{d}/feats.ark", f"ark:{tmp_path}/host.ark")
    got = (tmp_path / "torch.ark").read_bytes()
    assert got == (tmp_path / "jax.ark").read_bytes()
    assert got == (tmp_path / "host.ark").read_bytes()


@pytest.fixture(scope="module")
def ivec_model(tmp_path_factory):
    """A tiny random-init extractor (tests/test_cli_tail15.py's)."""
    from kaldi_tpu.gmm.diag_gmm import DiagGmm
    from kaldi_tpu.ivector.extractor import IvectorExtractor
    from kaldi_tpu.recipes.bench_corpus import save_ivector_extractor
    rng = np.random.default_rng(0)
    gmm = DiagGmm(4, 13)
    gmm.set_from_means_and_vars(np.full(4, 0.25),
                                rng.normal(scale=3.0, size=(4, 13)),
                                np.ones((4, 13)))
    path = tmp_path_factory.mktemp("ivec") / "ivec.npz"
    save_ivector_extractor(str(path), IvectorExtractor(gmm, 8))
    return str(path)


@pytest.mark.parametrize("tool", ["compute-online-feats-cuda",
                                  "compute-online-feats-batched-cuda"])
def test_online_feats_match_jax_and_the_extractor(env, ivec_model, tmp_path,
                                                 tool):
    import torch

    from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
    from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor
    d = env["d"]
    out = {}
    for side in ("jax", "torch"):
        _run(side, tool, f"--sample-frequency={env['fs']}", "--dither=0",
             "--ivector-period=7", "--batch-size=2", ivec_model,
             f"scp:{d}/wav.scp", f"ark:{tmp_path}/{side}.f.ark",
             f"ark:{tmp_path}/{side}.i.ark")
        out[side] = (_read(f"ark:{tmp_path}/{side}.f.ark"),
                     _read(f"ark:{tmp_path}/{side}.i.ark"))
    (feats, ivecs), (jfeats, jivecs) = out["torch"], out["jax"]
    assert sorted(ivecs) == sorted(jivecs) == sorted(env["test_wav"])
    bex = BatchedIvectorExtractor(load_ivector_extractor(ivec_model),
                                  device="cpu")
    for u in jivecs:
        assert_features_close("mfcc", feats[u], jfeats[u], u)
        np.testing.assert_allclose(ivecs[u], jivecs[u], rtol=1e-4,
                                   atol=3e-4)
    # the extractor itself over the tool's batches of 2 (zero-padded,
    # masked) of its own features, an estimate every 7 frames
    utts = sorted(feats)
    for b0 in range(0, len(utts), 2):
        part = utts[b0:b0 + 2]
        lens = np.array([feats[u].shape[0] for u in part])
        batch = np.zeros((len(part), lens.max(), feats[part[0]].shape[1]),
                         np.float32)
        for i, u in enumerate(part):
            batch[i, :lens[i]] = feats[u]
        state = bex.init_state(len(part))
        rows = [[] for _ in part]
        for c0 in range(0, lens.max(), 7):
            t = np.arange(c0, min(c0 + 7, lens.max()))
            state = bex.acc_chunk(state,
                                  torch.from_numpy(batch[:, c0:c0 + 7]),
                                  torch.from_numpy(t[None] < lens[:, None]))
            iv = bex.ivector(state).numpy()
            for i in range(len(part)):
                if c0 < lens[i]:
                    rows[i].append(iv[i])
        for i, u in enumerate(part):
            np.testing.assert_array_equal(ivecs[u], np.stack(rows[i]))


def _lattices(path):
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    return _read(f"ark:{path}", LatticeHolder())


def test_batched_wav_nnet3_cuda2_matches_jax(env, tmp_path, capfd):
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    d = env["d"]
    args = [f"--sample-frequency={env['fs']}", "--dither=0.0",
            "--frame-subsampling-factor=1", "--max-batch-size=2",
            f"{d}/am.mdl", f"{d}/HCLG.fst", f"scp:{d}/wav.scp"]
    for side in ("jax", "torch"):
        _run(side, "batched-wav-nnet3-cuda2", *args,
             f"ark:{tmp_path}/{side}.lat")
    err = capfd.readouterr().err
    assert err.count("RealTimeX: ") == 2
    assert re.search(r"batched-wav-nnet3-cuda2 stats \{.*\"search_s\"", err)
    ours, theirs = (_lattices(tmp_path / f"{s}.lat")
                    for s in ("torch", "jax"))
    assert sorted(ours) == sorted(theirs) == sorted(env["test_wav"])
    for u in theirs:
        a, b = lattice_best_path(ours[u]), lattice_best_path(theirs[u])
        assert a[:2] == b[:2]
        assert abs(a[2] - b[2]) <= 1e-4 * max(1.0, abs(b[2]))
    _run("torch", "batched-wav-nnet3-cuda", *args, f"ark:{tmp_path}/al.lat")
    assert (tmp_path / "al.lat").read_bytes() == \
        (tmp_path / "torch.lat").read_bytes()


def test_batched_wav_nnet3_cuda2_takes_every_third_frame(env, tmp_path):
    """At factor 3 the tool decodes frames 0, 3, 6, ... of the model's
    input-rate output (its lattices equal the decoder's on those frames
    computed here); JAX's tool decodes the first third of the frames, so
    its lattices have the same length and other costs."""
    from kaldi_tpu_torch.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.feat.window import FrameExtractionOptions
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    d = env["d"]
    args = [f"--sample-frequency={env['fs']}", "--dither=0.0",
            "--frame-subsampling-factor=3", f"{d}/am.mdl", f"{d}/HCLG.fst",
            f"scp:{d}/wav.scp"]
    for side in ("jax", "torch"):
        _run(side, "batched-wav-nnet3-cuda2", *args,
             f"ark:{tmp_path}/{side}.lat")
    ours, theirs = (_lattices(tmp_path / f"{s}.lat")
                    for s in ("torch", "jax"))
    tm, graph, _ = read_nnet3_any(f"{d}/am.mdl")
    net = compile_graph(graph, device="cpu")
    fe = OfflineFeature(MfccOptions(frame_opts=FrameExtractionOptions(
        samp_freq=env["fs"], dither=0.0)), device="cpu")
    dec = LatticeFasterDecoder(read_fst_file(f"{d}/HCLG.fst"),
                               LatticeFasterDecoderOptions())
    waves = {u: w.channel(0) for u, w in
             SequentialTableReader("wave", f"scp:{d}/wav.scp")}
    utts = sorted(waves)
    feats = fe.compute_batch([waves[u] for u in utts])
    t_max = -(-max(f.shape[0] for f in feats) // 8) * 8
    batch = np.zeros((len(utts), t_max, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        batch[i, :f.shape[0]] = f
    out = net(batch, None).numpy()
    moved = 0
    for i, u in enumerate(utts):
        want = dec.decode(out[i, :feats[i].shape[0]:3], tm.id2pdf_id, 1.0)
        assert lattice_best_path(ours[u]) == lattice_best_path(want)
        moved += lattice_best_path(theirs[u])[2] != \
            lattice_best_path(ours[u])[2]
    assert moved > 0


def test_batched_wav_nnet3_cuda_online_words_equal_jax(env, tmp_path):
    d = env["d"]
    for side in ("jax", "torch"):
        _run(side, "batched-wav-nnet3-cuda-online",
             f"--sample-frequency={env['fs']}", "--dither=0.0",
             "--frame-subsampling-factor=1", f"{d}/am.mdl",
             f"{d}/HCLG.fst", f"scp:{d}/wav.scp",
             f"ark,t:{tmp_path}/{side}.words")
    assert (tmp_path / "torch.words").read_bytes() == \
        (tmp_path / "jax.words").read_bytes()
    assert len((tmp_path / "jax.words").read_text().splitlines()) == \
        len(env["test_wav"])
