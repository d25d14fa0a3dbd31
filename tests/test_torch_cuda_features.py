"""The feature front end's card paths against their CPU twins: every
feature type (`feat/frontend.py`: MFCC, fbank, spectrogram, PLP, with
snip_edges true and false, a batch of mixed VTLN warps), the dither noise
(one seed twice equal on the card, its statistics), the online features
over fbank and PLP, and the *-cuda feature tools against --use-gpu=no.
Bars: tests/feat_tolerance.py's (the card's float32 FFT and products
round differently from the CPU's).  Needs a CUDA device; run on the card
with `python -m pytest tests/test_torch_cuda_features.py -m cuda -q
--noconftest` (tests/conftest.py imports jax, which the GPU machine
lacks).
"""

import os
import sys

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.feat import frontend as T
from kaldi_tpu_torch.feat.plp import PlpOptions
from kaldi_tpu_torch.feat.window import FrameExtractionOptions

sys.path.insert(0, os.path.dirname(__file__))
from feat_tolerance import assert_features_close  # noqa: E402

pytestmark = pytest.mark.cuda

OPTS = {"mfcc": T.MfccOptions, "fbank": T.FbankOptions,
        "spectrogram": T.SpectrogramOptions, "plp": PlpOptions}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def waves(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        tone = 3000 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
        out.append(np.clip(tone + rng.normal(size=n) * 2000, -32767,
                           32767).astype(np.int16))
    return out


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("kind", sorted(OPTS))
def test_types_card_against_cpu(cuda, kind, snip):
    opts = OPTS[kind](frame_opts=FrameExtractionOptions(dither=0.0,
                                                        snip_edges=snip))
    ws = waves(1, [16000, 9000, 2500])
    warps = [1.0, 0.9, 1.1] if kind in ("mfcc", "fbank", "plp") else 1.0
    got, n = T.OfflineFeature(opts, device=cuda).compute_batch_device(
        ws, vtln_warp=warps)
    ref, m = T.OfflineFeature(opts, device="cpu").compute_batch_device(
        ws, vtln_warp=warps)
    np.testing.assert_array_equal(n, m)
    got, ref = got.cpu().numpy(), ref.numpy()
    for b in range(len(ws)):
        assert_features_close(kind, got[b, :n[b]], ref[b, :n[b]],
                              f"lane {b}")


def test_dither_on_the_card(cuda):
    fe = T.OfflineFeature(T.MfccOptions(), device=cuda)
    w = waves(2, [8000])[0]
    a, b, c = (fe.compute(w, seed=s) for s in (3, 3, 4))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    noise = T.dither_noise((8, 1024, 400), 5, 2.0, cuda).double()
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 2.0) < 0.02


@pytest.mark.parametrize("kind", ["fbank", "plp"])
def test_online_feature_on_the_card(cuda, kind):
    from kaldi_tpu_torch.online.features import OnlineFeature
    opts = OPTS[kind](frame_opts=FrameExtractionOptions(dither=0.0))
    w = waves(3, [12000])[0].astype(np.float32)
    feats = {}
    for dev in (cuda, "cpu"):
        online = OnlineFeature(opts, device=dev)
        for s in range(0, len(w), 2500):
            online.accept_waveform(16000.0, w[s:s + 2500])
        online.finish_input()
        feats[str(dev)] = np.stack([online.get_frame(t) for t in
                                    range(online.num_frames_ready())])
    assert_features_close(kind, feats["cuda"], feats["cpu"])


@pytest.mark.parametrize("tool", ["compute-fbank-feats",
                                  "compute-plp-feats",
                                  "compute-spectrogram-feats",
                                  "compute-mfcc-feats-cuda"])
def test_feature_tools_card_against_cpu(cuda, tool, tmp_path):
    from kaldi_tpu_torch.cli import get_tool
    from kaldi_tpu_torch.feat.wave import WaveData
    from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter
    with TableWriter("wave", f"ark:{tmp_path}/wav.ark") as wr:
        for i, w in enumerate(waves(4, [9000, 13000, 4000])):
            wr.write(f"u{i}", WaveData(16000.0, w))
    out = {}
    for gpu in ("yes", "no"):
        assert get_tool(tool)([tool, f"--use-gpu={gpu}", "--dither=0",
                               f"ark:{tmp_path}/wav.ark",
                               f"ark:{tmp_path}/{gpu}.ark"]) == 0
        out[gpu] = dict(SequentialTableReader("matrix",
                                              f"ark:{tmp_path}/{gpu}.ark"))
    kind = "plp" if "plp" in tool else tool.split("-")[1]
    for k in out["no"]:
        assert_features_close(kind, out["yes"][k], out["no"][k], k)
