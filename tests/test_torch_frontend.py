"""Port parity: the MFCC frontend of kaldi_tpu_torch against the JAX
reference on mu-law, int16 and float waves of different lengths.
Tolerance atol 2e-3 / rtol 1e-4, as tests/test_ref_feat_golden.py.

The padded frames past nframes feed the acoustic model's right context,
so they are compared too, with one exception: on the mu-law wire the
zero pad byte decodes to a constant -32768, and a frame that holds only
padding is a constant whose DC removal leaves rounding noise; its
cepstra are that noise through a log, and differ between any two
implementations (the JAX reference's energy and spectrum branches do
not even agree with each other there).  Frames that hold at least one
real sample are compared on every wire."""

import numpy as np
import pytest

from kaldi_tpu.feat.frontend import OfflineFeature as JaxFeature
from kaldi_tpu.feat.frontend import mulaw_encode as jax_mulaw_encode
from kaldi_tpu.recipes.bench_corpus import BenchCorpusSpec, mfcc_options
from kaldi_tpu_torch.feat.frontend import (MfccOptions, OfflineFeature,
                                           mulaw_encode)
from kaldi_tpu_torch.feat.mel import MelBanksOptions
from kaldi_tpu_torch.feat.window import FrameExtractionOptions


def bench_options():
    """The bench configuration: 40 ceps, 40 bins, 16 kHz, dither 0."""
    opts = MfccOptions(frame_opts=FrameExtractionOptions(samp_freq=16000.0,
                                                         dither=0.0),
                       mel_opts=MelBanksOptions(num_bins=40))
    opts.num_ceps = 40
    return opts


def waves(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        tone = 3000 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
        out.append(np.clip(tone + rng.normal(size=n) * 2000,
                           -32767, 32767))
    return out


def test_mulaw_encode_matches():
    w = waves(0, [5000])[0]
    np.testing.assert_array_equal(mulaw_encode(w), jax_mulaw_encode(w))


@pytest.mark.parametrize("wire", ["mulaw", "int16", "float32"])
def test_mfcc_matches_jax(wire):
    ref_fe = JaxFeature(mfcc_options(BenchCorpusSpec()))
    fe = OfflineFeature(bench_options(), device="cpu")
    raw = waves({"mulaw": 1, "int16": 2, "float32": 3}[wire],
                [16000, 9731, 4400])
    if wire == "mulaw":
        ws = [jax_mulaw_encode(w) for w in raw]
    elif wire == "int16":
        ws = [w.astype(np.int16) for w in raw]
    else:
        ws = [w.astype(np.float32) for w in raw]
    ref, ref_n = ref_fe.compute_batch_device(ws)
    out, n = fe.compute_batch_device(ws)
    np.testing.assert_array_equal(n, ref_n)
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape == (3, 128, 40)
    for b, w in enumerate(ws):
        # frames that start inside the wave (zero padding is exact zero
        # on the int16 and float wires: every frame compares there)
        F = -(-len(w) // 160) if wire == "mulaw" else out.shape[1]
        assert F > n[b]
        np.testing.assert_allclose(out[b, :F], ref[b, :F], atol=2e-3,
                                   rtol=1e-4, err_msg=f"lane {b}")


@pytest.mark.parametrize("window_type", ["hanning", "sine", "hamming",
                                         "povey", "rectangular", "blackman"])
def test_window_functions_match(window_type):
    from kaldi_tpu.feat.window import FrameExtractionOptions as JaxFrameOpts
    from kaldi_tpu.feat.window import feature_window_function as jax_window
    from kaldi_tpu_torch.feat.window import feature_window_function
    np.testing.assert_array_equal(
        feature_window_function(FrameExtractionOptions(
            window_type=window_type)),
        jax_window(JaxFrameOpts(window_type=window_type)))


@pytest.mark.parametrize("variant", [
    dict(htk_compat=True, use_energy=False),
    dict(htk_compat=True, energy_floor=1.0),
    dict(raw_energy=False, cepstral_lifter=0.0),
    dict(num_ceps=13, htk_mode=True, num_bins=23, window_type="hamming"),
])
def test_mfcc_option_branches_match_jax(variant):
    """The other branches of the MFCC program, on int16 waves."""
    from kaldi_tpu.feat.frontend import MfccOptions as JaxMfcc
    from kaldi_tpu.feat.mel import MelBanksOptions as JaxMel
    from kaldi_tpu.feat.window import FrameExtractionOptions as JaxFrameOpts
    v = dict(variant)
    frame = dict(dither=0.0, window_type=v.pop("window_type", "povey"))
    mel = dict(num_bins=v.pop("num_bins", 40), htk_mode=v.pop("htk_mode",
                                                                False))
    v.setdefault("num_ceps", 40)
    ref_fe = JaxFeature(JaxMfcc(frame_opts=JaxFrameOpts(**frame),
                                mel_opts=JaxMel(**mel), **v))
    fe = OfflineFeature(MfccOptions(frame_opts=FrameExtractionOptions(**frame),
                                    mel_opts=MelBanksOptions(**mel), **v),
                        device="cpu")
    ws = [w.astype(np.int16) for w in waves(7, [7000, 3100])]
    ref, _ = ref_fe.compute_batch_device(ws)
    out, _ = fe.compute_batch_device(ws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=1e-4)
