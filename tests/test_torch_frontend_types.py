"""Port parity: every feature type of `kaldi_tpu_torch/feat/frontend.py`
(MFCC, fbank, spectrogram, PLP) against the JAX package's frontend on the
CPU, on waves made from a seed: snip_edges true and false, the float,
int16 and mu-law wires, the energy, htk_compat, power and log variants,
VTLN warps a lane, `make_feature_computer`, dither and the refused
`return_raw_fft`.  Tolerance: tests/feat_tolerance.py (atol 2e-3 / rtol
1e-4, PLP 5e-3 / 1e-3, the spectrogram's bins also their float32 FFT
rounding).

Frames are compared where they hold real samples: with snip_edges=True
the frames before nframes, with snip_edges=False every bucket frame that
the reference's two reflection passes reach without the final clip (a
frame of one clipped sample is a constant, whose DC removal leaves
rounding noise that the log turns into differences between any two
implementations).  Frames past nframes are compared on the int16 wire
with snip_edges=False, where they are the reflected utterance."""

import numpy as np
import pytest
import torch

from kaldi_tpu.feat import frontend as J
from kaldi_tpu.feat.mel import MelBanksOptions as JMel
from kaldi_tpu.feat.plp import PlpOptions as JPlp
from kaldi_tpu.feat.window import FrameExtractionOptions as JFrame
from kaldi_tpu_torch.feat import frontend as T
from kaldi_tpu_torch.feat.mel import MelBanksOptions as TMel
from kaldi_tpu_torch.feat.plp import PlpOptions as TPlp
from kaldi_tpu_torch.feat.window import FrameExtractionOptions as TFrame
from kaldi_tpu_torch.feat.window import first_sample_of_frame

from feat_tolerance import assert_features_close

OPTS = {"mfcc": (J.MfccOptions, T.MfccOptions),
        "fbank": (J.FbankOptions, T.FbankOptions),
        "spectrogram": (J.SpectrogramOptions, T.SpectrogramOptions),
        "plp": (JPlp, TPlp)}

def tol(kind):
    return dict(atol=5e-3, rtol=1e-3) if kind == "plp" else \
        dict(atol=2e-3, rtol=1e-4)


def waves(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        tone = 3000 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
        out.append(np.clip(tone + rng.normal(size=n) * 2000,
                           -32767, 32767))
    return out


def make(kind, frame=None, mel=None, **kw):
    """(JAX options, port options) of one configuration."""
    jc, tc = OPTS[kind]
    frame = dict(dither=0.0, **(frame or {}))
    out = []
    for cls, fcls, mcls in ((jc, JFrame, JMel), (tc, TFrame, TMel)):
        extra = dict(kw)
        if mel is not None:
            extra["mel_opts"] = mcls(**mel)
        out.append(cls(frame_opts=fcls(**frame), **extra))
    return out


def reached(n, fo, nbucket):
    """Bucket frames whose window two reflection passes bring inside an
    utterance of n samples (no clip)."""
    size = fo.window_size()
    return [f for f in range(nbucket)
            if first_sample_of_frame(f, fo) >= -n
            and first_sample_of_frame(f, fo) + size <= 2 * n]


def compare(jo, to, ws, kind, all_reached=False):
    ref, ref_n = J.OfflineFeature(jo).compute_batch_device(ws)
    out, n = T.OfflineFeature(to, device="cpu").compute_batch_device(ws)
    np.testing.assert_array_equal(n, ref_n)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape
    for b, w in enumerate(ws):
        rows = (reached(len(w), to.frame_opts, out.shape[1]) if all_reached
                else list(range(n[b])))
        assert_features_close(kind, out[b, rows], ref[b, rows],
                              f"lane {b}")
    return out, n


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("kind", sorted(OPTS))
def test_types_match_jax(kind, snip):
    jo, to = make(kind, frame=dict(snip_edges=snip))
    ws = [w.astype(np.float32) for w in waves(1, [16000, 9731, 4400, 800])]
    _out, n = compare(jo, to, ws, kind)
    assert (n > 0).all()
    if not snip:
        assert n[0] == 100      # (16000 + 80) // 160


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
@pytest.mark.parametrize("kind", sorted(OPTS))
def test_wires_match_jax(kind, wire):
    jo, to = make(kind)
    raw = waves(2, [12000, 5000])
    if wire == "mulaw":
        ws = [J.mulaw_encode(w) for w in raw]
    else:
        ws = [w.astype(np.int16 if wire == "int16" else np.float32)
              for w in raw]
    compare(jo, to, ws, kind)


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_reflected_padding_matches_jax(kind):
    """snip_edges=False on the int16 wire: every bucket frame the
    reflection reaches, past nframes too."""
    jo, to = make(kind, frame=dict(snip_edges=False))
    ws = [w.astype(np.int16) for w in waves(3, [7000, 2400, 500])]
    compare(jo, to, ws, kind, all_reached=True)


VARIANTS = [
    ("mfcc", dict(use_energy=False, htk_compat=True)),
    ("mfcc", dict(energy_floor=1.0, raw_energy=False)),
    ("fbank", dict(use_energy=True)),
    ("fbank", dict(use_energy=True, htk_compat=True, energy_floor=1.0)),
    ("fbank", dict(use_power=False)),
    ("fbank", dict(use_log_fbank=False)),
    ("spectrogram", dict(raw_energy=False)),
    ("spectrogram", dict(energy_floor=1e5)),
    ("plp", dict(use_energy=False)),
    ("plp", dict(htk_compat=True, raw_energy=False)),
    ("plp", dict(lpc_order=10, num_ceps=11, cepstral_scale=1.5)),
    ("plp", dict(cepstral_lifter=0.0, compress_factor=0.5)),
]


@pytest.mark.parametrize("kind,kw", VARIANTS)
def test_option_variants_match_jax(kind, kw):
    jo, to = make(kind, **kw)
    ws = [w.astype(np.int16) for w in waves(4, [9000, 3100])]
    compare(jo, to, ws, kind)


@pytest.mark.parametrize("kind", ["mfcc", "fbank", "plp"])
def test_vtln_warp_a_lane_matches_jax(kind):
    """A batch of mixed warps against JAX's one-warp batches."""
    jo, to = make(kind, mel=dict(num_bins=23, low_freq=20.0,
                                 vtln_low=100.0, vtln_high=-500.0))
    ws = [w.astype(np.float32) for w in waves(5, [8000, 6000, 7000])]
    warps = [0.9, 1.1, 0.9]
    out, n = T.OfflineFeature(to, device="cpu").compute_batch_device(
        ws, vtln_warp=warps)
    out = out.numpy()
    ref_fe = J.OfflineFeature(jo)
    for b, (w, warp) in enumerate(zip(ws, warps)):
        ref = ref_fe.compute(w, warp)
        np.testing.assert_allclose(out[b, :n[b]], ref, **tol(kind))
    assert not np.allclose(out[0, :n[0]], T.OfflineFeature(
        to, device="cpu").compute(ws[0]), **tol(kind))


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_make_feature_computer(kind):
    fe = T.make_feature_computer(kind, device="cpu")
    ref = J.make_feature_computer(kind)
    assert type(fe.opts).__name__ == type(ref.opts).__name__
    assert fe.dim() == ref.dim() and fe.type == ref.type == kind
    assert fe.opts.frame_opts.dither == 1.0


def test_return_raw_fft_raises():
    opts = T.SpectrogramOptions(return_raw_fft=True)
    with pytest.raises(NotImplementedError, match="return-raw-fft"):
        T.OfflineFeature(opts, device="cpu")


def _dither_fe():
    return T.OfflineFeature(T.MfccOptions(), device="cpu")


def test_dither_one_seed_twice_equal_another_differs():
    w = waves(6, [6000])[0].astype(np.float32)
    fe = _dither_fe()
    a = fe.compute(w, seed=11)
    b = fe.compute(w, seed=11)
    c = fe.compute(w, seed=12)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_dither_within_bound_of_undithered():
    """tests/test_feat.py:109's bound on its wave (a 300 Hz tone of
    amplitude 5000 plus noise of 500): no coefficient moves by 1.0."""
    rng = np.random.default_rng(6)
    t = np.arange(4000) / 16000.0
    w = (5000 * np.sin(2 * np.pi * 300.0 * t)
         + 500 * rng.normal(size=4000)).astype(np.float32)
    fo = TFrame(dither=0.0)
    plain = T.OfflineFeature(T.MfccOptions(frame_opts=fo),
                             device="cpu").compute(w)
    dith = _dither_fe().compute(w, seed=1)
    assert not np.array_equal(plain, dith)
    assert np.abs(dith - plain).max() < 1.0


def test_dither_seed_stream_is_the_reference_rng():
    """seed=None draws the reference's seeds: np.random.default_rng(0)
    of the computer, one a batch; a new computer starts over."""
    w = waves(7, [3000])[0].astype(np.float32)
    fe = _dither_fe()
    seeds = np.random.default_rng(0).integers(2 ** 31 - 1, size=2)
    a, b = fe.compute(w), fe.compute(w)
    np.testing.assert_array_equal(a, fe.compute(w, seed=int(seeds[0])))
    np.testing.assert_array_equal(b, fe.compute(w, seed=int(seeds[1])))
    np.testing.assert_array_equal(a, _dither_fe().compute(w))


def test_dither_noise_statistics():
    """The program adds `dither_noise` (its output equals the undithered
    program's on the frames plus that noise), and the noise over more
    than 1e6 draws has a mean within 0.01 x dither of 0 and a standard
    deviation within 1% of dither."""
    dither = 3.0
    fo = TFrame(dither=dither)
    frames = torch.from_numpy(np.stack(
        [np.lib.stride_tricks.sliding_window_view(w, 400)[::160][:64]
         for w in waves(8, [11000] * 8)]).astype(np.float32))
    fe = T.OfflineFeature(T.MfccOptions(frame_opts=fo), device="cpu")
    fe0 = T.OfflineFeature(T.MfccOptions(frame_opts=TFrame(dither=0.0)),
                           device="cpu")
    noise = T.dither_noise(frames.shape, 5, dither, torch.device("cpu"))
    assert torch.equal(fe._compute_frames(frames, seed=5),
                       fe0._compute_frames(frames + noise))
    big = T.dither_noise((4, 1024, 400), 6, dither,
                         torch.device("cpu")).numpy().astype(np.float64)
    assert big.size > 1e6
    assert abs(big.mean()) < 0.01 * dither
    assert abs(big.std() - dither) < 0.01 * dither
