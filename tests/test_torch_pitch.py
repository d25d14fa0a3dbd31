"""Port parity: the host numpy feature modules of the port
(`feat/resample.py`, `feat/pitch.py`, `feat/perturb.py`, `feat/htk.py`)
and `online/features.py` `OnlinePitchFeature` against the JAX package's
on the CPU: equal arrays (the port's copies keep the reference's dtypes,
products and order of operations), on tests/test_pitch.py's tones, on
waves made from a seed and on two utterances of the legacy bench corpus;
the HTK files byte for byte."""

import io

import numpy as np
import pytest

from kaldi_tpu.feat import htk as jhtk
from kaldi_tpu.feat import perturb as jperturb
from kaldi_tpu.feat import pitch as jpitch
from kaldi_tpu.feat import resample as jresample
from kaldi_tpu.online.features import OnlinePitchFeature as JOnlinePitch
from kaldi_tpu_torch.feat import htk, perturb, pitch, resample
from kaldi_tpu_torch.online.features import OnlinePitchFeature


def tone(freq, seconds=1.0, fs=16000, amp=8000):
    t = np.arange(int(seconds * fs)) / fs
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def glide(seconds=1.2, fs=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    f0 = 150 + 40 * np.sin(2 * np.pi * 1.5 * t)
    w = 6000 * np.sin(2 * np.pi * np.cumsum(f0) / fs)
    w[int(0.4 * fs):int(0.6 * fs)] = 0.0          # a silent stretch
    return (w + 200 * rng.normal(size=len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def bench_waves():
    from kaldi_tpu_torch.recipes.bench_corpus import (BenchCorpusSpec,
                                                      make_corpus)
    _lex, _tt, _tw, _test_txt, test_wav, _lm = make_corpus(
        BenchCorpusSpec(), train_audio=False)
    utts = sorted(test_wav)
    return {u: np.clip(test_wav[u], -32767, 32767).astype(np.int16)
            for u in (utts[0], utts[77])}


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000),
                                   (16000, 4000), (44100, 16000)])
def test_linear_resample_equal(rates):
    w = glide(0.3, fs=rates[0])
    for cutoff in (None, 0.4 * min(rates)):
        a = resample.LinearResample(*rates, filter_cutoff=cutoff,
                                    num_zeros=4).resample(w)
        b = jresample.LinearResample(*rates, filter_cutoff=cutoff,
                                     num_zeros=4).resample(w)
        np.testing.assert_array_equal(a, b)


def test_arbitrary_resample_equal():
    w = glide(0.1)
    pts = np.sort(np.random.default_rng(1).uniform(0, 0.09, 300))
    a = resample.ArbitraryResample(len(w), 16000, 3000.0, pts).resample(w)
    b = jresample.ArbitraryResample(len(w), 16000, 3000.0, pts).resample(w)
    np.testing.assert_array_equal(a, b)


WAVES = {"tone120": lambda: tone(120), "tone240": lambda: tone(240, 0.5),
         "two_tones": lambda: np.concatenate([tone(120, 0.5),
                                              tone(240, 0.5)]),
         "glide": glide}


@pytest.mark.parametrize("name", sorted(WAVES))
@pytest.mark.parametrize("snip", [True, False])
def test_pitch_and_processed_pitch_equal(name, snip):
    w = WAVES[name]()
    a = pitch.compute_kaldi_pitch(w, pitch.PitchExtractionOptions(
        snip_edges=snip))
    b = jpitch.compute_kaldi_pitch(w, jpitch.PitchExtractionOptions(
        snip_edges=snip))
    np.testing.assert_array_equal(a, b)
    assert a.shape[0] > 0
    np.testing.assert_array_equal(pitch.process_pitch(a),
                                  jpitch.process_pitch(b))


@pytest.mark.parametrize("kw", [dict(add_raw_log_pitch=True, delay=2),
                                dict(add_pov_feature=False,
                                     delta_pitch_noise_stddev=0.0),
                                dict(normalization_left_context=10,
                                     normalization_right_context=5)])
def test_process_pitch_options_equal(kw):
    raw = jpitch.compute_kaldi_pitch(glide())
    np.testing.assert_array_equal(
        pitch.process_pitch(raw, pitch.ProcessPitchOptions(**kw)),
        jpitch.process_pitch(raw, jpitch.ProcessPitchOptions(**kw)))


def test_bench_utterances_equal(bench_waves):
    for u, w in bench_waves.items():
        a = pitch.compute_and_process_kaldi_pitch(w.astype(np.float32))
        b = jpitch.compute_and_process_kaldi_pitch(w.astype(np.float32))
        np.testing.assert_array_equal(a, b, err_msg=u)
        assert a.shape[1] == 3 and a.shape[0] > 100


def _feed(online, w, piece):
    finals = []
    for start in range(0, len(w), piece):
        online.accept_waveform(16000.0, w[start:start + piece])
        n = (online.num_frames_final
             if hasattr(online, "num_frames_final") else online._num_final)
        finals.append((n, online.get_frames(np.arange(n)).copy()
                       if n else np.zeros((0, 3), np.float32)))
    online.input_finished()
    return finals, online.get_frames(np.arange(online.num_frames_ready()))


@pytest.mark.parametrize("latency", [30, 10 ** 6])
def test_online_pitch_chunk_by_chunk(latency):
    """Fed in 0.25 s pieces: the port's stream equals JAX's after every
    piece; no finalized frame changes later; with a latency past the
    stream's length the output equals the offline one."""
    w = glide(2.0, seed=3)
    piece = 4000
    ours, out = _feed(OnlinePitchFeature(max_frames_latency=latency), w,
                      piece)
    theirs, ref = _feed(JOnlinePitch(max_frames_latency=latency), w, piece)
    np.testing.assert_array_equal(out, ref)
    for (n, f), (m, g) in zip(ours, theirs):
        assert n == m
        np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(out[:n], f)
    if latency > len(w):
        assert all(n == 0 for n, _ in ours)
        np.testing.assert_array_equal(
            out, pitch.compute_and_process_kaldi_pitch(w))
    else:
        assert ours[-1][0] > 0


def test_online_pitch_refuses_wrong_rate_and_late_audio():
    online = OnlinePitchFeature()
    with pytest.raises(ValueError):
        online.accept_waveform(8000.0, tone(100, 0.1))
    online.accept_waveform(16000.0, tone(100, 0.1))
    online.input_finished()
    with pytest.raises(RuntimeError):
        online.accept_waveform(16000.0, tone(100, 0.1))


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1])
def test_speed_perturb_equal(factor):
    w = glide(0.5)
    np.testing.assert_array_equal(perturb.speed_perturb(w, 16000, factor),
                                  jperturb.speed_perturb(w, 16000, factor))


def test_volume_reverb_noise_equal():
    w = glide(0.5)
    rng = np.random.default_rng(4)
    rir = np.exp(-np.arange(800) / 100.0) * rng.normal(size=800)
    noise = rng.normal(size=3000) * 300
    np.testing.assert_array_equal(perturb.volume_perturb(w, 0.7),
                                  jperturb.volume_perturb(w, 0.7))
    for shift in (True, False):
        np.testing.assert_array_equal(
            perturb.reverberate(w, rir, shift_output=shift),
            jperturb.reverberate(w, rir, shift_output=shift))
    np.testing.assert_array_equal(
        perturb.add_noise(w, noise, 10.0, np.random.default_rng(5)),
        jperturb.add_noise(w, noise, 10.0, np.random.default_rng(5)))


def test_htk_bytes_and_read_back():
    feats = np.random.default_rng(6).normal(size=(7, 13)).astype(np.float32)
    a, b = io.BytesIO(), io.BytesIO()
    htk.write_htk(a, feats, sample_period=50000, parm_kind=6)
    jhtk.write_htk(b, feats, sample_period=50000, parm_kind=6)
    assert a.getvalue() == b.getvalue()
    b.seek(0)
    got, period, kind = htk.read_htk(b)
    np.testing.assert_array_equal(got, feats)
    assert (period, kind) == (50000, 6)
