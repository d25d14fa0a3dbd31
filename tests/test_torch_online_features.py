"""Port parity of the streaming features: kaldi_tpu_torch/online/
features.py (and feat/functions.py) against kaldi_tpu/online/features.py,
on the CPU.

The same seeded waves are fed to both packages in the same ragged
chunks.  After every chunk each stage has the same frames ready, and
those frames agree within 2e-3 absolute + 1e-4 relative (the two MFCC
frontends round differently); at the end, the same again, with the
last-frame flags equal.  Stages: the base MFCC, OnlineCmvn (with and
without speaker and global stats, variance normalization, a frozen
state, the state carried to the next utterance), OnlineSpliceFrames,
OnlineDeltaFeature, OnlineTransform (linear and affine),
OnlineAppendFeature, and OnlineFeaturePipeline over a stack of them.
The port's streamed base features equal its own offline extractor's."""

import numpy as np
import pytest

from kaldi_tpu.feat import functions as JFn
from kaldi_tpu.feat.frontend import MfccOptions as JaxMfcc
from kaldi_tpu.feat.window import FrameExtractionOptions as JaxFrames
from kaldi_tpu.online import features as JOF
from kaldi_tpu_torch.feat import functions as PFn
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.online import features as POF

ATOL, RTOL = 2e-3, 1e-4
FS = 8000.0


def wave(seed, seconds=0.9):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    return (rng.normal(scale=400, size=t.size)
            + 3000 * np.sin(2 * np.pi * 310 * t)).astype(np.float32)


def bases(num_ceps=13):
    p = MfccOptions(frame_opts=FrameExtractionOptions(samp_freq=FS,
                                                      dither=0.0))
    j = JaxMfcc(frame_opts=JaxFrames(samp_freq=FS, dither=0.0))
    p.num_ceps = j.num_ceps = num_ceps
    return POF.OnlineFeature(p, device="cpu"), JOF.OnlineFeature(j), p


def cmvn_state(mod, seed, dim, speaker=True, glob=True):
    rng = np.random.default_rng(seed)

    def stats(n):
        x = rng.normal(size=(n, dim)) * 5
        s = np.zeros((2, dim + 1))
        s[0, :dim], s[1, :dim], s[0, dim] = x.sum(0), (x * x).sum(0), n
        return s
    return mod.OnlineCmvnState(
        speaker_cmvn_stats=stats(40) if speaker else None,
        global_cmvn_stats=stats(300) if glob else None)


def build(kind, mod, base, dim, Fn):
    """The stage `kind` of package `mod` over `base`."""
    if kind == "base":
        return base
    if kind.startswith("cmvn"):
        opts = mod.OnlineCmvnOptions(cmn_window=30, speaker_frames=20,
                                     global_frames=15,
                                     normalize_variance=kind == "cmvn_var")
        state = cmvn_state(mod, 7, dim, speaker=kind != "cmvn_global",
                           glob=kind != "cmvn_none")
        return mod.OnlineCmvn(opts, state, base)
    if kind == "splice":
        return mod.OnlineSpliceFrames(2, 3, base)
    if kind == "delta":
        return mod.OnlineDeltaFeature(Fn.DeltaFeaturesOptions(order=2,
                                                              window=2),
                                      base)
    rng = np.random.default_rng(11)
    if kind == "transform_affine":
        return mod.OnlineTransform(rng.normal(size=(5, dim + 1)) * 0.3, base)
    if kind == "transform_linear":
        return mod.OnlineTransform(rng.normal(size=(6, dim)) * 0.3, base)
    if kind == "append":
        return mod.OnlineAppendFeature(
            base, mod.OnlineDeltaFeature(Fn.DeltaFeaturesOptions(order=1),
                                         base))
    raise ValueError(kind)


def close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def stream_and_compare(p_out, j_out, p_base, j_base, w, seed):
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(w):
        n = int(rng.integers(1, 2500))
        p_base.accept_waveform(FS, w[pos:pos + n])
        j_base.accept_waveform(FS, w[pos:pos + n])
        pos += n
        ready = p_out.num_frames_ready()
        assert ready == j_out.num_frames_ready()
        if ready:
            close(p_out.get_frames(range(ready)),
                  j_out.get_frames(range(ready)))
    p_base.finish_input()
    j_base.finish_input()
    T = p_out.num_frames_ready()
    assert T == j_out.num_frames_ready() > 0
    close(p_out.get_frames(range(T)), j_out.get_frames(range(T)))
    assert [p_out.is_last_frame(t) for t in range(T)] == \
        [j_out.is_last_frame(t) for t in range(T)]
    assert p_out.is_last_frame(T - 1) and p_out.dim() == j_out.dim()
    return T


KINDS = ["base", "cmvn", "cmvn_var", "cmvn_global", "cmvn_none", "splice",
         "delta", "transform_affine", "transform_linear", "append"]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", KINDS)
def test_stage_matches_jax_under_ragged_chunks(kind, seed):
    p_base, j_base, _ = bases()
    p_out = build(kind, POF, p_base, p_base.dim(), PFn)
    j_out = build(kind, JOF, j_base, j_base.dim(), JFn)
    stream_and_compare(p_out, j_out, p_base, j_base, wave(seed), 100 + seed)


def test_streamed_base_equals_offline():
    p_base, _, opts = bases()
    w = wave(3, 1.3)
    rng = np.random.default_rng(5)
    pos = 0
    while pos < len(w):
        n = int(rng.integers(1, 3000))
        p_base.accept_waveform(FS, w[pos:pos + n])
        pos += n
    p_base.finish_input()
    feats, n = OfflineFeature(opts, device="cpu").compute_batch_device([w])
    offline = feats[0, :int(n[0])].numpy()
    assert p_base.num_frames_ready() == offline.shape[0]
    np.testing.assert_allclose(
        p_base.get_frames(range(offline.shape[0])), offline, atol=1e-4,
        rtol=1e-5)


def test_pipeline_over_a_stack_matches_jax():
    """base -> CMVN -> deltas -> affine transform, through
    OnlineFeaturePipeline, and the CMVN state for the next utterance."""
    p_base, j_base, _ = bases()
    pipes = []
    for mod, Fn, base in ((POF, PFn, p_base), (JOF, JFn, j_base)):
        cmvn = build("cmvn_var", mod, base, base.dim(), Fn)
        delta = build("delta", mod, cmvn, cmvn.dim(), Fn)
        tr = build("transform_affine", mod, delta, delta.dim(), Fn)
        pipes.append((mod.OnlineFeaturePipeline(base, tr), cmvn))
    (pp, pc), (jp, jc) = pipes
    w = wave(4, 1.1)
    rng = np.random.default_rng(9)
    pos = 0
    assert not pp.finished
    while pos < len(w):
        n = int(rng.integers(100, 2000))
        pp.accept_waveform(FS, w[pos:pos + n])
        jp.accept_waveform(FS, w[pos:pos + n])
        pos += n
        assert pp.num_frames_ready() == jp.num_frames_ready()
        k = pp.num_frames_ready()
        close(pp.get_frames(0, k), jp.get_frames(0, k))
    pp.input_finished()
    jp.input_finished()
    assert pp.finished and pp.dim() == jp.dim() == 5
    T = pp.num_frames_ready()
    assert T == jp.num_frames_ready()
    close(pp.get_frames(0, T), jp.get_frames(0, T))
    assert pp.get_frames(3, 3).shape == (0, 5)
    ps, js = pc.get_state(T - 1), jc.get_state(T - 1)
    np.testing.assert_allclose(ps.speaker_cmvn_stats, js.speaker_cmvn_stats,
                               rtol=1e-4, atol=1e-2)
    assert ps.global_cmvn_stats is pc.state.global_cmvn_stats
    # a frozen state normalizes every frame alike in both
    pc.freeze(10)
    jc.freeze(10)
    close(pc.state.frozen_state, jc.state.frozen_state)
    close(np.stack([pc.get_frame(t) for t in range(T)]),
          np.stack([jc.get_frame(t) for t in range(T)]))


@pytest.mark.parametrize("order,window", [(1, 2), (2, 2), (3, 1)])
def test_delta_and_cmvn_functions_match_jax(order, window):
    """delta_scales and apply_cmvn against JAX's, and the streamed deltas
    of a finished stream against JAX's offline compute_deltas."""
    po, jo = PFn.DeltaFeaturesOptions(order, window), \
        JFn.DeltaFeaturesOptions(order, window)
    for a, b in zip(PFn.delta_scales(po), JFn.delta_scales(jo)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(order).normal(size=(11, 4)).astype(np.float32)
    stats = np.zeros((2, 5))
    stats[0, :4], stats[1, :4], stats[0, 4] = x.sum(0), (x * x).sum(0), 11
    for nv in (False, True):
        np.testing.assert_array_equal(PFn.apply_cmvn(x, stats, nv),
                                      JFn.apply_cmvn(x, stats, nv))
    with pytest.raises(ValueError, match="count"):
        PFn.apply_cmvn(x, np.zeros((2, 5)))
    p_base, _, _ = bases()
    delta = POF.OnlineDeltaFeature(po, p_base)
    w = wave(order)
    p_base.accept_waveform(FS, w)
    p_base.finish_input()
    T = delta.num_frames_ready()
    base = p_base.get_frames(range(T))
    np.testing.assert_allclose(delta.get_frames(range(T)),
                               JFn.compute_deltas(base, jo), atol=1e-4,
                               rtol=1e-5)
