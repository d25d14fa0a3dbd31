"""Streaming feature extraction (port of `kaldi_tpu/online/features.py`;
the reference's feat/online-feature.h: OnlineGenericBaseFeature:78,
OnlineCmvn:321 with OnlineCmvnState:266, OnlineSpliceFrames:458,
OnlineDeltaFeature:530, OnlineTransform, OnlineAppendFeature; and the
pipeline of online2/online-nnet2-feature-pipeline.h:200).

Audio arrives in pieces.  accept_waveform buffers the samples and
computes the newly complete frames with the batched offline extractor
(MFCC, fbank or PLP, on the device) over the whole received prefix: a
frame counted with flush=False depends only on samples already received,
so every complete frame is final and the recomputation equals streaming
emission.  Frames are kept on the host, and the stages above the base
feature are host numpy, as in the reference.

`OnlinePitchFeature` (host numpy, `feat/pitch.py`) recomputes the
pitch of the whole received waveform on every accept_waveform, as the
reference's code does, so its cost a chunk grows with the stream; a
frame becomes final once it is `max_frames_latency` plus the
normalization right context behind the newest frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.feat import window as win
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.feat.pitch import (PitchExtractionOptions,
                                        ProcessPitchOptions,
                                        compute_and_process_kaldi_pitch)
from kaldi_tpu_torch.feat.functions import (DeltaFeaturesOptions,
                                            apply_cmvn, delta_scales)


class OnlineFeatureInterface:
    """itf/online-feature-itf.h:49 contract."""

    def dim(self) -> int:
        raise NotImplementedError

    def num_frames_ready(self) -> int:
        raise NotImplementedError

    def is_last_frame(self, frame: int) -> bool:
        raise NotImplementedError

    def get_frame(self, frame: int) -> np.ndarray:
        return self.get_frames([frame])[0]

    def get_frames(self, frames) -> np.ndarray:
        return np.stack([self.get_frame(f) for f in frames])


class OnlineFeature(OnlineFeatureInterface):
    """OnlineGenericBaseFeature over the port's extractor of the options'
    type (MfccOptions, FbankOptions or PlpOptions), which runs on
    `device`."""

    def __init__(self, opts, device: DeviceLike = None):
        self.computer = OfflineFeature(opts, device=device)
        self.opts = opts
        self.fo = opts.frame_opts
        self.waveform: List[np.ndarray] = []
        self.num_samples = 0
        self.input_finished = False
        self._frames: List[np.ndarray] = []

    def dim(self) -> int:
        return self.computer.dim()

    def accept_waveform(self, samp_freq: float, wave: np.ndarray) -> None:
        if self.input_finished:
            raise RuntimeError("accept_waveform after input_finished")
        if abs(samp_freq - self.fo.samp_freq) > 0.01:
            raise ValueError(f"sample rate {samp_freq}, the features' "
                             f"{self.fo.samp_freq}")
        wave = np.asarray(wave, np.float32).reshape(-1)
        if wave.size:
            self.waveform.append(wave)
            self.num_samples += len(wave)
        self._compute_ready()

    def finish_input(self) -> None:
        self.input_finished = True
        self._compute_ready()

    def _compute_ready(self) -> None:
        total = win.num_frames(self.num_samples, self.fo,
                               flush=self.input_finished)
        have = len(self._frames)
        if total <= have:
            return
        wave = np.concatenate(self.waveform)
        feats, nframes = self.computer.compute_batch_device([wave])
        feats = feats[0, :int(nframes[0])].cpu().numpy()
        self._frames.extend(feats[have:total])

    def num_frames_ready(self) -> int:
        return len(self._frames)

    def is_last_frame(self, frame: int) -> bool:
        return (self.input_finished
                and frame == self.num_frames_ready() - 1)

    def get_frame(self, frame: int) -> np.ndarray:
        return self._frames[frame]


@dataclass
class OnlineCmvnOptions:
    cmn_window: int = field(default=600, metadata={"doc": "Number of frames of sliding context for cepstral mean normalization"})
    speaker_frames: int = field(default=600, metadata={"doc": "Number of frames of previous utterance(s) from this speaker to use in cepstral mean normalization"})
    global_frames: int = field(default=200, metadata={"doc": "Number of frames of global-average stats to use for cepstral mean normalization"})
    normalize_mean: bool = field(default=True, metadata={"doc": "If true, do mean normalization"})
    normalize_variance: bool = field(default=False, metadata={"doc": "If true, normalize variance to one"})


@dataclass
class OnlineCmvnState:
    """online-feature.h:266: carried between utterances of a speaker;
    each stats matrix is float64 (2, dim+1)."""
    speaker_cmvn_stats: Optional[np.ndarray] = None
    global_cmvn_stats: Optional[np.ndarray] = None
    frozen_state: Optional[np.ndarray] = None


class OnlineCmvn(OnlineFeatureInterface):
    """Sliding-window CMVN over the last cmn_window frames, topped up
    from the speaker's and then the global stats while the window is
    short (online-feature.cc)."""

    def __init__(self, opts: OnlineCmvnOptions, state: OnlineCmvnState,
                 src: OnlineFeatureInterface):
        self.opts = opts
        self.state = state
        self.src = src
        self._cumulative: List[np.ndarray] = []   # prefix sums (2, dim+1)

    def dim(self) -> int:
        return self.src.dim()

    def num_frames_ready(self) -> int:
        return self.src.num_frames_ready()

    def is_last_frame(self, frame: int) -> bool:
        return self.src.is_last_frame(frame)

    def _stats_up_to(self, t: int) -> np.ndarray:
        """The raw stats of frames [0, t]."""
        dim = self.dim()
        while len(self._cumulative) <= t:
            i = len(self._cumulative)
            x = self.src.get_frame(i).astype(np.float64)
            row = np.zeros((2, dim + 1))
            row[0, :dim] = x
            row[0, dim] = 1.0
            row[1, :dim] = x * x
            if i:
                row += self._cumulative[-1]
            self._cumulative.append(row)
        return self._cumulative[t]

    def _window_stats(self, t: int) -> np.ndarray:
        upto = self._stats_up_to(t)
        lo = t - self.opts.cmn_window
        return upto - self._stats_up_to(lo) if lo >= 0 else upto.copy()

    def get_frame(self, t: int) -> np.ndarray:
        opts, dim = self.opts, self.dim()
        x = np.asarray(self.src.get_frame(t), np.float32)
        if self.state.frozen_state is not None:
            stats = self.state.frozen_state
        else:
            stats = self._window_stats(t)
            for prior, frames in ((self.state.speaker_cmvn_stats,
                                   opts.speaker_frames),
                                  (self.state.global_cmvn_stats,
                                   opts.global_frames)):
                count = stats[0, dim]
                if (count < opts.cmn_window and prior is not None
                        and prior[0, dim] > 0):
                    take = min(frames, opts.cmn_window - count)
                    stats = stats + prior * (take / prior[0, dim])
        if not opts.normalize_mean:
            return x
        return apply_cmvn(x[None, :], stats,
                          norm_vars=opts.normalize_variance)[0]

    def freeze(self, t: int) -> None:
        """Freeze the normalization at frame t (where i-vectors take over
        the adaptation)."""
        self.state.frozen_state = self._window_stats(t)

    def get_state(self, t: int) -> OnlineCmvnState:
        """The state to carry to the next utterance of this speaker."""
        new = OnlineCmvnState(global_cmvn_stats=self.state.global_cmvn_stats)
        tot = self.state.speaker_cmvn_stats
        if t >= 0:
            utt = self._stats_up_to(t)
            tot = utt if tot is None else tot + utt
        new.speaker_cmvn_stats = tot
        return new


class _ContextFeature(OnlineFeatureInterface):
    """A stage that reads `context` frames to the right of each frame: a
    frame is ready once they have arrived, or at the end of the input
    (edge frames replicated)."""

    context = 0

    def num_frames_ready(self) -> int:
        n = self.src.num_frames_ready()
        if n == 0:
            return 0
        if self.src.is_last_frame(n - 1):
            return n
        return max(0, n - self.context)

    def is_last_frame(self, frame: int) -> bool:
        return (self.src.is_last_frame(self.src.num_frames_ready() - 1)
                and frame == self.num_frames_ready() - 1)

    def _src_frame(self, t: int) -> np.ndarray:
        n = self.src.num_frames_ready()
        return self.src.get_frame(min(max(t, 0), n - 1))


class OnlineSpliceFrames(_ContextFeature):
    def __init__(self, left_context: int, right_context: int,
                 src: OnlineFeatureInterface):
        self.left = left_context
        self.right = self.context = right_context
        self.src = src

    def dim(self) -> int:
        return self.src.dim() * (self.left + self.right + 1)

    def get_frame(self, t: int) -> np.ndarray:
        return np.concatenate([self._src_frame(t + off) for off in
                               range(-self.left, self.right + 1)])


class OnlineDeltaFeature(_ContextFeature):
    def __init__(self, opts: DeltaFeaturesOptions,
                 src: OnlineFeatureInterface):
        self.opts = opts
        self.src = src
        self.scales = delta_scales(opts)
        self.context = (len(self.scales[-1]) - 1) // 2

    def dim(self) -> int:
        return self.src.dim() * (self.opts.order + 1)

    def get_frame(self, t: int) -> np.ndarray:
        out = []
        for scales in self.scales:
            mo = (len(scales) - 1) // 2
            acc = None
            for j in range(-mo, mo + 1):
                s = scales[j + mo]
                if s == 0.0:
                    continue
                v = s * self._src_frame(t + j)
                acc = v if acc is None else acc + v
            out.append(acc)
        return np.concatenate(out)


class OnlineTransform(OnlineFeatureInterface):
    """A linear or affine transform (LDA+MLLT, fMLLR) of a stream
    (online-feature.h OnlineTransform); an affine matrix has the offset
    as its last column."""

    def __init__(self, mat: np.ndarray, src: OnlineFeatureInterface):
        mat = np.asarray(mat, np.float32)
        self.src = src
        if mat.shape[1] == src.dim() + 1:
            self.linear, self.offset = mat[:, :-1], mat[:, -1]
        else:
            self.linear = mat
            self.offset = np.zeros(mat.shape[0], np.float32)

    def dim(self) -> int:
        return self.linear.shape[0]

    def num_frames_ready(self) -> int:
        return self.src.num_frames_ready()

    def is_last_frame(self, frame: int) -> bool:
        return self.src.is_last_frame(frame)

    def get_frame(self, t: int) -> np.ndarray:
        return self.linear @ self.src.get_frame(t) + self.offset


class OnlineAppendFeature(OnlineFeatureInterface):
    def __init__(self, src1: OnlineFeatureInterface,
                 src2: OnlineFeatureInterface):
        self.src1, self.src2 = src1, src2

    def dim(self) -> int:
        return self.src1.dim() + self.src2.dim()

    def num_frames_ready(self) -> int:
        return min(self.src1.num_frames_ready(),
                   self.src2.num_frames_ready())

    def is_last_frame(self, frame: int) -> bool:
        return self.src1.is_last_frame(frame) or \
            self.src2.is_last_frame(frame)

    def get_frame(self, t: int) -> np.ndarray:
        return np.concatenate([self.src1.get_frame(t),
                               self.src2.get_frame(t)])


class OnlineFeaturePipeline:
    """The online2 feature pipeline: a base feature, and optionally the
    stages above it (CMVN, splicing or deltas, a transform, i-vectors
    through OnlineAppendFeature) built by the caller; this object moves
    the audio in and the frames out."""

    def __init__(self, base: OnlineFeature,
                 output: Optional[OnlineFeatureInterface] = None):
        self.base = base
        self.output = output or base

    def accept_waveform(self, samp_freq: float, wave: np.ndarray) -> None:
        self.base.accept_waveform(samp_freq, wave)

    def input_finished(self) -> None:
        self.base.finish_input()

    @property
    def finished(self) -> bool:
        return self.base.input_finished

    def dim(self) -> int:
        return self.output.dim()

    def num_frames_ready(self) -> int:
        return self.output.num_frames_ready()

    def get_frames(self, lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.zeros((0, self.dim()), np.float32)
        return np.stack([self.output.get_frame(t) for t in range(lo, hi)])


class OnlinePitchFeature(OnlineFeatureInterface):
    """Latency-controlled online pitch (parity: feat/pitch-functions.cc
    OnlinePitchFeature + online-feature.cc OnlineProcessPitch): the
    processed (pov-feature, normalized log pitch, delta pitch) stream.

    The Viterbi lag decisions of recent frames can change as more audio
    arrives, so frames within `max_frames_latency` plus the
    normalization right context of the newest frame are provisional:
    every accept_waveform() recomputes the whole received waveform
    (`compute_and_process_kaldi_pitch`) and replaces them, and a frame
    becomes final when it falls further behind, or at input_finished().
    Finalized frames never change, but need not equal the offline
    output: the latency window cuts the Viterbi backtrace and the
    normalization short, voiced frames too (tools/features_jax_bar.py
    counts them).  With max_frames_latency at least the stream's length
    the output equals the offline output bit for bit.
    """

    def __init__(self, pitch_opts: Optional[PitchExtractionOptions] = None,
                 process_opts: Optional[ProcessPitchOptions] = None,
                 max_frames_latency: int = 30):
        self.pitch_opts = pitch_opts or PitchExtractionOptions()
        self.process_opts = process_opts or ProcessPitchOptions()
        self.max_frames_latency = max_frames_latency
        self.waveform: List[np.ndarray] = []
        self.num_samples = 0
        self.finished = False
        self._feats = np.zeros((0, 3), np.float32)
        self._num_final = 0

    def dim(self) -> int:
        return self._feats.shape[1] if self._feats.size else 3

    def accept_waveform(self, samp_freq: float,
                        waveform: np.ndarray) -> None:
        if self.finished:
            raise RuntimeError("accept_waveform after input_finished")
        if abs(samp_freq - self.pitch_opts.samp_freq) > 1e-3:
            raise ValueError(f"sample rate {samp_freq}, the pitch "
                             f"options' {self.pitch_opts.samp_freq}")
        self.waveform.append(np.asarray(waveform, np.float32))
        self.num_samples += len(waveform)
        self._recompute()

    def input_finished(self) -> None:
        self.finished = True
        self._recompute()
        self._num_final = self._feats.shape[0]

    @property
    def num_frames_final(self) -> int:
        return self._num_final

    def _recompute(self) -> None:
        wave = (np.concatenate(self.waveform) if self.waveform
                else np.zeros(0, np.float32))
        if len(wave) < int(0.025 * self.pitch_opts.samp_freq):
            return
        feats = compute_and_process_kaldi_pitch(wave, self.pitch_opts,
                                                self.process_opts)
        if self._num_final:
            feats = np.concatenate([self._feats[:self._num_final],
                                    feats[self._num_final:]])
        self._feats = feats
        if not self.finished:
            # a frame is final only when the rightmost frame of its
            # normalization window is itself past the revision window:
            # the two lags add
            lag = (self.max_frames_latency
                   + self.process_opts.normalization_right_context)
            self._num_final = max(self._num_final, feats.shape[0] - lag)

    def num_frames_ready(self) -> int:
        return self._feats.shape[0]

    def is_last_frame(self, frame: int) -> bool:
        return self.finished and frame == self._feats.shape[0] - 1

    def get_frame(self, frame: int) -> np.ndarray:
        return self._feats[frame]

    def get_frames(self, frames) -> np.ndarray:
        return self._feats[np.asarray(frames)]
