"""Streaming feature extraction (port of `OnlineFeatureInterface` and
`OnlineFeature` of `kaldi_tpu/online/features.py`; the reference's
feat/online-feature.h OnlineGenericBaseFeature).

Audio arrives in pieces.  accept_waveform buffers the samples and
computes the newly complete frames with the batched offline extractor
over the whole received prefix: with snip_edges=True a frame depends
only on its own samples, so every complete frame is final and the
recomputation equals streaming emission.  Frames are kept on the host.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.feat import window as win
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature


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
    """OnlineGenericBaseFeature over the port's MFCC extractor, which
    runs on `device`."""

    def __init__(self, opts: MfccOptions, device: DeviceLike = None):
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
