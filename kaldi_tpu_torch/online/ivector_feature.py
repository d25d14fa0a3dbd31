"""Online i-vector features (port of `OnlineIvectorExtractionOptions`,
`OnlineIvectorAdaptationState`, `OnlineIvectorFeature` and
`OnlineSilenceWeighting` of `kaldi_tpu/online/ivector_feature.py`;
parity: online2/online-ivector-feature.h OnlineIvectorFeature:256 +
OnlineIvectorExtractorAdaptationState:211 + OnlineSilenceWeighting:465).
Float64 over `ivector.extractor.OnlineIvectorEstimationStats` on a
device, one utterance at a time; the batched pipelines carry the main
path's float32 state on the card (`ivector.batched.BatchedIvectorExtractor`).

Appends a slowly-updating utterance i-vector to each frame; stats carry
across utterances of a speaker via the adaptation state, and decoder
traceback feedback can down-weight silence frames before they enter
the i-vector stats."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               OnlineIvectorEstimationStats)
from kaldi_tpu_torch.online.features import OnlineFeatureInterface


@dataclass
class OnlineIvectorExtractionOptions:
    ivector_period: int = field(default=10, metadata={"doc": "Controls how frequently we recompute the i-vector"})
    max_count: float = field(default=0.0, metadata={"doc": "If nonzero, count by which we soft-limit the stats"})
    use_most_recent_ivector: bool = True
    silence_weight: float = field(default=0.0, metadata={"doc": "Weight applied to silence frames flagged by the decoder feedback"})


@dataclass
class OnlineIvectorAdaptationState:
    stats: Optional[OnlineIvectorEstimationStats] = None


class OnlineIvectorFeature(OnlineFeatureInterface):
    def __init__(self, extractor: IvectorExtractor,
                 src: OnlineFeatureInterface,
                 opts: Optional[OnlineIvectorExtractionOptions] = None,
                 adaptation_state: Optional[OnlineIvectorAdaptationState] = None,
                 device: DeviceLike = None):
        """The stats run on `device` (the card unless the caller names the
        CPU); an adaptation state's stats stay on their own."""
        self.ex = extractor
        self.src = src
        self.opts = opts or OnlineIvectorExtractionOptions()
        if adaptation_state is not None and adaptation_state.stats is not None:
            self.stats = adaptation_state.stats
        else:
            self.stats = OnlineIvectorEstimationStats(
                extractor, max_count=self.opts.max_count, device=device)
        self._frames_consumed = 0
        self._current_ivector = self.stats.ivector()
        self._frame_weights: Dict[int, float] = {}

    def dim(self) -> int:
        return self.ex.R

    def num_frames_ready(self) -> int:
        return self.src.num_frames_ready()

    def is_last_frame(self, frame):
        return self.src.is_last_frame(frame)

    def update_frame_weights(self, deltas: Sequence[Tuple[int, float]]):
        """OnlineSilenceWeighting feedback: (frame, weight-delta) pairs
        from decoder traceback — applied to frames not yet consumed."""
        for frame, w in deltas:
            self._frame_weights[frame] = self._frame_weights.get(frame, 1.0) \
                + w

    def _consume_up_to(self, t: int) -> None:
        hi = min(t + 1, self.src.num_frames_ready())
        if hi <= self._frames_consumed:
            return
        frames = np.stack([self.src.get_frame(i)
                           for i in range(self._frames_consumed, hi)])
        weights = np.array([self._frame_weights.get(i, 1.0)
                            for i in range(self._frames_consumed, hi)])
        self.stats.acc_frames(frames, weights)
        self._frames_consumed = hi
        self._current_ivector = self.stats.ivector()

    def get_frame(self, t: int) -> np.ndarray:
        # recompute at ivector_period boundaries (or every frame when
        # use_most_recent_ivector, matching the reference's online mode)
        if self.opts.use_most_recent_ivector:
            self._consume_up_to(t)
        else:
            period_end = (t // self.opts.ivector_period) \
                * self.opts.ivector_period
            self._consume_up_to(period_end)
        iv = self._current_ivector.copy()
        iv[0] -= self.ex.prior_offset
        return iv.astype(np.float32)

    def get_adaptation_state(self) -> OnlineIvectorAdaptationState:
        st = self.stats.copy()
        st.max_count = self.opts.max_count
        return OnlineIvectorAdaptationState(st)


class OnlineSilenceWeighting:
    """Derives frame-weight deltas from decoder traceback
    (online-ivector-feature.h:465): silence-phone frames get
    silence_weight."""

    def __init__(self, tm, silence_phones: Sequence[int],
                 silence_weight: float = 0.0):
        self.tm = tm
        self.silence = set(silence_phones)
        self.silence_weight = silence_weight
        self._applied = 0

    def compute_from_traceback(self, alignment: Sequence[int]
                               ) -> List[Tuple[int, float]]:
        deltas = []
        for t in range(self._applied, len(alignment)):
            phone = self.tm.transition_id_to_phone(alignment[t])
            if phone in self.silence:
                deltas.append((t, self.silence_weight - 1.0))
        self._applied = len(alignment)
        return deltas
