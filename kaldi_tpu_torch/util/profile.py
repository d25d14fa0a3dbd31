"""Real-time-factor reporting of streaming decoding (the `OnlineTimer` of
`kaldi_tpu/util/profile.py`; the reference's online2/online-timing.h).

Not carried over yet: `Timer`, the accumulate-by-name `profile` report
and `TaskSequencer`.
"""

from __future__ import annotations

import time


class OnlineTimer:
    """Wall time against audio time, for one utterance."""

    def __init__(self, utterance_id: str = ""):
        self.utt = utterance_id
        self._start = time.perf_counter()
        self.audio_seconds = 0.0

    def wait_until(self, audio_seconds: float) -> None:
        """Simulate real-time arrival: sleep while ahead of real time."""
        self.audio_seconds = audio_seconds
        elapsed = time.perf_counter() - self._start
        if elapsed < audio_seconds:
            time.sleep(audio_seconds - elapsed)

    def compute_now(self, audio_seconds: float) -> None:
        self.audio_seconds = audio_seconds

    def real_time_factor(self) -> float:
        elapsed = time.perf_counter() - self._start
        return elapsed / max(self.audio_seconds, 1e-9)
