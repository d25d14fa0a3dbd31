"""Endpoint rules of online decoding (port of the endpointing part of
`kaldi_tpu/online/decoding.py`; the reference's online2/online-endpoint.h).

An utterance has ended when any of five rules holds.  A rule looks at
the utterance's length, the trailing silence on the best path, the best
final cost relative to the best cost overall, and whether the best path
has left silence yet.  Times are in seconds.  The batched pipelines
tell silence from their graph's silence states, so the config names no
silence phones."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class EndpointRule:
    must_contain_nonsilence: bool = True
    min_trailing_silence: float = 1.0   # seconds
    max_relative_cost: float = float("inf")
    min_utterance_length: float = 0.0

    def active(self, utt_len: float, trailing_sil: float,
               relative_cost: float, contains_nonsilence: bool) -> bool:
        return ((contains_nonsilence or not self.must_contain_nonsilence)
                and trailing_sil >= self.min_trailing_silence
                and relative_cost <= self.max_relative_cost
                and utt_len >= self.min_utterance_length)


@dataclass
class OnlineEndpointConfig:
    """The reference's five default rules (online-endpoint.h:84)."""
    rule1: EndpointRule = field(default_factory=lambda: EndpointRule(
        False, 5.0, float("inf"), 0.0))
    rule2: EndpointRule = field(default_factory=lambda: EndpointRule(
        True, 0.5, 2.0, 0.0))
    rule3: EndpointRule = field(default_factory=lambda: EndpointRule(
        True, 1.0, 8.0, 0.0))
    rule4: EndpointRule = field(default_factory=lambda: EndpointRule(
        True, 2.0, float("inf"), 0.0))
    rule5: EndpointRule = field(default_factory=lambda: EndpointRule(
        False, 0.0, float("inf"), 20.0))

    def rules(self) -> List[EndpointRule]:
        return [self.rule1, self.rule2, self.rule3, self.rule4, self.rule5]
