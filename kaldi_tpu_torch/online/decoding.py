"""Online decoding on the host and its endpoint rules (port of
`kaldi_tpu/online/decoding.py`; the reference's
online2/online-nnet3-decoding.h:52 SingleUtteranceNnet3Decoder and
online2/online-endpoint.h:84,123,175).

OnlineFasterDecoder is the host FasterDecoder advanced a chunk of
acoustic scores at a time, with the best path so far after any chunk.
SingleUtteranceDecoder ties a feature pipeline, an acoustic scorer and
that decoder together.  The scorer is either a function of a chunk of
features (the reference's form: each chunk scored alone), or a
streaming scorer with accept_features / finish, such as
nnet3/streaming.py's OnlineNnetScorer, whose outputs are the offline
forward's.

An utterance has ended when any of five rules holds.  A rule looks at
the utterance's length, the trailing silence on the best path, the best
final cost relative to the best cost overall, and whether the best path
has left silence yet.  Times are in seconds.  `silence_phones` names
the silence of `endpoint_detected`; the batched pipelines tell silence
from their graph's silence states and do not read it.

Not carried over yet: the GMM online decoders
(`SingleUtteranceGmmDecoder` and its adaptation state and policy).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.viterbi import (INF, FasterDecoder,
                                             FasterDecoderOptions, _Token)
from kaldi_tpu_torch.fstext.fst import EPS, TropicalWeight, VectorFst

_log = logging.getLogger(__name__)


class OnlineFasterDecoder:
    """The beam Viterbi decoder of decoder/viterbi.py, advanced a chunk
    at a time: init_decoding / advance_decoding(chunk) / best_path."""

    def __init__(self, fst: VectorFst,
                 opts: Optional[FasterDecoderOptions] = None):
        self.fst = fst
        self.opts = opts or FasterDecoderOptions()
        self.init_decoding()

    def init_decoding(self) -> None:
        self._helper = FasterDecoder(self.fst, self.opts)
        self._emitting, self._emitting_of = None, None
        self.cur: Dict[int, _Token] = self._helper._process_nonemitting(
            {self.fst.start: _Token(0.0, None, 0, 0)}, self.opts.beam)
        self.num_frames_decoded = 0

    def advance_decoding(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray,
                         acoustic_scale: float = 1.0,
                         word_ins_penalty: float = 0.0) -> None:
        if tid_to_pdf is not self._emitting_of:
            self._emitting = self._helper.emitting_arcs(tid_to_pdf)
            self._emitting_of = tid_to_pdf
        for t in range(loglikes.shape[0]):
            nxt = self._helper._process_emitting(
                self.cur, self._emitting, loglikes[t], acoustic_scale,
                word_ins_penalty)
            if not nxt:
                _log.warning("online decode: no tokens survived; keeping "
                             "the state")
                return
            self.cur = self._helper._process_nonemitting(nxt,
                                                         self.opts.beam)
            self.num_frames_decoded += 1

    def best_path(self, use_final_probs: bool = True
                  ) -> Optional[Tuple[List[int], List[int], float]]:
        """(transition-ids, words, cost) of the best token, through a
        final state where one is active and use_final_probs is set."""
        best_tok, best_cost = None, INF
        if use_final_probs:
            for state, tok in self.cur.items():
                fw = self.fst.finals[state]
                if fw != TropicalWeight.zero and tok.cost + fw < best_cost:
                    best_cost, best_tok = tok.cost + fw, tok
        if best_tok is None:
            for tok in self.cur.values():
                if tok.cost < best_cost:
                    best_cost, best_tok = tok.cost, tok
        if best_tok is None:
            return None
        ali, words = [], []
        tok = best_tok
        while tok is not None:
            if tok.arc_ilabel != EPS:
                ali.append(tok.arc_ilabel)
            if tok.arc_olabel != EPS:
                words.append(tok.arc_olabel)
            tok = tok.prev
        ali.reverse()
        words.reverse()
        return ali, words, best_cost

    def final_relative_cost(self) -> float:
        """The best final cost less the best cost overall
        (lattice-faster-online-decoder FinalRelativeCost)."""
        best = min((t.cost for t in self.cur.values()), default=INF)
        best_final = min((t.cost + self.fst.finals[s]
                          for s, t in self.cur.items()
                          if self.fst.finals[s] != TropicalWeight.zero),
                         default=INF)
        return best_final - best


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
    silence_phones: Sequence[int] = field(default_factory=list)
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


def trailing_silence_frames(tm, alignment: Sequence[int],
                            silence_phones: Sequence[int]) -> int:
    sil = set(silence_phones)
    n = 0
    for tid in reversed(alignment):
        if tm.transition_id_to_phone(tid) not in sil:
            break
        n += 1
    return n


def endpoint_detected(config: OnlineEndpointConfig, tm,
                      decoder: OnlineFasterDecoder,
                      frame_shift_seconds: float,
                      tid_alignment: Optional[Sequence[int]] = None) -> bool:
    """EndpointDetected (online-endpoint.h:175): frames are the
    decoder's, each frame_shift_seconds long."""
    if decoder.num_frames_decoded == 0:
        return False
    if tid_alignment is None:
        res = decoder.best_path(use_final_probs=False)
        if res is None:
            return False
        tid_alignment = res[0]
    trailing = trailing_silence_frames(tm, tid_alignment,
                                       config.silence_phones)
    trailing_s = trailing * frame_shift_seconds
    utt_s = decoder.num_frames_decoded * frame_shift_seconds
    contains_nonsil = trailing < len(tid_alignment)
    relative_cost = decoder.final_relative_cost()
    return any(r.active(utt_s, trailing_s, relative_cost, contains_nonsil)
               for r in config.rules())


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SingleUtteranceDecoder:
    """online2's SingleUtteranceNnet3Decoder: a feature pipeline, an
    acoustic scorer and the online decoder.

    `scorer` is a function of a chunk of features (T, D) -> loglikes
    (T', P), or a streaming scorer (accept_features(feats) and finish(),
    each returning the output frames it makes ready), which is told the
    input has ended once the pipeline has.  Loglikes may come as a
    tensor on any device; they are read to the host once a chunk.
    `scorer_s`, `search_s`, `chunks` and `frames` accumulate the host
    seconds of scoring and of search."""

    def __init__(self, hclg: VectorFst, tm, scorer, pipeline,
                 acoustic_scale: float = 0.1,
                 opts: Optional[FasterDecoderOptions] = None,
                 word_ins_penalty: float = 0.0):
        self.decoder = OnlineFasterDecoder(hclg, opts)
        self.tm = tm
        self.scorer = scorer
        self.pipeline = pipeline
        self.acoustic_scale = acoustic_scale
        self.word_ins_penalty = word_ins_penalty
        self._frames_consumed = 0
        self._streaming = hasattr(scorer, "accept_features")
        self.scorer_s = self.search_s = 0.0
        self.chunks = self.frames = 0

    def advance_decoding(self) -> None:
        ready = self.pipeline.num_frames_ready()
        end = (self._streaming and getattr(self.pipeline, "finished", False)
               and not self.scorer.finished)
        if ready <= self._frames_consumed and not end:
            return
        t0 = time.perf_counter()
        feats = self.pipeline.get_frames(self._frames_consumed, ready)
        self._frames_consumed = max(ready, self._frames_consumed)
        if not self._streaming:
            loglikes = _host(self.scorer(feats))
        else:
            parts = [_host(self.scorer.accept_features(feats))] \
                if feats.shape[0] else []
            if end:
                parts.append(_host(self.scorer.finish()))
            parts = [p for p in parts if p.shape[0]]
            loglikes = (np.concatenate(parts) if parts
                        else np.zeros((0, 0), np.float32))
        t1 = time.perf_counter()
        self.decoder.advance_decoding(loglikes, self.tm.id2pdf_id,
                                      self.acoustic_scale,
                                      self.word_ins_penalty)
        self.scorer_s += t1 - t0
        self.search_s += time.perf_counter() - t1
        self.chunks += 1
        self.frames += loglikes.shape[0]

    def finalize_decoding(self):
        return self.decoder.best_path(use_final_probs=True)

    def endpoint_detected(self, config: OnlineEndpointConfig,
                          frame_shift: float = 0.01) -> bool:
        return endpoint_detected(config, self.tm, self.decoder, frame_shift)
