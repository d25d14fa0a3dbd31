"""Streaming acoustic scoring (port of `kaldi_tpu/nnet3/streaming.py`;
the reference's looped computations, nnet-compile-looped.h and
decodable-online-looped.h:135 AdvanceChunk).

The models are pure functions of a bounded input window, so streaming is
a rolling window of input frames, [left context | chunk | lookahead]:
each advance runs the forward on the window and emits the outputs whose
lookahead has arrived.  Where the contexts cover the model's receptive
field the outputs are the offline forward's, frame for frame.  The
window stays on the forward's device: new frames are copied there once,
and the frames no later window reads are dropped.

Two rules differ from the reference's, each where it is at fault:
  - the left context is rounded up to a multiple of the subsampling
    factor, so that a window starts on the output frame grid (the
    reference's window starts off the grid when it is not a multiple,
    and its outputs then belong to other input frames);
  - at the end of the input every output frame is emitted,
    ceil(T / subsample) of them, as the offline forward and upstream's
    decodable give (the reference emits floor(T / subsample) and drops
    the last frame when T is not a multiple).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, resolve_device


class OnlineNnetScorer:
    """Chunked streaming over forward((1, T, D) tensor) -> (1, T', P)
    tensor, whose output frame j is input frame j * subsample of its
    window.  Outputs are emitted once right_context frames of lookahead
    have arrived, and all of them at finish()."""

    def __init__(self, forward: Callable, left_context: int = 20,
                 right_context: int = 20, subsample: int = 1,
                 device: DeviceLike = None):
        self.forward = forward
        self.sub = subsample
        self.left = -(-left_context // subsample) * subsample
        self.right = right_context
        self.device = resolve_device(device)
        self._buf = torch.zeros((0, 0), device=self.device)
        self._base = 0          # input frame of the window's first row
        self._total = 0         # input frames received
        self._emitted = 0       # output frames emitted
        self.finished = False

    def accept_features(self, feats) -> torch.Tensor:
        """Add (T, D) input frames; -> the output frames now ready."""
        x = torch.as_tensor(np.asarray(feats, np.float32)
                            if not isinstance(feats, torch.Tensor)
                            else feats).to(self.device, torch.float32)
        self._buf = x if self._buf.numel() == 0 else torch.cat([self._buf,
                                                                x])
        self._total += x.shape[0]
        return self._advance()

    def finish(self) -> torch.Tensor:
        self.finished = True
        return self._advance()

    def _advance(self) -> torch.Tensor:
        T, sub = self._total, self.sub
        if self.finished:
            ready_out = -(-T // sub)
        else:
            ready_out = max(0, T - self.right) // sub
        if ready_out <= self._emitted:
            return torch.zeros((0, 0), device=self.device)
        emit_start = self._emitted * sub
        lo = max(0, emit_start - self.left)
        out = self.forward(self._buf[lo - self._base:T - self._base][None])[0]
        start_j = (emit_start - lo) // sub
        result = out[start_j:min(start_j + ready_out - self._emitted,
                                 out.shape[0])]
        self._emitted += result.shape[0]
        keep = max(0, self._emitted * sub - self.left)
        if keep > self._base:
            self._buf = self._buf[keep - self._base:]
            self._base = keep
        return result
