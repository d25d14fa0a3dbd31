"""Batched multi-stream online decoding with the search on the device
(port of `kaldi_tpu/online/batched_device_pipeline.py`:
`BatchedDeviceOnlinePipeline`, `BatchedDeviceOnlinePipelineLex`,
`BatchedDeviceOnlinePipelineNg` and `OnlineDynamicBatcher`; the
reference's cudadecoder/batched-threaded-nnet3-cuda-online-pipeline.h).

B lanes are the batch dimension of one resident carry of a decoder's
frame loop: the block-chain decoder's (cost (Up, N, B), roots (Up, B)),
whose frame step is the CUDA kernel `block_chain_step` on the card, or
the LexChain decoder's (rows (N, B), variant roots and silence shadows
(P+1, B)) or the n-gram decoder's (rows (Nr, B), unit roots and shadows
(U+1, B)), PyTorch ops.  compute() gathers every channel's pending frames,
right-pads them to one chunk of Tc frames, scores the chunk in one call
and runs the decoder's frame loop over it for all lanes from the carry;
a lane without new frames is frozen by the chunk's per-frame `act` mask.
The chunk's decisions stay on the device.  A partial or final result
runs the decoder's follow pass over all of them (concatenated on the
card once and kept) and ships only the (T, B) state trajectory to the
host.

Memory: the block-chain decisions take Up * N/8 * B bytes a frame (36
MB at V=700 and 128 lanes), the LexChain dumps N/8 * B bytes plus an
int32 source root a word and lane (V * B * 4), the n-gram dumps
Nr/8 * B bytes plus the pools.  The history is bounded by `max_frames`; `free_channel` drops the
frames before the earliest active utterance's start.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.block_chain import INF, BlockChainDecoder
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexDecoder
from kaldi_tpu_torch.online.decoding import OnlineEndpointConfig
from kaldi_tpu_torch.online.features import OnlineFeature

Hyp = Optional[Tuple[List[int], List[int], float]]
Dumps = Dict[str, torch.Tensor]


@dataclass
class _Channel:
    utterance_id: str
    feature: Optional[OnlineFeature] = None
    pending: List[np.ndarray] = field(default_factory=list)
    frames_consumed: int = 0       # feature frames pulled so far
    start_frame: int = 0           # global frame at utterance start
    end_frame: int = 0             # global frame past the last decoded
    finished: bool = False
    # endpointing trackers, at chunk granularity (the reference evaluates
    # EndpointDetected once per AdvanceDecoding chunk)
    trailing_sil: int = 0          # decoded frames best path in silence
    nonsil_seen: bool = False


class BatchedDeviceOnlinePipeline:
    """Decode many streams concurrently over a BlockChainDecoder.

    scorer: callable (feats (B, Tc, feat_dim) numpy) -> loglikes (B, Tc,
    P), a tensor (left on its device when that is the decoder's) or an
    array; any acoustic-model context or state lives in the scorer.
    feature_opts: MfccOptions of the channels' OnlineFeature when audio
    is fed with accept_waveform (None: features are fed directly)."""

    def __init__(self, decoder: BlockChainDecoder, scorer: Callable,
                 feat_dim: int, num_lanes: int = 8,
                 chunk_frames: int = 16, acoustic_scale: float = 1.0,
                 feature_opts=None, max_frames: int = 2048,
                 endpointing: bool = False):
        self.decoder = decoder
        self.device = decoder.device
        self.scorer = scorer
        self.feat_dim = feat_dim
        self.B = num_lanes
        self.Tc = chunk_frames
        self.acoustic_scale = acoustic_scale
        self.feature_opts = feature_opts
        self.max_frames = max_frames
        self.endpointing = endpointing
        self.channels: List[Optional[_Channel]] = [None] * num_lanes
        self._ys: List[Dumps] = []      # per-chunk decisions (device)
        self._acts: List[np.ndarray] = []
        self._total_frames = 0
        self._generation = 0            # bumps on every state change
        self._tb_cache: Tuple[int, Optional[List[Hyp]]] = (-1, None)
        self._last_rel_cost: Optional[np.ndarray] = None
        with torch.inference_mode():
            self._init_device()

    # -- decoder-specific hooks (overridden by the LexChain variants) ----
    def _init_device(self) -> None:
        dec = self.decoder
        self._cost = torch.full((dec.Up, dec.g.N, self.B), INF,
                                dtype=torch.float32, device=self.device)
        self._ovr = torch.full((dec.Up, self.B), INF, dtype=torch.float32,
                               device=self.device)

    def _reset_lane(self, lane: int) -> None:
        self._cost[:, :, lane] = INF
        self._ovr[:, lane] = INF
        self._ovr[self.decoder.g.V, lane] = 0.0         # begin root

    def _advance(self, am: torch.Tensor, act: torch.Tensor) -> Dumps:
        """One chunk from the carry -> the chunk's decisions."""
        (self._cost, self._ovr), (bits, args, selfs) = \
            self.decoder._forward(am, act, carry=(self._cost, self._ovr))
        return {"bits": bits, "args": args, "selfs": selfs}

    def _follow(self, ys: Dumps, act: torch.Tensor,
                final_state: torch.Tensor) -> torch.Tensor:
        return self.decoder._follow(ys["bits"], ys["args"], ys["selfs"],
                                    act, final_state)[1]

    def _final_costs(self) -> Tuple[np.ndarray, torch.Tensor]:
        """-> (best final cost (B,) numpy, final state (B,) device)."""
        dec = self.decoder
        g = dec.g
        total = self._ovr[:g.V] + dec._eos[:g.V, None]
        best_w = torch.argmin(total, dim=0)
        return (torch.amin(total, dim=0).cpu().numpy(),
                g.U * g.N + best_w)

    def _current_best(self) -> np.ndarray:
        # the reference's base class defines this twice, and the second
        # definition (raise NotImplementedError) wins, so its block-chain
        # pipeline fails in compute() with endpointing=True; the port
        # keeps the first, meant one
        return torch.minimum(self._cost.amin(dim=(0, 1)),
                             self._ovr.amin(dim=0)).cpu().numpy()

    def _best_in_silence(self) -> np.ndarray:
        """Whether each lane's best state is a silence state (False for
        graphs without silence modelling)."""
        return np.zeros(self.B, bool)

    def _decode_traj(self, traj: np.ndarray) -> Tuple[List[int],
                                                     List[int]]:
        """A lane's states after each of its frames -> (words, tids);
        the path starts at the begin root."""
        g = self.decoder.g
        U, V, N = g.U, g.V, g.N
        root0 = U * N
        cur = np.asarray(traj, np.int64)
        prev = np.concatenate([[root0 + V], cur])[:-1]
        held = prev == cur
        at_root = cur >= root0
        w = np.clip(cur - root0, 0, V - 1)
        n = cur % N
        pdf = np.where(
            at_root,
            np.where(held, g.pdf_root_self[w], g.pdf_wend_fwd[w]),
            np.where(held, g.pdf_self_row[n], g.pdf_fwd_row[n]))
        tids = pdf.astype(np.int64) + 1 + np.where(held, g.num_pdfs, 0)
        return (w[at_root & ~held] + 1).tolist(), tids.tolist()

    # -- channel management ---------------------------------------------
    def init_channel(self, lane: int, utterance_id: str) -> None:
        """Bind `lane` to a new utterance: its carry restarts at the
        begin state."""
        ch = _Channel(utterance_id)
        if self.feature_opts is not None:
            ch.feature = OnlineFeature(self.feature_opts, device=self.device)
        ch.start_frame = ch.end_frame = self._total_frames
        self.channels[lane] = ch
        self._generation += 1
        with torch.inference_mode():
            self._reset_lane(lane)

    def free_channel(self, lane: int) -> None:
        self.channels[lane] = None
        self._maybe_trim()
        self._trim_committed()

    def _open_channel(self, lane: int) -> _Channel:
        ch = self.channels[lane]
        if ch is None or ch.finished:
            raise RuntimeError(f"lane {lane} has no utterance taking input")
        return ch

    def accept_waveform(self, lane: int, samp_freq: float,
                        samples: np.ndarray) -> None:
        ch = self._open_channel(lane)
        if ch.feature is None:
            raise RuntimeError("accept_waveform needs feature_opts")
        ch.feature.accept_waveform(samp_freq, samples)

    def accept_features(self, lane: int, feats: np.ndarray) -> None:
        """Direct feature input, (n, feat_dim)."""
        ch = self._open_channel(lane)
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.feat_dim:
            raise ValueError(f"features {feats.shape}, expected (n, "
                             f"{self.feat_dim})")
        ch.pending.append(feats)

    def input_finished(self, lane: int) -> None:
        ch = self.channels[lane]
        if ch is None:
            raise RuntimeError(f"lane {lane} has no utterance")
        if ch.feature is not None:
            ch.feature.finish_input()
        ch.finished = True

    # -- the batched device step ----------------------------------------
    def _pull_frames(self, ch: _Channel, limit: int) -> np.ndarray:
        if ch.feature is not None:
            n = min(ch.feature.num_frames_ready() - ch.frames_consumed,
                    limit)
            if n <= 0:
                return np.zeros((0, self.feat_dim), np.float32)
            out = ch.feature.get_frames(range(ch.frames_consumed,
                                              ch.frames_consumed + n))
            ch.frames_consumed += n
            return out
        out: List[np.ndarray] = []
        need = limit
        while ch.pending and need > 0:
            f = ch.pending[0]
            if len(f) <= need:
                out.append(f)
                need -= len(f)
                ch.pending.pop(0)
            else:
                out.append(f[:need])
                ch.pending[0] = f[need:]
                need = 0
        if not out:
            return np.zeros((0, self.feat_dim), np.float32)
        return np.concatenate(out, 0)

    def compute(self) -> int:
        """One chunk for every lane with pending frames.  Returns the
        number of lanes advanced."""
        B, Tc = self.B, self.Tc
        feats = np.zeros((B, Tc, self.feat_dim), np.float32)
        n_new = np.zeros(B, np.int64)
        for b, ch in enumerate(self.channels):
            if ch is None:
                continue
            f = self._pull_frames(ch, Tc)
            n_new[b] = len(f)
            feats[b, :len(f)] = f
        if not n_new.any():
            return 0
        if self._total_frames + Tc - 1 >= self.max_frames:
            raise RuntimeError(
                f"online pipeline exceeded max_frames={self.max_frames}; "
                "finalize or reset channels")
        act = np.arange(Tc)[:, None] < n_new[None, :]
        with torch.inference_mode():
            loglikes = torch.as_tensor(self.scorer(feats),
                                       dtype=torch.float32,
                                       device=self.device)
            if tuple(loglikes.shape[:2]) != (B, Tc):
                raise ValueError(f"scorer gave {tuple(loglikes.shape)}, "
                                 f"expected ({B}, {Tc}, P)")
            am = (loglikes * (-self.acoustic_scale)).permute(
                1, 2, 0).contiguous()
            self._ys.append(self._advance(
                am, torch.as_tensor(act, device=self.device)))
        self._acts.append(act)
        self._generation += 1
        for b, ch in enumerate(self.channels):
            if ch is not None:
                ch.end_frame += int(n_new[b])
        self._total_frames += Tc
        if self.endpointing:
            self._update_endpoint_trackers(n_new)
        return int((n_new > 0).sum())

    # -- results --------------------------------------------------------
    def _history(self) -> Dumps:
        """Every chunk's decisions, concatenated on the card once and
        kept, so that repeated tracebacks copy no chunk twice."""
        if len(self._ys) > 1:
            self._ys = [{k: torch.cat([y[k] for y in self._ys])
                         for k in self._ys[0]}]
        return self._ys[0]

    def _traceback(self) -> List[Hyp]:
        """The follow pass over everything accumulated -> per lane
        (words, tids, cost) over the lane's own frames.  Cached per
        state change: finalizing all lanes costs one follow pass."""
        if not self._ys:
            return [None] * self.B
        if self._tb_cache[0] == self._generation:
            return self._tb_cache[1]
        act = np.concatenate(self._acts, 0)          # (T, B)
        # The reference pads the time axis to a power of two here, so
        # that its jitted follow pass compiles once a bucket.  A frame
        # with act False changes no state, so the port follows the
        # frames as they are.
        with torch.inference_mode():
            ys = self._history()
            best_cost, final_state = self._final_costs()
            states = self._follow(ys, torch.as_tensor(act, device=self.device),
                                  final_state).cpu().numpy()
        out: List[Hyp] = []
        for b, ch in enumerate(self.channels):
            if ch is None or best_cost[b] >= INF / 2:
                out.append(None)
                continue
            # the lane's active frames of its current utterance
            frames = np.nonzero(act[:, b])[0]
            frames = frames[frames >= ch.start_frame]
            words, tids = self._decode_traj(states[frames, b])
            out.append((words, tids, float(best_cost[b])))
        self._tb_cache = (self._generation, out)
        return out

    def get_partial(self, lane: int) -> Hyp:
        """(words, tids, cost) so far for one lane (None if dead)."""
        return self._traceback()[lane]

    def finalize(self, lane: int) -> Hyp:
        """Final result for a finished lane; frees nothing by itself
        (free_channel() the lane afterwards)."""
        return self._traceback()[lane]

    def _maybe_trim(self) -> None:
        if all(c is None for c in self.channels):
            self._ys.clear()
            self._acts.clear()
            self._total_frames = 0

    def _trim_committed(self) -> None:
        """Drop the history before the all-lane watermark (the earliest
        active utterance's start).  This bounds the follow pass and the
        decision store by the active window instead of the session, so
        a rotating-lane session streams indefinitely (the reference
        frees a channel's history when its lattice is taken,
        cudadecoder/cuda-decoder.h:370)."""
        if not self._ys:
            return
        active = [c for c in self.channels if c is not None]
        wm = min((c.start_frame for c in active),
                 default=self._total_frames)
        if wm < 4 * self.Tc:          # not worth a device copy yet
            return
        act = np.concatenate(self._acts, 0)
        with torch.inference_mode():
            # a slice is a view of the whole history: the copy lets the
            # dropped frames' storage go
            self._ys = [{k: v[wm:].clone()
                         for k, v in self._history().items()}]
        self._acts = [act[wm:]]
        self._total_frames -= wm
        for ch in active:
            ch.start_frame -= wm
            ch.end_frame -= wm
        self._tb_cache = (-1, None)   # frame indices shifted

    # -- endpointing (online2/online-endpoint.h:123,175), on the lanes'
    # device state --------------------------------------------------------
    def _endpoint_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (relative cost (B,), best state in silence (B,)) numpy."""
        with torch.inference_mode():
            best_cost, _ = self._final_costs()
            rel = best_cost - self._current_best()
            return rel, self._best_in_silence()

    def _update_endpoint_trackers(self, n_new: np.ndarray) -> None:
        rel, is_sil = self._endpoint_stats()
        self._last_rel_cost = rel
        for b, ch in enumerate(self.channels):
            if ch is None or n_new[b] == 0:
                continue
            if is_sil[b]:
                ch.trailing_sil += int(n_new[b])
            else:
                ch.trailing_sil = 0
                ch.nonsil_seen = True

    def endpoint_detected(self, lane: int, config: OnlineEndpointConfig,
                          frame_shift: float = 0.03) -> bool:
        """Whether any of the config's rules holds for one lane
        (online-endpoint.h:175).  frame_shift: seconds a decoded frame
        (0.03 for chain frame subsampling 3)."""
        ch = self.channels[lane]
        if ch is None:
            return False
        utt_len = (ch.end_frame - ch.start_frame) * frame_shift
        trailing = ch.trailing_sil * frame_shift
        rel_cost = (float(self._last_rel_cost[lane])
                    if self._last_rel_cost is not None else float("inf"))
        return any(rule.active(utt_len, trailing, rel_cost, ch.nonsil_seen)
                   for rule in config.rules())


class BatchedDeviceOnlinePipelineLex(BatchedDeviceOnlinePipeline):
    """Streaming batched decode over a LexChainDecoder (the shared-lexicon
    entry-LM graph of a real lexicon, a backoff bigram and a chain
    tree), exact search: the resident carry is (chain rows (N, B),
    variant roots and silence shadows (P+1, B)), resumed by the
    decoder's own frame loop."""

    def _init_device(self) -> None:
        g = self.decoder.g
        self._alloc_planes(g.N, g.P)

    def _alloc_planes(self, rows: int, roots: int) -> None:
        """The carry: rows (rows, B); roots and shadows (roots + 1, B),
        the begin root last."""
        self._cost = torch.full((rows, self.B), INF, dtype=torch.float32,
                                device=self.device)
        self._roots = torch.full((roots + 1, self.B), INF,
                                 dtype=torch.float32, device=self.device)
        self._sil = torch.full_like(self._roots, INF)

    def _reset_lane(self, lane: int) -> None:
        self._cost[:, lane] = INF
        self._roots[:, lane] = INF
        self._roots[-1, lane] = 0.0                    # the begin root
        self._sil[:, lane] = INF

    def _advance(self, am: torch.Tensor, act: torch.Tensor) -> Dumps:
        (self._cost, self._roots, self._sil), outs = self.decoder._forward(
            am, act, carry=(self._cost, self._roots, self._sil))
        return outs

    def _follow(self, ys: Dumps, act: torch.Tensor,
                final_state: torch.Tensor) -> torch.Tensor:
        return self.decoder._follow(ys, act, final_state)[1]

    def _final_costs(self) -> Tuple[np.ndarray, torch.Tensor]:
        final_state, best = self.decoder._final_state(self._roots,
                                                      self._sil)
        return best.cpu().numpy(), final_state

    def _live_best(self) -> torch.Tensor:
        """Each lane's best row or root cost (B,)."""
        return torch.minimum(self._cost.amin(dim=0),
                             self._roots.amin(dim=0))

    def _current_best(self) -> np.ndarray:
        cur = self._live_best()
        if self.decoder.g.use_sil:
            cur = torch.minimum(cur, self._sil.amin(dim=0))
        return cur.cpu().numpy()

    def _best_in_silence(self) -> np.ndarray:
        if not self.decoder.g.use_sil:
            return np.zeros(self.B, bool)
        return (self._sil.amin(dim=0) < self._live_best()).cpu().numpy()

    def _traj_labels(self, traj: np.ndarray, rows: int, roots: int,
                     row_word: np.ndarray, root_word: np.ndarray
                     ) -> Tuple[List[int], List[int]]:
        """A lane's states after each of its frames -> (words, tids), the
        path starting at the begin root: rows [0, rows), roots
        [rows, rows + roots), the begin root, then the shadows."""
        g = self.decoder.g
        root0, begin, sil0 = rows, rows + roots, rows + roots + 1
        cur = np.asarray(traj, np.int64)
        prev = np.concatenate([[begin], cur])[:-1]
        held = prev == cur
        is_row = cur < rows
        is_sil = (cur >= sil0) & bool(g.use_sil)
        n = np.clip(cur, 0, rows - 1)
        u = np.clip(cur - root0, 0, roots - 1)
        tids = np.where(
            is_row, np.where(held, g.tid_self_row[n], g.tid_fwd_row[n]),
            np.where(is_sil, np.where(held, g.sil_tid_self, g.sil_tid_fwd),
                     np.where(held, g.tid_root_self[u], g.tid_end[u])))
        word = np.where(
            is_row & ~held & g.row_is_first[n] & (prev >= rows),
            row_word[n] + 1,
            np.where(~is_row & ~is_sil & ~held & (g.end_row[u] < 0),
                     root_word[u] + 1, 0))
        return word[word > 0].tolist(), tids.tolist()

    def _decode_traj(self, traj: np.ndarray) -> Tuple[List[int],
                                                     List[int]]:
        g = self.decoder.g
        return self._traj_labels(traj, g.N, g.P, np.maximum(g.row_word, 0),
                                 g.pron_word)


class BatchedDeviceOnlinePipelineNg(BatchedDeviceOnlinePipelineLex):
    """The production online configuration: streaming batched decode over
    an NgramLexDecoder ((context-dependent tree) x (backoff trigram)
    graphs), each frame's pool the lane's prune_k best rows within
    prune_beam.  The carry is (rows (Nr, B), unit roots and shadows
    (U+1, B)); everything else is the LexChain pipeline's."""

    def __init__(self, decoder: NgramLexDecoder, scorer: Callable,
                 feat_dim: int, *args, prune_k: int = 128,
                 prune_beam: float = 16.0, **kw):
        self._prune_k = prune_k
        self._prune_beam = float(prune_beam)
        super().__init__(decoder, scorer, feat_dim, *args, **kw)

    def _init_device(self) -> None:
        dec = self.decoder
        # the reference asks for the approximate pool selection here
        # (exact_topk=False); the port's selection is always exact
        self._K = int(min(self._prune_k, dec.VC))
        self._alloc_planes(dec.g.Nr, dec.g.U)

    def _advance(self, am: torch.Tensor, act: torch.Tensor) -> Dumps:
        (self._cost, self._roots, self._sil), outs = self.decoder._forward(
            am, act, self._K, self._prune_beam,
            carry=(self._cost, self._roots, self._sil))
        return outs

    def _decode_traj(self, traj: np.ndarray) -> Tuple[List[int],
                                                     List[int]]:
        g = self.decoder.g
        return self._traj_labels(traj, g.Nr, g.U,
                                 g.unit_word[np.maximum(g.row_unit, 0)],
                                 g.unit_word)


class OnlineDynamicBatcher:
    """Host-side dynamic batcher over an online pipeline: binds queued
    utterances to the fixed device lanes, finalizes a lane on its
    endpoint or at the end of its input, and rebinds the freed lane to
    the next queued utterance mid-stream (the reference's
    cudadecoder/cuda-online-pipeline-dynamic-batcher.h:38 with the
    endpoint-triggered channel rotation of online2/online-endpoint.h:175).
    """

    def __init__(self, pipe: BatchedDeviceOnlinePipeline,
                 endpoint_config: Optional[OnlineEndpointConfig] = None,
                 frame_shift: float = 0.03):
        self.pipe = pipe
        self.config = endpoint_config
        self.frame_shift = frame_shift
        self.queue: List[Tuple[str, np.ndarray]] = []
        self.results: Dict[str, Hyp] = {}
        self.endpointed: Dict[str, bool] = {}

    def push(self, utterance_id: str, feats: np.ndarray) -> None:
        self.queue.append((utterance_id, np.asarray(feats, np.float32)))

    def _bind_free_lanes(self) -> None:
        for b in range(self.pipe.B):
            if self.pipe.channels[b] is None and self.queue:
                uid, feats = self.queue.pop(0)
                self.pipe.init_channel(b, uid)
                self.pipe.accept_features(b, feats)
                self.pipe.input_finished(b)

    def _drained(self, b: int) -> bool:
        ch = self.pipe.channels[b]
        if ch is None or not ch.finished:
            return False
        if ch.feature is not None:
            return ch.frames_consumed >= ch.feature.num_frames_ready()
        return not ch.pending

    def run(self) -> Dict[str, Hyp]:
        """Drive until the queue and all lanes drain -> utterance_id ->
        (words, tids, cost), None where no path survives."""
        self._bind_free_lanes()
        while any(c is not None for c in self.pipe.channels) or self.queue:
            advanced = self.pipe.compute()
            for b in range(self.pipe.B):
                ch = self.pipe.channels[b]
                if ch is None:
                    continue
                done = self._drained(b)
                epd = (not done and self.config is not None
                       and self.pipe.endpointing
                       and self.pipe.endpoint_detected(
                           b, self.config, self.frame_shift))
                if done or epd:
                    self.results[ch.utterance_id] = self.pipe.finalize(b)
                    self.endpointed[ch.utterance_id] = bool(epd)
                    self.pipe.free_channel(b)
            self._bind_free_lanes()
            if advanced == 0 and not any(
                    c is not None for c in self.pipe.channels) \
                    and not self.queue:
                break
        return self.results
