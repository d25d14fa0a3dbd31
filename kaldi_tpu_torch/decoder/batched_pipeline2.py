"""Offline batched full-pipeline decoder: waves -> MFCC -> i-vectors ->
chain TDNN-F (bf16) -> batched Viterbi search (the n-gram lexchain, the
LexChain or the block-chain decoder) -> words (and, in lattice mode,
word lattices), all batched on one card (port of
`kaldi_tpu/decoder/batched_pipeline2.py`).

The reference's analogue is the offline batched GPU pipeline of the
upstream project (BatchedThreadedNnet3CudaPipeline2, whose printed
`RealTimeX = total_audio / total_time` is the metric of record).  Here
three batched device stages run back to back: the feature frontend, the
acoustic model in one dispatch, and the exact Viterbi search.  Host work
is wave staging and the final traceback or, in lattice mode, the lattice
assembly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.device import DeviceLike, resolve_device, same_device
from kaldi_tpu_torch.lat.functions import lattice_best_path


@dataclass
class PipelineStats:
    total_audio_s: float = 0.0
    wall_s: float = 0.0
    feat_s: float = 0.0
    am_s: float = 0.0
    search_s: float = 0.0

    @property
    def xrt(self) -> float:
        return self.total_audio_s / self.wall_s if self.wall_s else 0.0


class BatchedOfflinePipeline2:
    """decode_batch(waves) -> per lane (word_ids, total_cost) or None;
    with generate_lattices=True, (word_ids, total_cost, Lattice) or None.

    model: a ChainTdnnf carrying its weights (see
    `nnet3.models.chain_tdnnf_from_flax`); decoder: anything with a
    `decode_batch` (an NgramLexDecoder, a LexChainDecoder, a
    BlockChainDecoder; lattice mode needs `decode_batch_lattice`, which
    all three have); feature_computer: an OfflineFeature;
    ivector_extractor: an optional BatchedIvectorExtractor whose
    whole-utterance i-vectors are the model's second input.  All of them
    must live on `device`.  search_kwargs are forwarded to
    `decoder.decode_batch` in best-path mode only (prune_k/prune_beam of
    the n-gram decoder, for example)."""

    def __init__(self, model, decoder, feature_computer,
                 acoustic_scale: float = 1.0, sample_rate: float = 16000.0,
                 search_kwargs: Optional[dict] = None,
                 ivector_extractor=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.decoder = decoder
        self.feats = feature_computer
        self.ivec = ivector_extractor
        self.acoustic_scale = acoustic_scale
        self.sample_rate = sample_rate
        self.search_kwargs = dict(search_kwargs or {})
        parts = [("decoder", decoder.device),
                 ("feature_computer", feature_computer.device),
                 ("model", next(model.parameters()).device)]
        if ivector_extractor is not None:
            parts.append(("ivector_extractor", ivector_extractor.device))
        for name, dev in parts:
            if not same_device(dev, self.device):
                raise ValueError(f"{name} is on {dev}, the pipeline on "
                                 f"{self.device}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def loglikes(self, feats: torch.Tensor, nframes: np.ndarray
                 ) -> Tuple[torch.Tensor, np.ndarray]:
        """Acoustic stage: feats (B, T, D) on the device -> (loglikes
        (B, T_out, num_pdfs) float32, out_lens (B,)).  The model input is
        rounded to bf16 first, as the reference does; padded feature rows
        feed the right context of the last real frames and are masked by
        out_lens."""
        T = int(feats.shape[1])
        with torch.inference_mode():
            ivecs = (None if self.ivec is None
                     else self.ivec.extract_batch(feats, nframes))
            loglikes = self.model.chain(
                feats.to(torch.bfloat16),
                None if ivecs is None else ivecs.to(torch.bfloat16)
            ).to(torch.float32)
        sub = max(1, -(-T // loglikes.shape[1]))
        out_lens = -(-np.asarray(nframes, np.int64) // sub)
        return loglikes, out_lens

    def decode_batch(self, waves: Sequence[np.ndarray],
                     stats: Optional[PipelineStats] = None,
                     generate_lattices: bool = False,
                     lattice_beam: float = 8.0,
                     lat_stats: Optional[dict] = None,
                     num_waves: int = 1) -> List[Optional[tuple]]:
        """generate_lattices=False: per lane (word_ids, total_cost).
        generate_lattices=True: per lane (word_ids, total_cost, word
        Lattice): the search runs in lattice mode with its default J,
        pool and event capacity (device dumps of each word end's top-J
        predecessors, host assembly), and the words and cost are the
        lattice's best path.  search_kwargs do not apply.  lat_stats, when
        given, is the decoder's `decode_batch_lattice` stats: the lattice
        stages' seconds and sizes (the n-gram decoder's fwd_s, n_events,
        pool_s and assemble_s; the LexChain and block-chain decoders'
        keys).

        num_waves: the reference splits the batch into waves whose host
        to device transfers overlap the compute; only 1 is ported."""
        if num_waves != 1:
            raise NotImplementedError(
                f"num_waves={num_waves}: splitting the batch into waves is "
                "not ported; pass num_waves=1")
        t_all = time.perf_counter()
        feats_d, nframes = self.feats.compute_batch_device(waves)
        self._sync()
        t_feat = time.perf_counter() - t_all
        t0 = time.perf_counter()
        loglikes, out_lens = self.loglikes(feats_d, nframes)
        self._sync()
        t_am = time.perf_counter() - t0
        t0 = time.perf_counter()
        if generate_lattices:
            lats = self.decoder.decode_batch_lattice(
                loglikes, self.acoustic_scale, lengths=out_lens,
                lattice_beam=lattice_beam, stats=lat_stats)
            out = []
            for lat in lats:
                if lat is None:
                    out.append(None)
                    continue
                _ali, words, cost = lattice_best_path(lat)
                out.append((words, cost, lat))
        else:
            hyps = self.decoder.decode_batch(loglikes, self.acoustic_scale,
                                             lengths=out_lens,
                                             **self.search_kwargs)
            out = [None if h is None else (h[0], h[2]) for h in hyps]
        t_search = time.perf_counter() - t0
        wall = time.perf_counter() - t_all
        if stats is not None:
            stats.total_audio_s += sum(len(w) for w in waves) / \
                self.sample_rate
            stats.wall_s += wall
            stats.feat_s += t_feat
            stats.am_s += t_am
            stats.search_s += t_search
        return out
