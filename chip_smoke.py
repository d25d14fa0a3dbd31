#!/usr/bin/env python3
"""Smoke test of the kaldi_tpu_torch port on one NVIDIA GPU.

Drives the port's main path as the repo's headline measures it
(bench.py main_scale): the 128 test utterances of the V=20,000 bench
corpus on the mu-law wire -> MFCC -> i-vectors -> the committed
flagship_ng chain TDNN-F (17 x 1536, bf16) -> NgramLexDecoder over the
trigram x triphone NgramLexGraph (495,782 states, pool of 128 rows, beam
16) -> words -> WER, through BatchedOfflinePipeline2.decode_batch, and
in lattice mode as bench.py --with-lattices runs it (J=4, 64 word-end
events and 128 pool rows a frame, lattice_beam=8).  No hand-written
kernel is on that path (its search is PyTorch ops).  The
paths that carry the kernels run at full width too: 128 lanes x 5 s of
seeded mu-law audio -> the same frontend and model -> exact block-chain
Viterbi over the V=700 DirectGraphSpec graph (2,215,861 states), in
best-path mode, and in lattice mode (generate_lattices=True,
lattice_beam=8, J=4) on 32 of the lanes, kernel b's own checks and times
at full width; and the same 128 lanes' loglikes ->
BatchedViterbi.run, the dense exact Viterbi over a flat graph (the V=64
block-chain graph's to_flat_graph(): 20,865 states, 44,914 arcs, in-arc
tables padded to K=128, of which the relaxation kernel walks the live
slots only), shared by all lanes (decode) and one graph a lane (forced
alignment).  Online, the same slices stream through the port's
batched online pipeline: the best-path slice's loglikes through
BatchedDeviceOnlinePipeline (kernel a every frame of every chunk), and the
main path as egs/bench_corpus/measure_online_ng.py runs it
(BatchedDeviceOnlinePipelineNg, 32-frame chunks scored by the TDNN-F,
endpointing on), its offline loglikes streamed, and OnlineDynamicBatcher
over 32 lanes.  The legacy path (bench.py --legacy) runs at full width
too: the 128 test utterances of the V=200 bench corpus -> MFCC -> the
committed flagship_params.npz TDNN-F (17 x 1536, bf16, no i-vectors) ->
exact LexChainDecoder search over the bigram x monophone-chain graph
(818 states), offline, in lattice mode as bench.py --legacy
--with-lattices runs it (J=4, lattice_beam=8, with the exact backward
pass), and streaming (egs/bench_corpus/measure_online.py's configuration
through BatchedDeviceOnlinePipelineLex); the host lattice functions run
on the lattices of both lattice phases.  Kaldi nnet3 models go through
the port's reader, writer, compiled module (nnet3/torch_bridge.py) and
nnet3-compute tools: the reference C++ golden, the flagship model
imported from a .mdl and decoded through the main path's search, and a
TDNN-LSTM through the module's frame loop.  The legacy model and graph
are also served as a Kaldi user serves them, a .mdl, an OpenFst HCLG.fst
and a words.txt through the port's online2-wav-nnet3-latgen-faster and
online2-tcp-nnet3-decode-faster (the model on the card in a streaming
window, the search on the host), and as an xconfig checkpoint directory
decoded into lattices by nnet3-latgen-faster, scored by the lattice
tools and compute-wer.

Phases, one JSON line each (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from kaldi_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's full shape and at a small ragged shape (torch.equal;
     the lattice step also on forced ties; the relaxation with its live
     counts and without, the first version, into the batched decoder's
     lanes-fastest rows, dead column included, and into rows of its own,
     with the instantiation each call takes), and their times (the
     relaxation: first version and live walk in turns, by CUDA events
     around a replayed CUDA graph of launches, beside the padded and the
     live bound, and the host time of a launch);
  4. the best-path slice: one warm-up decode_batch, three timed ones with
     the kernel launch counts read around each; the bf16 AM against
     float32 on 4 lanes; 8 lanes decoded again with the plain step (equal
     words, tids and costs); one decode_batch under torch.profiler
     (device time by kernel, busy share, peak memory); slice_online: the
     same loglikes streamed through BatchedDeviceOnlinePipeline in
     16-frame chunks with ragged arrivals, idle lanes and 8 lanes bound
     again mid-session (each result equal to decode_batch, kernel a
     launched 16 times a chunk, wall, chunk and finalize ms p50/p99, peak
     memory), then the same schedule at 128 lanes through a kernel and a
     plain-step pipeline in lockstep (carries and decisions equal after
     every chunk, every result equal, no launch by the plain one);
  5. the main path (ng_graph, slice_ng, profile_ng, ng_cpu_check,
     cross_check_ng): the bench corpus, its fingerprint against the
     committed model's, the graph and its sizes; one warm-up and three
     timed decode_batch calls (wall, xRT, the feat/am/search split, the
     decoder's fwd_s/fol_s/traceback_s, lanes decoded, WER within half a
     point of the recorded 9.34%, no kernel launched); one call under
     torch.profiler (device time by kernel, by op and by decoder block,
     launches per frame, busy share, peak memory); 4 lanes' loglikes
     through the decoder on the CPU (equal words and tids, costs within
     1e-4 relative); a V=30 graph from the same transition model and tree
     decoded exactly on the card and by the host FasterDecoder on its
     to_flat_graph() (equal words and tids); then the main path in lattice
     mode (slice_ng_lattice, ng_lattice_cpu_check): one warm-up and one
     timed decode_batch(generate_lattices=True, lattice_beam=8) of the 128
     utterances (wall, lattice xRT, the decoder's fwd_s/n_events/pool_s/
     assemble_s, peak memory, lattices, median states and arcs, the WER of
     the lattice best paths against the WER of decode_batch with the same
     pool on the same loglikes, the lanes whose words differ, no kernel
     launched; at least 95% lattices, the two WERs within half a point);
     2 lanes' lattices on the CPU equal to the card's in structure,
     weights within 1e-9 x the largest |prefix sum| of acoustic costs;
     then the main path online: slice_online_ng (the 128 utterances
     through BatchedDeviceOnlinePipelineNg, a warm-up and a timed round:
     xRT, chunk and finalize ms, WER, each lane equal to decode_batch of
     the loglikes its scorer produced; then a round for the stage
     seconds), online_ng_stream_offline
     (slice_ng's loglikes streamed: no lane differing from slice_ng, so
     its WER), online_batcher_ng (OnlineDynamicBatcher on 32 lanes with
     the default endpoint rules: every utterance equal to decode_batch of
     the frames its lane consumed, endpoints, the history trimmed);
     then Kaldi nnet3 models: nnet3_ref_golden (the reference C++
     nnet3-compute output of tests/data/ref_golden, tdnn.raw and
     tdnn_text.raw through compile_graph and tdnn.raw through the
     nnet3-compute tool, within 1e-4), nnet3_import_flagship (the
     flagship_ng TDNN-F written with flagship_ng.tm as a Kaldi .mdl, read
     back and compiled; the 128 test utterances' features and i-vectors
     scored in float32 as nnet3-compute-batch batches them: write, read
     and compile seconds, the file's size, wall and device ms, xRT, peak
     memory, launches a batch; interior frames of the subsampled output
     within 1e-3 of the native model, 2 lanes within 1e-3 of the host
     evaluator; the WER of the main path's search on it within half a
     point and 8 words of 9.399%, 128/128 lanes), nnet3_cli_batch (8
     utterances through `python -m kaldi_tpu_torch.cli
     nnet3-compute-batch --ivectors=...` in a process of its own, its ark
     torch.equal to the module under the same batching), nnet3_recurrent
     (a TDNN-LSTM of three fast-lstmp layers at run_tdnn_lstm_1a's widths
     through the frame loop, 32 lanes x 500 frames: wall, ms and launches
     a frame, peak memory, 2 lanes within 1e-3 of the host evaluator);
     then the legacy path: lex_graph (corpus and graph build seconds, V,
     N, P, states, explicit bigrams, the corpus fingerprint against the
     JAX package's), slice_lex (one warm-up with no host sync in the frame
     loop or the follow pass, three timed decode_batch calls on the
     mu-law wire: wall, xRT, the feat/am/search split, the decoder's
     fwd_s/fol_s/traceback_s, peak memory, 128/128 lanes, WER, no kernel
     launched), profile_lex (launches a frame), slice_lex_int16 (the
     same utterances on the int16 wire: WER within 0.5 points and 8
     words of the JAX package's CPU WER), lex_pruned_full_k (every
     virtual-context row in the pool: equal to exact), lex_cpu_check (4
     lanes again on the CPU), slice_lex_lattice (one warm-up with no
     host sync in the forward or the backward frame loop, one timed
     decode_batch(generate_lattices=True, lattice_beam=8) on the mu-law
     wire: wall, xRT, the feat/am/search split, the decoder's lattice
     stats, _assemble_lane's host seconds, peak memory, median states and
     arcs, WER; 128/128 lattices, each lane's best path decode_batch's
     words, cost within 1e-4 relative, no kernel launched),
     profile_lex_lattice (launches a frame of each loop),
     lex_lattice_cpu_check (2 lanes' lattices on the CPU equal to the
     card's in structure, weights within 1e-9 x the largest |prefix
     sum|), lattice_functions (8 lattices of slice_lex_lattice and 8 of
     slice_ng_lattice: determinize_lattice_pruned, posteriors,
     lattice_best_path_lattice, lattice_scale, add_word_ins_penalty, each
     one's seconds; the best path kept, posteriors summing to 1 within
     1e-6 a frame), cross_check_lex (the 2 shortest lanes
     against the host FasterDecoder on to_flat_graph(): equal, or a
     float64 tie), slice_online_lex (measure_online.py's configuration
     at 128 lanes: a warm-up, a timed and a staged round; xRT, chunk and
     finalize ms, WER, peak memory, each lane equal to decode_batch of
     the loglikes its scorer produced); then online2 serving:
     online2_graph (the legacy TDNN-F written as a .mdl with its
     contexts, read back and compiled; the legacy graph's flat form
     written as an OpenFst HCLG.fst and read back, every arc equal;
     words.txt; 16 test utterances on the int16 wire as a wav archive),
     online2_wav (online2-wav-nnet3-latgen-faster in a process of its
     own: each utterance's words equal to the offline reference, the
     compiled module over the whole utterance's features and the host
     FasterDecoder; RTF, WER, agreement with slice_lex_int16; the
     streamed features and loglikes against the offline ones, the
     scorer's device ms and launches a chunk), online2_tcp
     (online2-tcp-nnet3-decode-faster in a process of its own, 16
     clients 4 at a time: every client sees a partial and its finals
     equal online2_wav's words; wall, final latency p50/p99, the
     scorer's and the search's host ms, peak memory); then the legacy
     model as an xconfig checkpoint: xconfig_graph (chain_tdnnf_xconfig
     text and a .npz checkpoint directory written, read back and built,
     the module within 1e-4 of the native TDNN-F on every frame;
     final.tm; the 16 utterances' MFCCs as feats.ark), xconfig_latgen
     (nnet3-latgen-faster at decode.sh's beams in a process of its own,
     then lattice-scale | lattice-add-penalty | lattice-best-path and
     compute-wer as processes: 16/16 lattices, none undeterminized, each
     best path the tool's words and the host FasterDecoder's at beam 15;
     WER, the tool's stats line, the forward's device ms and launches),
     xconfig_latgen_variants (-batch and -looped on 4 utterances: the
     base tool's words; -batch's interior loglikes within 1e-4),
     xconfig_zoo (a TDNN-LSTM, a GRU, attention, a CNN front end and an
     x-vector network at their recipes' widths, seeded random weights,
     32 x 500 frames on the card against float64 on the CPU), disc_smbr
     (sMBR fine-tuning of the same checkpoint through the tools over 32
     training utterances: compile-train-graphs, nnet3-align-compiled at
     the output rate, nnet3-latgen-faster's denominator lattices, the
     discriminative egs tools, compute-objf before and after,
     nnet3-discriminative-train in a process of its own, the tuned WER
     within 0.5 points of tools/disc_jax_bar.py's and of the untuned
     one's, one step's gradient on the card against the CPU's float64,
     one profiled step); then the
     legacy training recipe:
     train_lex (recipes/train_bench.py, 6 of its 8 epochs (all 8:
     chip_main_path.py --train): stage seconds, the
     aligner, each epoch's objective, step ms, peak memory, the WER of
     the test set within 2.0 points of the JAX package's),
     profile_train_step (one step under torch.profiler) and
     train_lex_check (the card against the CPU from one state and one
     minibatch: the step, the optimizer, every leaf's gradient, the
     chain loglikes, GMM loglikes and alignments); then Kaldi chain
     training through the tools over train_lex's system: chain_cli
     (tree, 0.trans_mdl, feats.ark, the alignments and phones written;
     chain-est-phone-lm, chain-make-den-fst, chain-get-supervision,
     nnet3-chain-get-egs, -shuffle-egs, -subset-egs; nnet3-chain-train
     of the 17 x 1536 TDNN-F and nnet3-chain-compute-prob each in a
     process of its own; nnet3-chain-combine; the test set decoded with
     the trained raw nnet through LexChainDecoder, its WER within 2.0
     points of the JAX package's; the guard's rejects 0; one step under
     torch.profiler), chain_cli_check (one trainer step on 4 egs on the
     card and on the CPU in float64: objective, every gradient leaf,
     the optimizer's move), chain_cli_e2e (flat-start egs of 16 test
     utterances, compute-prob on the card equal to the CPU's) and
     nnet3_train_cli (ali-to-pdf, ali-to-post, nnet3-get-egs, -shuffle,
     -merge, nnet3-train at 1536/160, nnet3-compute-prob above the
     uniform -log P, nnet3-average), train_chain_frame (the frame-rate
     train_chain over train_lex's mono system, 32 utterances, 17 x 1536,
     dropout 0.1: the objective rising, the keep rate within 3 sigma of
     0.9, the first step's gradient against the CPU's float64 with the
     same masks, step ms) and ng_precondition (online_natural_gradient,
     rank 32, over 10 of its gradients on the card in float32 against
     the CPU in float64; spec_augment's draws on a (8, 300, 40) batch);
     then the --scale
     training recipe: train_scale (recipes/train_scale.py at full width,
     the i-vector extractor, the triphone tree, the window-LM
     denominator's sizes, 8 of the recipe's 16 epochs of the TDNN-F with
     i-vectors (all 16: chip_main_path.py --train-scale), stage
     seconds, step ms, peak memory, the test set through the main path,
     its WER within 2.0 points of the committed model's 9.53%),
     profile_train_scale_step (one step under torch.profiler) and
     train_scale_check (4 real chunks through the bucketed denominator:
     every leaf's gradient on the card against the CPU's float64,
     bit-equal twice); kernels a-c launched 0 times in each;
     then the generic corpus recipe (egs/template/run.py through the
     port's recipes/template_run.py and tools) on a fabricated corpus of
     112 train and 32 test utterances at the recipe's widths (100
     leaves, 200 Gaussians, 13 cepstra), one call at its defaults
     (stages 0-7) and one of stage 8 over the same directory, each
     held to the JAX recipe's on the CPU (tools/template_jax_bar.py):
     template_gmm (stages 0-5: the lang dir, MFCC on the card, the mono
     GMM through the tools, tri1, the HCLG from the ARPA bigram,
     gmm-latgen-faster and the lm-scale x penalty sweep; the WER within
     2.0 points and 3 words, the HCLG's states and arcs equal, no
     alignment failure, no determinization fallback, each stage's and
     tool's seconds, the device ms of MFCC and GMM scoring,
     gmm-latgen-faster's RTF, peak memory), template_lda_sat (stages
     6-7: tri2 LDA+MLLT and tri3 SAT with the two-pass fMLLR decode,
     each WER within 2.0 points and 3 words, final.mat (20, 66), a
     transform for every train and test speaker; the device ms of GMM
     scoring, of the statistics and of the feature transforms; the LDA,
     MLLT and fMLLR statistics rebuilt from tri2 and tri3 on the card
     and on the CPU, within 1e-9 of their largest magnitude; acc-lda,
     est-lda, gmm-acc-mllt, est-mllt, compose-transforms,
     transform-feats and gmm-est-fmllr over the run's files within 1e-6
     of the in-process matrices) and template_chain_e2e (stage 8: the
     flat-start e2e TDNN-F trained TEMPLATE_CHAIN_EPOCHS epochs on the
     card and decoded, the WER within 5.0 points of the JAX recipe's at
     the same epochs, the last epoch's objective above the first's, step
     ms by CUDA events, peak memory, one step under torch.profiler);
     kernels a-c launched 0 times in each;
  6. the block-chain lattice slice on 32 of the lanes: one timed
     decode_batch call in lattice mode, under torch.profiler (launch
     counts, the lattice stages' seconds, each lane's lattice best path
     against the best-path decode); 1 lane decoded again with the plain
     lattice step (equal lattices);
  7. the flat-graph slice: one warm-up and three timed BatchedViterbi.run
     calls (seconds of table preparation, frame loop, copy to the host
     and traceback; launch counts: one emitting launch a frame, no
     closure launch on this epsilon-free graph), one under
     torch.profiler; one run as the first version made it (every slot
     walked, every launch fully checked, the closure launched: equal
     hypotheses, its frame loop's seconds beside the new one's); the
     block-chain decoder and, on 2 lanes, the host FasterDecoder on the
     same graph and loglikes (cross_check); one sub-graph a lane cut along its
     decoded words (alignment: the per-lane-table form of the kernel
     must give the lane's tids and cost back); 8 lanes again with the
     plain relaxation;
  8. the kernel table (kernel a's launches on the online path too, and
     each kernel's launches on the legacy, the online2, the xconfig, the
     training, the nnet3 and the three template phases, which must be
     0);
     the
     last line is {"ok": true, "device": ...}.

After the xconfig phases, over the --scale corpus (384 training and 128
test utterances, 24 speakers) with the committed flagship extractor's
i-vectors (ivector-extract), the speaker and language back ends and
VTLN: backend_lid (logistic-regression-train at its defaults and with
--mix-up=48, -eval, -copy: top-1 accuracy within 2 test utterances of
tools/backend_jax_bar.py's, the card's weights within 1e-5 of the
CPU's), backend_diar (PLDA, ivector-plda-scoring-dense of 8 recordings
of 3 speakers, agglomerative-cluster with the true counts and with a
threshold: each recording's speaker errors within one segment of
JAX's), gmm_vtln (compute-mfcc-feats --vtln-warp/--vtln-map card
against CPU, the 31 LVTLN classes over the flagship UBM, each
speaker's warp within one class of JAX's, the twofeats statistics card
against CPU, gmm-global-est-fmllr); gmm_mmi over the generic
recipe's corpus made again (boosted MMI of the JAX recipe's tri1 over
24 training utterances, in process and one iteration through the
train_mmi.sh tools: objectives within 2e-3 of JAX's, the tools within
1e-6 of the in-process model, the test WER no worse and JAX's), in the
train worker after synthetic_run; after the template phases,
synthetic_run (egs/synthetic/run.py's stages 0-7 through the port's
tools, each stage's word errors within 3 of JAX's); kernels a-c
launched 0 times in each.

After the xconfig phases, the graph and scoring tool chains over the
legacy corpus: mkgraph_legacy (utils/format_lm.sh and utils/mkgraph.sh
through the port's tools, tools/mkgraph_steps.py, over the legacy
lexicon, its bigram written by to_arpa and online2_graph's .mdl: the
HCLG's size equal to the tools' on the CPU; the 128 test utterances on
the int16 wire through nnet3-latgen-faster on the card, the WER within
0.5 points and 8 words of tools/mkgraph_jax_bar.py's, 0 determinization
fallbacks; the tool graph, the tool graph built tropical and without
fstpushspecial, and the flat form decoded on one set of loglikes, each
difference in their words covered by the cost terms that part the
graphs) and scoring_legacy (score_kaldi.sh's sweep with
lattice-mbr-decode, MBR within 0.5 points of the best path and 8 words
of JAX's; get_ctm.sh's chain and lattice-to-ctm-conf, every CTM's words
the 1-best's; lattice-determinize-phone-pruned and the rescoring
identity through lattice-lmrescore, -const-arpa and -pruned, every best
path kept, and lowered by its words' ARPA cost without the LM); after
template_gmm, mkgraph_template (the recipe's tri1
graph through the same steps, gmm-latgen-faster on the card, JAX's
0.000% and the in-process graph's words); kernels a-c launched 0 times
in each.

The other decoders over an HCLG: dense_flat (in this process, after
slice_viterbi: DenseViterbiDecoder over the V=64 flat graph on the same
loglikes, every lane's cost within 1e-4 of kernel c's decode and its
words equal, a tie reported), then the decoders group over the legacy
tool HCLG and the test utterances' nnet3-compute loglikes: dense_hclg
(DenseViterbiDecoder, no cost above latgen-faster-mapped's, the WER
within 0.5 points of tools/decoders_jax_bar.py's, 16 lanes bit-equal on
the CPU twin, no epsilon closure cut), beam_sparse_hclg
(BeamSparseDecoder exact, equal to dense_hclg, and at its defaults, the
WER held to JAX's; no traceback failure), lazy_lm
(nnet3-latgen-faster-lookahead over HCL composed on demand with G, its
WER held to JAX's; gmm-latgen-biglm-faster over the template tri1
system, old G = new G byte for byte gmm-latgen-faster's),
incremental (latgen-incremental-mapped's best paths against
latgen-faster-mapped's, online2-wav-nnet3-latgen-incremental, no
marker label leaked) and grammar (make-grammar-fst and
nnet3-latgen-grammar byte for byte nnet3-latgen-faster's), then
batched_cuda2 (batched-wav-nnet3-cuda2 over the HCLG, the .mdl and the
128 utterances: the WER within 0.5 points and 8 words of
tools/features_jax_bar.py's, RealTimeX, the card's busy ms; the -cuda
alias's lattices and batched-wav-nnet3-cuda-online's words as forwarding
checks); kernels a-c launched 0 times in each.

The rest of the feature front end (the features group, over the legacy
corpus's 128 test utterances): feats_offline (compute-{mfcc,fbank,
spectrogram,plp}-feats with and without --snip-edges, MFCC at 40/40: the
frames tools/features_jax_bar.py's, the card within the feature bars of
--use-gpu=no, device ms and launches a batch), feats_dither (a seed
twice equal, another different, within 1.0 of the undithered features,
the noise's mean and deviation), feats_pitch (make_mfcc_pitch.sh's
pipeline to copy-feats --compress=true, each pitch frame count and
column means the bar's, the compressed archive within the CM format's
step, OnlinePitchFeature in 0.25 s pieces against the offline output and
JAX's online figures) and cudafeat_tools (the i-vector tools equal to
BatchedIvectorExtractor; the feature and CMVN tools, which forward to the
plain ones, as forwarding checks); kernels a-c launched 0 times in
each.

The online2, xconfig and training phases (online2_graph to
xconfig_zoo, after a decode of the legacy test utterances on the int16
wire as slice_lex_int16's, then mkgraph_legacy and scoring_legacy;
train_lex to ng_precondition, then the generic corpus recipe with
mkgraph_template, the synthetic recipe and MMI; train_scale, then the
i-vector tools), the decoders group and the features group run in five
processes of their own on the same card (`--worker online2`, `--worker
train`, `--worker scale`, `--worker decoders`, `--worker features`) at a
lower host priority (nice 10; the decoders and features groups at nice 19
and 2 host threads), started once 3, 4 and slice_ng with profile_ng
are done, beside the rest of 5 and 6-7; their lines are printed when
they end, before 8.  The back ends and VTLN run in this process after
7, beside the workers.  The walls from ng_cpu_check on are measured
beside them.

Run: python3 chip_smoke.py   (needs CUDA; exits nonzero without it)
"""

from __future__ import annotations

import atexit
import bisect
import collections
import concurrent.futures
import contextlib
import copy
import ctypes
import gc
import io
import itertools
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from kaldi_tpu_torch.base import io_funcs
from kaldi_tpu_torch.chain.graphs import batch_pack, den_graph_from_fst_file
from kaldi_tpu_torch.chain.objective import (ChainTrainingOptions, InArcs,
                                             chain_loss, den_arcs)
from kaldi_tpu_torch.chain.supervision import alignment_to_phone_segments
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
from kaldi_tpu_torch.cli.lat_tools2 import compose_lattice_fst_op
from kaldi_tpu_torch.cli.nnet3_latgen_tools import _Forward, batch_loglikes
from kaldi_tpu_torch.cli.nnet3_tools import pad_batch
from kaldi_tpu_torch.decoder.batched_pipeline2 import (
    BatchedOfflinePipeline2, PipelineStats)
from kaldi_tpu_torch.decoder import batched_viterbi as tbv
from kaldi_tpu_torch.decoder.batched_viterbi import BatchedViterbi
from kaldi_tpu_torch.decoder.beam_sparse import (BeamSparseDecoder,
                                                 SparseDeviceGraph)
from kaldi_tpu_torch.decoder.block_chain import (BlockChainDecoder,
                                                 BlockChainGraph)
from kaldi_tpu_torch.decoder.dense_relax import (DenseDeviceGraph,
                                                 DenseViterbiDecoder)
from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                  synth_bigram, synth_lexicon,
                                                  to_dense_device_graph)
from kaldi_tpu_torch.decoder.graph import (TrainingGraphCompiler,
                                           add_lex_disambig,
                                           make_linear_word_acceptor)
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.decoder.lexchain import LexChainDecoder
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexDecoder
from kaldi_tpu_torch.decoder.native_viterbi import NativeViterbi
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.device import full_f32
from kaldi_tpu_torch.feat import functions as ff
from kaldi_tpu_torch.feat.frontend import (OfflineFeature, dither_noise,
                                           make_feature_computer,
                                           mulaw_encode)
from kaldi_tpu_torch.feat.pitch import compute_and_process_kaldi_pitch
from kaldi_tpu_torch.feat.wave import WaveData
from kaldi_tpu_torch.fstext.fst import Arc, LogWeight, VectorFst
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
from kaldi_tpu_torch.fstext.ops import compose
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.lm.arpa import parse_arpa
from kaldi_tpu_torch.lat import functions as latf
from kaldi_tpu_torch.nnet3 import mdl_io
from kaldi_tpu_torch.nnet3.egs import merged_minibatches
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax,
                                          chain_tdnnf_to_flax)
from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from kaldi_tpu_torch.nnet3.xconfig import (build_xconfig_model,
                                           chain_tdnnf_variables_to_xconfig,
                                           chain_tdnnf_xconfig, parse_xconfig,
                                           xconfig_from_flax)
from kaldi_tpu_torch.online.batched_device_pipeline import (
    BatchedDeviceOnlinePipeline, BatchedDeviceOnlinePipelineLex,
    BatchedDeviceOnlinePipelineNg, OnlineDynamicBatcher)
from kaldi_tpu_torch.online.decoding import OnlineEndpointConfig
from kaldi_tpu_torch.online.features import (OnlineFeature,
                                             OnlineFeaturePipeline,
                                             OnlinePitchFeature)
from kaldi_tpu_torch.ops import _build, kernel_launch_counts
from kaldi_tpu_torch.ops import block_chain_lattice_step as bcl
from kaldi_tpu_torch.ops import block_chain_step as bcs
from kaldi_tpu_torch.ops import viterbi_relax as vr
from kaldi_tpu_torch.parallel import optim
from kaldi_tpu_torch.parallel import trainer as ptrainer
from kaldi_tpu_torch.parallel.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.recipes import mono as tmono
from kaldi_tpu_torch.recipes import template_run, train_bench, train_scale
from kaldi_tpu_torch.recipes.bench_corpus import (
    BenchCorpusSpec, bench_scale_spec, build_decode_graph,
    build_decode_graph_ng, build_lang, chain_tm_tree_for, corpus_fingerprint,
    load_ivector_extractor, load_params, make_corpus, make_lexicon,
    make_text, mfcc_options, speaker_params, train_system, wer_of)
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.transform.fmllr import FmllrDiagGmmAccs
from kaldi_tpu_torch.transform.lda import LdaEstimate, LdaOptions
from kaldi_tpu_torch.transform.mllt import MlltAccs
from kaldi_tpu_torch.util.kaldi_io import (read_kaldi_object,
                                           write_kaldi_object)
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools"))
import mkgraph_steps  # noqa: E402  (tools/mkgraph_steps.py)

REPO = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()
ART = os.path.join(REPO, "egs", "bench_corpus")
SEED = 0
LANES, UTT_S, FS = 128, 5.0, 16000
# published device-memory rates (bytes/s) by card name; H100 SXM default
HBM_RATE = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12)]
FP32_OPS = 67e12          # H100 SXM float32 outside the tensor cores
LAT_J, LAT_BEAM = 4, 8.0
LN2 = float(np.log(2.0))
# the two decoders of cross_check round in different orders, so two paths
# whose float64 costs differ by less than this share of the cost are a tie
# that either may win
TIE_REL = 4e-6
# the main path's search, as bench.py main_scale runs it (bench.py:139-185):
# the trigram pruned at counts 2 and 3, a pool of 128 rows within a beam
# of 16
NG_LM_PRUNE = dict(prune_bi=2, prune_tri=3)
NG_SEARCH = dict(prune_k=128, prune_beam=16.0, exact_topk=False)
# the last recorded WER of that path (BENCH_r05.json: 1564 test words);
# the port's bar is this value within half a point: the record's search
# selected its pool approximately and its bf16 acoustic model ran on
# another device, so a few words may go either way
NG_WER, NG_WER_BAND = 9.34, 0.5
# lattice mode of the main path: the decoder's default pool of 128 rows a
# lane and frame (no beam); its lattice best paths are scored against
# decode_batch with that pool
NG_LAT_POOL = 128
# the block-chain lattice slice runs this many of the 128 lanes: its host
# assembly is the slowest phase of the script
BC_LAT_LANES = 32
# the profiler's marker of a launch that waited for a full launch queue
STALL = "Command Buffer Full"
# template_gmm: the fabricated corpus's train and test utterances, and the
# JAX package's run of egs/template/run.py stages 0-5 on it at the
# recipe's defaults, measured once on the CPU by tools/template_jax_bar.py
# (WER and word errors of the 128 test words, the HCLG's states and arcs,
# the (pdfs, Gaussians) of mono/final.mdl and tri1/final.mdl)
TEMPLATE_UTTS = (112, 32)
TEMPLATE_BAR = dict(wer=0.0, word_errors=0, hclg_states=424, hclg_arcs=1176,
                    mono=(17, 129), tri1=(16, 200))
TEMPLATE_WER_BAND, TEMPLATE_WORDS_BAND = 2.0, 3
# template_lda_sat: stages 6-7 of the same JAX run (tri2 LDA+MLLT, tri3
# SAT with the two-pass fMLLR decode: WER and word errors, the (pdfs,
# Gaussians) of tri2/final.mdl and tri3/final.mdl, final.mat's shape);
# the card's statistics against the CPU's, relative to their largest
# magnitude, and the tools' matrices against the in-process ones
TEMPLATE_LDA_SAT_BAR = dict(tri2=dict(wer=0.0, word_errors=0, pdfs=39,
                                      gaussians=108),
                            tri3=dict(wer=0.0, word_errors=0, pdfs=18,
                                      gaussians=74),
                            final_mat=(20, 66))
TEMPLATE_STATS_TOL, TEMPLATE_TOOLS_TOL = 1e-9, 1e-6
# template_chain_e2e: stage 8 of the JAX recipe over the same directory
# with --chain-epochs N (tools/template_jax_bar.py), by N; the smoke
# trains TEMPLATE_CHAIN_EPOCHS (PERF.md §6 says why not the smallest N
# whose WER is under 15%, 2)
TEMPLATE_CHAIN_BAR = {1: dict(wer=24.21875, word_errors=31),
                      2: dict(wer=14.84375, word_errors=19),
                      3: dict(wer=0.0, word_errors=0),
                      4: dict(wer=0.0, word_errors=0),
                      6: dict(wer=0.0, word_errors=0),
                      8: dict(wer=0.0, word_errors=0)}
TEMPLATE_CHAIN_EPOCHS = 4
TEMPLATE_CHAIN_WER_BAND = 5.0
# the n-gram decoder's blocks: four a frame, then the follow pass
NG_BLOCKS = ("_forward", "_lm_fold", "_expand", "_rows", "_roots",
             "_follow")
# online: the block-chain pipeline's chunk (the reference's default), the
# n-gram pipeline as egs/bench_corpus/measure_online_ng.py runs it, and
# the dynamic batcher's lanes
ONLINE_TC = 16
# slice_online's lanes that first stream a short utterance: how many, its
# first frame and its length
ONLINE_SHORT = (8, 100, 40)
NG_ONLINE = dict(chunk_frames=32, prune_k=128, prune_beam=16.0,
                 endpointing=True)
ONLINE_BATCH_LANES = 32
# the online pipeline's stages that slice_online_ng times, in a round of
# their own
STAGES = ("scorer", "_advance", "_endpoint_stats", "_traceback")
# the legacy path (bench.py --legacy): the default BenchCorpusSpec (V=200)
# and the committed flagship_params.npz TDNN-F, exact search.  Its bar is
# the JAX package's own output on the same corpus, measured once on the
# CPU by tools/legacy_jax_bar.py: the corpus fingerprint, and the WER and
# word errors of the 128 test utterances (1544 words) on the int16 wire.
# On the mu-law wire (bench.py's default) the JAX package's CPU output
# ends every lane with words decoded from pad frames (39.637% WER, the
# mu-law pad-frame divergence of ROADMAP.md section 3), so the WER of the
# mu-law calls is reported and the bar is held on the int16 wire
LEX_FINGERPRINT = "3e53478d13ee20fd"
LEX_WER, LEX_WORD_ERRORS = 6.023316062176166, 93
LEX_WER_BAND, LEX_WORDS_BAND = 0.5, 8
# the legacy decoder's blocks whose launches profile_lex counts
LEX_BLOCKS = ("_forward", "_follow")
# measure_online.py's configuration (--chunk 32, no endpointing), at 128
# lanes instead of its default 64 so that the WER covers every test word
LEX_ONLINE = dict(chunk_frames=32)
# lattice mode of the legacy decoder: its two frame loops, whose launches
# a frame profile_lex_lattice counts
LEX_LAT_BLOCKS = ("_forward_lattice", "_backward")
# lattice_functions: how many lattices of each lattice phase it runs, the
# determinization beam, and the lattice_scale / word penalty it applies
LATF_LANES, LATF_DET_BEAM = 8, 8.0
LATF_SCALE, LATF_PENALTY = (0.5, 0.08), 1.5
# the legacy training recipe (egs/bench_corpus/train.py main(), the port's
# recipes/train_bench.py) at full width: 8 epochs of the 17 x 1536 TDNN-F.
# Its bar is the JAX package's own run of the same recipe on the CPU,
# measured once by tools/legacy_train_jax_bar.py: the WER of the 128 test
# utterances decoded with the trained weights in bf16, as train_lex decodes
# them (99 word errors of 1544; 6.477%, 100 errors, with float32 weights),
# plus 2.0 points (the initial weights alone move it by more than a point:
# PERF.md)
TRAIN_EPOCHS = 8
# this script trains SMOKE_TRAIN_EPOCHS of them, with the same bars, to
# keep a margin under its time limit (6 epochs held the WER bar on an H100,
# 4 did not: PERF.md); the full 8 run under chip_main_path.py --train
SMOKE_TRAIN_EPOCHS = 6
TRAIN_JAX_WER, TRAIN_WER_BAND = 6.4119170984455955, 2.0
# the JAX package's chain objective a frame, each epoch's mean
TRAIN_JAX_EPOCH_OBJF = [0.9396, 1.4081, 1.4991, 1.545, 1.58, 1.6063,
                        1.621, 1.6331]
# train_lex_check: the utterances of its GMM and alignment checks, and the
# chunks of its one training step (one minibatch)
TRAIN_CHECK_UTTS, TRAIN_CHECK_CHUNKS = 8, 32
# the --scale training recipe (egs/bench_corpus/train.py main_scale, the
# port's recipes/train_scale.py) at full width: 16 epochs of
# the 17 x 1536 TDNN-F with i-vectors over the triphone tree, the test set
# decoded through the main path.  Its bar is the committed model's train
# WER (flagship_ng_meta.json: 9.53%, a TPU run with approximate selection)
# plus 2.0 points, train_lex's margin for other initial weights; beside it
# the committed model through the port's main path (slice_ng: 147 of 1564)
SCALE_EPOCHS = 16
# this script trains SMOKE_SCALE_EPOCHS of them, so that it keeps a margin
# under its time limit (train_scale is a third of its wall, and the host
# speed of a call moves the whole by a fifth); the full 16 run under
# chip_main_path.py --train-scale, with the same bars
SMOKE_SCALE_EPOCHS = 8
SCALE_META_WER, SCALE_WER_BAND = 9.53, 2.0
SCALE_COMMITTED_PORT_WER = 100.0 * 147 / 1564
SCALE_FINGERPRINT = "9fd542ef303e6a0d"
# train_scale_check: the real chunks of its gradient check
SCALE_CHECK_CHUNKS = 4
# Kaldi chain training through the command-line tools (cli/chain_tools.py,
# parallel/trainer.py) over train_lex's corpus, features, chain transition
# model, tree and alignments: the egs tools at their defaults (chunk 140,
# contexts 13, subsampling 3), nnet3-chain-train of the 17 x 1536 TDNN-F
# (bottleneck 160; prefinal 768 and the subsampling at layer 8 by the
# trainer's formula) at minibatch 32 for 4 epochs, compute-prob on a
# subset of 64 egs.  Its bar is the JAX package's own run of the same tools
# on the CPU, measured once by tools/chain_cli_jax_bar.py: the WER of the
# 128 test utterances decoded with the trained raw nnet, its BatchNorm
# statistics recomputed from the final weights as the port's trainer does
# (547 errors of 1544; 4721 with the moving averages the JAX trainer
# writes, ROADMAP §3), plus 2.0 points, train_lex's margin for other
# initial weights
CHAIN_CLI_WIDTHS = dict(hidden_dim=1536, bottleneck_dim=160, num_layers=17)
CHAIN_CLI_TRAIN = ["--hidden-dim=1536", "--bottleneck-dim=160",
                   "--num-layers=17", "--minibatch-size=32", "--num-epochs=4"]
CHAIN_CLI_SUBSET, CHAIN_CLI_MB = 64, 32
CHAIN_CLI_JAX_WER, CHAIN_CLI_WER_BAND = 100.0 * 547 / 1544, 2.0
# chain_cli_check: the egs of its one step; chain_cli_e2e: the test
# utterances of its flat-start egs
CHAIN_CLI_CHECK_EGS, CHAIN_CLI_E2E_UTTS = 4, 16
# nnet3_train_cli: the training utterances of its plain egs (about 3,500
# egs of 8 frames), nnet3-train's options and the egs compute-prob reads
NNET3_TRAIN_UTTS, NNET3_TRAIN_SUBSET = 64, 256
NNET3_TRAIN_ARGS = ["--hidden-dim=1536", "--bottleneck-dim=160",
                    "--num-epochs=1", "--minibatch-size=32"]
# Kaldi nnet3 models (nnet3/mdl_io.py, nnet3/torch_bridge.py, cli/): the
# reference C++ nnet3-compute output of tests/data/ref_golden (a 2-layer
# TDNN on 13-dim features with 2 frames of context each side, which
# nnet3-compute gave it by replicating the edge frames), within 1e-4
GOLDEN = os.path.join(REPO, "tests", "data", "ref_golden")
GOLDEN_PAD, GOLDEN_TOL = 2, 1e-4
# the flagship imported from a .mdl, scored as nnet3-compute-batch batches
# (32 lanes, zero-padded to a multiple of 8 frames) in float32 with TF32
# off: interior frames within 1e-3 of the native model, 2 lanes within
# 1e-3 of the host evaluator, and the WER of the subsampled output within
# half a point and 8 words of the main path's (slice_ng: 147 of 1564
# words; bf16 there, float32 here)
NNET3_BATCH, NNET3_TOL = 32, 1e-3
NNET3_WER, NNET3_WER_BAND, NNET3_WORDS_BAND = 100.0 * 147 / 1564, 0.5, 8
NNET3_CLI_UTTS, NNET3_HOST_LANES = 8, 2
# the recurrent graph: three fast-lstmp layers, each after a TDNN layer, at
# the widths of Kaldi's egs/swbd/s5c/local/chain/tuning/run_tdnn_lstm_1a.sh
# (TDNN 1024; cell 1024, recurrent and non-recurrent projections 256,
# delay -3), 40-dim input, 32 lanes x 500 frames
LSTM_SHAPE = dict(feat_dim=40, tdnn_dim=1024, cell_dim=1024, rec_proj=256,
                  nonrec_proj=256, delay=-3, layers=3, num_pdfs=2000)
LSTM_LANES, LSTM_FRAMES = 32, 500
# online2 serving (the online2-tcp-nnet3-decode-faster and
# online2-wav-nnet3-latgen-faster tools) over the legacy graph's flat form
# as an HCLG.fst and the legacy model as a .mdl: the first 16 test
# utterances of BenchCorpusSpec() on the int16 wire, the tools' default
# 180-ms chunks and the wav tool's default beam (its offline reference
# searches with the same), 16 clients of the server, 4 connections at a
# time.  The search is host Python (about 2 ms a frame on the CPU), so 16
# utterances keep the three phases near 150 s
ONLINE2_UTTS, ONLINE2_CONC, ONLINE2_CHUNK_S, ONLINE2_BEAM = 16, 4, 0.18, 15.0
# the i-vector tool chain (cli/ivector_tools.py) over the --scale corpus
# (384 training and 128 test utterances, 24 speakers round-robin) at the
# widths of Kaldi's chain recipes (steps/online/nnet2/train_diag_ubm.sh,
# sid/train_full_ubm.sh, train_ivector_extractor.sh): a 512-Gaussian UBM
# from 20 EM iterations on up to 500,000 frames, 4 diagonal and 4 full EM
# iterations, a 100-dim extractor with 10 iterations over 4 splits,
# online i-vectors every 10 frames; the sre v1 back end with a 23-dim LDA
# (the speakers less one).  IVECTOR_JAX_BAR is what tools/ivector_jax_bar.py
# printed for the same tools and options over the same corpus made and
# featurized by the JAX package on the CPU
IVECTOR_UBM = dict(num_gauss=512, init_iters=20, num_frames=500000,
                   diag_iters=4, full_iters=4)
IVECTOR_DIM, IVECTOR_ITERS, IVECTOR_SPLITS, IVECTOR_PERIOD = 100, 10, 4, 10
IVECTOR_LDA_DIM, IVECTOR_CHECK_UTTS = 23, 16
IVECTOR_JAX_BAR = dict(
    ubm_avg_loglike=dict(
        init=-106.75430435368402,
        diag1=-106.75077827173743,
        diag2=-106.74718219108262,
        diag3=-106.74390569078574,
        diag4=-106.74083743649867,
        full1=-103.05275161632117,
        full2=-102.66437771328539,
        full3=-102.46734563531993,
        full4=-102.34934363117807),
    eer_plda=31.4708, eer_dot=12.449,
    flagship_offline_gap=0.00020560555445570117,
    flagship_online_gap=0.010546028785690787,
    test_ivector_norm_mean=0.178918121088242,
    seconds=3680.6844349780004)
# bars: the UBM's log-likelihood a frame within 1e-3 of JAX's after every
# stage (the card's MFCC differs from JAX's by up to about 2e-3), each EER
# within two of the 128 target trials, the flagship's i-vectors within
# twice the gap JAX shows between its own host and batched extractors;
# card against CPU within 1e-9 of the largest element (statistics) and
# 1e-6 (i-vectors)
IVECTOR_LL_BAND, IVECTOR_EER_BAND = 1e-3, 100.0 * 2 / 128
IVECTOR_STATS_TOL, IVECTOR_IVEC_TOL = 1e-9, 1e-6


def emit(phase: str, **kw) -> None:
    """One JSON line of a phase; "t" is the seconds since this module
    was imported."""
    print(json.dumps({"phase": phase, **kw,
                      "t": time.perf_counter() - _T0}), flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    return 3.35e12


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of fn over `iters` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synth_wave(rng: np.random.Generator) -> np.ndarray:
    """UTT_S seconds of mu-law audio in the style of the corpus the
    acoustic model was trained on: a random run of two-formant phones
    (30 log-spaced (f1, f2) pairs, 70-120 ms each, a speaker warp and
    gain) in noise."""
    inventory = [(280.0 * 1.16 ** g, 1100.0 * 1.19 ** g * 1.06 ** m)
                 for g in range(10) for m in range(3)]
    warp, speaker_gain = rng.uniform(0.97, 1.03), rng.uniform(0.7, 1.3)
    n = int(FS * UTT_S)
    parts, total = [], 0
    while total < n:
        f1, f2 = inventory[rng.integers(len(inventory))]
        k = int((0.07 + 0.05 * rng.random()) * FS)
        t = np.arange(k) / FS
        gain = (0.75 + 0.5 * rng.random()) * speaker_gain
        tones = 1500 * np.sin(2 * np.pi * f1 * warp * t) \
            + 950 * np.sin(2 * np.pi * f2 * warp * t)
        ramp = np.minimum(1.0, np.minimum(np.arange(k), k - np.arange(k))
                          / (0.008 * FS))
        parts.append((gain * tones + 1600 * rng.normal(size=k)) * ramp)
        total += k
    x = np.concatenate(parts)[:n]
    return mulaw_encode(np.clip(x, -32767, 32767))


def step_inputs(dec: BlockChainDecoder, B: int, seed: int, n_inactive: int):
    """Seeded random planes with INF entries, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Up, N = dec.Up, dec.g.N

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def with_inf(x):
        mask = torch.rand(x.shape, generator=gen, device="cuda") < 0.2
        return x.masked_fill_(mask, bcs.INF)

    cost = with_inf(randn(Up, N, B) * 5 + 20)
    ovr = with_inf(randn(Up, B) * 5 + 15)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[B - n_inactive:] = False
    return (cost, ovr, randn(N, B), randn(N, B), dec._first,
            dec._bigram_ends, dec._end_src, active)


def lattice_step_inputs(dec: BlockChainDecoder, B: int, seed: int,
                        n_inactive: int, t: int, ties: bool = False):
    """The planes of step_inputs plus an entry-frame plane in [0, t].
    ties: every block holds the same columns and one bigram cost, so the
    candidates of a word meet at equal cost, and blocks 3 and 7 are
    lowered, so that smaller candidates displace entries of equal cost."""
    cost, ovr, amf, ams, first, bigram_ends, end_src, active = step_inputs(
        dec, B, seed, n_inactive)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    ent = torch.floor(torch.rand(cost.shape, generator=gen, device="cuda")
                      * (t + 1))
    if ties:
        cost[:] = cost[0].clone()
        ovr[:] = ovr[0].clone()
        for plane in (cost, ovr):
            plane[4:] += 1.0
            plane[3] -= 2.0
            plane[7] -= 5.0
        bigram_ends = torch.where(bigram_ends < bcs.INF, 1.25, bcs.INF)
    return (t, cost, ent, ovr, amf, ams, first, bigram_ends, end_src, active)


def step_cost(dec: BlockChainDecoder, B: int):
    """Bytes a best-path step must move (each input read once, each output
    written once) and the adds/compares it must do, at batch B."""
    Up, N, Vp = dec.Up, dec.g.N, dec.Vp
    plane = Up * N * B
    bytes_in = 4 * plane + 4 * Up * B + 2 * 4 * N * B + N + 4 * Up * Vp \
        + 4 * Vp + B
    bytes_out = 4 * plane + plane // 8 + 2 * 4 * Vp * B
    ops = 4 * plane + 2 * N * B + 2 * Up * Vp * B
    return bytes_in + bytes_out, ops


def lattice_step_cost(dec: BlockChainDecoder, B: int, J: int):
    """The same for a lattice step: two planes in, two out, three (J, Vp,
    B) lists out; two adds, a compare and two selects per state, an add
    and a compare per word-end candidate (the few insertions that follow
    a won compare are not counted)."""
    Up, N, Vp = dec.Up, dec.g.N, dec.Vp
    plane = Up * N * B
    bytes_in = 2 * 4 * plane + 4 * Up * B + 2 * 4 * N * B + N \
        + 4 * Up * Vp + 4 * Vp + B + 4
    bytes_out = 2 * 4 * plane + 3 * 4 * J * Vp * B
    ops = 5 * plane + 2 * N * B + 2 * Up * Vp * B
    return bytes_in + bytes_out, ops


def relax_inputs(arrays: dict, B: int, P: int, seed: int,
                 big_ll0: bool = False):
    """Seeded costs with INF entries and loglikes on the card, lanes
    fastest as the decoder keeps them, beside the tables of
    `BatchedViterbi._prepare` and their live counts.
    -> (emitting args, closure args, emitting counts, closure counts)."""
    tabs = {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()
            if k != "init_cost"}
    e_deg = vr.live_counts(arrays["e_in_src"], arrays["e_in_w"],
                           arrays["e_in_pdf"])
    ne_deg = vr.live_counts(arrays["ne_in_src"], arrays["ne_in_w"])
    S = tabs["e_in_src"].shape[-2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cost = torch.randn(S + 1, B, generator=gen, device="cuda") * 50 + 400
    cost.masked_fill_(torch.rand(cost.shape, generator=gen, device="cuda")
                      < 0.3, float(vr.INF))
    cost[S] = float(vr.INF)
    ll = torch.randn(P, B, generator=gen, device="cuda") * 4
    if big_ll0:
        ll[0] = 1e25
    emitting = (cost.T, tabs["e_in_src"], tabs["e_in_w"], tabs["e_in_pdf"],
                ll.T)
    return (emitting, (cost.T, tabs["ne_in_src"], tabs["ne_in_w"]),
            torch.as_tensor(e_deg, device="cuda"),
            torch.as_tensor(ne_deg, device="cuda"))


def relax_cost(args, in_deg=None):
    """Bytes a relaxation must move (each once) and its float operations
    (emitting: an add, a multiply and a subtraction a candidate; closure:
    an add a candidate and a min a state), from its arguments.  Without
    `in_deg`: the padded tables counted whole, as the first version walks
    them.  With it: what this table's data needs, the live slots (12 bytes
    each, 8 in a closure), the counts, and a candidate for every live slot
    and for one dead slot of every state that has one."""
    cost, in_src = args[0], args[1]
    B, S1 = cost.shape
    K = in_src.shape[-1]
    closure = len(args) == 3
    rows = 2 * 4 * B * S1 + (0 if closure else 4 * args[4].numel())
    per_lane = B if in_src.dim() == 2 else 1
    if in_deg is None:
        slots = walk = in_src.numel()
        table_bytes = 4 * slots * (2 if closure else 3)
    else:
        slots = int(in_deg.sum())
        walk = slots + int((in_deg < K).sum())
        table_bytes = 4 * slots * (2 if closure else 3) + 4 * in_deg.numel()
    cand = walk * per_lane
    ops = cand + B * (S1 - 1) if closure else 3 * cand
    return table_bytes + rows, ops


def degree_tables(S: int, K: int, P: int, seed: int) -> dict:
    """Seeded shared tables with a state whose K slots are all live (state
    0), a long walk that ends in a dead slot (state 1, 5K/8 in-arcs), a
    state without in-arc (the last) and 1-3 in-arcs elsewhere; an epsilon
    table with K/2 arcs into state 2."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(K, np.int64), np.ones(5 * K // 8, np.int64),
                          rng.integers(2, S - 1, 2 * S)])
    e = vr.build_incoming_table(S, rng.integers(0, S, len(dst)), dst,
                                rng.uniform(0.1, 3.0, len(dst)),
                                rng.integers(0, P, len(dst)))
    ne_dst = np.concatenate([np.full(K // 2, 2),
                             rng.integers(3, S - 1, S // 4)])
    ne = vr.build_incoming_table(S, rng.integers(0, S, len(ne_dst)), ne_dst,
                                 rng.uniform(0.1, 3.0, len(ne_dst)),
                                 np.zeros(len(ne_dst), np.int64))
    if e[3] != K:
        raise SystemExit(f"degree_tables: K={e[3]}, expected {K}")
    return {"e_in_src": e[0], "e_in_w": e[1], "e_in_pdf": e[2],
            "ne_in_src": ne[0], "ne_in_w": ne[1]}


def eps_fst(seed: int, n: int = 41) -> VectorFst:
    """A seeded random graph with an epsilon DAG (arcs to higher states
    only), for the closure mode of the relaxation kernel."""
    rng = np.random.default_rng(seed)
    fst = VectorFst()
    for _ in range(n):
        fst.add_state()
    fst.start = 0
    for s in range(n):
        fst.add_arc(s, Arc(int(rng.integers(1, 30)), 0,
                           float(rng.uniform(0.1, 2.0)), s))
        for d in rng.integers(0, n, 2):
            fst.add_arc(s, Arc(int(rng.integers(1, 30)), 0,
                               float(rng.uniform(0.1, 2.0)), int(d)))
        for d in rng.integers(s + 1, n, 2 if s + 1 < n else 0):
            if rng.random() < 0.5:
                fst.add_arc(s, Arc(0, int(rng.integers(0, 4)),
                                   float(rng.uniform(0.2, 1.5)), int(d)))
    fst.set_final(n - 1, 0.5)
    return fst


def flat_fsts(vocabs) -> list:
    """Flat graphs of small block-chain graphs of different sizes."""
    out = []
    for i, v in enumerate(vocabs):
        spec = DirectGraphSpec(vocab=v, num_phones=6, min_pron=1, max_pron=4,
                               num_pdfs=64, seed=10 + i)
        out.append(BlockChainGraph.build(
            synth_lexicon(spec), synth_bigram(spec),
            num_pdfs=64).to_flat_graph().to_vector_fst())
    return out


def timed_methods(obj, names, sink: dict) -> None:
    """Wrap obj's methods so that each call adds its seconds, the card's
    queued work included, to sink[name]."""
    for name in names:
        inner = getattr(obj, name)

        def wrapper(*args, _inner=inner, _name=name, **kw):
            t0 = time.perf_counter()
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            sink[_name] = sink.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(obj, name, wrapper)


def path_cost(g: BlockChainGraph, words, tids, loglikes: np.ndarray) -> float:
    """Float64 cost of a decoded path from its labels: LN2 an arc, the
    bigram cost of each word in the context of the one before, the
    end-of-sentence cost, and minus the loglike of each frame's pdf."""
    ctx = [g.V] + [w - 1 for w in words[:-1]]
    graph = len(tids) * LN2 + float(g.eos_cost[words[-1] - 1]) + sum(
        float(g.bigram[u, w - 1]) for u, w in zip(ctx, words))
    pdfs = g.tid2pdf[np.asarray(tids)]
    return graph - float(loglikes[np.arange(len(tids)), pdfs]
                         .astype(np.float64).sum())


def lane_subgraph(g: BlockChainGraph, flat, words) -> VectorFst:
    """The part of the flat graph that a word sequence runs through: the
    begin root, each word's root, and each word's chain rows in the block
    of the word before it.  States and arcs keep their order."""
    root0 = g.U * g.N
    keep = {root0 + g.V}
    u = g.V
    for word in words:
        w = word - 1
        e = int(g.end_row[w])
        if e >= 0:
            k = len(g.prons[w])
            keep.update(range(u * g.N + e - (k - 2), u * g.N + e + 1))
        keep.add(root0 + w)
        u = w
    states = np.array(sorted(keep))
    arcs = np.nonzero(np.isin(flat.src, states) & np.isin(flat.dst, states))[0]
    new_id = {int(s): i for i, s in enumerate(states)}
    fst = VectorFst()
    for _ in states:
        fst.add_state()
    fst.start = new_id[flat.start]
    for a in arcs:
        fst.add_arc(new_id[int(flat.src[a])],
                    Arc(int(flat.ilabel[a]), int(flat.olabel[a]),
                        float(flat.weight[a]), new_id[int(flat.dst[a])]))
    for s in states:
        if flat.finals[s] < vr.INF / 2:
            fst.set_final(new_id[int(s)], float(flat.finals[s]))
    return fst


def check_kernel(name: str, kernel, plain, names, args, label: str,
                 B: int, **kw) -> dict:
    """Hold one kernel launch against its plain version (torch.equal on
    every output); exits on a difference."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    equal = {n: bool(torch.equal(g, w)) for n, g, w in zip(names, got, want)}
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    row = {"shape": label, "B": B, "equal": equal, "max_abs_err": err}
    if not all(equal.values()):
        emit("kernel_check", ok=False, kernel=name, **row)
        raise SystemExit(f"{name} differs from its plain version at "
                         f"{label}: {equal}")
    return row


def check_relax(args, deg, label: str, lanes_a_thread: int, **kw) -> list:
    """One relaxation case against the plain version, torch.equal, through
    the live walk (`deg`) and through the first version, each in two
    output layouts: the wrapper's own (B, S) rows, and a lanes-fastest
    (B, S+1) row as the batched decoder passes it, filled with NaN
    before, whose dead column must come back as INF from an emitting step
    and as the old value from a closure step (the closure cases get a dead
    column of 7e29 to tell the two apart).  The wrapper is asked which
    instantiation each call takes: in the decoder's layout the live walk
    must take `lanes_a_thread` lanes a thread.  Exits on a difference."""
    closure = len(args) == 3
    cost, in_src, in_w = args[:3]
    in_pdf, ll = (None, None) if closure else args[3:5]
    B, S = cost.shape[0], cost.shape[1] - 1
    if closure:
        cost = cost.clone()                         # keeps the strides
        cost[:, S] = 7e29
        args = (cost, in_src, in_w)
    want = vr.relax_padded(*args, **kw)
    dead = cost[:, S] if closure else torch.full((B,), float(vr.INF),
                                                 device="cuda")
    rows = []
    for walk, in_deg, lanes in (("live", deg, lanes_a_thread),
                                ("all_slots", None, 0)):
        plan = vr.PreparedRelax(in_src, in_w, in_pdf, 1.0, in_deg)
        for layout in ("own_rows", "decoder_rows"):
            if layout == "own_rows":
                got = vr.viterbi_relax(*args, in_deg=in_deg, **kw)
                ran = plan.lanes_a_thread(cost, ll, got)
                equal = {"new": bool(torch.equal(got, want))}
                ran_ok = ran == min(lanes, 1)       # lanes are not fastest
            else:
                out = torch.full((S + 1, B), float("nan"), device="cuda").T
                got = vr.viterbi_relax(*args, out=out, in_deg=in_deg, **kw)
                ran = plan.lanes_a_thread(cost, ll, out)
                equal = {"new": bool(torch.equal(out[:, :S], want)),
                         "returned": bool(torch.equal(got, out[:, :S])),
                         "dead_column": bool(torch.equal(out[:, S], dead))}
                ran_ok = ran == lanes
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            row = {"shape": f"{label}/{walk}/{layout}", "B": B,
                   "equal": equal, "max_abs_err": err, "lanes_a_thread": ran}
            if not (all(equal.values()) and ran_ok):
                emit("kernel_check", ok=False, kernel="viterbi_relax", **row)
                raise SystemExit(
                    f"viterbi_relax at {row['shape']}: {equal}, {ran} lanes "
                    f"a thread (expected {lanes} in the decoder's layout)")
            rows.append(row)
    return rows


def time_kernel(name: str, kernel_once, plain_once, plain_iters: int,
                nbytes: int, nops: int, rate: float, shape) -> dict:
    """ms a launch by CUDA events (kernel, plain, kernel again) beside the
    bound from the bytes and operations of this run's shapes."""
    for _ in range(3):
        kernel_once()
    plain_once()
    torch.cuda.synchronize()
    k_ms = cuda_ms(kernel_once, 20)
    p_ms = cuda_ms(plain_once, plain_iters)
    k_ms_2 = cuda_ms(kernel_once, 20)
    bytes_ms, ops_ms = nbytes / rate * 1e3, nops / FP32_OPS * 1e3
    row = {"kernel": name, "shape": list(shape), "ms": k_ms,
           "ms_repeat": k_ms_2, "plain_ms": p_ms,
           "bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes, "ops": nops,
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "achieved_bytes_per_s": nbytes / (k_ms * 1e-3)}
    emit("kernel_time", **row)
    return row


def relax_all_slots(*args, in_deg=None, **kw):
    """The relaxation as the first version of the kernel made it: the live
    counts are dropped, every launch is fully checked."""
    return vr.viterbi_relax(*args, **kw)


def tables_identity(arrays: dict) -> bool:
    """Whether `BatchedViterbi._forward` will prove the closure step over
    these tables the identity and launch none."""
    return vr.closure_is_identity(
        arrays["ne_in_src"], arrays["ne_in_w"],
        vr.live_counts(arrays["ne_in_src"], arrays["ne_in_w"]),
        arrays["e_in_src"], arrays["e_in_w"],
        vr.live_counts(arrays["e_in_src"], arrays["e_in_w"],
                       arrays["e_in_pdf"]))


def graph_ms(fn, launches: int = 50, replays: int = 4) -> float:
    """Device ms per call of fn: CUDA events around replays of a captured
    CUDA graph of `launches` calls, so that no host time separates the
    launches (a kernel of ten microseconds is shorter than any wrapper)."""
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_ms(fn, iters: int = 200) -> float:
    """Host ms per call of fn by the host clock: the time to enqueue, the
    card's work not awaited (the queue is drained before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def time_relax(name: str, args, in_deg, rate: float, shape, **extra) -> dict:
    """One relaxation at `args`: the first version (all K slots) and the
    live walk in turns (old, new, new, old), device ms a launch under a
    replayed CUDA graph; the plain version by events; host ms of a launch
    through the fully checked call and through the prepared form; the
    padded and the live bound."""
    closure = len(args) == 3
    cost, in_src, in_w = args[:3]
    in_pdf, ll = (None, None) if closure else args[3:5]
    out = torch.empty((cost.shape[1], cost.shape[0]), device="cuda").T
    old = vr.PreparedRelax(in_src, in_w, in_pdf, 1.0)
    new = vr.PreparedRelax(in_src, in_w, in_pdf, 1.0, in_deg)
    before = vr.launches

    def old_once():
        old(cost, ll, out=out)

    def new_once():
        new(cost, ll, out=out)

    def full_checks_once():
        vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, 1.0, out=out)

    def plain_once():
        vr.relax_padded(cost, in_src, in_w, in_pdf, ll, 1.0)

    for fn in (old_once, new_once, plain_once):
        fn()
    torch.cuda.synchronize()
    lanes = new.lanes_a_thread(cost, ll, out)
    if lanes != (4 if in_src.dim() == 2 else 1):
        raise SystemExit(f"{name}: the timed live walk takes {lanes} lanes a "
                         "thread, not what the decoder's layout gives")
    ms = [graph_ms(fn) for fn in (old_once, new_once, new_once, old_once)]
    p_ms = cuda_ms(plain_once, 5)
    loop_ms = cuda_ms(new_once, 200)
    host = {"full_checks": host_ms(full_checks_once),
            "prepared": host_ms(new_once),
            "prepared_first_version": host_ms(old_once)}
    bounds = {}
    for key, deg in (("padded", None), ("live", in_deg)):
        nbytes, nops = relax_cost(args, deg)
        bytes_ms, ops_ms = nbytes / rate * 1e3, nops / FP32_OPS * 1e3
        bounds[key] = {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes,
                       "ops": nops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations"}
    row = {"kernel": name, "shape": list(shape), "lanes_a_thread": lanes,
           "clock": "device ms a launch: CUDA events around a replayed CUDA "
                    "graph of 50 launches on the same buffers",
           "first_version_ms": ms[0], "ms": ms[1], "ms_repeat": ms[2],
           "first_version_ms_repeat": ms[3],
           "speedup": (ms[0] + ms[3]) / (ms[1] + ms[2]),
           "events_around_a_loop_of_prepared_calls_ms": loop_ms,
           "host_ms_a_launch": host, "plain_ms": p_ms,
           "bound_ms": bounds["live"]["bound_ms"],
           "bound_by": bounds["live"]["bound_by"],
           "share_of_live_bound": bounds["live"]["bound_ms"] / ms[1],
           "first_version_share_of_padded_bound":
               bounds["padded"]["bound_ms"] / ms[0],
           "bounds": bounds, "launches_made": vr.launches - before, **extra}
    emit("kernel_time", **row)
    return row


def profile_call(fn, per_launch_of: str = "", top: int = 10,
                 ranges=(), cross_check: bool = False) -> dict:
    """Where one call spends the card's time: device time by kernel and
    by the torch op that launched it (the `top` largest), the number of
    kernel launches and peak memory.  per_launch_of: a kernel name (or
    part of one) whose mean device ms a launch is reported too.  ranges:
    names of `record_function` ranges whose device time (their kernels'
    and their children's) is reported.

    The tables come from the profiler's raw events in one pass
    (`event_tables`); torch's own event tree (`key_averages`, the events'
    children) takes about a minute to build for a call of 10^5 launches.
    `profiler_s` reports the seconds of the profiled call, of the
    profiler's stop and of the tables.  cross_check: also build the
    tables from torch's event tree (`key_average_tables`), time that,
    and fail unless both agree."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    fn()
    prof_wall = time.perf_counter() - t0
    prof.stop()
    t1 = time.perf_counter()
    out = event_tables(prof.profiler.kineto_results.events(), top, ranges)
    t2 = time.perf_counter()
    out = {"wall_s_profiled": prof_wall, **out,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profiler_s": {"call": prof_wall, "stop": t1 - t0 - prof_wall,
                          "tables": t2 - t1}}
    if cross_check:
        want = key_average_tables(prof, top, ranges)
        out["profiler_s"]["key_average_tables"] = time.perf_counter() - t2
        differ = tables_differ(out, want)
        emit("profile_cross_check", tables_differ=differ,
             profiler_s=out["profiler_s"],
             **{f"{key}_{side}": tables[key] for key in differ
                for side, tables in (("key_averages", want),
                                     ("raw_events", out))})
        if differ:
            raise SystemExit(f"profile_call: {differ} from the raw events "
                             "differ from torch's tables")
    if per_launch_of:
        hits = [(t["ms"], t["calls"]) for t in out.pop("by_kernel")
                if per_launch_of in t["name"]]
        if len(hits) != 1:
            raise SystemExit(f"{len(hits)} profiled kernels match "
                             f"{per_launch_of!r}")
        out["ms_per_launch"] = {per_launch_of: hits[0][0] / hits[0][1]}
    else:
        out.pop("by_kernel")
    return out


def same_tables(a, b, rel: float = 1e-6) -> bool:
    """Two profile tables equal, their float times within rel."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_tables(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same_tables(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-9
    return a == b


def tables_differ(raw: dict, tree: dict) -> list:
    """The tables of event_tables (raw) that differ from those of
    key_average_tables (tree) beyond event_tables' documented rule: an
    op's calls at least torch's."""
    out = []
    for key, want in tree.items():
        got = raw[key]
        if key == "by_op":
            ok = [x["op"] for x in got] == [x["op"] for x in want] and all(
                same_tables(x["ms"], y["ms"]) and x["calls"] >= y["calls"]
                for x, y in zip(got, want))
        else:
            ok = same_tables(got, want)
        if not ok:
            out.append(key)
    return out


def _ns(ev, which: str) -> int:
    """An event's start or duration in ns (older torch has only us)."""
    f = getattr(ev, f"{which}_ns", None)
    return f() if f is not None else getattr(ev, f"{which}_us")() * 1000


def event_tables(events, top: int, ranges=()) -> dict:
    """profile_call's tables from the profiler's raw (kineto) events:
    device events by name (device time, count), as torch's
    `key_averages` gives them; the CPU ops that launched kernels by name
    (the device time of the kernels linked to the op, the count of the
    op's calls); for each range, its host ms and calls, its span on the
    card, and the launches and device time of the kernels launched by
    the range or by an op inside it (the same thread, inside its
    interval).  As in torch's tables, a kernel counts once for each op
    event that carries its correlation id (a runtime marker such as
    cudaDeviceSynchronize may carry an op's), and a STALL marker's
    kernels are left out.  One rule of torch's event tree is not
    followed: it merges an op's only child of the same name into it (an
    op called through its out= variant counts one call there, two
    here)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    dev_ms, dev_n = collections.Counter(), collections.Counter()
    op_ms, op_n = collections.Counter(), collections.Counter()
    span_ms = collections.Counter()
    # correlation id -> [(name, start, thread)] of the op events carrying
    # it (a runtime marker may carry an op's id)
    ops = collections.defaultdict(list)
    spans = collections.defaultdict(list)   # range -> [(start, end, thread)]
    kernels = []                   # (duration ns, linked correlation id)
    for ev in events:
        name, dt = ev.name(), ev.device_type()
        # torch's rule: an asynchronous event has no device time of its
        # own, and no kernels are linked to it; it still counts as a call
        sync = not ev.is_async() and \
            ev.start_thread_id() == ev.end_thread_id()
        if dt == cuda:
            dur = _ns(ev, "duration")
            if name in ranges:
                span_ms[name] += dur / 1e6 if sync else 0.0
                continue
            dev_n[name] += 1
            dev_ms[name] += dur / 1e6 if sync else 0.0
            kernels.append((dur, ev.linked_correlation_id()))
        elif dt == cpu:
            op_n[name] += 1
            if name in ranges:
                start = _ns(ev, "start")
                spans[name].append((start, start + _ns(ev, "duration"),
                                    ev.start_thread_id()))
            if sync and ev.linked_correlation_id() == 0 and name != STALL:
                ops[ev.correlation_id()].append((name, _ns(ev, "start"),
                                                 ev.start_thread_id()))
    by_name = sorted(((ms, dev_n[k], k) for k, ms in dev_ms.items()
                      if ms > 0), reverse=True)
    out = {"device_ms": sum(ms for ms, _, _ in by_name),
           "copy_ms": sum(ms for ms, _, k in by_name if k.startswith("Mem")),
           "kernel_launches": sum(c for _, c, k in by_name
                                  if not k.startswith("Mem")),
           "top": [{"ms": ms, "calls": c, "name": k[:70]}
                   for ms, c, k in by_name[:top]],
           "by_kernel": [{"ms": ms, "calls": c, "name": k}
                         for ms, c, k in by_name]}
    linked = [(dur, ops[corr]) for dur, corr in kernels if corr in ops]
    for dur, owners in linked:
        for name, _, _ in owners:
            op_ms[name] += dur / 1e6
    by_op = sorted(((ms, op_n[k], k) for k, ms in op_ms.items()
                    if ms > 0 and k not in ranges), reverse=True)
    out["by_op"] = [{"ms": ms, "calls": c, "op": k[:60]}
                    for ms, c, k in by_op[:top]]
    if ranges:
        out["ranges"] = {}
        for name, ivs in spans.items():
            ivs.sort()
            starts = [a for a, _, _ in ivs]
            n, ns = 0, 0
            for dur, owners in linked:
                # ranges of one name do not nest: the latest start before
                # an owner's start is the only candidate
                for _, t, thread in owners:
                    i = bisect.bisect_right(starts, t) - 1
                    if i >= 0 and t <= ivs[i][1] and ivs[i][2] == thread:
                        n += 1
                        ns += dur
            out["ranges"][name] = {
                "host_ms": sum(b - a for a, b, _ in ivs) / 1e6,
                "calls": len(ivs), "device_ms": ns / 1e6,
                "kernel_launches": n}
            if name in span_ms:
                out["ranges"][name]["span_ms"] = span_ms[name]
    return out


def key_average_tables(prof, top: int, ranges=()) -> dict:
    """event_tables' tables built from torch's event tree (key_averages
    and the events' children), for profile_call's cross_check."""
    averages = prof.key_averages()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    by_name = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in averages
                      if e.device_type == cuda and e.key not in ranges
                      and e.self_device_time_total > 0), reverse=True)
    out = {"device_ms": sum(ms for ms, _, _ in by_name),
           "copy_ms": sum(ms for ms, _, k in by_name if k.startswith("Mem")),
           "kernel_launches": sum(c for _, c, k in by_name
                                  if not k.startswith("Mem")),
           "top": [{"ms": ms, "calls": c, "name": k[:70]}
                   for ms, c, k in by_name[:top]]}
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in averages
                  if e.device_type == cpu and e.key not in ranges
                  and e.key != STALL and e.self_device_time_total > 0),
                 reverse=True)
    out["by_op"] = [{"ms": ms, "calls": c, "op": k[:60]}
                    for ms, c, k in ops[:top]]
    if ranges:
        out["ranges"] = {e.key: {"host_ms": e.cpu_time_total / 1e3,
                                 "calls": e.count, "device_ms": 0.0,
                                 "kernel_launches": 0}
                         for e in averages
                         if e.device_type == cpu and e.key in ranges}
        for e in averages:
            if e.device_type == cuda and e.key in out["ranges"]:
                out["ranges"][e.key]["span_ms"] = e.device_time_total / 1e3

        def kernels(ev):
            """(launches, device us) under ev; a STALL marker repeats the
            kernels of the launch it delayed, so it is left out"""
            if ev.name == STALL:
                return 0, 0.0
            n, us = len(ev.kernels), sum(k.duration for k in ev.kernels)
            for child in ev.cpu_children:
                cn, cus = kernels(child)
                n, us = n + cn, us + cus
            return n, us

        for ev in prof.events():
            if ev.name in out["ranges"] and ev.device_type == cpu:
                n, us = kernels(ev)
                out["ranges"][ev.name]["kernel_launches"] += n
                out["ranges"][ev.name]["device_ms"] += us / 1e3
    return out


@contextlib.contextmanager
def each_call_inside(obj, names, around):
    """Inside the block, each call of one of obj's methods `names` runs
    inside the context manager around(name)."""
    for name in names:
        inner = getattr(obj, name)

        def wrapper(*args, _inner=inner, _name=name, **kw):
            with around(_name):
                return _inner(*args, **kw)

        setattr(obj, name, wrapper)
    try:
        yield
    finally:
        for name in names:
            delattr(obj, name)


@contextlib.contextmanager
def no_host_sync(_name=None):
    """Inside the block, anything that waits for the card raises
    (torch's sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def gc_pauses():
    """Inside the block, the garbage collector's collections are counted
    and timed: yields a dict whose collections, gen2 (full collections)
    and seconds grow as they happen."""
    log = {"collections": 0, "gen2": 0, "seconds": 0.0}
    start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
            return
        log["collections"] += 1
        log["gen2"] += info["generation"] == 2
        log["seconds"] += time.perf_counter() - start[0]

    gc.callbacks.append(on_gc)
    try:
        yield log
    finally:
        gc.callbacks.remove(on_gc)


def lattice_diff(got, want) -> float:
    """Largest weight difference between two lattices of equal structure
    (states, arc labels and next states); exits when the structure
    differs."""
    if (got is None) != (want is None):
        raise SystemExit("one lattice is None, the other is not")
    if got is None:
        return 0.0
    labels = [[[(a.ilabel, a.olabel, a.nextstate) for a in arcs]
               for arcs in lat.arcs] for lat in (got, want)]
    if got.start != want.start or labels[0] != labels[1]:
        raise SystemExit("two lattices differ in states or arc labels")
    pairs = [(a.weight, r.weight) for ga, wa in zip(got.arcs, want.arcs)
             for a, r in zip(ga, wa)]
    pairs += [(f, g) for f, g in zip(got.finals, want.finals) if f != g]
    return max((abs(x - y) for p, q in pairs for x, y in zip(p, q)),
               default=0.0)


def flagship_am():
    """The committed flagship_ng chain TDNN-F (17 x 1536, bf16) and
    i-vector extractor on the card, and the bench MFCC frontend.
    -> (config, flax variables, model, i-vector extractor, frontend)."""
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=32, num_pdfs=2000,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    variables = load_params(os.path.join(ART, "flagship_ng_params.npz"))
    model = chain_tdnnf_from_flax(cfg, variables, dtype=torch.bfloat16,
                                  device="cuda")
    ivec = BatchedIvectorExtractor(load_ivector_extractor(
        os.path.join(ART, "flagship_ng_ivec.npz")), device="cuda")
    fe = OfflineFeature(mfcc_options(bench_scale_spec()), device="cuda")
    return cfg, variables, model, ivec, fe


def reset_kernel_counts() -> None:
    bcs.launches = bcl.launches = vr.launches = 0


def build_ng_path() -> dict:
    """The main path's search: the bench corpus (V=20,000), its trigram
    LM (prune 2/3) x the committed triphone tree, the NgramLexGraph and
    its decoder on the card; the corpus fingerprint against the one
    recorded beside the committed model."""
    spec = bench_scale_spec()
    t0 = time.perf_counter()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    corpus_s = time.perf_counter() - t0
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    with open(os.path.join(ART, "flagship_ng_meta.json")) as f:
        meta = json.load(f)
    t0 = time.perf_counter()
    tm = read_kaldi_object(TransitionModel.read,
                           os.path.join(ART, "flagship_ng.tm"))
    tree = read_kaldi_object(ContextDependency.read,
                             os.path.join(ART, "flagship_ng.tree"))
    lang = build_lang(lexicon)
    graph = build_decode_graph_ng(lexicon, lm_text, tm, tree, lang=lang,
                                  **NG_LM_PRUNE)
    graph_s = time.perf_counter() - t0
    del lm_text
    t0 = time.perf_counter()
    dec = NgramLexDecoder(graph, device="cuda")
    torch.cuda.synchronize()
    lm = graph.lm
    emit("ng_graph", vocab=graph.V, states=graph.num_states,
         states_meta=meta["states"], units=graph.U, rows=graph.n_rows_true,
         Nr=graph.Nr, pair_states=lm.SP, bigrams=lm.num_explicit_bi,
         trigrams=lm.num_explicit_tri, VC=dec.VC,
         K=min(NG_SEARCH["prune_k"], dec.VC), fold_levels=len(
             dec._fold_levels), hist_inv=dec._hist_inv is not None,
         num_pdfs=graph.num_pdfs, corpus_fingerprint=fingerprint,
         meta_fingerprint=meta["corpus_hash"], corpus_s=corpus_s,
         graph_s=graph_s, decoder_s=time.perf_counter() - t0)
    if fingerprint != meta["corpus_hash"]:
        raise SystemExit(f"corpus fingerprint {fingerprint}, the committed "
                         f"model's {meta['corpus_hash']}")
    if graph.num_states != meta["states"]:
        raise SystemExit(f"{graph.num_states} graph states, the committed "
                         f"model's graph has {meta['states']}")
    return {"spec": spec, "lexicon": lexicon, "lang": lang, "tm": tm,
            "tree": tree, "test_txt": test_txt, "test_wav": test_wav,
            "graph": graph, "dec": dec}


def run_ng_slice(ng: dict, model, ivec, fe, cross_check: bool = False
                 ) -> dict:
    """slice_ng and profile_ng: the 128 bench test utterances on the
    mu-law wire through BatchedOfflinePipeline2 with the n-gram decoder
    (one warm-up, three timed calls; WER against the test text), then one
    call under the profiler (cross_check: its tables built from torch's
    event tree too, profile_call's).  None of kernels a-c is on this path:
    their counts must stay 0."""
    spec, graph, dec = ng["spec"], ng["graph"], ng["dec"]
    test_txt, test_wav = ng["test_txt"], ng["test_wav"]
    utts = sorted(test_wav)
    waves = [mulaw_encode(np.clip(test_wav[u], -32767, 32767))
             for u in utts]
    dec_stats: dict = {}
    pipe = BatchedOfflinePipeline2(
        model, dec, fe, sample_rate=spec.fs, ivector_extractor=ivec,
        search_kwargs=dict(NG_SEARCH, stats=dec_stats), device="cuda")
    n_words = sum(len(r) for r in test_txt.values())
    t0 = time.perf_counter()
    with each_call_inside(dec, ("_forward", "_follow"), no_host_sync):
        pipe.decode_batch(waves)                             # warm-up
    emit("ng_warmup", seconds=time.perf_counter() - t0,
         frame_loop_and_follow_pass_host_syncs=0)
    bucket = fe.stage_batch(waves)[3]
    T_out = -(-bucket // 3)
    runs, outs = [], None
    for it in range(3):
        stats = PipelineStats()
        reset_kernel_counts()
        outs = pipe.decode_batch(waves, stats=stats)
        hyps = {u: ([] if o is None else [graph.words[w] for w in o[0]])
                for u, o in zip(utts, outs)}
        wer = wer_of(hyps, test_txt)
        run = {"iter": it, "lanes_decoded": sum(o is not None for o in outs),
               "lanes": len(waves), "frames": T_out,
               "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
               "feat_s": stats.feat_s, "am_s": stats.am_s,
               "search_s": stats.search_s, "xrt": stats.xrt,
               "fwd_s": dec_stats["fwd_s"], "fol_s": dec_stats["fol_s"],
               "traceback_s": dec_stats["traceback_s"], "wer": wer,
               "word_errors": round(wer * n_words / 100.0),
               "ref_words": n_words, "wer_reference": NG_WER,
               "launches": kernel_launch_counts()}
        emit("slice_ng", **run)
        runs.append(run)
        if run["lanes_decoded"] != len(waves):
            raise SystemExit(f"only {run['lanes_decoded']}/{len(waves)} "
                             "lanes decoded")
        if any(run["launches"].values()):
            raise SystemExit("a kernel of another path ran in slice_ng")
        if not abs(wer - NG_WER) <= NG_WER_BAND:
            raise SystemExit(f"WER {wer:.2f}% is more than {NG_WER_BAND} "
                             f"points from {NG_WER}%")
    walls = sorted(r["wall_s"] for r in runs)
    with each_call_inside(dec, NG_BLOCKS, torch.profiler.record_function):
        prof = profile_call(lambda: pipe.decode_batch(waves), top=25,
                            ranges=NG_BLOCKS, cross_check=cross_check)
    blocks = prof["ranges"]
    emit("profile_ng", busy_share_of_median_wall=prof["device_ms"] / 1e3
         / walls[1], frames=T_out,
         launches_per_frame=blocks["_forward"]["kernel_launches"] / T_out,
         follow_launches_per_frame=blocks["_follow"]["kernel_launches"]
         / T_out, **prof)
    feats, nframes = fe.compute_batch_device(waves)
    loglikes, out_lens = pipe.loglikes(feats, nframes)
    return {"runs": runs, "outs": outs, "loglikes": loglikes,
            "out_lens": out_lens, "frames": T_out}


def ng_cpu_check(ng: dict, loglikes, out_lens, lanes: int = 4) -> None:
    """The same loglikes of `lanes` lanes through the port's n-gram
    decoder on the CPU and on the card: equal words and tids, costs
    within 1e-4 relative."""
    kw = dict(lengths=out_lens[:lanes], **NG_SEARCH)
    card = ng["dec"].decode_batch(loglikes[:lanes], **kw)
    t0 = time.perf_counter()
    cpu_dec = NgramLexDecoder(ng["graph"], device="cpu")
    host = cpu_dec.decode_batch(loglikes[:lanes].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    rel = max(abs(c[2] - h[2]) / max(1.0, abs(h[2]))
              for c, h in zip(card, host))
    same = [c[0] == h[0] and c[1] == h[1] for c, h in zip(card, host)]
    emit("ng_cpu_check", lanes=lanes, words_and_tids_equal=same,
         max_cost_rel_diff=rel, limit=1e-4, cpu_seconds=cpu_s,
         words_lane0=card[0][0][:12], cost_lane0=card[0][2])
    if not all(same) or not rel <= 1e-4:
        raise SystemExit("the n-gram decoder differs between the card and "
                         "the CPU")


def cross_check_ng(ng: dict, vocab: int = 30, lanes: int = 3,
                   frames: int = 24) -> None:
    """A V=30 graph from the committed transition model and tree (the
    first words of the bench lexicon, LM text of the same process): the
    port's n-gram decoder on the card with every virtual row in the pool
    (exact) against the host FasterDecoder on its to_flat_graph(), on
    seeded random loglikes.  Equal words and tids, costs within 1e-3 *
    max(1, |cost|) (float32 sums against float64)."""
    t0 = time.perf_counter()
    spec = bench_scale_spec(vocab=vocab, num_lm_sents=300, num_test=4)
    lexicon = make_lexicon(spec)
    text = make_text(spec, spec.num_lm_sents, spec.seed + 3)
    graph = build_decode_graph_ng(lexicon, text, ng["tm"], ng["tree"],
                                  lang=ng["lang"])
    dec = NgramLexDecoder(graph, device="cuda")
    flat = graph.to_flat_graph()
    host = FasterDecoder(flat.to_vector_fst(),
                         FasterDecoderOptions(beam=1e9, max_active=10 ** 9))
    rng = np.random.default_rng(SEED + 20)
    ll = rng.normal(size=(lanes, frames, graph.num_pdfs)).astype(np.float32)
    got = dec.decode_batch(ll)
    n_equal = 0
    for lane, h in enumerate(got):
        ref = host.decode(ll[lane], graph.tid2pdf)
        if h is None or ref is None:
            raise SystemExit(f"cross_check_ng lane {lane}: no path")
        if h[0] != ref[1] or h[1] != ref[0] or \
                abs(h[2] - ref[2]) > 1e-3 * max(1.0, abs(ref[2])):
            raise SystemExit(f"cross_check_ng lane {lane}: {h[0]} "
                             f"{h[2]} against the host's {ref[1]} {ref[2]}")
        n_equal += 1
    emit("cross_check_ng", vocab=graph.V, states=graph.num_states,
         units=graph.U, flat_arcs=flat.num_arcs, VC=dec.VC, K=dec.VC,
         lanes=lanes, frames=frames, lanes_equal=n_equal,
         words_lane0=got[0][0], seconds=time.perf_counter() - t0)


def run_ng_lattice(ng: dict, model, ivec, fe, loglikes, out_lens) -> dict:
    """slice_ng_lattice: the 128 bench test utterances through
    BatchedOfflinePipeline2 in lattice mode with the n-gram decoder (J=4,
    event_cap=64, prune_k=128, the decoder's defaults; lattice_beam=8),
    one warm-up and one timed call.  Each lane's lattice best path is
    scored against the test text, and against decode_batch with the same
    pool (prune_k=128, no beam) on the same loglikes.  None of kernels
    a-c is on this path: their counts must stay 0."""
    spec, graph, dec = ng["spec"], ng["graph"], ng["dec"]
    test_txt, test_wav = ng["test_txt"], ng["test_wav"]
    utts = sorted(test_wav)
    waves = [mulaw_encode(np.clip(test_wav[u], -32767, 32767))
             for u in utts]
    pipe = BatchedOfflinePipeline2(model, dec, fe, sample_rate=spec.fs,
                                   ivector_extractor=ivec, device="cuda")
    t0 = time.perf_counter()
    pipe.decode_batch(waves, generate_lattices=True,
                      lattice_beam=LAT_BEAM)                 # warm-up
    warm_s = time.perf_counter() - t0
    stats, lat_stats, host_s = PipelineStats(), {}, {}
    # the host assembly's two phases, summed over the lanes
    timed_methods(dec, ("_plan_lane", "_assemble_lane"), host_s)
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    outs = pipe.decode_batch(waves, stats=stats, generate_lattices=True,
                             lattice_beam=LAT_BEAM, lat_stats=lat_stats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_s = dict(host_s)
    launches = kernel_launch_counts()

    def words_of(hyps):
        return {u: ([] if h is None else [graph.words[w] for w in h[0]])
                for u, h in zip(utts, hyps)}

    t0 = time.perf_counter()
    pooled = dec.decode_batch(loglikes, lengths=out_lens,
                              prune_k=NG_LAT_POOL)
    pooled_s = time.perf_counter() - t0
    have = [o for o in outs if o is not None]
    wer_lat = wer_of(words_of(outs), test_txt)
    wer_pool = wer_of(words_of(pooled), test_txt)
    differ = [lane for lane, (o, h) in enumerate(zip(outs, pooled))
              if o is None or h is None or o[0] != h[0]]
    states = sorted(o[2].num_states for o in have)
    arcs = sorted(o[2].num_arcs() for o in have)
    run = {"lanes": len(waves), "lattices": len(have),
           "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
           "xrt": stats.xrt, "feat_s": stats.feat_s, "am_s": stats.am_s,
           "search_s": stats.search_s, "warmup_s": warm_s,
           "lat_stats": lat_stats, "plan_lane_s": host_s["_plan_lane"],
           "assemble_lane_s": host_s["_assemble_lane"],
           "peak_memory_gb": peak_gb,
           "states_median": states[len(states) // 2] if states else 0,
           "arcs_median": arcs[len(arcs) // 2] if arcs else 0,
           "wer_lattice_best_path": wer_lat, "wer_same_pool": wer_pool,
           "same_pool_decode_s": pooled_s, "lanes_words_differ": differ,
           "launches": launches}
    emit("slice_ng_lattice", **run)
    if any(launches.values()):
        raise SystemExit("a kernel of another path ran in slice_ng_lattice")
    if len(have) < 0.95 * len(waves):
        raise SystemExit(f"only {len(have)}/{len(waves)} lattices")
    if not abs(wer_lat - wer_pool) <= 0.5:
        raise SystemExit(f"lattice WER {wer_lat:.3f}% is more than 0.5 "
                         f"points from the same pool's {wer_pool:.3f}%")
    # the first lattices, for lattice_functions
    run["lattices"] = [o[2] for o in have[:LATF_LANES]]
    return run


def ng_lattice_cpu_check(ng: dict, loglikes, out_lens, lanes: int = 2
                         ) -> None:
    """ng_lattice_cpu_check: `lanes` lanes' loglikes through the n-gram
    decoder's lattice mode on the card and on the CPU.  The lattices must
    be equal in structure (states, start, arc labels and next states);
    weights and finals may differ by the rounding of the float64 prefix
    sums of the acoustic costs (the two devices sum in other orders): the
    bound is 1e-9 x max(1, the largest |prefix sum|)."""
    kw = dict(lengths=out_lens[:lanes], lattice_beam=LAT_BEAM)
    card = ng["dec"].decode_batch_lattice(loglikes[:lanes], **kw)
    t0 = time.perf_counter()
    cpu_dec = NgramLexDecoder(ng["graph"], device="cpu")
    host = cpu_dec.decode_batch_lattice(loglikes[:lanes].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    cs_max = float(torch.cumsum(-loglikes[:lanes].double(), 1).abs().max())
    bound = 1e-9 * max(1.0, cs_max)
    diff = max(lattice_diff(c, h) for c, h in zip(card, host))
    emit("ng_lattice_cpu_check", lanes=lanes, max_weight_diff=diff,
         bound=bound, max_abs_prefix_sum=cs_max, cpu_seconds=cpu_s,
         states=[None if c is None else c.num_states for c in card])
    if any(c is None for c in card):
        raise SystemExit("a lane of the CPU check has no lattice")
    if not diff <= bound:
        raise SystemExit("the n-gram lattices differ between the card and "
                         "the CPU")


def ms_percentiles(seconds) -> dict:
    """p50, p99 and max of a list of seconds, in ms (of 128 finalize
    calls the one that runs the follow pass is above p99)."""
    xs = np.asarray(seconds, np.float64) * 1e3
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(xs.max()),
            "n": int(xs.size)}


def gather_scorer(loglikes: torch.Tensor):
    """A chunk scorer over loglikes already on the card: each frame's
    features are (utterance, frame), and it returns that frame's row of
    `loglikes` (B, T, P), on the card."""
    def score(feats: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(feats.astype(np.int64)).to(loglikes.device)
        return loglikes[idx[..., 0], idx[..., 1]]
    return score


def frame_ids(utt: int, start: int, n: int) -> np.ndarray:
    """The (n, 2) features of gather_scorer: utterance, frame."""
    return np.stack([np.full(n, utt), np.arange(start, start + n)],
                    1).astype(np.float32)


def differing_lanes(got, want) -> list:
    """Lanes whose (words, tids, cost) differ."""
    return [i for i, (o, r) in enumerate(zip(got, want))
            if o is None or r is None or tuple(o) != tuple(r)]


def record_finalize(pipe, consumed: dict, seconds: list) -> None:
    """Wrap pipe.finalize so that consumed[utterance] gets the frames its
    lane decoded and each call's seconds go to `seconds`."""
    inner = pipe.finalize

    def finalize(lane):
        ch = pipe.channels[lane]
        t0 = time.perf_counter()
        out = inner(lane)
        seconds.append(time.perf_counter() - t0)
        consumed[ch.utterance_id] = ch.end_frame - ch.start_frame
        return out

    pipe.finalize = finalize


def word_errors(wer: float, test_txt: dict) -> int:
    return round(wer * sum(len(r) for r in test_txt.values()) / 100.0)


def online_schedule(pipes, out_lens: np.ndarray, compute) -> list:
    """Drive `pipes` (block-chain online pipelines over gather_scorer of
    the best-path slice's loglikes, one lane an utterance stream) in
    lockstep through slice_online's seeded schedule: pieces of 1-24
    frames, each lane idle in a round with probability 1/4; lanes below
    ONLINE_SHORT[0] first stream ONLINE_SHORT[2] of their own frames from
    ONLINE_SHORT[1], are finalized and freed mid-session, and are bound
    again by init_channel to their full utterance.  compute() runs one
    chunk on every pipe and returns the lanes advanced.  -> each pipe's
    results by utterance id ("b.0", then "b.1" for a rebound lane)."""
    n_short, short0, short_len = ONLINE_SHORT
    lanes = pipes[0].B
    plan = {b: ([(b, short0, short_len)] if b < n_short else [])
            + [(b, 0, int(out_lens[b]))] for b in range(lanes)}
    rng = np.random.default_rng(SEED + 30)
    results = [{} for _ in pipes]
    cursor = [0] * lanes
    for p in pipes:
        for b in range(lanes):
            p.init_channel(b, f"{b}.0")
    while any(plan.values()):
        for b in range(lanes):
            if not plan[b] or cursor[b] >= plan[b][0][2] or \
                    rng.random() < 0.25:
                continue
            u, s, n = plan[b][0]
            k = min(int(rng.integers(1, 25)), n - cursor[b])
            for p in pipes:
                p.accept_features(b, frame_ids(u, s + cursor[b], k))
            cursor[b] += k
        compute()
        for b in range(lanes):
            if not plan[b] or cursor[b] < plan[b][0][2]:
                continue
            if len(plan[b]) > 1:           # decoded: rebind mid-session
                if pipes[0].channels[b].pending:
                    continue
                for p, res in zip(pipes, results):
                    res[f"{b}.0"] = p.finalize(b)
                    p.free_channel(b)
                    p.init_channel(b, f"{b}.1")
            plan[b].pop(0)
            cursor[b] = 0
    while compute():
        pass
    for p, res in zip(pipes, results):
        for b in range(lanes):
            res[p.channels[b].utterance_id] = p.finalize(b)
            p.free_channel(b)
    return results


def run_slice_online(decoder: BlockChainDecoder, loglikes: torch.Tensor,
                     out_lens: np.ndarray) -> dict:
    """slice_online: kernel a in the online pattern.  The best-path
    slice's loglikes (128 lanes x 171 frames, V=700 graph) stream through
    BatchedDeviceOnlinePipeline in chunks of ONLINE_TC frames on
    online_schedule's seeded pieces, idle lanes and mid-session rebinds.
    Every result must equal decode_batch of the same loglikes; kernel a
    must launch Tc times a compute() that advanced.  Then the same
    schedule drives a kernel pipeline and a plain-step pipeline in
    lockstep at all 128 lanes: after every chunk their carries and the
    chunk's decisions must be equal, every result too, and the plain
    pipeline must launch the kernel 0 times."""
    lanes = loglikes.shape[0]
    n_short, short0, short_len = ONLINE_SHORT

    def online_pipe(dec):
        return BatchedDeviceOnlinePipeline(
            dec, gather_scorer(loglikes), feat_dim=2, num_lanes=lanes,
            chunk_frames=ONLINE_TC)

    pipe = online_pipe(decoder)
    fin_s: list = []
    record_finalize(pipe, {}, fin_s)
    chunk_s: list = []

    def timed_compute() -> int:
        t0 = time.perf_counter()
        n = pipe.compute()
        torch.cuda.synchronize()
        if n:
            chunk_s.append(time.perf_counter() - t0)
        return n

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t_start = time.perf_counter()
    results = online_schedule([pipe], out_lens, timed_compute)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = bcs.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del pipe
    torch.cuda.empty_cache()
    full = decoder.decode_batch(loglikes, lengths=out_lens)
    short = decoder.decode_batch(
        loglikes[:n_short, short0:short0 + short_len].contiguous())
    got = [results[f"{b}.{int(b < n_short)}"] for b in range(lanes)]
    differ = differing_lanes(got, full) + [
        lanes + i for i in differing_lanes(
            [results[f"{b}.0"] for b in range(n_short)], short)]
    # the same schedule again, kernel and plain step in lockstep
    kpipe = online_pipe(decoder)
    ppipe = online_pipe(BlockChainDecoder(
        decoder.g, device=decoder.device,
        step=bcs.block_chain_step_reference))
    plain = {"launches": 0, "chunks": 0, "chunks_differing": []}

    def both() -> int:
        n = kpipe.compute()
        before = bcs.launches
        m = ppipe.compute()
        plain["launches"] += bcs.launches - before
        if n or m:
            ky, py = kpipe._ys[-1], ppipe._ys[-1]
            if not (n == m and torch.equal(kpipe._cost, ppipe._cost)
                    and torch.equal(kpipe._ovr, ppipe._ovr)
                    and all(torch.equal(v, py[k]) for k, v in ky.items())):
                plain["chunks_differing"].append(plain["chunks"])
            plain["chunks"] += 1
        return n

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k_res, p_res = online_schedule([kpipe, ppipe], out_lens, both)
    plain_s = time.perf_counter() - t0
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del kpipe, ppipe
    torch.cuda.empty_cache()
    ids = sorted(results)
    plain_differ = [u for u in ids
                    if not results[u] == k_res[u] == p_res[u]]
    run = {"lanes": lanes, "chunk_frames": ONLINE_TC,
           "utterances": len(results), "compute_calls_advanced":
           len(chunk_s), "frames": ONLINE_TC * len(chunk_s),
           "wall_s": wall,
           "chunk_ms": ms_percentiles(chunk_s),
           "finalize_ms": ms_percentiles(fin_s),
           "peak_memory_gb": peak_gb,
           "launches": {"block_chain_step": launches},
           "launches_expected": ONLINE_TC * len(chunk_s),
           "lanes_differing_from_decode_batch": differ,
           "plain_lanes": lanes, "plain_chunks_compared": plain["chunks"],
           "plain_chunks_differing": plain["chunks_differing"],
           "plain_launches": plain["launches"],
           "plain_utterances_differing": plain_differ,
           "plain_lockstep_s": plain_s,
           "plain_lockstep_peak_memory_gb": plain_peak_gb,
           "words_lane0": got[0][0][:12], "cost_lane0": got[0][2]}
    emit("slice_online", **run)
    if launches != ONLINE_TC * len(chunk_s):
        raise SystemExit(f"block_chain_step launched {launches} times in "
                         f"{len(chunk_s)} chunks of {ONLINE_TC}")
    if differ or any(h is None for h in got):
        raise SystemExit(f"online lanes {differ} differ from decode_batch")
    if plain["chunks_differing"] or plain_differ or plain["launches"] or \
            plain["chunks"] != len(chunk_s):
        raise SystemExit("the plain step streams differently, or launched "
                         "the kernel")
    return run


def online_ng_pipe(ng: dict, scorer, feat_dim: int, lanes: int):
    return BatchedDeviceOnlinePipelineNg(
        ng["dec"], scorer, feat_dim=feat_dim, num_lanes=lanes,
        **NG_ONLINE)


def ng_words(graph, hyps) -> list:
    return [[] if h is None else [graph.words[w] for w in h[0]]
            for h in hyps]


def stacked_mfcc(fe, waves, sub: int = 3):
    """Each wave's MFCCs (float waves, as egs/bench_corpus/measure_online*.py
    compute them) stacked by `sub` to the model's output rate -> (the
    features on the card (B, T, D), nframes, the stacked rows of each
    lane as numpy (T // sub, sub * D))."""
    with torch.inference_mode():
        feats, nframes = fe.compute_batch_device(waves)
    host = feats.cpu().numpy()
    stacked = []
    for b, n in enumerate(nframes):
        T = (int(n) // sub) * sub
        stacked.append(host[b, :T].reshape(T // sub, sub * host.shape[2]))
    return feats, nframes, stacked


def online_rounds(pipe, utts, stacked, Tc: int) -> dict:
    """An online slice's three rounds through `pipe`, one lane an
    utterance, Tc stacked rows a lane and round: a warm-up, a timed round
    (chunk and finalize seconds, kernel launches, peak memory; the chunks
    the scorer produced are kept) and a staged round whose stages
    (STAGES) each end with a sync.  -> {"rounds": [{wall_s, chunks,
    chunk_s, fin_s, results}] x 3, "captured": [(am, act)] of the timed
    round, "stage_s", "launches", "peak_gb"}."""
    lanes = len(utts)
    captured: list = []
    stage_s: dict = {}
    rounds, launches, peak_gb = [], {}, 0.0
    for rnd in ("warm-up", "timed", "staged"):
        if rnd == "timed":
            advance = pipe._advance

            def capture(am, act, _inner=advance):
                captured.append((am, act))
                return _inner(am, act)

            pipe._advance = capture
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
        elif rnd == "staged":
            del pipe._advance
            launches = kernel_launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # a round apart from the timed one: the stages of a chunk and
            # of a result, each call ended by a sync: the scorer, the
            # frame loop, the endpoint statistics (two host reads a
            # chunk, with endpointing on) and the follow pass
            timed_methods(pipe, STAGES, stage_s)
        results, chunk_s, fin_s = [None] * lanes, [], []
        cursors = [0] * lanes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, u in enumerate(utts):
            pipe.init_channel(b, u)
        while True:
            fed = False
            for b in range(lanes):
                c = cursors[b]
                if c < len(stacked[b]):
                    pipe.accept_features(b, stacked[b][c:c + Tc])
                    cursors[b] += Tc
                    fed = True
            if not fed:
                break
            t1 = time.perf_counter()
            pipe.compute()
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t1)
        while pipe.compute():
            pass
        for b in range(lanes):
            t1 = time.perf_counter()
            results[b] = pipe.finalize(b)
            fin_s.append(time.perf_counter() - t1)
            pipe.free_channel(b)
        wall = time.perf_counter() - t0
        rounds.append({"wall_s": wall, "chunks": len(chunk_s),
                       "chunk_s": chunk_s, "fin_s": fin_s,
                       "results": results})
    return {"rounds": rounds, "captured": captured, "stage_s": stage_s,
            "launches": launches, "peak_gb": peak_gb}


def online_check(name: str, dec, graph, utts, test_txt, out: dict,
                 audio_s: float, run: dict, search: dict) -> dict:
    """The checks and numbers of an online slice after online_rounds:
    every lane of the timed round must equal decode_batch (with
    `search`) of the loglikes the scorer produced in it, concatenated per
    lane, the staged round must give the same results, and no kernel of
    another path may have launched.  `run` (the metric's own keys) is
    completed with xRT, chunk and finalize ms, WER and the rest, emitted
    as phase `name` and returned."""
    lanes = len(utts)
    # the loglikes the scorer produced, each lane's active frames in order
    am = torch.cat([a for a, _ in out["captured"]])         # (T, P, B)
    act = torch.cat([a for _, a in out["captured"]])        # (T, B)
    lens = act.sum(0).cpu().numpy()
    ll = torch.zeros((lanes, int(lens.max()), am.shape[1]),
                     device=dec.device)
    for b in range(lanes):
        ll[b, :int(lens[b])] = -am[act[:, b], :, b]
    del am, act
    out["captured"].clear()
    want = dec.decode_batch(ll, lengths=lens, **search)
    del ll
    rounds = out["rounds"]
    timed = rounds[1]
    results = timed["results"]
    differ = differing_lanes(results, want)
    wer = wer_of(dict(zip(utts, ng_words(graph, results))), test_txt)
    chunk = ms_percentiles(timed["chunk_s"])
    fin = ms_percentiles(timed["fin_s"])
    run.update({
        "value": audio_s / timed["wall_s"], "unit": "x realtime",
        "lanes": lanes, "states": graph.num_states, "vocab": graph.V,
        "chunk_ms_p50": chunk["p50"], "finalize_ms_p50": fin["p50"],
        "finalize_ms_p99": fin["p99"], "wer": wer,
        "decoded": sum(h is not None for h in results),
        "chunk_ms_p99": chunk["p99"], "chunk_ms_max": chunk["max"],
        "finalize_ms_max": fin["max"], "finalize_calls": fin["n"],
        "chunks": timed["chunks"], "audio_s": audio_s,
        "wall_s": timed["wall_s"], "warmup_wall_s": rounds[0]["wall_s"],
        "word_errors": word_errors(wer, test_txt),
        "peak_memory_gb": out["peak_gb"], "launches": out["launches"],
        "frames_scored": int(lens.sum()), "stage_s": out["stage_s"],
        "staged_wall_s": rounds[2]["wall_s"],
        "lanes_differing_from_decode_batch": differ,
        "staged_lanes_differing": differing_lanes(rounds[2]["results"],
                                                  results)})
    emit(name, **run)
    if differ or run["staged_lanes_differing"]:
        raise SystemExit(f"{name}: lanes {differ} differ from decode_batch "
                         "of the scorer's loglikes, or between rounds")
    if run["decoded"] != lanes:
        raise SystemExit(f"{name}: only {run['decoded']}/{lanes} lanes "
                         "decoded")
    if any(out["launches"].values()):
        raise SystemExit(f"a kernel of another path ran in {name}")
    return run


def run_online_ng(ng: dict, model, ivec, fe) -> dict:
    """slice_online_ng: the production online configuration as
    egs/bench_corpus/measure_online_ng.py runs it, at 128 lanes.  The
    128 test utterances' MFCCs (float waves, as that script computes
    them) stacked by 3 to the model's output rate, fed 32 output frames a
    lane and round; the flagship TDNN-F (bf16) scores each chunk of 96
    input frames with each lane's utterance i-vector (extract_batch, with
    the lanes' frame counts); BatchedDeviceOnlinePipelineNg over the
    495,782-state graph (pool 128, beam 16, endpointing on).  A warm-up
    round, a timed one (xRT, chunk and finalize latency, WER), and a
    staged one whose stage seconds end each call with a sync.  Every lane
    of the timed round must equal decode_batch (same pool) of the
    loglikes the scorer produced in it, concatenated per lane, and the
    staged round must give the same results."""
    graph, dec = ng["graph"], ng["dec"]
    utts = sorted(ng["test_wav"])
    lanes, Tc = len(utts), NG_ONLINE["chunk_frames"]
    sub = 3
    waves = [np.asarray(ng["test_wav"][u], np.float32) for u in utts]
    feats, nframes, stacked = stacked_mfcc(fe, waves, sub)
    with torch.inference_mode():
        ivecs = ivec.extract_batch(feats, nframes).to(torch.bfloat16)
    D = feats.shape[2]
    del feats

    def scorer(chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(chunk).to(dec.device).view(lanes, Tc * sub,
                                                         D)
        return model.chain(x, ivecs).to(torch.float32)

    pipe = online_ng_pipe(ng, scorer, sub * D, lanes)
    out = online_rounds(pipe, utts, stacked, Tc)
    # the keys of measure_online_ng.py's JSON line (unrounded), then more
    return online_check(
        "slice_online_ng", dec, graph, utts, ng["test_txt"], out,
        sum(len(f) for f in stacked) * 0.03,
        {"metric": "online_ng_pipeline_aggregate_xRT", "chunk_frames": Tc,
         "endpointing": True},
        dict(prune_k=NG_ONLINE["prune_k"],
             prune_beam=NG_ONLINE["prune_beam"]))


def run_online_stream_offline(ng: dict, loglikes: torch.Tensor,
                              out_lens: np.ndarray, outs: list,
                              slice_ng_errors: int) -> dict:
    """online_ng_stream_offline: the main path's own loglikes (slice_ng's)
    streamed 32 frames a lane and round through the online n-gram
    pipeline, the scorer returning each slice: every lane's words and
    cost must equal slice_ng's, and so its WER."""
    graph, test_txt = ng["graph"], ng["test_txt"]
    utts = sorted(ng["test_wav"])
    lanes, Tc = len(utts), NG_ONLINE["chunk_frames"]
    pipe = online_ng_pipe(ng, gather_scorer(loglikes), 2, lanes)
    reset_kernel_counts()
    t0 = time.perf_counter()
    for b, u in enumerate(utts):
        pipe.init_channel(b, u)
    for c in range(0, int(out_lens.max()), Tc):
        for b in range(lanes):
            n = min(Tc, int(out_lens[b]) - c)
            if n > 0:
                pipe.accept_features(b, frame_ids(b, c, n))
        pipe.compute()
    while pipe.compute():
        pass
    results = [pipe.finalize(b) for b in range(lanes)]
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts()
    for b in range(lanes):
        pipe.free_channel(b)
    differ = [b for b, (h, o) in enumerate(zip(results, outs))
              if h is None or o is None or (h[0], h[2]) != tuple(o)]
    wer = wer_of(dict(zip(utts, ng_words(graph, results))), test_txt)
    errors = word_errors(wer, test_txt)
    emit("online_ng_stream_offline", lanes=lanes, chunk_frames=Tc,
         wall_s=wall, wer=wer, word_errors=errors,
         slice_ng_word_errors=slice_ng_errors, launches=launches,
         lanes_differing_from_slice_ng=differ)
    if differ or errors != slice_ng_errors:
        raise SystemExit(f"streaming the main path's loglikes differs from "
                         f"slice_ng in lanes {differ}")
    if any(launches.values()):
        raise SystemExit("a kernel of another path ran in "
                         "online_ng_stream_offline")
    return {"wall_s": wall, "wer": wer}


def run_online_batcher(ng: dict, loglikes: torch.Tensor,
                       out_lens: np.ndarray) -> dict:
    """online_batcher_ng: the 128 utterances' offline loglikes through
    OnlineDynamicBatcher on 32 lanes (default OnlineEndpointConfig,
    frame_shift 0.03 s): lanes finalize on an endpoint or at the end of
    their input and are bound again to the next utterance mid-stream.
    Every utterance must get a result equal to decode_batch of the frames
    its lane consumed (the whole utterance, or its prefix up to the
    endpoint)."""
    graph, test_txt = ng["graph"], ng["test_txt"]
    utts = sorted(ng["test_wav"])
    pipe = online_ng_pipe(ng, gather_scorer(loglikes), 2,
                          ONLINE_BATCH_LANES)
    consumed: dict = {}
    fin_s: list = []
    record_finalize(pipe, consumed, fin_s)
    trims, windows = [], []
    trim = pipe._trim_committed

    def counted_trim():
        before = pipe._total_frames
        trim()
        windows.append(pipe._total_frames)
        if pipe._total_frames < before:
            trims.append(before - pipe._total_frames)

    pipe._trim_committed = counted_trim
    batcher = OnlineDynamicBatcher(pipe, OnlineEndpointConfig(),
                                   frame_shift=0.03)
    for b, u in enumerate(utts):
        batcher.push(u, frame_ids(b, 0, int(out_lens[b])))
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    results = batcher.run()
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts()
    lens = np.array([consumed.get(u, 0) for u in utts])
    got = [results.get(u) for u in utts]
    want = ng["dec"].decode_batch(loglikes, lengths=lens,
                                  prune_k=NG_ONLINE["prune_k"],
                                  prune_beam=NG_ONLINE["prune_beam"])
    differ = differing_lanes(got, want)
    n_ep = sum(batcher.endpointed.values())
    wer = wer_of(dict(zip(utts, ng_words(graph, got))), test_txt)
    emit("online_batcher_ng", lanes=ONLINE_BATCH_LANES,
         utterances=len(utts), results=sum(h is not None for h in got),
         endpointed=n_ep, frames_cut_by_endpoints=int(
             (out_lens[:len(utts)] - lens).sum()),
         wer=wer, wall_s=wall, finalize_ms=ms_percentiles(fin_s),
         finalize_s=sum(fin_s), trims=len(trims),
         frames_trimmed=int(sum(trims)),
         max_window_frames=max(windows), max_frames=pipe.max_frames,
         launches=launches, lanes_differing_from_decode_batch=differ)
    if len(results) != len(utts) or any(h is None for h in got):
        raise SystemExit("an utterance of the batcher has no result")
    if differ:
        raise SystemExit(f"batcher results {differ} differ from the decode "
                         "of the frames their lanes consumed")
    if not trims:
        raise SystemExit("the batcher's session never trimmed its history")
    if any(launches.values()):
        raise SystemExit("a kernel of another path ran in online_batcher_ng")
    return {"wall_s": wall, "wer": wer, "endpointed": n_ep}


def build_lex_path() -> dict:
    """The legacy path's search: the default BenchCorpusSpec corpus
    (V=200, no training audio), the chain system of chain_tm_tree_for,
    the LexChainGraph of build_decode_graph and its decoder on the card;
    the corpus fingerprint against the JAX package's."""
    spec = BenchCorpusSpec()
    t0 = time.perf_counter()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    corpus_s = time.perf_counter() - t0
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    t0 = time.perf_counter()
    lang, tm, tree = chain_tm_tree_for(lexicon)
    graph = build_decode_graph(lexicon, lm_text, tm, tree, lang=lang)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = LexChainDecoder(graph, device="cuda")
    torch.cuda.synchronize()
    emit("lex_graph", vocab=graph.V, N=graph.N, rows=graph.n_true,
         P=graph.P, states=graph.num_states,
         explicit_bigrams=graph.lm.num_explicit, num_pdfs=graph.num_pdfs,
         tm_pdfs=tm.num_pdfs, dense_corrections=dec._use_dense_corr,
         dense_table=list(dec._srcw_tab.shape), buckets=len(dec._buckets),
         variants_a_word=dec._maxvar, VC=dec.VC,
         corpus_fingerprint=fingerprint,
         jax_cpu_fingerprint=LEX_FINGERPRINT, corpus_s=corpus_s,
         graph_s=graph_s, decoder_s=time.perf_counter() - t0)
    if fingerprint != LEX_FINGERPRINT:
        raise SystemExit(f"corpus fingerprint {fingerprint}, the JAX "
                         f"package's {LEX_FINGERPRINT}")
    return {"spec": spec, "lexicon": lexicon, "tm": tm,
            "test_txt": test_txt, "test_wav": test_wav, "graph": graph,
            "dec": dec}


def legacy_am(lex: dict):
    """The committed legacy TDNN-F, flagship_params.npz (17 x 1536,
    bottleneck 160, 50 pdfs, no i-vectors) in bf16 on the card, and the
    40-cepstra MFCC frontend, as bench.py main_legacy builds them."""
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0,
                           num_pdfs=lex["tm"].num_pdfs, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8,
                           frame_subsampling_factor=3)
    model = chain_tdnnf_from_flax(
        cfg, load_params(os.path.join(ART, "flagship_params.npz")),
        dtype=torch.bfloat16, device="cuda")
    fe = OfflineFeature(mfcc_options(lex["spec"], num_ceps=40),
                        device="cuda")
    return model, fe


def lex_words(lex: dict, utts, outs) -> dict:
    return {u: ([] if o is None else [lex["graph"].words[w] for w in o[0]])
            for u, o in zip(utts, outs)}


def run_lex_slice(lex: dict, model, fe) -> dict:
    """slice_lex and profile_lex: the 128 test utterances through
    BatchedOfflinePipeline2 with the LexChain decoder, exact search, as
    bench.py --legacy runs it (mu-law wire): one warm-up with no host
    sync allowed in the frame loop or the follow pass, three timed calls
    (wall, xRT, the feat/am/search split, the decoder's
    fwd_s/fol_s/traceback_s, peak memory, lanes decoded, WER; none of
    kernels a-c may launch), one call under the profiler (launches a
    frame); then the same utterances on the int16 wire, whose WER is held
    to the JAX package's CPU WER; and one pruned decode with every
    virtual-context row in the pool, equal to the exact one."""
    spec, graph, dec = lex["spec"], lex["graph"], lex["dec"]
    test_txt, test_wav = lex["test_txt"], lex["test_wav"]
    utts = sorted(test_wav)
    clipped = [np.clip(test_wav[u], -32767, 32767) for u in utts]
    waves = [mulaw_encode(w) for w in clipped]
    dec_stats: dict = {}
    pipe = BatchedOfflinePipeline2(model, dec, fe, sample_rate=spec.fs,
                                   search_kwargs={"stats": dec_stats},
                                   device="cuda")
    n_words = sum(len(r) for r in test_txt.values())
    t0 = time.perf_counter()
    with each_call_inside(dec, LEX_BLOCKS, no_host_sync):
        pipe.decode_batch(waves)                             # warm-up
    emit("lex_warmup", seconds=time.perf_counter() - t0,
         frame_loop_and_follow_pass_host_syncs=0)
    bucket = fe.stage_batch(waves)[3]
    T_out = -(-bucket // 3)
    runs = []
    for it in range(3):
        stats = PipelineStats()
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        outs = pipe.decode_batch(waves, stats=stats)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wer = wer_of(lex_words(lex, utts, outs), test_txt)
        run = {"iter": it, "wire": "mulaw",
               "lanes_decoded": sum(o is not None for o in outs),
               "lanes": len(waves), "frames": T_out,
               "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
               "feat_s": stats.feat_s, "am_s": stats.am_s,
               "search_s": stats.search_s, "xrt": stats.xrt,
               "fwd_s": dec_stats["fwd_s"], "fol_s": dec_stats["fol_s"],
               "traceback_s": dec_stats["traceback_s"],
               "peak_memory_gb": peak_gb, "wer": wer,
               "word_errors": round(wer * n_words / 100.0),
               "ref_words": n_words, "launches": kernel_launch_counts()}
        emit("slice_lex", **run)
        runs.append(run)
        if run["lanes_decoded"] != len(waves):
            raise SystemExit(f"only {run['lanes_decoded']}/{len(waves)} "
                             "lanes decoded")
        if any(run["launches"].values()):
            raise SystemExit("a kernel of another path ran in slice_lex")
    walls = sorted(r["wall_s"] for r in runs)
    with each_call_inside(dec, LEX_BLOCKS, torch.profiler.record_function):
        prof = profile_call(lambda: pipe.decode_batch(waves), top=15,
                            ranges=LEX_BLOCKS)
    blocks = prof["ranges"]
    emit("profile_lex", busy_share_of_median_wall=prof["device_ms"] / 1e3
         / walls[1], frames=T_out,
         launches_per_frame=blocks["_forward"]["kernel_launches"] / T_out,
         follow_launches_per_frame=blocks["_follow"]["kernel_launches"]
         / T_out, **prof)
    # the bar: the int16 wire against the JAX package's CPU output
    reset_kernel_counts()
    stats = PipelineStats()
    outs16 = pipe.decode_batch([w.astype(np.int16) for w in clipped],
                               stats=stats)
    wer16 = wer_of(lex_words(lex, utts, outs16), test_txt)
    errors16 = round(wer16 * n_words / 100.0)
    emit("slice_lex_int16", wer=wer16, word_errors=errors16,
         jax_cpu_wer=LEX_WER, jax_cpu_word_errors=LEX_WORD_ERRORS,
         band_points=LEX_WER_BAND, band_words=LEX_WORDS_BAND,
         lanes_decoded=sum(o is not None for o in outs16),
         wall_s=stats.wall_s, xrt=stats.xrt,
         launches=kernel_launch_counts(),
         mulaw_wer=runs[-1]["wer"])
    if sum(o is not None for o in outs16) != len(waves):
        raise SystemExit("a lane of the int16 call has no result")
    if not (abs(wer16 - LEX_WER) <= LEX_WER_BAND
            and abs(errors16 - LEX_WORD_ERRORS) <= LEX_WORDS_BAND):
        raise SystemExit(f"int16 WER {wer16:.3f}% ({errors16} errors) is "
                         f"more than {LEX_WER_BAND} points or "
                         f"{LEX_WORDS_BAND} words from the JAX package's "
                         f"{LEX_WER:.3f}% ({LEX_WORD_ERRORS})")
    if any(kernel_launch_counts().values()):
        raise SystemExit("a kernel of another path ran in slice_lex_int16")
    # every virtual-context row in the pool: the exact search's candidates
    feats, nframes = fe.compute_batch_device(waves)
    loglikes, out_lens = pipe.loglikes(feats, nframes)
    exact = dec.decode_batch(loglikes, lengths=out_lens)
    t0 = time.perf_counter()
    full = dec.decode_batch(loglikes, lengths=out_lens, prune_k=dec.VC)
    full_s = time.perf_counter() - t0
    differ = [b for b, (f, e) in enumerate(zip(full, exact))
              if f is None or e is None or f[:2] != e[:2]
              or abs(f[2] - e[2]) > 1e-4 * max(1.0, abs(e[2]))]
    emit("lex_pruned_full_k", K=dec.VC, lanes=len(full), seconds=full_s,
         lanes_differing_from_exact=differ,
         lanes_differing_from_slice=[
             b for b, (e, o) in enumerate(zip(exact, outs))
             if e is None or o is None or e[0] != o[0]])
    if differ:
        raise SystemExit(f"pruned search with every row in the pool "
                         f"differs from exact in lanes {differ}")
    return {"runs": runs, "loglikes": loglikes, "out_lens": out_lens,
            "frames": T_out, "wer_int16": wer16, "errors_int16": errors16,
            "words_int16": lex_words(lex, utts, outs16), "profile": prof}


def lex_cpu_check(lex: dict, loglikes, out_lens, lanes: int = 4) -> None:
    """The same loglikes of `lanes` lanes through the LexChain decoder on
    the CPU and on the card: equal words and tids, costs within 1e-4
    relative."""
    kw = dict(lengths=out_lens[:lanes])
    card = lex["dec"].decode_batch(loglikes[:lanes], **kw)
    t0 = time.perf_counter()
    host = LexChainDecoder(lex["graph"], device="cpu").decode_batch(
        loglikes[:lanes].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    rel = max(abs(c[2] - h[2]) / max(1.0, abs(h[2]))
              for c, h in zip(card, host))
    same = [c[0] == h[0] and c[1] == h[1] for c, h in zip(card, host)]
    emit("lex_cpu_check", lanes=lanes, words_and_tids_equal=same,
         max_cost_rel_diff=rel, limit=1e-4, cpu_seconds=cpu_s,
         words_lane0=card[0][0][:12], cost_lane0=card[0][2])
    if not all(same) or not rel <= 1e-4:
        raise SystemExit("the LexChain decoder differs between the card "
                         "and the CPU")


def run_lex_lattice(lex: dict, model, fe) -> dict:
    """slice_lex_lattice and profile_lex_lattice: the 128 test
    utterances (mu-law wire) through BatchedOfflinePipeline2 in lattice
    mode with the LexChain decoder, as bench.py --legacy --with-lattices
    runs it (J=4, lattice_beam=8): one warm-up with no host sync allowed
    in the forward or the backward frame loop, one timed call (wall,
    xRT, the feat/am/search split, the decoder's stats, the host seconds
    of _assemble_lane summed over the lanes, peak memory, lattices,
    median states and arcs, the best paths' WER; none of kernels a-c may
    launch).  Each lane's lattice best path must be decode_batch's on the
    loglikes the call scored: equal words, cost within 1e-4 relative (the
    search is exact, so one lane that differs is a fault).  Then one
    decode_batch_lattice under the profiler: launches a frame of each
    loop.  The timed call also reports the garbage collector's pauses
    inside it.  -> the numbers, the loglikes and the first lattices."""
    spec, graph, dec = lex["spec"], lex["graph"], lex["dec"]
    test_txt, test_wav = lex["test_txt"], lex["test_wav"]
    utts = sorted(test_wav)
    waves = [mulaw_encode(np.clip(test_wav[u], -32767, 32767))
             for u in utts]
    pipe = BatchedOfflinePipeline2(model, dec, fe, sample_rate=spec.fs,
                                   device="cuda")
    scored = {}
    inner = pipe.loglikes

    def loglikes(feats, nframes):
        scored["ll"] = inner(feats, nframes)
        return scored["ll"]

    pipe.loglikes = loglikes
    t0 = time.perf_counter()
    with each_call_inside(dec, LEX_LAT_BLOCKS, no_host_sync):
        pipe.decode_batch(waves, generate_lattices=True,
                          lattice_beam=LAT_BEAM)             # warm-up
    warm_s = time.perf_counter() - t0
    stats, lat_stats, host_s = PipelineStats(), {}, {}
    timed_methods(dec, ("_assemble_lane",), host_s)
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    with gc_pauses() as gc_log:
        outs = pipe.decode_batch(waves, stats=stats, generate_lattices=True,
                                 lattice_beam=LAT_BEAM, lat_stats=lat_stats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel_launch_counts()
    delattr(dec, "_assemble_lane")
    ll, lens = scored["ll"]
    best = dec.decode_batch(ll, lengths=lens)
    have = [o for o in outs if o is not None]
    differ = [b for b, (o, h) in enumerate(zip(outs, best))
              if o is None or h is None or o[0] != h[0]
              or abs(o[1] - h[2]) > 1e-4 * max(1.0, abs(h[2]))]
    rel = max((abs(o[1] - h[2]) / max(1.0, abs(h[2]))
               for o, h in zip(outs, best) if o is not None
               and h is not None), default=0.0)
    states = sorted(o[2].num_states for o in have)
    arcs = sorted(o[2].num_arcs() for o in have)
    n_words = sum(len(r) for r in test_txt.values())
    wer = wer_of(lex_words(lex, utts, outs), test_txt)
    T = int(ll.shape[1])
    run = {"lanes": len(waves), "lattices": len(have), "frames": T,
           "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
           "xrt": stats.xrt, "feat_s": stats.feat_s, "am_s": stats.am_s,
           "search_s": stats.search_s, "warmup_s": warm_s,
           "warmup_frame_loop_host_syncs": 0, "lat_stats": lat_stats,
           "assemble_lane_s": host_s["_assemble_lane"],
           "gc_in_timed_call": gc_log, "peak_memory_gb": peak_gb,
           "states_median": states[len(states) // 2] if states else 0,
           "arcs_median": arcs[len(arcs) // 2] if arcs else 0,
           "wer_lattice_best_path": wer,
           "word_errors": round(wer * n_words / 100.0),
           "wer_decode_batch": wer_of(lex_words(
               lex, utts, [None if h is None else (h[0],) for h in best]),
               test_txt),
           "lanes_differing_from_decode_batch": differ,
           "max_cost_rel_diff": rel, "launches": launches}
    emit("slice_lex_lattice", **run)
    if any(launches.values()):
        raise SystemExit("a kernel of another path ran in slice_lex_lattice")
    if len(have) != len(waves):
        raise SystemExit(f"only {len(have)}/{len(waves)} lattices")
    if differ:
        raise SystemExit(f"lattice best paths differ from decode_batch in "
                         f"lanes {differ}")
    with each_call_inside(dec, LEX_LAT_BLOCKS,
                          torch.profiler.record_function):
        prof = profile_call(lambda: dec.decode_batch_lattice(
            ll, lengths=lens, lattice_beam=LAT_BEAM), top=12,
            ranges=LEX_LAT_BLOCKS)
    blocks = prof["ranges"]
    emit("profile_lex_lattice", frames=T,
         forward_launches_per_frame=blocks["_forward_lattice"]
         ["kernel_launches"] / T,
         backward_launches_per_frame=blocks["_backward"]["kernel_launches"]
         / T, busy_share_of_wall=prof["device_ms"] / 1e3
         / prof["wall_s_profiled"], **prof)
    run.update(profile=prof, loglikes=ll, out_lens=lens,
               lattices=[o[2] for o in have[:LATF_LANES]])
    return run


def lex_lattice_cpu_check(lex: dict, loglikes, out_lens, lanes: int = 2
                          ) -> None:
    """lex_lattice_cpu_check: `lanes` lanes' loglikes through the
    LexChain decoder's lattice mode on the card and on the CPU.  The
    lattices must be equal in structure (states, start, arc labels and
    next states); weights and finals may differ by the rounding of the
    float64 prefix sums of the acoustic costs (the two devices sum in
    other orders): the bound is 1e-9 x max(1, the largest |prefix
    sum|), as in ng_lattice_cpu_check."""
    kw = dict(lengths=out_lens[:lanes], lattice_beam=LAT_BEAM)
    card = lex["dec"].decode_batch_lattice(loglikes[:lanes], **kw)
    t0 = time.perf_counter()
    host = LexChainDecoder(lex["graph"], device="cpu").decode_batch_lattice(
        loglikes[:lanes].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    cs_max = float(torch.cumsum(-loglikes[:lanes].double(), 1).abs().max())
    bound = 1e-9 * max(1.0, cs_max)
    diff = max(lattice_diff(c, h) for c, h in zip(card, host))
    emit("lex_lattice_cpu_check", lanes=lanes, max_weight_diff=diff,
         bound=bound, max_abs_prefix_sum=cs_max, cpu_seconds=cpu_s,
         states=[None if c is None else c.num_states for c in card])
    if any(c is None for c in card):
        raise SystemExit("a lane of the CPU check has no lattice")
    if not diff <= bound:
        raise SystemExit("the LexChain lattices differ between the card "
                         "and the CPU")


def lattice_functions(sets: dict) -> dict:
    """lattice_functions: the host lattice functions on the lattices of
    each lattice phase (sets: phase -> lattices): the pruned
    determinization (beam LATF_DET_BEAM), the per-frame posteriors,
    the best path as a lattice, lattice_scale and add_word_ins_penalty,
    each one's seconds summed over the lattices, and the states before
    and after determinization.  Bars: the best path's words are kept
    through the determinization and through lattice_best_path_lattice
    (its cost too), the posteriors of every frame sum to 1 within 1e-6,
    and lattice_scale(1, 1) leaves the best path as it was."""
    out = {}
    # the garbage collector paused, as timeit does: a collection of the
    # heap's older objects would land on whichever call crossed its
    # threshold
    gc.collect()
    gc.disable()
    try:
        for phase, lats in sets.items():
            out[phase] = _lattice_functions_on(phase, lats)
    finally:
        gc.enable()
    emit("lattice_functions", det_beam=LATF_DET_BEAM, scale=LATF_SCALE,
         penalty=LATF_PENALTY, **out)
    return out


def _lattice_functions_on(phase: str, lats) -> dict:
    """lattice_functions on one phase's lattices -> its numbers."""
    secs = dict.fromkeys(("determinize_lattice_pruned",
                          "lattice_forward_backward_post",
                          "lattice_best_path_lattice", "lattice_scale",
                          "add_word_ins_penalty"), 0.0)
    before, after, post_err = [], [], 0.0

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        secs[name] += time.perf_counter() - t0
        return res

    for i, lat in enumerate(lats):
        _, words, cost = latf.lattice_best_path(lat)
        det = timed("determinize_lattice_pruned",
                    latf.determinize_lattice_pruned, lat,
                    beam=LATF_DET_BEAM)
        before.append(lat.num_states)
        after.append(det.num_states)
        post = timed("lattice_forward_backward_post",
                     latf.lattice_forward_backward_post, lat)
        post_err = max([post_err] + [abs(sum(p for _, p in frame) - 1.0)
                                     for frame in post])
        one = timed("lattice_best_path_lattice",
                    latf.lattice_best_path_lattice, lat)
        same = timed("lattice_scale", latf.lattice_scale, lat, 1.0, 1.0)
        timed("lattice_scale", latf.lattice_scale, lat, *LATF_SCALE)
        timed("add_word_ins_penalty", latf.add_word_ins_penalty, lat,
              LATF_PENALTY)
        checks = {
            "determinized": latf.lattice_best_path(det)[1] == words,
            "best_path_lattice": latf.lattice_best_path(one)[1] == words
            and abs(latf.lattice_best_path(one)[2] - cost)
            <= 1e-9 * max(1.0, abs(cost)),
            "scale_1_1": latf.lattice_best_path(same)
            == latf.lattice_best_path(lat),
            "frames": len(post) == len(latf.lattice_best_path(lat)[0])}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"lattice_functions {phase} lattice {i}: "
                             f"{failed} failed")
    if not post_err <= 1e-6:
        raise SystemExit(f"lattice_functions {phase}: posteriors sum "
                         f"to 1 within {post_err}")
    return {"lattices": len(lats), "seconds": secs,
            "states_before": before, "states_after_det": after,
            "max_posterior_sum_err": post_err}


def flat_path_cost(flat, tids, words, ll: np.ndarray) -> float:
    """Float64 cost of the cheapest path of the flat graph with these
    input labels (one a frame) and output words: its arc weights and
    final cost, minus the loglike of each frame's pdf."""
    K = len(words)
    cost = np.full((flat.num_states, K + 1), np.inf)
    cost[flat.start, 0] = 0.0
    weight = flat.weight.astype(np.float64)
    for tid in tids:
        sel = flat.ilabel == tid
        src, dst, olab, w = flat.src[sel], flat.dst[sel], \
            flat.olabel[sel], weight[sel]
        new = np.full_like(cost, np.inf)
        for k in range(K + 1):
            c = cost[src, k] + w
            eps = olab == 0
            np.minimum.at(new[:, k], dst[eps], c[eps])
            if k < K:
                hit = olab == words[k]
                np.minimum.at(new[:, k + 1], dst[hit], c[hit])
        cost = new
    graph = float((cost[:, K] + flat.finals.astype(np.float64)).min())
    pdfs = flat.tid2pdf[np.asarray(tids)]
    return graph - float(ll[np.arange(len(tids)), pdfs]
                         .astype(np.float64).sum())


def cross_check_lex(lex: dict, loglikes, out_lens, lanes: int = 2) -> None:
    """The LexChain decoder on the card (exact) against the host
    FasterDecoder on the graph's to_flat_graph(), on the `lanes` shortest
    lanes of the slice's loglikes: equal words and tids, costs within
    1e-3 * max(1, |cost|) (float32 sums against float64).  Where the
    paths differ they must be a float64 tie (TIE_REL)."""
    t0 = time.perf_counter()
    graph = lex["graph"]
    flat = graph.to_flat_graph()
    host = FasterDecoder(flat.to_vector_fst(),
                         FasterDecoderOptions(beam=1e9, max_active=10 ** 9))
    pick = [int(b) for b in np.argsort(out_lens, kind="stable")[:lanes]]
    ll = loglikes[pick].cpu().numpy()
    got = lex["dec"].decode_batch(loglikes[pick], lengths=out_lens[pick])
    verdicts = []
    for i, b in enumerate(pick):
        n = int(out_lens[b])
        ref = host.decode(ll[i, :n], flat.tid2pdf)
        h = got[i]
        if h is None or ref is None:
            raise SystemExit(f"cross_check_lex lane {b}: no path")
        if abs(h[2] - ref[2]) > 1e-3 * max(1.0, abs(ref[2])):
            raise SystemExit(f"cross_check_lex lane {b}: cost {h[2]} "
                             f"against the host's {ref[2]}")
        if h[0] == ref[1] and h[1] == ref[0]:
            verdicts.append("equal")
            continue
        gap = abs(flat_path_cost(flat, h[1], h[0], ll[i])
                  - flat_path_cost(flat, ref[0], ref[1], ll[i]))
        if gap > TIE_REL * max(1.0, abs(ref[2])):
            raise SystemExit(f"cross_check_lex lane {b}: different paths "
                             f"{gap} apart in float64")
        verdicts.append("tied")
    emit("cross_check_lex", lanes=pick, frames=[int(out_lens[b])
                                                for b in pick],
         flat_states=flat.num_states, flat_arcs=flat.num_arcs,
         lanes_equal=verdicts.count("equal"),
         lanes_tied=verdicts.count("tied"), tie_rel=TIE_REL,
         words_lane0=got[0][0], seconds=time.perf_counter() - t0)


def run_online_lex(lex: dict, model, fe) -> dict:
    """slice_online_lex: egs/bench_corpus/measure_online.py's
    configuration, at 128 lanes rather than its 64.  The 128 test
    utterances' MFCCs (float waves) stacked by 3 (feat_dim 120), fed 32
    output frames a lane and round; the legacy TDNN-F (bf16, no
    i-vectors) scores each chunk of 96 input frames on its own;
    BatchedDeviceOnlinePipelineLex over the V=200 graph, exact search,
    no endpointing.  Rounds and checks as slice_online_ng: every lane
    equal to decode_batch of the loglikes the scorer produced."""
    graph, dec = lex["graph"], lex["dec"]
    utts = sorted(lex["test_wav"])
    lanes, Tc = len(utts), LEX_ONLINE["chunk_frames"]
    sub = 3
    waves = [np.asarray(lex["test_wav"][u], np.float32) for u in utts]
    feats, _, stacked = stacked_mfcc(fe, waves, sub)
    D = feats.shape[2]
    del feats

    def scorer(chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(chunk).to(dec.device).view(lanes, Tc * sub,
                                                         D)
        return model.chain(x, None).to(torch.float32)

    pipe = BatchedDeviceOnlinePipelineLex(dec, scorer, feat_dim=sub * D,
                                          num_lanes=lanes, **LEX_ONLINE)
    out = online_rounds(pipe, utts, stacked, Tc)
    return online_check(
        "slice_online_lex", dec, graph, utts, lex["test_txt"], out,
        sum(len(f) for f in stacked) * 0.03,
        {"metric": "online_pipeline_aggregate_xRT", "chunk_frames": Tc,
         "endpointing": False, "lanes_measure_online_default": 64}, {})


def legacy_phases(ng_lattices=None) -> dict:
    """The legacy path on the card: lex_graph, slice_lex (with
    profile_lex, slice_lex_int16, lex_pruned_full_k), lex_cpu_check,
    slice_lex_lattice (with profile_lex_lattice), lex_lattice_cpu_check,
    lattice_functions (on slice_lex_lattice's lattices and on
    ng_lattices, slice_ng_lattice's, where given), cross_check_lex and
    slice_online_lex -> their numbers, and slice_lex_int16's words of
    each utterance (words_int16)."""
    lex = build_lex_path()
    model, fe = legacy_am(lex)
    res = run_lex_slice(lex, model, fe)
    lex_cpu_check(lex, res["loglikes"], res["out_lens"])
    lat = run_lex_lattice(lex, model, fe)
    lex_lattice_cpu_check(lex, lat["loglikes"], lat["out_lens"])
    sets = {"slice_lex_lattice": lat["lattices"]}
    if ng_lattices:
        sets["slice_ng_lattice"] = ng_lattices
    latfn = lattice_functions(sets)
    cross_check_lex(lex, res["loglikes"], res["out_lens"])
    online = run_online_lex(lex, model, fe)
    walls = sorted(r["wall_s"] for r in res["runs"])
    lat_blocks = lat["profile"]["ranges"]
    out = {"lex_wall_s_median": walls[1],
           "lex_xrt_median": res["runs"][0]["audio_s"] / walls[1],
           "lex_wer_mulaw": res["runs"][-1]["wer"],
           "lex_wer_int16": res["wer_int16"],
           "lex_launches_per_frame":
               res["profile"]["ranges"]["_forward"]["kernel_launches"]
               / res["frames"],
           "lex_lattice_wall_s": lat["wall_s"],
           "lex_lattice_xrt": lat["xrt"],
           "lex_lattice_wer": lat["wer_lattice_best_path"],
           "lex_lattice_launches_per_frame": {
               k: lat_blocks[k]["kernel_launches"] / lat["frames"]
               for k in LEX_LAT_BLOCKS},
           "lattice_functions_s": {k: sum(v["seconds"].values())
                                   for k, v in latfn.items()},
           "online_lex_xrt": online["value"],
           "online_lex_chunk_ms_p50": online["chunk_ms_p50"],
           "online_lex_finalize_ms_max": online["finalize_ms_max"],
           "online_lex_wer": online["wer"],
           "words_int16": res["words_int16"],
           "launches": {"slice_lex": res["runs"][-1]["launches"],
                        "slice_lex_lattice": lat["launches"],
                        "slice_online_lex": online["launches"]}}
    del lex, model, fe, res, lat
    torch.cuda.empty_cache()
    return out


def run_train_lex(epochs: int = TRAIN_EPOCHS) -> dict:
    """train_lex: the legacy training recipe on the card
    (recipes/train_bench.py train_and_decode): the corpus, MFCC, the mono
    GMM, the alignment, the chain examples, `epochs` epochs of the
    17 x 1536 TDNN-F (the recipe's TRAIN_EPOCHS by default), then the
    128 test utterances decoded in bf16.  The
    seconds of each stage, the aligner, the steps, each epoch's
    objective, the median step ms by CUDA events, the peak memory, the
    WER and kernels a-c's launches (0); then one more step under the
    profiler (its launches and device time).  Bars: the native aligner
    ran, every step's objective is finite, the last epoch's mean is above
    the first's, the WER is within TRAIN_WER_BAND of the JAX package's."""
    reset_kernel_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    t0 = time.perf_counter()
    meta = train_bench.train_and_decode(
        os.path.join(REPO, "_chip", "train_lex"), epochs, "cuda",
        stats=stats)
    seconds = time.perf_counter() - t0
    launches = kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    sysd = stats.pop("system")
    step_ms = sorted(stats["step_ms"])
    dec = stats["decode"]
    out = {"seconds": seconds,
           "stage_s": {k: stats[k] for k in (
               "corpus_s", "mfcc_s", "mono_s", "graphs_s", "align_s",
               "chain_s", "decode_s")},
           "aligner": stats["aligner"], "chunks": stats["chunks"],
           "steps": len(stats["step_objf"]), "epochs": epochs,
           "epoch_objf": stats["epoch_objf"],
           "jax_epoch_objf": TRAIN_JAX_EPOCH_OBJF,
           "mono_avg_loglike_last": stats["mono_avg_loglikes"][-1],
           "step_ms_median": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "chain_s_a_step": stats["chain_s"] / len(stats["step_objf"]),
           "peak_memory_gb": peak, "wer": dec["wer"],
           "word_errors": dec["word_errors"], "ref_words": dec["ref_words"],
           "lanes_decoded": dec["lanes_decoded"],
           "decode_batch_s": dec["seconds"], "jax_cpu_wer": TRAIN_JAX_WER,
           "wer_band": TRAIN_WER_BAND, "corpus_hash": meta["corpus_hash"],
           "launches": launches}
    emit("train_lex", **out)
    if stats["aligner"] != tmono.NATIVE:
        raise SystemExit(f"train_lex aligned with {stats['aligner']}, not "
                         "the native aligner")
    if meta["corpus_hash"] != LEX_FINGERPRINT:
        raise SystemExit(f"corpus fingerprint {meta['corpus_hash']}")
    if not np.isfinite(stats["step_objf"]).all():
        raise SystemExit("a training step's objective is not finite")
    if not stats["epoch_objf"][-1] > stats["epoch_objf"][0]:
        raise SystemExit("the last epoch's objective is not above the "
                         "first's")
    if dec["wer"] > TRAIN_JAX_WER + TRAIN_WER_BAND:
        raise SystemExit(f"train_lex WER {dec['wer']:.3f}% against the JAX "
                         f"package's {TRAIN_JAX_WER:.3f}% + {TRAIN_WER_BAND}")
    if any(launches.values()):
        raise SystemExit(f"a hand kernel launched in train_lex: {launches}")
    # one more step on the trained weights, under the profiler
    den, chunks, nums = tchain.chain_egs(
        sysd["gmm"], sysd["feats"], sysd["alignments"], sysd["chain_tm"],
        sysd["chain_tree"], train_bench.train_options(), 3)
    cfg = train_bench.flagship_config(sysd["spec"])
    reset_kernel_counts()
    prof = profile_call(lambda: tchain._fit_chain(
        cfg, den, chunks[:TRAIN_CHECK_CHUNKS], nums[:TRAIN_CHECK_CHUNKS],
        train_bench.train_options(1), 150, 40,
        variables=sysd["variables"], device="cuda"),
        ranges=(tchain.STEP_RANGE,))
    step = prof["ranges"][tchain.STEP_RANGE]
    step_launches = kernel_launch_counts()
    emit("profile_train_step", launches=step_launches,
         launches_a_step=step["kernel_launches"],
         device_ms_a_step=step["device_ms"], host_ms_a_step=step["host_ms"],
         span_ms=step.get("span_ms"), top=prof["top"], by_op=prof["by_op"],
         peak_memory_gb=prof["peak_memory_gb"])
    if any(step_launches.values()):
        raise SystemExit("a hand kernel launched in profile_train_step: "
                         f"{step_launches}")
    out["launches_a_step"] = step["kernel_launches"]
    out["device_ms_a_step"] = step["device_ms"]
    out["launches"] = {"train_lex": launches,
                       "profile_train_step": step_launches}
    return {"sysd": sysd, "egs": (den, chunks, nums), "cfg": cfg,
            "summary": out}


def param_grads(cfg, variables, feats_b, packed, den, opts, dev,
                dtype=torch.float32, ivecs_b=None) -> dict:
    """The gradient of minus the chain objective with respect to every
    parameter, the model built from `variables` in `dtype` in training
    mode on `dev` (TF32 off), fed feats_b (and ivecs_b, the i-vectors),
    in flax's layout as numpy float64."""
    model = chain_tdnnf_from_flax(cfg, variables, dtype, dev)
    model.train()
    model.requires_grad_(True)
    with full_f32():
        chain_out, xent_out = model(
            feats_b.to(dev, dtype),
            None if ivecs_b is None else ivecs_b.to(dev, dtype))
        objf, _ = chain_loss(opts.chain, den, packed, chain_out, xent_out)
        objf.neg().backward()
    for p in model.parameters():
        p.data = torch.zeros_like(p) if p.grad is None else p.grad
    return {k: v.astype(np.float64) for k, v in
            _leaves(chain_tdnnf_to_flax(model)["params"])}


def _leaves(tree, prefix=""):
    """(path, array) of every array of a nested dict, in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _unflatten(leaves: dict) -> dict:
    """{"/a/b": x} -> {"a": {"b": x}}: the inverse of `_leaves`."""
    tree: dict = {}
    for path, x in leaves.items():
        node = tree
        *head, last = path.strip("/").split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def _leaf_errors(grads: dict, ref: dict) -> dict:
    """Each leaf's largest |grads - ref| over the leaf's own largest
    |ref| (a leaf whose ref is all 0: 0 if grads is too, else inf)."""
    out = {}
    for p, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(grads[p] - r).max())
        out[p] = err / scale if scale > 0 else (0.0 if err == 0 else np.inf)
    return out


def gradient_agreement(grad_of, reproduce: bool = True) -> dict:
    """The card's gradients against the CPU's float64: grad_of(dev,
    dtype) -> {leaf: float64 array} run on the CPU and the card in
    float64 and float32 (and the card's float32 once more if
    `reproduce`).  Each leaf's error over its own largest value ->
    {"g64": the CPU's float64 leaves, "grads": the other runs' leaves,
    "worst", "worst_leaf": each run's worst leaf error and its name,
    "f32_bar": the card's float32 bar (twice the CPU float32's worst, or
    1e-3), "reproducible": the second float32 run bit for bit (True
    unless `reproduce`), "bars": the card's float64 within 1e-6, its
    float32 within f32_bar, reproducible}."""
    grads = {f"{dev}_{str(dt)[6:]}": grad_of(dev, dt)
             for dev in ("cpu", "cuda") for dt in (torch.float64,
                                                   torch.float32)}
    g64 = grads.pop("cpu_float64")
    reproducible = True
    if reproduce:
        again = grad_of("cuda", torch.float32)
        reproducible = all(np.array_equal(again[p], grads["cuda_float32"][p])
                           for p in g64)
    leaf_err = {k: _leaf_errors(g, g64) for k, g in grads.items()}
    worst = {k: max(e.values()) for k, e in leaf_err.items()}
    f32_bar = max(2.0 * worst["cpu_float32"], 1e-3)
    return {"g64": g64, "grads": grads, "worst": worst,
            "worst_leaf": {k: max(e, key=e.get) for k, e in leaf_err.items()},
            "f32_bar": f32_bar, "reproducible": reproducible,
            "bars": {"gradient float64": worst["cuda_float64"] <= 1e-6,
                     "gradient float32": worst["cuda_float32"] <= f32_bar,
                     "gradient reproducible": reproducible}}


def adam_first_move(grads: dict, lr: float, max_norm: float,
                    eps: float = 1e-8) -> dict:
    """The plain first step of ChainOptimizer in float64 -> each leaf's
    move: the global norm clip, then Adam's first update, whose bias
    corrections cancel its moments (u = g / (|g| + eps), |u| < 1)."""
    norm = np.sqrt(sum(float(np.sum(g * g)) for g in grads.values()))
    c = 1.0 if norm < max_norm else max_norm / norm
    return {p: -lr * (g * c) / (np.abs(g * c) + eps)
            for p, g in grads.items()}


def _move_error(new: dict, old: dict, want: dict, lr: float) -> float:
    """The largest |(new - old) - want| over want's leaves beyond the
    rounding of a float32 parameter (half its spacing), in units of lr."""
    worst = 0.0
    for p, w in want.items():
        half_ulp = 0.5 * np.spacing(np.abs(new[p]).astype(np.float32))
        err = np.abs((new[p].astype(np.float64) - old[p]) - w) - half_ulp
        worst = max(worst, float(err.max()) / lr)
    return worst


def optimizer_step(cfg, variables, grads: dict, opts, dev) -> dict:
    """ChainOptimizer's first step with a one-step `_fit_chain`'s
    schedule on `dev`, from `variables`, fed `grads` (flax's layout, in
    float32) -> the new parameters' leaves."""
    model = chain_tdnnf_from_flax(cfg, variables, torch.float32, dev)
    gmodel = chain_tdnnf_from_flax(
        cfg, {"params": grads, "batch_stats": variables["batch_stats"]},
        torch.float32, dev)
    opt = tchain.ChainOptimizer(
        list(model.parameters()),
        tchain.lr_schedule(opts.learning_rate, opts.final_learning_rate,
                           1, 1), opts.max_param_change)
    opt.step(list(gmodel.parameters()))
    return dict(_leaves(chain_tdnnf_to_flax(model)["params"]))


def train_lex_check(trained: dict) -> dict:
    """train_lex_check: the card against the port's CPU code (TF32 off)
    from the trained state and one minibatch.
      gradients: every parameter's in float64 on the card and on the CPU,
        each leaf within 1e-6 of its own largest (an all-zero leaf, the
        unused xent head's, exactly 0); in float32 on both against the
        CPU's float64, each leaf against its own largest, the card's worst
        leaf at most twice the CPU's (or 1e-3); the card's float32
        gradient a second time bit for bit (a step adds in a fixed order);
      the optimizer: its first step on each device, fed the same gradient
        (the CPU's float64 in float32), within 1e-3 lr of the plain
        float64 update beyond a float32 parameter's rounding;
      one `_fit_chain` step on each device: the objective within 1e-4
        relative, the batch statistics within 1e-4, and each device's
        parameters moved as the plain update of its own float32 gradient
        moves them, within 1e-3 lr (so by at most lr);
      the semi-orthogonal constraint on the trained factors within 1e-4;
      the numerator and denominator loglikes (1e-4 relative) and the
        gradient of the chain objective on the card's network outputs
        (1e-4 of its largest);
      the mono GMM's loglikes of TRAIN_CHECK_UTTS utterances (1e-4
        relative) and their alignments, equal or a flipped Viterbi tie
        (both paths' costs within 1e-4 relative);
    and kernels a-c launched 0 times."""
    reset_kernel_counts()
    sysd, cfg = trained["sysd"], trained["cfg"]
    variables = sysd["variables"]
    den, chunks, nums = trained["egs"]
    mb, mb_nums = chunks[:TRAIN_CHECK_CHUNKS], nums[:TRAIN_CHECK_CHUNKS]
    opts = train_bench.train_options(1)
    lr0 = float(tchain.lr_schedule(opts.learning_rate,
                                   opts.final_learning_rate, 1, 1)(0))
    old = {p: a.astype(np.float64) for p, a in _leaves(variables)}
    # the minibatch in the order `_fit_chain` shuffles it to, so that the
    # gradients below are its step's
    order = np.arange(len(mb))
    np.random.default_rng(opts.seed).shuffle(order)
    feats_b = torch.from_numpy(np.stack([mb[j][0] for j in order]))
    packed = batch_pack([mb_nums[j] for j in order])

    # every parameter's gradient, in float64 and float32 on each device
    agree = gradient_agreement(lambda dev, dt: param_grads(
        cfg, variables, feats_b, packed, den, opts, dev, dt))
    g64, grads = agree["g64"], agree["grads"]

    # the optimizer on each device, fed one gradient
    g32 = {p: g.astype(np.float32) for p, g in g64.items()}
    want = adam_first_move({p: g.astype(np.float64) for p, g in g32.items()},
                           lr0, opts.max_param_change)
    opt_err = {dev: _move_error(
        optimizer_step(cfg, variables, _unflatten(g32), opts, dev),
        {p: old["/params" + p] for p in want}, want, lr0)
        for dev in ("cuda", "cpu")}

    # one `_fit_chain` step on each device, from its own gradient
    steps, step_err, moved = {}, {}, {}
    for dev in ("cuda", "cpu"):
        st: dict = {}
        t0 = time.perf_counter()
        _, v = tchain._fit_chain(cfg, den, mb, mb_nums, opts, 150, 40,
                                 variables=variables, device=dev, stats=st)
        steps[dev] = (st["step_objf"][0], dict(_leaves(v)),
                      time.perf_counter() - t0)
        new = dict(_leaves(v["params"]))
        step_err[dev] = _move_error(
            new, {p: old["/params" + p] for p in new},
            adam_first_move(grads[f"{dev}_float32"], lr0,
                            opts.max_param_change), lr0)
        moved[dev] = max(float(np.abs(a - old["/params" + p]).max())
                         for p, a in new.items())
    stats_diff = max(float(np.abs(a - steps["cpu"][1][p]).max())
                     for p, a in steps["cuda"][1].items()
                     if p.startswith("/batch_stats"))
    parted = {p: np.abs(a - steps["cpu"][1][p]) for p, a in
              steps["cuda"][1].items() if p.startswith("/params")}
    apart = sum(int((d > 1e-2 * lr0).sum()) for d in parted.values())
    objf_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])

    # the semi-orthogonal constraint (every `orthonormal_interval` steps,
    # not in this one) on the trained factors
    constrained = {}
    for dev in ("cuda", "cpu"):
        model = chain_tdnnf_from_flax(cfg, variables, torch.float32, dev)
        tchain.apply_orthonormal(model)
        constrained[dev] = dict(_leaves(chain_tdnnf_to_flax(model)["params"]))
    del model
    constraint_diff = max(
        float(np.abs(a - constrained["cpu"][p]).max())
        for p, a in constrained["cuda"].items() if p.endswith("/linear"))
    # the chain objective on the card's outputs for the minibatch
    model = chain_tdnnf_from_flax(cfg, variables, torch.float32, "cuda")
    with torch.no_grad(), full_f32():
        out = model.chain(feats_b.cuda())
    del model
    losses = {}
    for dev in ("cuda", "cpu"):
        x = out.to(dev).clone().requires_grad_(True)
        objf, aux = chain_loss(opts.chain, den, packed, x)
        objf.backward()
        losses[dev] = (float(aux["num"].detach()),
                       float(aux["den"].detach()), x.grad.cpu().numpy())
    num_rel = abs(losses["cuda"][0] - losses["cpu"][0]) / abs(
        losses["cpu"][0])
    den_rel = abs(losses["cuda"][1] - losses["cpu"][1]) / abs(
        losses["cpu"][1])
    g_out = losses["cpu"][2]
    out_grad_rel = float(np.abs(losses["cuda"][2] - g_out).max()
                         / np.abs(g_out).max())
    # the GMM's loglikes and the alignments of a few utterances
    gmm = sysd["gmm"]
    utts = list(sysd["feats"])[:TRAIN_CHECK_UTTS]
    feats = {u: sysd["feats"][u] for u in utts}
    cpu_am = AmDiagGmm(device="cpu")
    for g in gmm.am.densities:
        cpu_am.add_pdf(g)
    cpu_gmm = tmono.MonoSystem(gmm.lang, gmm.tree, gmm.tm, cpu_am)
    ll_rel = max(float(np.abs(gmm.am.log_likes_batch(f)
                              - cpu_am.log_likes_batch(f)).max()
                       / np.abs(cpu_am.log_likes_batch(f)).max())
                 for f in feats.values())
    comp = TrainingGraphCompiler(gmm.tm, gmm.tree, gmm.lang)
    graphs = {u: comp.compile(sysd["train_txt"][u]) for u in utts}
    ali = {name: tmono._align_all(s, graphs, feats, 10.0, 0.1, 1.0)
           for name, s in (("cuda", gmm), ("cpu", cpu_gmm))}
    ties = []
    for u in utts:
        if ali["cuda"][u] == ali["cpu"][u]:
            continue
        costs = [NativeViterbi(graphs[u]).decode(
            s.am.log_likes_batch(feats[u]), s.tm.id2pdf_id, 0.1,
            beam=10.0)[2] for s in (gmm, cpu_gmm)]
        ties.append({"utt": u, "costs": costs})
    launches = kernel_launch_counts()
    out = {"step_objf_cuda": steps["cuda"][0],
           "step_objf_cpu": steps["cpu"][0], "step_objf_rel": objf_rel,
           "first_step_lr": lr0,
           "parameters": sum(a.size for a in g64.values()),
           "grad_worst_leaf_rel": agree["worst"],
           "grad_worst_leaf": agree["worst_leaf"],
           "grad_f32_bar": agree["f32_bar"],
           "grad_reproducible": agree["reproducible"],
           "optimizer_err_lr": opt_err, "step_err_lr": step_err,
           "step_moved_max": moved, "step_elements_apart": apart,
           "param_max_abs_diff": max(float(d.max())
                                     for d in parted.values()),
           "batch_stats_max_abs_diff": stats_diff,
           "constraint_max_abs_diff": constraint_diff,
           "step_s_cuda": steps["cuda"][2], "step_s_cpu": steps["cpu"][2],
           "num_rel": num_rel, "den_rel": den_rel,
           "grad_rel_to_max": out_grad_rel,
           "gmm_loglike_rel_to_max": ll_rel, "utts": len(utts),
           "alignments_equal": len(utts) - len(ties), "ties": ties,
           "launches": launches, "tolerance": 1e-4}
    emit("train_lex_check", **out)
    bars = {
        **agree["bars"],
        "optimizer": max(opt_err.values()) <= 1e-3,
        "step": max(step_err.values()) <= 1e-3,
        "step objective": objf_rel <= 1e-4,
        "batch statistics": stats_diff <= 1e-4,
        "constraint": constraint_diff <= 1e-4,
        "chain loglikes": max(num_rel, den_rel, out_grad_rel) <= 1e-4,
        "GMM loglikes": ll_rel <= 1e-4,
        "weights moved": min(moved.values()) >= 1e-6,
        "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"train_lex_check: the card and the CPU disagree: "
                         f"{failed}")
    for t in ties:
        if abs(t["costs"][0] - t["costs"][1]) > 1e-4 * abs(t["costs"][1]):
            raise SystemExit(f"train_lex_check: {t['utt']} aligns "
                             "differently and is no tie")
    return out


def train_phases(epochs: int = TRAIN_EPOCHS) -> tuple:
    """train_lex (`epochs` epochs), profile_train_step and
    train_lex_check -> (their summary, with kernels a-c's launches in
    each; train_lex's system)."""
    trained = run_train_lex(epochs)
    check = train_lex_check(trained)
    out = dict(trained["summary"])
    out["launches"]["train_lex_check"] = check["launches"]
    out["check"] = {k: check[k] for k in (
        "step_objf_rel", "grad_worst_leaf_rel", "step_err_lr", "num_rel",
        "den_rel", "alignments_equal")}
    sysd = trained["sysd"]
    del trained
    torch.cuda.empty_cache()
    return out, sysd


def chain_cli_system() -> dict:
    """train_lex's system without its chain training: the corpus, MFCC,
    the mono GMM, the alignment, the chain transition model and tree
    (what chain_cli_phases takes; chip_main_path.py --chain-cli)."""
    spec = BenchCorpusSpec()
    return train_system(spec, cfg=train_bench.flagship_config(spec),
                        chain_opts=train_bench.train_options(0),
                        num_ceps=40, device="cuda")


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def chain_ali_input_rate(ali, mono_tm, chain_tm) -> list:
    """A mono alignment as chain transition-ids at the input frame rate
    (`convert-ali` to the chain topology): each phone segment of d frames
    becomes [forward, self-loop x (d - 1)]."""
    tids = {}
    for ts in range(1, chain_tm.num_transition_states + 1):
        phone = chain_tm.transition_state_to_phone(ts)
        if phone in tids:
            continue
        fwd = next(t for t in (chain_tm.pair_to_transition_id(ts, i)
                               for i in range(
                                   chain_tm.num_transition_indices(ts)))
                   if not chain_tm.is_self_loop(t))
        tids[phone] = (fwd, chain_tm.self_loop_of(ts))
    out = []
    for phone, s, e in alignment_to_phone_segments(ali, mono_tm):
        fwd, loop = tids[phone]
        out.extend([fwd] + [loop] * (e - s - 1))
    return out


def chain_ali_repeated(ali, mono_tm, chain_tm) -> list:
    """A mono alignment as chain transition-ids as Kaldi's `convert-ali
    --frame-subsampling-factor=3 --repeat-frames=true` gives it:
    converted at the output rate (each phone at least one frame, its
    forward transition first; `mono_ali_to_chain_ali`), each output frame
    repeated 3 times.  nnet3-chain-get-egs subsamples the alignment it is
    given as it is, so only this form keeps each phone's forward
    transition at any chunk offset (the input-rate form keeps it for
    about a third of the phones)."""
    return [t for t in tchain.mono_ali_to_chain_ali(ali, mono_tm, chain_tm, 3)
            for _ in range(3)]


def timed_tool(seconds: dict, tool: str, *args, key: str = "") -> str:
    """One tool in this process through get_tool -> its stderr and
    stdout; its seconds go to seconds[key or tool] (summed over
    calls)."""
    # stdout with a byte buffer behind it: a tool may write bytes there
    err, out = io.StringIO(), io.TextIOWrapper(io.BytesIO(), "utf-8")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = get_tool(tool)([tool] + [str(a) for a in args])
    out.flush()
    key = key or tool
    seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}:\n{err.getvalue()[-4000:]}")
    return err.getvalue() + out.buffer.getvalue().decode()


def timed_cli(seconds: dict, tool: str, *args, dev: str = "cuda") -> str:
    """`cli` (a process of its own, on `dev`) timed into seconds[tool] ->
    stderr."""
    t0 = time.perf_counter()
    proc = cli(tool, *([] if dev == "cuda" else ["--use-gpu=no"]), *args)
    seconds[tool] = time.perf_counter() - t0
    return proc.stderr


def chain_prob(log: str) -> float:
    """nnet3-chain-compute-prob's objective a frame, from its log."""
    m = re.findall(r"Overall log-probability for 'output' is (\S+) per "
                   r"frame", log)
    if not m:
        raise SystemExit(f"no compute-prob line in:\n{log[-2000:]}")
    return float(m[-1])


def fields_max_diff(a, b) -> float:
    """The largest |a - b| over two nnet3 graphs' float parameter
    arrays, component by component."""
    return max(
        float(np.abs(np.asarray(b.components[n].fields[k], np.float64)
                     - np.asarray(v, np.float64)).max())
        for n, comp in a.components.items() for k, v in comp.fields.items()
        if np.asarray(v).dtype.kind == "f" and np.asarray(v).size > 0)


def chain_cli_inputs(sysd: dict, d: str) -> None:
    """What a Kaldi user has after the GMM stage, from train_lex's
    system: tree, 0.trans_mdl, feats.ark (the 384 training utterances),
    ali.ark (their alignments as chain transition-ids at the input rate,
    what chain-get-supervision segments into phones and nnet3-get-egs
    takes as frame targets), ali_sub.ark (the same converted for frame
    subsampling, what nnet3-chain-get-egs subsamples) and phones.ark
    (their phone sequences)."""
    os.makedirs(d, exist_ok=True)
    mono_tm, chain_tm = sysd["gmm"].tm, sysd["chain_tm"]
    write_kaldi_object(sysd["chain_tree"].write, f"{d}/tree")
    write_kaldi_object(chain_tm.write, f"{d}/0.trans_mdl")
    feats, alis = sysd["feats"], sysd["alignments"]
    with TableWriter("matrix", f"ark:{d}/feats.ark") as w:
        for u in sorted(feats):
            w.write(u, np.asarray(feats[u], np.float32))
    with TableWriter("int-vector", f"ark:{d}/ali.ark") as w, \
            TableWriter("int-vector", f"ark:{d}/ali_sub.ark") as ws, \
            TableWriter("int-vector", f"ark:{d}/phones.ark") as wp:
        for u in sorted(alis):
            w.write(u, chain_ali_input_rate(alis[u], mono_tm, chain_tm))
            ws.write(u, chain_ali_repeated(alis[u], mono_tm, chain_tm))
            wp.write(u, [s[0] for s in alignment_to_phone_segments(
                alis[u], mono_tm)])


def test_feats(sysd: dict, utts, dev: str = "cuda") -> list:
    """The test utterances' MFCCs on `dev`, as train_lex decodes them ->
    [(T, 40) numpy]."""
    fe = OfflineFeature(mfcc_options(sysd["spec"]), device=dev)
    feats, nframes = fe.compute_batch_device(
        [sysd["test_wav"][u] for u in utts])
    feats = feats.cpu().numpy()
    return [feats[i, :nframes[i]] for i in range(len(utts))]


def run_chain_cli(sysd: dict, d: str, dev: str = "cuda") -> dict:
    """chain_cli: Kaldi chain training through the tools at full width,
    from train_lex's corpus, features, chain transition model, tree and
    alignments: chain-est-phone-lm, chain-make-den-fst,
    chain-get-supervision, nnet3-chain-get-egs (the tool's defaults),
    -shuffle-egs, -subset-egs (CHAIN_CLI_SUBSET egs) in this process;
    nnet3-chain-train (CHAIN_CLI_TRAIN: the 17 x 1536 TDNN-F) and
    nnet3-chain-compute-prob on the subset, each in a process of its
    own; nnet3-chain-combine of two copies of the model (equal to it
    within 1e-6); the 128 test utterances decoded with the trained raw
    nnet (the compiled module at the input rate, every third frame)
    through LexChainDecoder over train_lex's graph.  Then one training
    step of CHAIN_CLI_MB egs in this process under the profiler.  Bars:
    every step's objective finite, 0 guard rejects, the combine, the
    compute-prob objective finite, the WER within CHAIN_CLI_WER_BAND of
    the JAX package's, kernels a-c 0 launches."""
    reset_kernel_counts()
    t_phase = time.perf_counter()
    seconds: dict = {}
    t0 = time.perf_counter()
    chain_cli_inputs(sysd, d)
    seconds["inputs"] = time.perf_counter() - t0
    timed_tool(seconds, "chain-est-phone-lm", f"ark:{d}/phones.ark",
               f"{d}/phone_lm.fst")
    timed_tool(seconds, "chain-make-den-fst", f"{d}/tree",
               f"{d}/0.trans_mdl", f"{d}/phone_lm.fst", f"{d}/den.fst",
               f"{d}/normalization.fst")
    timed_tool(seconds, "chain-get-supervision", f"{d}/tree",
               f"{d}/0.trans_mdl", f"ark:{d}/ali.ark", f"ark:{d}/sup.ark")
    log = timed_tool(seconds, "nnet3-chain-get-egs", f"{d}/0.trans_mdl",
                     f"ark:{d}/feats.ark", f"ark:{d}/ali_sub.ark",
                     f"ark:{d}/egs.ark")
    n_egs = int(re.search(r"(\d+) examples", log).group(1))
    timed_tool(seconds, "nnet3-chain-shuffle-egs", f"ark:{d}/egs.ark",
               f"ark:{d}/egs_shuf.ark")
    timed_tool(seconds, "nnet3-chain-subset-egs", f"--n={CHAIN_CLI_SUBSET}",
               f"ark:{d}/egs_shuf.ark", f"ark:{d}/egs_sub.ark")
    log = timed_cli(seconds, "nnet3-chain-train", *CHAIN_CLI_TRAIN,
                    f"{d}/den.fst", f"ark:{d}/egs_shuf.ark",
                    f"{d}/final.raw", dev=dev)
    train = tool_stats("nnet3-chain-train", log)
    prob = chain_prob(timed_cli(seconds, "nnet3-chain-compute-prob",
                                f"{d}/final.raw", f"{d}/den.fst",
                                f"ark:{d}/egs_sub.ark", dev=dev))
    timed_tool(seconds, "nnet3-chain-combine", f"{d}/final.raw",
               f"{d}/final.raw", f"{d}/combined.raw")
    raw = mdl_io.read_raw_nnet3(f"{d}/final.raw")
    combine_err = fields_max_diff(raw, mdl_io.read_raw_nnet3(
        f"{d}/combined.raw"))

    # the test set through the legacy search with the trained raw nnet
    t0 = time.perf_counter()
    utts = sorted(sysd["test_wav"])
    feats = test_feats(sysd, utts, dev)
    net = compile_graph(raw, "output", device=dev)
    outs = [net(f[None])[0, ::3] for f in feats]
    lens = [int(o.shape[0]) for o in outs]
    loglikes = torch.zeros((len(outs), max(lens), outs[0].shape[1]),
                           device=dev)
    for i, o in enumerate(outs):
        loglikes[i, :lens[i]] = o
    graph = build_decode_graph(sysd["lexicon"], sysd["lm_text"],
                               sysd["chain_tm"], sysd["chain_tree"],
                               lang=sysd["lang"])
    hyps = LexChainDecoder(graph, device=dev).decode_batch(
        loglikes, lengths=lens)
    words = {u: ([] if h is None else [graph.words[w] for w in h[0]])
             for u, h in zip(utts, hyps)}
    wer = wer_of(words, sysd["test_txt"])
    seconds["decode"] = time.perf_counter() - t0
    del net, loglikes, outs

    # one step of CHAIN_CLI_MB egs under the profiler, from fresh weights
    first = next(merged_minibatches(f"ark:{d}/egs_shuf.ark", CHAIN_CLI_MB))
    step_fn, state, batch, _m = chain_cli_step(
        first, den_graph_from_fst_file(f"{d}/den.fst"), dev)
    step_fn(state, batch)                                  # warm-up
    prof = profile_call(lambda: step_fn(state, batch), top=8)
    launches = kernel_launch_counts()
    step_ms = sorted(train["step_ms"])
    out = {"seconds": time.perf_counter() - t_phase, "tool_s": seconds,
           "egs": n_egs, "steps": len(train["step_objf"]),
           "train_s": train["seconds"],
           "step_ms_median": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "peak_memory_gb": train["peak_memory_gb"],
           "final_objf": train["step_objf"][-1],
           "first_objf": train["step_objf"][0],
           "objf_finite": bool(np.isfinite(train["step_objf"]).all()),
           "guard_rejects": train["rejects"],
           "compute_prob_objf": prob, "subset": CHAIN_CLI_SUBSET,
           "combine_max_abs_err": combine_err,
           "wer": wer, "word_errors": word_errors(wer, sysd["test_txt"]),
           "ref_words": sum(len(r) for r in sysd["test_txt"].values()),
           "lanes_decoded": sum(h is not None for h in hyps),
           "jax_cpu_wer": CHAIN_CLI_JAX_WER, "wer_band": CHAIN_CLI_WER_BAND,
           "profiled_step": {
               "egs": CHAIN_CLI_MB, "launches": prof["kernel_launches"],
               "device_ms": prof["device_ms"],
               "wall_ms": 1e3 * prof["wall_s_profiled"],
               "peak_memory_gb": prof["peak_memory_gb"],
               "top": prof["top"]},
           "launches": launches}
    emit("chain_cli", **out)
    bars = {"objectives finite": out["objf_finite"],
            "guard rejects 0": train["rejects"] == 0,
            "combine": combine_err <= 1e-6,
            "compute-prob finite": bool(np.isfinite(prob)),
            "WER": wer <= CHAIN_CLI_JAX_WER + CHAIN_CLI_WER_BAND,
            "all lanes decoded": out["lanes_decoded"] == len(utts),
            "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"chain_cli: {failed}")
    return out


def chain_cli_step(batch: dict, den, dev, dtype=torch.float32):
    """The trainer's step over fresh flagship weights (nnet3-chain-train's
    configuration under CHAIN_CLI_TRAIN, its initializer's seed 0) on
    `dev` in `dtype`, and a merged minibatch trimmed as the trainer trims
    it -> (step_fn, state, step batch, model)."""
    lc, rc = int(batch["left_context"]), int(batch["right_context"])
    feats = batch["feats"][:, lc:batch["feats"].shape[1] - rc]
    cfg = ChainTdnnfConfig(
        feat_dim=feats.shape[-1],
        num_pdfs=max(int(den.graph.pdf.max()),
                     int(batch["num_graphs"][2].max())) + 1,
        prefinal_dim=max(CHAIN_CLI_WIDTHS["hidden_dim"] // 2,
                         CHAIN_CLI_WIDTHS["bottleneck_dim"]),
        subsample_layer=min(8, max(1, CHAIN_CLI_WIDTHS["num_layers"] // 2)),
        frame_subsampling_factor=3, **CHAIN_CLI_WIDTHS)
    state, model, tx = ptrainer.make_chain_train_state(
        cfg, torch.Generator().manual_seed(0), device=dev)
    if dtype != torch.float32:
        state = optim.tree_map(lambda x: x.to(dtype), state)
        model.to(dtype)
    step_fn = ptrainer.make_sharded_train_step(
        model, tx, ChainTrainingOptions(xent_regularize=0.1), den)
    return step_fn, state, {
        "feats": torch.from_numpy(np.ascontiguousarray(feats)).to(dev,
                                                                   dtype),
        "num_graphs": batch["num_graphs"]}, model


def flax_leaves(model, tensors: dict, stats: dict) -> dict:
    """Tensors by the model's names -> {path: float64 array} of their
    flax layout's params."""
    st = ptrainer.ChainTrainState(tensors, stats, None)
    return {p: np.asarray(a, np.float64) for p, a in
            _leaves(ptrainer.load_state(model, st)["params"])}


def chain_cli_check(d: str, dev: str = "cuda") -> dict:
    """chain_cli_check: one trainer step on the first CHAIN_CLI_CHECK_EGS
    egs of chain_cli's shuffled archive at full width, on the card in
    float32 and float64 and on the CPU in float64 and float32, from the
    same fresh weights, held as train_lex_check holds its step: the
    objective within 1e-4 relative; every gradient leaf against the CPU's
    float64, each against its own largest value, the card's float64
    within 1e-6 and its float32 at most twice the CPU float32's (or
    1e-3); the card's step objective equal to its own value_and_grad; the
    optimizer's move (clip, then Adam's first update) within 1e-3 lr of
    the plain float64 update of the card's gradient."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    first = next(merged_minibatches(f"ark:{d}/egs_shuf.ark",
                                    CHAIN_CLI_CHECK_EGS))
    opts = ChainTrainingOptions(xent_regularize=0.1)
    den = den_graph_from_fst_file(f"{d}/den.fst")
    res = {}

    def grad_of(on, dtype):
        """The step's value_and_grad on `on` in `dtype` (on the card the
        step itself too) -> the gradient's leaves; the objective into
        res."""
        step_fn, state, batch, model = chain_cli_step(
            first, den, dev if on == "cuda" else on, dtype)

        def fn(outputs):
            objf, aux = chain_loss(opts, den, batch["num_graphs"], *outputs)
            return -objf, aux
        loss, _aux, _st, grads = ptrainer.value_and_grad(
            model, state.params, state.batch_stats, batch["feats"], fn)
        name = f"{on}_{str(dtype)[6:]}"
        res[name] = {"objf": float(-loss)}
        leaves = flax_leaves(model, grads, state.batch_stats)
        if name == "cuda_float32":
            new, met = step_fn(state, batch)
            res[name].update(
                grads=leaves, step_objf=float(met["objf"]),
                old=flax_leaves(model, state.params, state.batch_stats),
                new=flax_leaves(model, new.params, new.batch_stats))
            del new
        del step_fn, state, grads, model
        torch.cuda.empty_cache()
        return leaves

    agree = gradient_agreement(grad_of, reproduce=False)
    card, cpu = res["cuda_float32"], res["cpu_float64"]
    objf_rel = abs(card["objf"] - cpu["objf"]) / abs(cpu["objf"])
    lr = 1e-3
    want = adam_first_move(card["grads"], lr, 2.0)
    move_err = _move_error(card["new"], card["old"], want, lr)
    launches = kernel_launch_counts()
    out = {"egs": CHAIN_CLI_CHECK_EGS, "objf_cuda": card["objf"],
           "objf_cpu_float64": cpu["objf"], "objf_rel": objf_rel,
           "step_objf_equal": card["step_objf"] == card["objf"],
           "grad_worst_leaf_rel": agree["worst"],
           "grad_worst_leaf": agree["worst_leaf"],
           "grad_f32_bar": agree["f32_bar"], "move_err_lr": move_err,
           "parameters": sum(a.size for a in agree["g64"].values()),
           "seconds": time.perf_counter() - t0, "launches": launches,
           "tolerance": 1e-4}
    emit("chain_cli_check", **out)
    bars = {"objective": objf_rel <= 1e-4,
            "step objective = value_and_grad": out["step_objf_equal"],
            **agree["bars"],
            "optimizer": move_err <= 1e-3,
            "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"chain_cli_check: the card and the CPU disagree: "
                         f"{failed}")
    return out


def run_chain_cli_e2e(sysd: dict, d: str, dev: str = "cuda") -> dict:
    """chain_cli_e2e: nnet3-chain-e2e-get-egs on the first
    CHAIN_CLI_E2E_UTTS test utterances (their phone transcripts from the
    lexicon's first pronunciations, silence optional at every boundary),
    then nnet3-chain-compute-prob of chain_cli's trained raw nnet on them
    in this process, on the card and on the CPU (the host
    evaluator).  Bar: the card's objective finite and the CPU's
    within 1e-4 relative (each printed to 4 decimals)."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    seconds: dict = {}
    utts = sorted(sysd["test_wav"])[:CHAIN_CLI_E2E_UTTS]
    lang, lexicon = sysd["lang"], sysd["lexicon"]
    with TableWriter("matrix", f"ark:{d}/test_feats.ark") as w:
        for u, f in zip(utts, test_feats(sysd, utts, dev)):
            w.write(u, f)
    with TableWriter("int-vector", f"ark:{d}/test_phones.ark") as w:
        for u in utts:
            w.write(u, [lang.phones[p] for word in sysd["test_txt"][u]
                        for p in lexicon[word][0]])
    timed_tool(seconds, "nnet3-chain-e2e-get-egs",
               f"--optional-silence-phone={lang.phones['SIL']}",
               f"{d}/0.trans_mdl", f"ark:{d}/test_feats.ark",
               f"ark:{d}/test_phones.ark", f"ark:{d}/e2e.ark")
    args = (f"{d}/final.raw", f"{d}/den.fst", f"ark:{d}/e2e.ark")
    card = chain_prob(timed_tool(
        seconds, "nnet3-chain-compute-prob",
        *([] if dev == "cuda" else ["--use-gpu=no"]), *args))
    cpu = chain_prob(timed_tool(seconds, "nnet3-chain-compute-prob",
                                "--use-gpu=no", *args,
                                key="nnet3-chain-compute-prob --use-gpu=no"))
    launches = kernel_launch_counts()
    rel = abs(card - cpu) / max(abs(cpu), 1.0)
    out = {"utts": len(utts), "objf_cuda": card, "objf_cpu": cpu,
           "rel": rel, "seconds": time.perf_counter() - t0,
           "tool_s": seconds, "launches": launches}
    emit("chain_cli_e2e", **out)
    if not (np.isfinite(card) and rel <= 1e-4):
        raise SystemExit(f"chain_cli_e2e: card {card} against CPU {cpu}")
    if any(launches.values()):
        raise SystemExit(f"a hand kernel launched in chain_cli_e2e: "
                         f"{launches}")
    return out


def run_nnet3_train_cli(sysd: dict, d: str, dev: str = "cuda") -> dict:
    """nnet3_train_cli: the plain nnet3 tools on the first
    NNET3_TRAIN_UTTS training utterances, in this process: ali-to-pdf ->
    ali-to-post -> nnet3-get-egs (the tool's defaults: 8 frames, no
    context) -> nnet3-shuffle-egs -> nnet3-merge-egs; ali-to-post of the
    transition-ids -> post-to-pdf-post (the same archive as the pdf
    route); nnet3-train at hidden 1536, bottleneck 160 (its default 4
    layers) for 1 epoch on the card; nnet3-compute-prob on a subset of
    NNET3_TRAIN_SUBSET egs on the card; nnet3-average of two copies.
    Bars: the training objective finite, compute-prob above the uniform
    -log(pdfs), the average equal to the model, the two posterior
    routes equal, kernels a-c 0 launches."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    seconds: dict = {}
    utts = sorted(sysd["feats"])[:NNET3_TRAIN_UTTS]
    alis = dict(SequentialTableReader("int-vector", f"ark:{d}/ali.ark"))
    with TableWriter("matrix", f"ark:{d}/nn_feats.ark") as wf, \
            TableWriter("int-vector", f"ark:{d}/nn_ali.ark") as wa:
        for u in utts:
            wf.write(u, np.asarray(sysd["feats"][u], np.float32))
            wa.write(u, alis[u])
    timed_tool(seconds, "ali-to-pdf", f"{d}/0.trans_mdl",
               f"ark:{d}/nn_ali.ark", f"ark:{d}/nn_pdf.ark")
    timed_tool(seconds, "ali-to-post", f"ark:{d}/nn_pdf.ark",
               f"ark:{d}/nn_post.ark")
    timed_tool(seconds, "ali-to-post", f"ark:{d}/nn_ali.ark",
               f"ark:{d}/nn_tid_post.ark")
    timed_tool(seconds, "post-to-pdf-post", f"{d}/0.trans_mdl",
               f"ark:{d}/nn_tid_post.ark", f"ark:{d}/nn_pdf_post.ark")
    routes_equal = _same_bytes(f"{d}/nn_post.ark", f"{d}/nn_pdf_post.ark")
    log = timed_tool(seconds, "nnet3-get-egs", f"ark:{d}/nn_feats.ark",
                     f"ark:{d}/nn_post.ark", f"ark:{d}/nn_egs.ark")
    n_egs = int(re.search(r"generated (\d+) examples", log).group(1))
    timed_tool(seconds, "nnet3-shuffle-egs", f"ark:{d}/nn_egs.ark",
               f"ark:{d}/nn_egs_shuf.ark")
    log = timed_tool(seconds, "nnet3-merge-egs", f"ark:{d}/nn_egs_shuf.ark",
                     f"ark:{d}/nn_egs_merged.ark")
    n_merged = int(re.search(r"into (\d+) minibatches", log).group(1))
    gpu = [] if dev == "cuda" else ["--use-gpu=no"]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    log = timed_tool(seconds, "nnet3-train", *gpu, *NNET3_TRAIN_ARGS,
                     f"ark:{d}/nn_egs_shuf.ark", f"{d}/nn_final.raw")
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
            else None)
    m = re.search(r"nnet3-train: (\d+) steps, final objf (\S+)", log)
    steps, objf = int(m.group(1)), float(m.group(2))
    timed_tool(seconds, "nnet3-subset-egs", f"--n={NNET3_TRAIN_SUBSET}",
               f"ark:{d}/nn_egs_shuf.ark", f"ark:{d}/nn_egs_sub.ark")
    log = timed_tool(seconds, "nnet3-compute-prob", *gpu,
                     f"{d}/nn_final.raw", f"ark:{d}/nn_egs_sub.ark")
    prob = float(re.search(r"log-prob per frame: (\S+)", log).group(1))
    timed_tool(seconds, "nnet3-average", f"{d}/nn_final.raw",
               f"{d}/nn_final.raw", f"{d}/nn_avg.raw")
    avg_err = fields_max_diff(*(mdl_io.read_raw_nnet3(f"{d}/nn_{n}.raw")
                                for n in ("final", "avg")))
    num_pdfs = sysd["chain_tm"].num_pdfs
    launches = kernel_launch_counts()
    out = {"utts": len(utts), "egs": n_egs, "merged_minibatches": n_merged,
           "steps": steps, "final_objf": objf, "compute_prob": prob,
           "subset": NNET3_TRAIN_SUBSET, "uniform": -float(np.log(num_pdfs)),
           "average_max_abs_err": avg_err, "posterior_routes_equal":
           routes_equal, "peak_memory_gb": peak,
           "seconds": time.perf_counter() - t0, "tool_s": seconds,
           "launches": launches}
    emit("nnet3_train_cli", **out)
    bars = {"objective finite": bool(np.isfinite(objf)),
            "compute-prob above uniform": prob > out["uniform"],
            "average": avg_err <= 1e-6,
            "posterior routes": routes_equal,
            "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"nnet3_train_cli: {failed}")
    return out


def chain_cli_phases(sysd: dict, dev: str = "cuda") -> dict:
    """chain_cli, chain_cli_check, chain_cli_e2e and nnet3_train_cli over
    train_lex's system on `dev` -> their summary, with kernels a-c's
    launches in each."""
    d = os.path.join(REPO, "_chip", "chain_cli")
    res = {"chain_cli": run_chain_cli(sysd, d, dev)}
    res["chain_cli_check"] = chain_cli_check(d, dev)
    res["chain_cli_e2e"] = run_chain_cli_e2e(sysd, d, dev)
    res["nnet3_train_cli"] = run_nnet3_train_cli(sysd, d, dev)
    out = {k: {kk: vv for kk, vv in v.items()
               if kk not in ("launches", "profiled_step", "tool_s")}
           for k, v in res.items()}
    out["launches"] = {k: v["launches"] for k, v in res.items()}
    return out


# ---------------------------------------------------------------------------
# train_chain_frame and ng_precondition: the frame-rate chain trainer at
# the legacy TDNN-F's widths over train_lex's mono system, dropout on; the
# online natural-gradient preconditioner over its gradients; SpecAugment

# the first CHAIN_FRAME_UTTS training utterances, one epoch of chunks of
# ChainTrainOptions' defaults (60 frames, minibatches of 8): ~30 steps
CHAIN_FRAME_UTTS = 32
CHAIN_FRAME_DROPOUT = 0.1
NG_RANK, NG_STEPS = 32, 10
# the card's float32 preconditioned gradient against the CPU's float64,
# max |card - CPU| over max |CPU|, each tensor and step
NG_REL_BAR = 1e-4
NG_NORM_BAR = 1e-5
NG_TENSORS = ("input_affine.weight", "tdnnf.0.w_down", "tdnnf.8.w_up",
              "prefinal_chain.affine.weight", "output_affine.weight")
SPEC_AUGMENT_SHAPE = (8, 300, 40)


class _FedMasks:
    """components.dropout_mask replaced: each call returns the next of
    `masks` (boolean CPU tensors) on the generator's device."""

    def __init__(self, masks):
        self.masks, self.i = masks, 0

    def __call__(self, shape, keep, gen):
        m = self.masks[self.i]
        self.i += 1
        if tuple(m.shape) != tuple(shape):
            raise SystemExit(f"dropout mask {tuple(m.shape)} for {shape}")
        return m.to(gen.device)


def chain_frame_grad_of(cfg, variables, feats_b, num_graphs, den, opts,
                        masks):
    """grad_of for gradient_agreement: the first step's gradient of minus
    the chain objective, the model from `variables` in training mode with
    the dropout masks `masks` fed in -> {leaf: float64 array}."""
    from kaldi_tpu_torch.nnet3 import components as tcomp

    def grad_of(dev, dtype):
        saved = tcomp.dropout_mask
        tcomp.dropout_mask = _FedMasks(masks)
        try:
            model = chain_tdnnf_from_flax(cfg, variables, dtype, dev)
            model.train()
            model.requires_grad_(True)
            model.dropout_gen = torch.Generator(dev)
            arcs = InArcs(*batch_pack(num_graphs), cfg.num_pdfs, dev)
            with full_f32():
                chain_out, xent_out = model(
                    torch.from_numpy(feats_b).to(dev, dtype))
                objf, _ = chain_loss(opts.chain, den, arcs, chain_out,
                                     xent_out)
                objf.neg().backward()
        finally:
            tcomp.dropout_mask = saved
        for prm in model.parameters():
            prm.data = torch.zeros_like(prm) if prm.grad is None else prm.grad
        return {k: v.astype(np.float64) for k, v in
                _leaves(chain_tdnnf_to_flax(model)["params"])}
    return grad_of


def run_train_chain_frame(sysd: dict) -> dict:
    """train_chain_frame: `train_chain` (recipes/chain.py) over train_lex's
    mono GMM system, its alignments and features of the first
    CHAIN_FRAME_UTTS training utterances, at the 17 x 1536 widths with
    frame_subsampling_factor 1 and dropout CHAIN_FRAME_DROPOUT, one epoch
    of ChainTrainOptions' defaults.  Records the dropout masks' keep rate,
    the first NG_STEPS gradients of the NG_TENSORS (for ng_precondition)
    and the first minibatch; then that step's gradient on the card
    against the CPU's float64 with the same masks."""
    from kaldi_tpu_torch.nnet3 import components as tcomp
    from kaldi_tpu_torch.nnet3.models import ChainTdnnf, chain_tdnnf_init
    reset_kernel_counts()
    gmm = sysd["gmm"]
    utts = sorted(sysd["feats"])[:CHAIN_FRAME_UTTS]
    feats = {u: np.asarray(sysd["feats"][u], np.float32) for u in utts}
    alis = {u: list(sysd["alignments"][u]) for u in utts}
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=gmm.tm.num_pdfs,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=1,
                           dropout=CHAIN_FRAME_DROPOUT)
    opts = tchain.ChainTrainOptions(num_epochs=1)
    names = [n for n, _ in ChainTdnnf(cfg).named_parameters()]
    want = [names.index(n) for n in NG_TENSORS]
    spy = {"kept": 0, "drawn": 0, "grads": [], "first": None}
    draw, opt_step, fit_step = (tcomp.dropout_mask,
                                tchain.ChainOptimizer.step,
                                tchain._ChainFit.step)

    def counted_mask(shape, keep, gen):
        m = draw(shape, keep, gen)
        spy["kept"] += m.sum()
        spy["drawn"] += m.numel()
        return m

    def grads_spy(self, grads):
        if len(spy["grads"]) < NG_STEPS:
            spy["grads"].append({n: grads[i].detach().clone()
                                 for n, i in zip(NG_TENSORS, want)})
        return opt_step(self, grads)

    def first_step(self, feats_b, num_graphs, ivecs_b=None):
        if spy["first"] is None:
            spy["first"] = (feats_b, num_graphs, self.den_graph)
        return fit_step(self, feats_b, num_graphs, ivecs_b)
    tcomp.dropout_mask = counted_mask
    tchain.ChainOptimizer.step = grads_spy
    tchain._ChainFit.step = first_step
    stats: dict = {}
    t0 = time.perf_counter()
    try:
        model, variables, den = tchain.train_chain(
            gmm, feats, alis, cfg, opts, device="cuda", stats=stats)
    finally:
        tcomp.dropout_mask = draw
        tchain.ChainOptimizer.step = opt_step
        tchain._ChainFit.step = fit_step
    train_s = time.perf_counter() - t0
    del model, variables
    steps = stats["step_objf"]
    keep = float(spy["kept"]) / spy["drawn"]
    sigma = (0.9 * 0.1 / spy["drawn"]) ** 0.5
    # the first step: its initial weights (chain_tdnnf_init from the
    # trainer's seed), its minibatch, masks drawn once on the CPU
    feats_b, num_graphs, den0 = spy["first"]
    init = chain_tdnnf_init(cfg, torch.Generator().manual_seed(opts.seed))
    gen = torch.Generator().manual_seed(1)
    B, T = feats_b.shape[:2]
    masks = [torch.rand((B, T, cfg.hidden_dim), generator=gen)
             < 1.0 - CHAIN_FRAME_DROPOUT for _ in range(cfg.num_layers)]
    agree = gradient_agreement(chain_frame_grad_of(
        cfg, init, feats_b, num_graphs, den0, opts, masks))
    k = max(1, len(steps) // 6)
    res = {"utterances": len(utts), "chunks": stats["chunks"],
           "steps": len(steps), "train_s": train_s,
           "first_steps_objf": float(np.mean(steps[:k])),
           "last_steps_objf": float(np.mean(steps[-k:])),
           "step_objf": steps,
           "step_ms": ms_percentiles(np.asarray(stats["step_ms"]) / 1e3),
           "peak_memory_gb": stats.get("peak_memory_gb"),
           "dropout_keep_rate": keep, "dropout_drawn": spy["drawn"],
           "dropout_keep_sigma": sigma,
           "grad_worst": agree["worst"],
           "grad_worst_leaf": agree["worst_leaf"],
           "grad_f32_bar": agree["f32_bar"],
           "grad_reproducible": agree["reproducible"],
           "launches": kernel_launch_counts()}
    emit("train_chain_frame", **res)
    bad = [name for name, ok in (
        ("objective finite", bool(np.isfinite(steps).all())),
        ("objective rises", res["last_steps_objf"] > res["first_steps_objf"]),
        ("keep rate within 3 sigma of 0.9", abs(keep - 0.9) <= 3 * sigma),
        *agree["bars"].items()) if not ok]
    if bad:
        raise SystemExit(f"train_chain_frame: {bad}")
    return {"res": res, "grads": spy["grads"]}


def run_ng_precondition(grads: list) -> dict:
    """ng_precondition: online_natural_gradient (rank NG_RANK) over the
    first NG_STEPS gradients of train_chain_frame's NG_TENSORS, on the card
    in float32 and on the CPU in float64 from the same initial state: each
    step's preconditioned gradient within NG_REL_BAR of the CPU's, its
    norm the gradient's within NG_NORM_BAR; the card's ms an update (CUDA
    events).  Then spec_augment on a SPEC_AUGMENT_SHAPE batch on the
    card: its draws within their bounds, its output the CPU's on the same
    draws, whole bands and spans zeroed."""
    from kaldi_tpu_torch.nnet3.components import (apply_spec_augment,
                                                  spec_augment_draws)
    from kaldi_tpu_torch.nnet3.natural_gradient import online_natural_gradient
    reset_kernel_counts()
    tx = online_natural_gradient(rank=NG_RANK)
    cpu = [{k: g.cpu().double() for k, g in step.items()} for step in grads]
    s_card, s_cpu = tx.init(grads[0]), tx.init(cpu[0])
    kinds = {k: "low rank" if isinstance(f, tuple) else "dense"
             for k, f in s_card.fisher.items()}
    rel, norm_err, ms = 0.0, 0.0, []
    worst = {}
    for g_card, g_cpu in zip(grads, cpu):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with full_f32():
            ev[0].record()
            o_card, s_card = tx.update(g_card, s_card)
            ev[1].record()
            o_cpu, s_cpu = tx.update(g_cpu, s_cpu)
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        for k in o_card:
            a, b = o_card[k].double().cpu(), o_cpu[k]
            e = float((a - b).abs().max() / b.abs().max())
            worst[k] = max(worst.get(k, 0.0), e)
            rel = max(rel, e)
            n = float(torch.linalg.norm(o_card[k].double())
                      / torch.linalg.norm(g_card[k].double()))
            norm_err = max(norm_err, abs(n - 1.0))
    # SpecAugment on the card
    gen = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randn(SPEC_AUGMENT_SHAPE, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED + 1))
    f0, widths, t0, tw = spec_augment_draws(x.shape, gen)
    B, T, D = x.shape
    max_w = max(int(T * 0.1), 1)
    in_bounds = bool(((f0 >= 0) & (f0 < max(D - 10, 1))).all()
                     and ((widths >= 0) & (widths <= 10)).all()
                     and ((t0 >= 0) & (t0 < max(T - max_w, 1))).all()
                     and ((tw >= 0) & (tw <= max_w)).all())
    y = apply_spec_augment(x, f0, widths, t0, tw)
    y_cpu = apply_spec_augment(x.cpu(), f0.cpu(), widths.cpu(), t0.cpu(),
                               tw.cpu())
    zero = y == 0
    whole = bool(torch.equal(zero, zero.all(dim=1)[:, None, :]
                             | zero.all(dim=2)[:, :, None]))
    res = {"tensors": {k: list(g.shape) for k, g in grads[0].items()},
           "paths": kinds, "steps": len(grads), "rank": NG_RANK,
           "rel_err": rel, "rel_err_by_tensor": worst,
           "rel_bar": NG_REL_BAR, "norm_err": norm_err,
           "norm_bar": NG_NORM_BAR,
           "update_ms": ms_percentiles(np.asarray(ms) / 1e3),
           "spec_augment": {"shape": list(SPEC_AUGMENT_SHAPE),
                            "draws_in_bounds": in_bounds,
                            "equal_cpu": bool(torch.equal(y.cpu(), y_cpu)),
                            "whole_bands_and_spans": whole,
                            "masked_share": float(zero.float().mean())},
           "launches": kernel_launch_counts()}
    emit("ng_precondition", **res)
    bad = [name for name, ok in (
        ("low-rank path", "low rank" in kinds.values()),
        ("preconditioned gradient", rel <= NG_REL_BAR),
        ("norm kept", norm_err <= NG_NORM_BAR),
        ("spec_augment bounds", in_bounds),
        ("spec_augment card = CPU", res["spec_augment"]["equal_cpu"]),
        ("spec_augment bands and spans", whole)) if not ok]
    if bad:
        raise SystemExit(f"ng_precondition: {bad}")
    return res


def chain_frame_phases(sysd: dict) -> dict:
    """train_chain_frame and ng_precondition over train_lex's system ->
    their summary, with kernels a-c's launches in each."""
    t0 = time.perf_counter()
    frame = run_train_chain_frame(sysd)
    ng = run_ng_precondition(frame.pop("grads"))
    torch.cuda.empty_cache()
    r = frame["res"]
    launches = {"train_chain_frame": r["launches"],
                "ng_precondition": ng["launches"]}
    if any(any(c.values()) for c in launches.values()):
        raise SystemExit(f"a kernel of another path ran in the chain "
                         f"frame phases: {launches}")
    return {"train_chain_frame": {k: r[k] for k in (
                "steps", "train_s", "first_steps_objf", "last_steps_objf",
                "step_ms", "dropout_keep_rate", "peak_memory_gb")},
            "ng_precondition": {k: ng[k] for k in (
                "rel_err", "norm_err", "update_ms")},
            "seconds": time.perf_counter() - t0, "launches": launches}


def run_train_scale(epochs: int) -> dict:
    """train_scale: the --scale training recipe on the card
    (recipes/train_scale.py train_and_decode): the V=20,000 corpus, MFCC,
    the mono GMM, the alignment, the i-vector extractor, the triphone tree,
    the window-LM denominator and its bucketed layout, the chain examples,
    `epochs` epochs of the 17 x 1536 TDNN-F with i-vectors, the decode
    graph and the 128 test utterances through the main path.  The seconds
    of each stage, the leaves and tids, the denominator's states, arcs and
    slots by bucket, the chunks and steps, each epoch's objective, the
    median step ms by CUDA events, the training's peak memory, the WER and
    kernels a-c's launches (0).  Bars: the corpus fingerprint, every
    step's objective finite, the last epoch's mean above the first's, the
    WER within SCALE_WER_BAND of the committed model's train WER."""
    reset_kernel_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    t0 = time.perf_counter()
    meta = train_scale.train_and_decode(
        os.path.join(REPO, "_chip", "train_scale"), epochs, "cuda",
        stats=stats)
    seconds = time.perf_counter() - t0
    launches = kernel_launch_counts()
    sysd = stats.pop("system")
    step_ms = sorted(stats["step_ms"])
    dec = stats["decode"]
    out = {"seconds": seconds,
           "stage_s": {k: stats[k] for k in (
               "corpus_s", "mfcc_s", "mono_s", "graphs_s", "align_s",
               "ivector_s", "tree_s", "den_s", "egs_s", "chain_s",
               "graph_s", "decode_s")},
           "aligner": stats["aligner"], "leaves": stats["leaves"],
           "tids": stats["tids"], "tokens": stats["tokens"],
           "window_den": stats["window_den"], "den": stats["den"],
           "segment_skipped": stats["segment_skipped"],
           "chunks": stats["chunks"], "steps": len(stats["step_objf"]),
           "epochs": epochs, "epoch_objf": stats["epoch_objf"],
           "step_ms_median": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "chain_s_a_step": stats["chain_s"] / len(stats["step_objf"]),
           "peak_memory_gb": stats["peak_memory_gb"],
           "wer": dec["wer"], "word_errors": dec["word_errors"],
           "ref_words": dec["ref_words"],
           "lanes_decoded": dec["lanes_decoded"],
           "graph_states": dec["states"], "decode_batch_s": dec["seconds"],
           "files_equal_committed": {
               name: _same_bytes(os.path.join(REPO, "_chip", "train_scale",
                                              "chain" + ext),
                                 os.path.join(ART, "flagship_ng" + ext))
               for name, ext in (("tm", ".tm"), ("tree", ".tree"))},
           "committed_model_port_wer": SCALE_COMMITTED_PORT_WER,
           "committed_model_meta_wer": SCALE_META_WER,
           "wer_band": SCALE_WER_BAND, "corpus_hash": meta["corpus_hash"],
           "launches": launches}
    emit("train_scale", **out)
    if meta["corpus_hash"] != SCALE_FINGERPRINT:
        raise SystemExit(f"corpus fingerprint {meta['corpus_hash']}")
    if not np.isfinite(stats["step_objf"]).all():
        raise SystemExit("a training step's objective is not finite")
    if not stats["epoch_objf"][-1] > stats["epoch_objf"][0]:
        raise SystemExit("the last epoch's objective is not above the "
                         "first's")
    if dec["lanes_decoded"] != len(sysd["test_wav"]):
        raise SystemExit(f"only {dec['lanes_decoded']} lanes decoded")
    if dec["wer"] > SCALE_META_WER + SCALE_WER_BAND:
        raise SystemExit(f"train_scale WER {dec['wer']:.3f}% against the "
                         f"committed model's {SCALE_META_WER}% + "
                         f"{SCALE_WER_BAND}")
    if any(launches.values()):
        raise SystemExit(f"a hand kernel launched in train_scale: "
                         f"{launches}")
    return {"sysd": sysd, "summary": out}


def train_scale_check(trained: dict) -> dict:
    """profile_train_scale_step and train_scale_check, from the trained
    state, on real chunks of the scale system (its first utterances'
    numerators and i-vectors) through the bucketed window-LM denominator:
    one training step of 32 chunks under the profiler (its launches and
    device time), then the gradient check of SCALE_CHECK_CHUNKS chunks:
    every parameter's gradient in float64 on the card within 1e-6 of the
    CPU's float64, each leaf against its own largest value; in float32 on
    the card against the CPU's float64, the worst leaf at most twice the
    CPU float32's (or 1e-3); the card's float32 gradient a second time
    bit for bit; kernels a-c launched 0 times in each."""
    reset_kernel_counts()
    sysd = trained["sysd"]
    lang, lexicon = sysd["lang"], sysd["lexicon"]
    utts = sorted(sysd["feats"])[:16]
    prons = {u: [[lang.phones[p] for p in lexicon[w][0]]
                 for w in sysd["train_txt"][u]] for u in utts}
    segs, _ = tchain.ctx_segments(
        sysd["gmm"], {u: sysd["alignments"][u] for u in utts}, prons)
    opts = train_scale.train_options(1)
    chunks, nums = tchain.ctx_chain_egs(
        {u: sysd["feats"][u] for u in utts}, segs, sysd["chain_tm"],
        sysd["chain_tree"], opts, 3, sysd["ivectors"])
    cfg = train_scale.scale_config(sysd["chain_tm"].num_pdfs)
    prof = profile_call(lambda: tchain._fit_chain(
        cfg, sysd["den"], chunks[:32], nums[:32], opts, 150, 40,
        variables=sysd["variables"], device="cuda", use_ivectors=True),
        ranges=(tchain.STEP_RANGE,))
    step = prof["ranges"][tchain.STEP_RANGE]
    step_launches = kernel_launch_counts()
    emit("profile_train_scale_step", launches=step_launches,
         launches_a_step=step["kernel_launches"],
         device_ms_a_step=step["device_ms"], host_ms_a_step=step["host_ms"],
         span_ms=step.get("span_ms"), top=prof["top"], by_op=prof["by_op"],
         peak_memory_gb=prof["peak_memory_gb"])
    if any(step_launches.values()):
        raise SystemExit("a hand kernel launched in "
                         f"profile_train_scale_step: {step_launches}")
    reset_kernel_counts()
    chunks, nums = chunks[:SCALE_CHECK_CHUNKS], nums[:SCALE_CHECK_CHUNKS]
    feats_b = torch.from_numpy(np.stack([c[0] for c in chunks]))
    ivecs_b = torch.from_numpy(np.stack([c[2] for c in chunks]))
    packed = batch_pack(nums)
    den, variables = sysd["den"], sysd["variables"]
    t0 = time.perf_counter()
    agree = gradient_agreement(lambda dev, dt: param_grads(
        cfg, variables, feats_b, packed, den, opts, dev, dt, ivecs_b))
    launches = kernel_launch_counts()
    out = {"chunks": len(chunks), "output_frames": feats_b.shape[1] // 3,
           "parameters": sum(a.size for a in agree["g64"].values()),
           "grad_worst_leaf_rel": agree["worst"],
           "grad_worst_leaf": agree["worst_leaf"],
           "grad_f32_bar": agree["f32_bar"],
           "grad_reproducible": agree["reproducible"],
           "den": den_arcs(den, cfg.num_pdfs, torch.device("cuda"))
           .slot_sizes(), "seconds": time.perf_counter() - t0,
           "launches": launches, "profile_launches": step_launches,
           "launches_a_step": step["kernel_launches"],
           "device_ms_a_step": step["device_ms"]}
    emit("train_scale_check", **out)
    bars = {**agree["bars"], "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"train_scale_check: the card and the CPU "
                         f"disagree: {failed}")
    return out


def train_scale_phases(epochs: int = SCALE_EPOCHS,
                       keep: dict = None) -> dict:
    """train_scale and train_scale_check -> their summary, with kernels
    a-c's launches in each.  `keep`, when given, receives the system's
    training features and test waves (the i-vector phases read them)."""
    trained = run_train_scale(epochs)
    if keep is not None:
        keep.update({k: trained["sysd"][k] for k in ("feats", "test_wav")})
    check = train_scale_check(trained)
    out = dict(trained["summary"])
    out["launches"] = {"train_scale": out["launches"],
                       "profile_train_scale_step": check["profile_launches"],
                       "train_scale_check": check["launches"]}
    out["check"] = {k: check[k] for k in (
        "grad_worst_leaf_rel", "grad_reproducible", "launches_a_step",
        "device_ms_a_step")}
    del trained
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Kaldi nnet3 models: the reference golden, the flagship imported from a
# .mdl, the CLI, a TDNN-LSTM through the frame loop


@contextlib.contextmanager
def device_ms_of(cls, name: str, sink, key=None):
    """Inside the block, each call of cls.name runs between two CUDA
    events; sink gets the (start, end) pairs (read them after a sync).
    With `key`, sink is a dict and each pair goes to the list under
    key() at the call."""
    inner = getattr(cls, name)

    def wrapper(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        try:
            return inner(*args, **kw)
        finally:
            ev[1].record()
            (sink if key is None else sink.setdefault(key(), [])).append(ev)

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, inner)


def _template_args(root: str, *extra) -> list:
    return ["--train", f"{root}/train", "--test", f"{root}/test",
            "--lexicon", f"{root}/lexicon.txt", "--arpa", f"{root}/lm.arpa",
            "--dir", f"{root}/exp", *extra]


def run_template_recipe(root: str) -> dict:
    """One call of template_run.main at its defaults (egs/template/run.py
    stages 0-7) on the card over the fabricated corpus at TEMPLATE_UTTS
    and the recipe's default widths.  Returns its WER and report, the
    device ms and calls of each measured function by stage (CUDA events a
    call: MFCC, GMM scoring, the LDA, MLLT and fMLLR statistics and the
    feature transforms), and the kernel launches and peak memory of
    stages 0-5 and of stages 6-7 (split where stage 6 reads tri1)."""
    from kaldi_tpu_torch.recipes import lda_mllt
    from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
    make_standard_corpus(root, *TEMPLATE_UTTS)
    report: dict = {"stage_s": {}}
    sinks = {"mfcc": {}, "gmm": {}, "stats": {}, "transform": {}}
    split: dict = {}
    tri1_system = template_run._tri1_system

    def stage6_starts(*a, **kw):
        if not split:
            torch.cuda.synchronize()
            split.update(launches=kernel_launch_counts(),
                         peak_memory_gb=torch.cuda.max_memory_allocated()
                         / 1e9)
            torch.cuda.reset_peak_memory_stats()
        return tri1_system(*a, **kw)

    def stage():
        return str(len(report["stage_s"]))

    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    template_run._tri1_system = stage6_starts
    try:
        with device_ms_of(OfflineFeature, "_compute_frames", sinks["mfcc"],
                          stage), \
                device_ms_of(AmDiagGmm, "log_likes_device", sinks["gmm"],
                             stage), \
                device_ms_of(LdaEstimate, "accumulate_tensors",
                             sinks["stats"], stage), \
                device_ms_of(MlltAccs, "accumulate_rows", sinks["stats"],
                             stage), \
                device_ms_of(FmllrDiagGmmAccs, "accumulate_rows",
                             sinks["stats"], stage), \
                device_ms_of(lda_mllt, "apply_affine_transform",
                             sinks["transform"], stage):
            wer = template_run.main(_template_args(root), report=report)
    finally:
        template_run._tri1_system = tri1_system
    torch.cuda.synchronize()
    end = kernel_launch_counts()
    return {"wer": wer, "report": report,
            "device_ms": {name: {st: sum(a.elapsed_time(b) for a, b in evs)
                                 for st, evs in by_stage.items()}
                          for name, by_stage in sinks.items()},
            "device_calls": {name: {st: len(evs)
                                    for st, evs in by_stage.items()}
                             for name, by_stage in sinks.items()},
            "launches_0_5": split["launches"],
            "launches_6_7": {k: end[k] - split["launches"][k] for k in end},
            "peak_memory_gb_0_5": split["peak_memory_gb"],
            "peak_memory_gb_6_7": torch.cuda.max_memory_allocated() / 1e9}


def _stage_sum(by_stage: dict, stages) -> float:
    return sum(by_stage.get(str(s), 0) for s in stages)


def run_template_gmm(run: dict) -> dict:
    """template_gmm: stages 0-5 of the recipe's call (run_template_recipe),
    held to TEMPLATE_BAR."""
    report = run["report"]
    tri1 = report["tri1"]
    latgen = report["tool_stats"]["gmm-latgen-faster"]
    models = {}
    for name in ("mono", "tri1"):
        _tm, am = read_am_gmm(f"{run['root']}/exp/{name}/final.mdl",
                              device="cpu")
        models[name] = (am.num_pdfs, am.num_gauss())
    launches = run["launches_0_5"]
    stage_s = {k: v for k, v in report["stage_s"].items() if int(k) <= 5}
    out = {"utterances": list(TEMPLATE_UTTS), "wer": tri1["wer"],
           "word_errors": tri1["word_errors"],
           "ref_words": tri1["ref_words"], "bar": TEMPLATE_BAR,
           "lm_scale": tri1["lm_scale"], "penalty": tri1["penalty"],
           "hclg_states": report["hclg_states"],
           "hclg_arcs": report["hclg_arcs"], "mono": models["mono"],
           "tri1": models["tri1"], "aligned": report["aligned"][:7],
           "align_failures": report["align_failures"],
           "lattices": tri1["lattices"],
           "det_fallbacks": latgen["det_fallbacks"],
           "latgen_rtf": latgen["rtf"], "latgen": latgen,
           "mfcc_device_ms": _stage_sum(run["device_ms"]["mfcc"], range(6)),
           "mfcc_calls": _stage_sum(run["device_calls"]["mfcc"], range(6)),
           "gmm_device_ms": _stage_sum(run["device_ms"]["gmm"], range(6)),
           "gmm_calls": _stage_sum(run["device_calls"]["gmm"], range(6)),
           "peak_memory_gb": run["peak_memory_gb_0_5"],
           "stage_s": stage_s, "tool_s": report["tool_s"],
           "launches": {"template_gmm": launches},
           "seconds": sum(stage_s.values())}
    emit("template_gmm", **out)
    bar = TEMPLATE_BAR
    wer = out["wer"]
    if any(launches.values()):
        raise SystemExit("a kernel of another path ran in template_gmm")
    if abs(wer - bar["wer"]) > TEMPLATE_WER_BAND or \
            abs(out["word_errors"] - bar["word_errors"]) > \
            TEMPLATE_WORDS_BAND:
        raise SystemExit(f"template_gmm: WER {wer:.3f}% "
                         f"({out['word_errors']} errors) outside "
                         f"{TEMPLATE_WER_BAND} points and "
                         f"{TEMPLATE_WORDS_BAND} words of {bar['wer']}%")
    if (out["hclg_states"], out["hclg_arcs"]) != (bar["hclg_states"],
                                                  bar["hclg_arcs"]):
        raise SystemExit(f"template_gmm: HCLG {out['hclg_states']} states "
                         f"{out['hclg_arcs']} arcs, the JAX recipe's "
                         f"{bar['hclg_states']} and {bar['hclg_arcs']}")
    if out["align_failures"] or out["det_fallbacks"] or \
            out["lattices"] != TEMPLATE_UTTS[1]:
        raise SystemExit(f"template_gmm: {out['align_failures']} alignment "
                         f"failures, {out['det_fallbacks']} determinization "
                         f"fallbacks, {out['lattices']} lattices")
    if models["mono"][0] != bar["mono"][0]:
        raise SystemExit(f"template_gmm: mono has {models['mono'][0]} pdfs, "
                         f"the JAX recipe's {bar['mono'][0]}")
    return out


def _rel_to_largest(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def template_systems(root: str, device) -> dict:
    """tri2 and tri3 of the recipe's run read back on `device`, the train
    set's features (raw, spliced, in tri2's space), texts and speakers,
    and each system's alignments of the train set (the recipe's aligner
    on the card)."""
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
    from kaldi_tpu_torch.feat.functions import splice_frames
    from kaldi_tpu_torch.recipes.lda_mllt import transform_all
    from kaldi_tpu_torch.recipes.mono import MonoSystem, _align_all
    exp = f"{root}/exp"
    lexicon = template_run.read_lexicon(f"{root}/lexicon.txt")
    feats = dict(SequentialTableReader("matrix",
                                       f"ark:{root}/train/feats.ark"))
    texts = template_run.read_texts(f"{root}/train")
    mat = read_kaldi_object(iof.read_matrix, f"{exp}/tri2/final.mat")
    spliced = {u: splice_frames(f, 2, 2) for u, f in feats.items()}
    out = {"feats": feats, "spliced": spliced, "mat": mat,
           "feats2": transform_all(spliced, mat, "cuda"),
           "utt2spk": template_run.read_utt2spk(f"{root}/train")}
    for name, fs in (("tri2", out["feats2"]), ("tri3", feats)):
        lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
        tm, am = read_am_gmm(f"{exp}/{name}/final.mdl", device=device)
        lang.topo = tm.topo
        tree = read_kaldi_object(ContextDependency.read, f"{exp}/{name}/tree")
        sys_ = MonoSystem(lang, tree, tm, am)
        compiler = TrainingGraphCompiler(tm, tree, lang)
        out[name] = sys_
        out[f"ali_{name[-1]}"] = _align_all(
            sys_, {u: compiler.compile(texts[u]) for u in fs}, fs, 10.0,
            0.1, 1.0)
    return out


def template_stats(s: dict, device) -> dict:
    """The LDA, MLLT and fMLLR statistics of the recipe's passes, from
    the systems and alignments of `template_systems`, accumulated on
    `device`: LDA over the spliced features by tri2's pdfs, MLLT in
    tri2's space, each train speaker's fMLLR under tri3."""
    from kaldi_tpu_torch.recipes import lda_mllt
    tri2 = s["tri2"] if device == "cuda" else s["tri2_cpu"]
    tri3 = s["tri3"] if device == "cuda" else s["tri3_cpu"]
    lda = lda_mllt.lda_estimate(tri2, s["spliced"], s["ali_2"])
    mllt = MlltAccs(s["mat"].shape[0], device=device)
    mllt.accumulate_groups(lda_mllt.mllt_groups(tri2, s["feats2"],
                                                s["ali_2"]))
    fmllr = lda_mllt.speaker_fmllr_accs(tri3, s["feats"], s["ali_3"],
                                        s["utt2spk"])
    return {"lda": lda, "mllt": mllt, "fmllr": fmllr}


def template_tools_check(root: str, s: dict, stats: dict) -> dict:
    """The tools of steps/train_lda_mllt.sh and steps/train_sat.sh over
    the run's files, in process on the card, against the in-process
    matrices: acc-lda -> est-lda, gmm-acc-mllt -> est-mllt ->
    compose-transforms, transform-feats, gmm-est-fmllr --spk2utt.
    Returns each comparison's largest difference relative to the
    in-process matrix's largest magnitude, and the tools' seconds."""
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.cli import get_tool
    from kaldi_tpu_torch.recipes import lda_mllt
    exp, d = f"{root}/exp", f"{root}/exp/tools"
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    for name, table in (("spliced", s["spliced"]), ("feats2", s["feats2"])):
        with TableWriter("matrix", f"ark:{d}/{name}.ark") as w:
            for u in s["ali_2"]:
                w.write(u, table[u])
    for n in ("2", "3"):
        with TableWriter("int-vector", f"ark:{d}/ali{n}.ark") as w:
            for u, a in s[f"ali_{n}"].items():
                w.write(u, a)
    spk2utt: dict = {}
    for u in s["ali_3"]:
        spk2utt.setdefault(s["utt2spk"].get(u, u), []).append(u)
    with open(f"{d}/spk2utt", "w") as f:
        for spk, us in spk2utt.items():
            f.write(f"{spk} {' '.join(us)}\n")

    def sh(tool, *args):
        rc = get_tool(tool)([tool, *map(str, args)])
        if rc != 0:
            raise SystemExit(f"template_lda_sat: {tool} failed ({rc})")

    def mat(path):
        return read_kaldi_object(iof.read_matrix, path)

    sh("ali-to-post", f"ark:{d}/ali2.ark", f"ark:{d}/post2.ark")
    sh("ali-to-post", f"ark:{d}/ali3.ark", f"ark:{d}/post3.ark")
    sh("acc-lda", f"{exp}/tri2/final.mdl", f"ark:{d}/spliced.ark",
       f"ark:{d}/ali2.ark", f"{d}/lda.acc")
    sh("est-lda", f"--dim={s['mat'].shape[0]}", f"{d}/lda.mat",
       f"{d}/lda.acc")
    sh("gmm-acc-mllt", f"{exp}/tri2/final.mdl", f"ark:{d}/feats2.ark",
       f"ark:{d}/post2.ark", f"{d}/mllt.acc")
    sh("est-mllt", f"{d}/mllt.mat", f"{d}/mllt.acc")
    sh("compose-transforms", f"{d}/mllt.mat", f"{exp}/tri2/final.mat",
       f"{d}/composed.mat")
    sh("transform-feats", f"{exp}/tri2/final.mat", f"ark:{d}/spliced.ark",
       f"ark:{d}/transformed.ark")
    sh("gmm-est-fmllr", f"--spk2utt=ark:{d}/spk2utt",
       f"{exp}/tri3/final.mdl", f"ark:{root}/train/feats.ark",
       f"ark:{d}/post3.ark", f"ark:{d}/fmllr.ark")
    tools_s = time.perf_counter() - t0
    lda, _ = stats["lda"].estimate(LdaOptions(dim=s["mat"].shape[0]))
    M, _ = stats["mllt"].update()
    W = s["mat"]
    composed = np.concatenate([M @ W[:, :-1], (M @ W[:, -1])[:, None]],
                              axis=1)
    transformed = dict(SequentialTableReader("matrix",
                                             f"ark:{d}/transformed.ark"))
    fmllr = dict(SequentialTableReader("matrix", f"ark:{d}/fmllr.ark"))
    want_fmllr = {spk: a.update()[0] for spk, a in stats["fmllr"].items()}
    out = {"est-lda": _rel_to_largest(mat(f"{d}/lda.mat"), lda),
           "est-mllt": _rel_to_largest(mat(f"{d}/mllt.mat"), M),
           "compose-transforms": _rel_to_largest(mat(f"{d}/composed.mat"),
                                                 composed),
           "transform-feats": max(_rel_to_largest(transformed[u], s["feats2"][u])
                                  for u in s["feats2"]),
           "gmm-est-fmllr": max(_rel_to_largest(fmllr[spk], want_fmllr[spk])
                                for spk in want_fmllr),
           "fmllr_speakers": sorted(fmllr) == sorted(want_fmllr),
           "transformed_utterances": len(transformed),
           "tools_s": tools_s}
    return out


def run_template_lda_sat(run: dict) -> dict:
    """template_lda_sat: stages 6-7 of the recipe's call
    (run_template_recipe), held to TEMPLATE_LDA_SAT_BAR; then the LDA,
    MLLT and fMLLR statistics rebuilt from the run's tri2 and tri3 and
    their alignments on the card and on the CPU (agreeing to
    TEMPLATE_STATS_TOL of their largest magnitude), and the transform
    tools over the run's files against the in-process matrices (to
    TEMPLATE_TOOLS_TOL)."""
    root, report = run["root"], run["report"]
    t0 = time.perf_counter()
    reset_kernel_counts()
    s = template_systems(root, "cuda")
    for name in ("tri2", "tri3"):
        tm, am = read_am_gmm(f"{root}/exp/{name}/final.mdl", device="cpu")
        s[f"{name}_cpu"] = tmono.MonoSystem(s[name].lang, s[name].tree, tm,
                                            am)
    stats_ev: list = []
    with device_ms_of(MlltAccs, "accumulate_rows", stats_ev), \
            device_ms_of(FmllrDiagGmmAccs, "accumulate_rows", stats_ev), \
            device_ms_of(LdaEstimate, "accumulate_tensors", stats_ev):
        card = template_stats(s, "cuda")
    torch.cuda.synchronize()
    t_cpu = time.perf_counter()
    cpu = template_stats(s, "cpu")
    cpu_s = time.perf_counter() - t_cpu
    agree = {
        "lda": max(_rel_to_largest(getattr(card["lda"], k),
                                   getattr(cpu["lda"], k))
                   for k in ("zero_acc", "first_acc", "total_second_acc")),
        "mllt": max(_rel_to_largest(card["mllt"].G, cpu["mllt"].G),
                    _rel_to_largest(card["mllt"].beta, cpu["mllt"].beta)),
        "fmllr": max(max(_rel_to_largest(getattr(card["fmllr"][spk], k),
                                         getattr(cpu["fmllr"][spk], k))
                         for k in ("beta", "K", "G"))
                     for spk in cpu["fmllr"])}
    check_s = time.perf_counter() - t0
    tools = template_tools_check(root, s, card)
    launches = {k: run["launches_6_7"][k] + v
                for k, v in kernel_launch_counts().items()}
    tri2, tri3 = report["tri2"], report["tri3"]
    speakers = {split: len(set(template_run.read_utt2spk(
        f"{root}/{split}").values())) for split in ("train", "test")}
    stages = (6, 7)
    out = {"utterances": list(TEMPLATE_UTTS),
           "tri2": tri2, "tri3": tri3, "bar": TEMPLATE_LDA_SAT_BAR,
           "speakers": speakers, "aligned": report["aligned"][7:],
           "align_failures": report["align_failures"],
           "decode_failures": report["decode_failures"],
           "stage_s": {str(st): report["stage_s"][str(st)] for st in stages},
           "gmm_device_ms": _stage_sum(run["device_ms"]["gmm"], stages),
           "gmm_calls": _stage_sum(run["device_calls"]["gmm"], stages),
           "stats_device_ms": _stage_sum(run["device_ms"]["stats"], stages),
           "stats_calls": _stage_sum(run["device_calls"]["stats"], stages),
           "transform_device_ms": _stage_sum(run["device_ms"]["transform"],
                                             stages),
           "transform_calls": _stage_sum(run["device_calls"]["transform"],
                                         stages),
           "peak_memory_gb": run["peak_memory_gb_6_7"],
           "check": {"card_vs_cpu": agree, "tol": TEMPLATE_STATS_TOL,
                     "card_stats_device_ms": sum(a.elapsed_time(b)
                                                 for a, b in stats_ev),
                     "cpu_stats_s": cpu_s, "seconds": check_s,
                     "pdfs_aligned": {n: s[n].am.num_pdfs
                                      for n in ("tri2", "tri3")}},
           "tools": {**tools, "tol": TEMPLATE_TOOLS_TOL},
           "launches": {"template_lda_sat": launches},
           "seconds": sum(report["stage_s"][str(st)] for st in stages)
           + time.perf_counter() - t0}
    emit("template_lda_sat", **out)
    bar = TEMPLATE_LDA_SAT_BAR
    if any(launches.values()):
        raise SystemExit(f"a hand kernel launched in template_lda_sat: "
                         f"{launches}")
    for name in ("tri2", "tri3"):
        got, want = out[name], bar[name]
        if abs(got["wer"] - want["wer"]) > TEMPLATE_WER_BAND or \
                abs(got["word_errors"] - want["word_errors"]) > \
                TEMPLATE_WORDS_BAND:
            raise SystemExit(
                f"template_lda_sat: {name} WER {got['wer']:.3f}% "
                f"({got['word_errors']} errors) outside {TEMPLATE_WER_BAND} "
                f"points and {TEMPLATE_WORDS_BAND} words of the JAX "
                f"recipe's {want['wer']}%")
    if tuple(tri2["final_mat"]) != bar["final_mat"]:
        raise SystemExit(f"template_lda_sat: final.mat {tri2['final_mat']}, "
                         f"the JAX recipe's {bar['final_mat']}")
    if (tri3["train_speakers"], tri3["test_speakers"]) != \
            (speakers["train"], speakers["test"]):
        raise SystemExit(f"template_lda_sat: {tri3['train_speakers']} train "
                         f"and {tri3['test_speakers']} test speaker "
                         f"transforms for {speakers}")
    if out["align_failures"] or out["decode_failures"] or \
            any(n != TEMPLATE_UTTS[0] for n in out["aligned"]):
        raise SystemExit(f"template_lda_sat: {out['align_failures']} "
                         f"alignment failures, {out['decode_failures']} "
                         f"decode failures, aligned {out['aligned']}")
    if max(agree.values()) > TEMPLATE_STATS_TOL:
        raise SystemExit(f"template_lda_sat: the card's statistics against "
                         f"the CPU's: {agree}")
    bad = {k: v for k, v in tools.items() if k in (
        "est-lda", "est-mllt", "compose-transforms", "transform-feats",
        "gmm-est-fmllr") and not v <= TEMPLATE_TOOLS_TOL}
    if bad or not tools["fmllr_speakers"] or \
            tools["transformed_utterances"] != TEMPLATE_UTTS[0]:
        raise SystemExit(f"template_lda_sat: the tools against the "
                         f"in-process matrices: {tools}")
    return out


def run_template_chain_e2e(root: str, epochs: int) -> dict:
    """template_chain_e2e: `--stage 8 --chain-epochs epochs` over the
    recipe's directory (the flat-start e2e TDNN-F trained on the card, the
    test set decoded), its WER held within TEMPLATE_CHAIN_WER_BAND of the
    JAX recipe's at the same epochs; then one step under torch.profiler."""
    from kaldi_tpu_torch.decoder.graph import Lang
    if epochs not in TEMPLATE_CHAIN_BAR:
        raise SystemExit(f"template_chain_e2e: no JAX bar at {epochs} "
                         f"epochs (TEMPLATE_CHAIN_BAR: "
                         f"{sorted(TEMPLATE_CHAIN_BAR)})")
    t0 = time.perf_counter()
    report: dict = {}
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    wer = template_run.main(_template_args(
        root, "--stage", "8", "--chain-epochs", str(epochs)), report=report)
    torch.cuda.synchronize()
    launches = kernel_launch_counts()
    chain = report["chain"]
    train = chain["train"]
    # one step more, under the profiler: the first 4 utterances, one epoch
    feats = dict(itertools.islice(SequentialTableReader(
        "matrix", f"ark:{root}/train/feats.ark"), 4))
    lang = Lang(template_run.read_lexicon(f"{root}/lexicon.txt"),
                sil_phone="SIL", sil_prob=0.5)
    prof = profile_call(lambda: tchain.train_chain_e2e(
        lang, feats, template_run.read_texts(f"{root}/train"),
        opts=tchain.ChainTrainOptions(num_epochs=1, learning_rate=2e-3,
                                      minibatch_size=4), device="cuda"),
        ranges=(tchain.STEP_RANGE,))
    step = prof["ranges"][tchain.STEP_RANGE]
    step_launches = kernel_launch_counts()
    bar = TEMPLATE_CHAIN_BAR[epochs]
    out = {"utterances": list(TEMPLATE_UTTS), "epochs": epochs,
           "wer": wer, "word_errors": chain["word_errors"],
           "ref_words": chain["ref_words"],
           "acoustic_scale": chain["acoustic_scale"], "bar": bar,
           "hclg_states": chain["hclg_states"],
           "hclg_arcs": chain["hclg_arcs"],
           "epoch_objf": train["epoch_objf"],
           "steps": len(train["step_objf"]),
           "step_ms_median": float(np.median(train["step_ms"])),
           "step_ms_p90": float(np.percentile(train["step_ms"], 90)),
           "train_s": train["train_s"],
           "launches_a_step": step["kernel_launches"],
           "device_ms_a_step": step["device_ms"],
           "host_ms_a_step": step["host_ms"],
           "peak_memory_gb": train["peak_memory_gb"],
           "stage_s": report["stage_s"],
           "launches": {"template_chain_e2e": launches,
                        "profile_template_chain_step": step_launches},
           "seconds": time.perf_counter() - t0}
    emit("template_chain_e2e", **out)
    if any(launches.values()) or any(step_launches.values()):
        raise SystemExit(f"a hand kernel launched in template_chain_e2e: "
                         f"{launches} {step_launches}")
    if abs(wer - bar["wer"]) > TEMPLATE_CHAIN_WER_BAND:
        raise SystemExit(f"template_chain_e2e: WER {wer:.3f}% outside "
                         f"{TEMPLATE_CHAIN_WER_BAND} points of the JAX "
                         f"recipe's {bar['wer']}% at {epochs} epochs")
    if not train["epoch_objf"][-1] > train["epoch_objf"][0]:
        raise SystemExit("template_chain_e2e: the last epoch's objective "
                         "is not above the first's")
    if not step["kernel_launches"] or not step["device_ms"]:
        raise SystemExit("template_chain_e2e: the profiled step launched "
                         "nothing on the card")
    return out


def template_phases(epochs: int = TEMPLATE_CHAIN_EPOCHS) -> dict:
    """The generic corpus recipe's three phases over one directory:
    template_gmm (stages 0-5) and template_lda_sat (stages 6-7) from one
    call at the recipe's defaults, then template_chain_e2e (stage 8);
    then the synthetic demo recipe (synthetic_run)."""
    with tempfile.TemporaryDirectory() as root:
        run = run_template_recipe(root)
        run["root"] = root
        out = {"template_gmm": run_template_gmm(run),
               "mkgraph_template": run_mkgraph_template(run),
               "template_lda_sat": run_template_lda_sat(run),
               "template_chain_e2e": run_template_chain_e2e(root, epochs)}
    with tempfile.TemporaryDirectory() as root:
        out["synthetic_run"] = run_synthetic(root)
    return out


# ---------------------------------------------------------------------------
# the i-vector tool chain: the UBMs, the extractor, extraction and the sid
# back end through the port's tools, and the flagship extractor through them


def mfcc_of(fe, waves: dict) -> dict:
    """{utt: (T, D) float32} of the waves, 64 utterances a batch."""
    keys = sorted(waves)
    out = {}
    for i in range(0, len(keys), 64):
        part = keys[i:i + 64]
        f, n = fe.compute_batch_device([waves[u] for u in part])
        f = f.cpu().numpy()
        out.update((u, f[j, :n[j]]) for j, u in enumerate(part))
    return out


def ivec_tool(sec: dict, dev: str, tool: str, *args, key: str = "") -> str:
    """timed_tool of an i-vector, VTLN or back-end tool, on the CPU with
    dev "cpu"."""
    from kaldi_tpu_torch.cli.ivector_tools import DEVICE_TOOLS as IV
    from kaldi_tpu_torch.cli.vtln_tools import DEVICE_TOOLS as VT
    on_card = IV + VT + ("compute-mfcc-feats",)
    extra = ["--use-gpu=no"] if dev == "cpu" and tool in on_card else []
    return timed_tool(sec, tool, *extra, *args, key=key)


def ivector_data(d: str, feats: dict = None, test_wav: dict = None,
                 dev: str = "cuda") -> dict:
    """The --scale corpus's features as archives under d: the training
    utterances' (train_scale's, or the corpus made and featurized here),
    the test utterances' (the main path's frontend on the card),
    IVECTOR_SPLITS splits of the training set, each set's spk2utt and
    utt2spk (speaker i mod 24), the trials of the 24 speakers against the
    128 test utterances."""
    spec = bench_scale_spec()
    t0 = time.perf_counter()
    fe = OfflineFeature(mfcc_options(spec), device=dev)
    if feats is None or test_wav is None:
        _, _, train_wav, _, test_wav, _ = make_corpus(spec)
        feats = mfcc_of(fe, train_wav)
        del train_wav
    test = mfcc_of(fe, test_wav)
    mfcc_s = time.perf_counter() - t0

    def spk(u):
        return f"spk{int(u[2:]) % spec.num_speakers:02d}"

    def write(name, fs, keys):
        with TableWriter("matrix", f"ark:{os.path.join(d, name)}") as w:
            for u in keys:
                w.write(u, fs[u])

    def lines(name, rows):
        with open(os.path.join(d, name), "w") as f:
            f.write("".join(r + "\n" for r in rows))

    sets = {"train": feats, "test": test}
    for name, fs in sets.items():
        keys = sorted(fs)
        write(f"{name}.ark", fs, keys)
        s2u = {}
        for u in keys:
            s2u.setdefault(spk(u), []).append(u)
        lines(f"{name}.spk2utt", [f"{s} {' '.join(us)}"
                                  for s, us in sorted(s2u.items())])
        lines(f"{name}.utt2spk", [f"{u} {spk(u)}" for u in keys])
    keys = sorted(feats)
    for j in range(IVECTOR_SPLITS):
        write(f"train.{j}.ark", feats, keys[j::IVECTOR_SPLITS])
    write("check.ark", feats, keys[:IVECTOR_CHECK_UTTS])
    models = sorted({spk(u) for u in keys})
    trials = [(s, u) for s in models for u in sorted(test)]
    lines("trials", [f"{s} {u}" for s, u in trials])
    lines("flagship.utt2utt", [f"{u} {u}" for u in sorted(test)])
    return {"train": feats, "test": test, "mfcc_s": mfcc_s,
            "targets": {(s, u) for s, u in trials if spk(u) == s},
            "trials": len(trials), "frames": int(sum(
                f.shape[0] for f in feats.values()))}


def ubm_avg_loglike(path: str, full: bool, feats: dict,
                    dev: str = "cuda") -> float:
    """The UBM's average log-likelihood a frame over the training frames
    on the card, scored as its acc-stats tool scores them."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.gmm.ubm import UbmScorer
    sc = UbmScorer(read_kaldi_object(FullGmm.read if full else DiagGmm.read,
                                     path), dev)
    x = sc.frames(np.concatenate([feats[u] for u in sorted(feats)]))
    return float(sc.log_likelihood(x).to(torch.float64).mean())


def read_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def peak_gb(dev: str):
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else None)


def run_ivector_train(d: str, data: dict, dev: str = "cuda") -> dict:
    """ivector_train: the diagonal UBM (gmm-global-init-from-feats, then
    4 x gmm-global-acc-stats / gmm-global-est), the full UBM
    (gmm-global-to-fgmm, 4 x fgmm-global-acc-stats over the 4 splits,
    fgmm-global-sum-accs, fgmm-global-est), the extractor
    (ivector-extractor-init --use-full-ubm, 10 x acc-stats over the 4
    splits, sum-accs, est), ivector-extract-online2 of both sets over
    their spk2utt; all in this process on the card.  The UBM's average
    log-likelihood a frame after each of its 9 files, the seconds of each
    EM iteration, the mean norm of each utterance's last online i-vector
    (offset removed), the peak memory, kernels a-c's launches (0).  Then
    the check: fgmm-global-acc-stats, ivector-extractor-acc-stats and
    ivector-extract of IVECTOR_CHECK_UTTS utterances with --use-gpu=no and
    on the card.  Bars: each log-likelihood within IVECTOR_LL_BAND of
    IVECTOR_JAX_BAR's, the card's statistics within IVECTOR_STATS_TOL of
    the CPU's largest element, its i-vectors within IVECTOR_IVEC_TOL."""
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractorStats
    reset_kernel_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    u = IVECTOR_UBM
    sec: dict = {}
    iter_s: dict = {"diag": [], "full": [], "extractor": []}
    ll = {}

    def p(name):
        return os.path.join(d, name)

    tr = "ark:" + p("train.ark")
    t_all = time.perf_counter()
    ivec_tool(sec, dev, "gmm-global-init-from-feats",
              f"--num-gauss={u['num_gauss']}",
              f"--num-iters={u['init_iters']}",
              f"--num-frames={u['num_frames']}", tr, p("0.dubm"))
    ll["init"] = ubm_avg_loglike(p("0.dubm"), False, data["train"], dev)
    for it in range(u["diag_iters"]):
        t0 = time.perf_counter()
        ivec_tool(sec, dev, "gmm-global-acc-stats", p(f"{it}.dubm"), tr,
                  p(f"{it}.dacc"))
        ivec_tool(sec, dev, "gmm-global-est", p(f"{it}.dubm"), p(f"{it}.dacc"),
                  p(f"{it + 1}.dubm"))
        iter_s["diag"].append(time.perf_counter() - t0)
        ll[f"diag{it + 1}"] = ubm_avg_loglike(p(f"{it + 1}.dubm"), False,
                                              data["train"], dev)
    ivec_tool(sec, dev, "gmm-global-to-fgmm", p(f"{u['diag_iters']}.dubm"),
              p("0.ubm"))
    for it in range(u["full_iters"]):
        t0 = time.perf_counter()
        accs = [p(f"{it}.{j}.facc") for j in range(IVECTOR_SPLITS)]
        for j, acc in enumerate(accs):
            ivec_tool(sec, dev, "fgmm-global-acc-stats", p(f"{it}.ubm"),
                      "ark:" + p(f"train.{j}.ark"), acc)
        ivec_tool(sec, dev, "fgmm-global-sum-accs", p(f"{it}.facc"), *accs)
        ivec_tool(sec, dev, "fgmm-global-est", p(f"{it}.ubm"), p(f"{it}.facc"),
                  p(f"{it + 1}.ubm"))
        iter_s["full"].append(time.perf_counter() - t0)
        ll[f"full{it + 1}"] = ubm_avg_loglike(p(f"{it + 1}.ubm"), True,
                                              data["train"], dev)
    ubm = p(f"{u['full_iters']}.ubm")
    ivec_tool(sec, dev, "ivector-extractor-init", "--use-full-ubm",
              f"--ivector-dim={IVECTOR_DIM}", ubm, p("0.ie"))
    for it in range(IVECTOR_ITERS):
        t0 = time.perf_counter()
        accs = [p(f"{it}.{j}.iacc") for j in range(IVECTOR_SPLITS)]
        for j, acc in enumerate(accs):
            ivec_tool(sec, dev, "ivector-extractor-acc-stats", p(f"{it}.ie"),
                      "ark:" + p(f"train.{j}.ark"), acc)
        ivec_tool(sec, dev, "ivector-extractor-sum-accs", p(f"{it}.iacc"),
                  *accs)
        ivec_tool(sec, dev, "ivector-extractor-est", p(f"{it}.ie"),
                  p(f"{it}.iacc"), p(f"{it + 1}.ie"))
        iter_s["extractor"].append(time.perf_counter() - t0)
        for f in accs + [p(f"{it}.iacc"), p(f"{it}.ie")]:
            os.remove(f)
    final = p(f"{IVECTOR_ITERS}.ie")
    norms = {}
    for name in ("train", "test"):
        ivec_tool(sec, dev, "ivector-extract-online2",
                  f"--ivector-period={IVECTOR_PERIOD}",
                  "ark:" + p(f"{name}.spk2utt"), final,
                  "ark:" + p(f"{name}.ark"), "ark:" + p(f"{name}.online"),
                  key=f"ivector-extract-online2 {name}")
        last = np.stack([np.asarray(m[-1], np.float64) for _, m in
                         SequentialTableReader("matrix", "ark:" +
                                               p(f"{name}.online"))])
        last[:, 0] -= 100.0      # ivector-extractor-init's prior offset
        norms[name] = float(np.linalg.norm(last, axis=1).mean())
    seconds = time.perf_counter() - t_all
    launches = kernel_launch_counts()
    peak = peak_gb(dev)
    # the card against the CPU on the same files
    ck = "ark:" + p("check.ark")
    sides = (("card", "yes" if dev == "cuda" else "no"), ("cpu", "no"))
    for side, use_gpu in sides:
        timed_tool(sec, "fgmm-global-acc-stats", f"--use-gpu={use_gpu}", ubm,
                   ck, p(f"check.{side}.facc"), key=f"check {side}")
        timed_tool(sec, "ivector-extractor-acc-stats", f"--use-gpu={use_gpu}",
                   final, ck, p(f"check.{side}.iacc"), key=f"check {side}")
        timed_tool(sec, "ivector-extract", f"--use-gpu={use_gpu}", final, ck,
                   "ark:" + p(f"check.{side}.ivec"), key=f"check {side}")
    fy, fn = read_npz(p("check.card.facc")), read_npz(p("check.cpu.facc"))
    iy, inn = (read_kaldi_object(IvectorExtractorStats.read,
                                 p(f"check.{g}.iacc"))
               for g in ("card", "cpu"))
    vy, vn = (np.stack([np.asarray(v) for _, v in SequentialTableReader(
        "vector", "ark:" + p(f"check.{g}.ivec"))]) for g in ("card", "cpu"))
    check = {f"full_ubm_{k}": _rel_to_largest(fy[k], fn[k]) for k in fn}
    check["extractor_A"] = _rel_to_largest(iy.A, inn.A)
    check["extractor_B"] = _rel_to_largest(iy.B, inn.B)
    check["ivectors_max_abs"] = float(np.abs(vy - vn).max())
    bar = IVECTOR_JAX_BAR["ubm_avg_loglike"]
    ll_diff = {k: abs(v - bar[k]) for k, v in ll.items()}
    out = {"seconds": seconds, "tool_s": sec, "em_iter_s": iter_s,
           "ubm_avg_loglike": ll, "jax_ubm_avg_loglike": bar,
           "ubm_loglike_diff": ll_diff, "frames": data["frames"],
           "mfcc_s": data["mfcc_s"], "online_last_norm_mean": norms,
           "check": check, "check_utts": IVECTOR_CHECK_UTTS,
           "peak_memory_gb": peak, "launches": launches}
    emit("ivector_train", **out)
    bars = {"ubm loglike": max(ll_diff.values()) <= IVECTOR_LL_BAND,
            "card statistics": max(v for k, v in check.items()
                                   if k != "ivectors_max_abs")
            <= IVECTOR_STATS_TOL,
            "card i-vectors": check["ivectors_max_abs"] <= IVECTOR_IVEC_TOL,
            "online norms finite": all(np.isfinite(list(norms.values()))),
            "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"ivector_train: {failed}")
    out["final"] = final
    return out


def eer_from_scores(path: str, targets: set, d: str, name: str) -> float:
    """compute-eer (in this process) of a scores file's trials labelled
    by `targets`."""
    lab = os.path.join(d, name + ".labeled")
    with open(path) as f, open(lab, "w") as g:
        for line in f:
            a, b, sc = line.split()
            g.write(f"{sc} {'target' if (a, b) in targets else 'nontarget'}"
                    "\n")
    out = timed_tool({}, "compute-eer", lab)
    return float(re.findall(r"^(\S+)%$", out, re.M)[-1])


def run_ivector_sid(d: str, data: dict, final: str,
                    dev: str = "cuda") -> dict:
    """ivector_sid: the sre v1 back end over ivector_train's extractor:
    compute-vad, select-voiced-frames, ivector-extract of both sets,
    ivector-mean over the training spk2utt (24 models), ivector-compute-lda
    --dim=23, then ivector-transform, ivector-subtract-global-mean and
    ivector-normalize-length of the training i-vectors, the models and the
    test i-vectors, ivector-compute-plda over the training ones,
    ivector-plda-scoring of the 3,072 trials and compute-eer,
    ivector-compute-dot-products and compute-eer.  Bars: each EER within
    IVECTOR_EER_BAND of IVECTOR_JAX_BAR's; kernels a-c 0 launches."""
    reset_kernel_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sec: dict = {}

    def p(name):
        return os.path.join(d, name)

    def a(name):
        return "ark:" + p(name)

    t_all = time.perf_counter()
    voiced = {}
    for name in ("train", "test"):
        ivec_tool(sec, dev, "compute-vad", a(f"{name}.ark"), a(f"{name}.vad"))
        ivec_tool(sec, dev, "select-voiced-frames", a(f"{name}.ark"),
                  a(f"{name}.vad"), a(f"{name}.voiced"))
        v = [np.asarray(x) for _, x in SequentialTableReader(
            "vector", a(f"{name}.vad"))]
        voiced[name] = float(np.concatenate(v).mean())
        ivec_tool(sec, dev, "ivector-extract", final, a(f"{name}.voiced"),
                  a(f"{name}.ivec"))
    ivec_tool(sec, dev, "ivector-mean", a("train.spk2utt"), a("train.ivec"),
              a("spk.ivec"), a("num_utts"))
    ivec_tool(sec, dev, "ivector-compute-lda", f"--dim={IVECTOR_LDA_DIM}",
              a("train.ivec"), a("train.utt2spk"), p("lda.mat"))
    for name in ("train", "spk", "test"):
        ivec_tool(sec, dev, "ivector-transform", p("lda.mat"),
                  a(f"{name}.ivec"), a(f"{name}.lda"))
        ivec_tool(sec, dev, "ivector-subtract-global-mean", a(f"{name}.lda"),
                  a(f"{name}.cen"))
        ivec_tool(sec, dev, "ivector-normalize-length", a(f"{name}.cen"),
                  a(f"{name}.norm"))
    ivec_tool(sec, dev, "ivector-compute-plda", a("train.spk2utt"),
              a("train.norm"), p("plda"))
    ivec_tool(sec, dev, "ivector-plda-scoring", "--num-utts=" + a("num_utts"),
              p("plda"), a("spk.norm"), a("test.norm"), p("trials"),
              p("scores.plda"))
    ivec_tool(sec, dev, "ivector-compute-dot-products", p("trials"),
              a("spk.norm"), a("test.norm"), p("scores.dot"))
    eer = {"plda": eer_from_scores(p("scores.plda"), data["targets"], d,
                                   "plda"),
           "dot": eer_from_scores(p("scores.dot"), data["targets"], d,
                                  "dot")}
    test_norm = float(np.mean([np.linalg.norm(v) for _, v in
                               SequentialTableReader("vector",
                                                     a("test.ivec"))]))
    seconds = time.perf_counter() - t_all
    launches = kernel_launch_counts()
    jax = {"plda": IVECTOR_JAX_BAR["eer_plda"],
           "dot": IVECTOR_JAX_BAR["eer_dot"]}
    out = {"seconds": seconds, "tool_s": sec, "eer": eer, "jax_eer": jax,
           "eer_band": IVECTOR_EER_BAND, "trials": data["trials"],
           "target_trials": len(data["targets"]), "voiced_share": voiced,
           "test_ivector_norm_mean": test_norm,
           "jax_test_ivector_norm_mean":
               IVECTOR_JAX_BAR["test_ivector_norm_mean"],
           "peak_memory_gb": peak_gb(dev),
           "launches": launches}
    emit("ivector_sid", **out)
    bars = {f"eer {k}": abs(eer[k] - jax[k]) <= IVECTOR_EER_BAND
            for k in eer}
    bars["kernels a-c"] = not any(launches.values())
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"ivector_sid: {failed}")
    return out


def run_ivector_flagship(d: str, data: dict, dev: str = "cuda") -> dict:
    """ivector_flagship: the committed flagship_ng_ivec.npz written as an
    .ie file through the port's extractor I/O; ivector-extract of the main
    path's 128 test utterances against `BatchedIvectorExtractor.
    extract_batch`, and ivector-extract-online2 --ivector-period=10 (each
    utterance its own speaker) against init_state / acc_chunk / ivector
    fed the same 10-frame chunks.  Bars: the largest difference of each
    within twice the gap the JAX package shows between its own host and
    batched extractors (IVECTOR_JAX_BAR); kernels a-c 0 launches."""
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    reset_kernel_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sec: dict = {}

    def p(name):
        return os.path.join(d, name)

    t_all = time.perf_counter()
    arrays = load_ivector_extractor(os.path.join(ART, "flagship_ng_ivec.npz"))
    ex = IvectorExtractor.from_arrays(arrays)
    write_kaldi_object(ex.write, p("flagship.ie"))
    ivec_tool(sec, dev, "ivector-extract", p("flagship.ie"),
              "ark:" + p("test.ark"), "ark:" + p("flagship.ivec"))
    ivec_tool(sec, dev, "ivector-extract-online2",
              f"--ivector-period={IVECTOR_PERIOD}",
              "ark:" + p("flagship.utt2utt"), p("flagship.ie"),
              "ark:" + p("test.ark"), "ark:" + p("flagship.online"))
    tool_iv = dict(SequentialTableReader("vector",
                                         "ark:" + p("flagship.ivec")))
    tool_on = dict(SequentialTableReader("matrix",
                                         "ark:" + p("flagship.online")))
    utts = sorted(data["test"])
    lens = np.asarray([data["test"][u].shape[0] for u in utts])
    T = int(-(-lens.max() // IVECTOR_PERIOD) * IVECTOR_PERIOD)
    padded = np.zeros((len(utts), T, ex.dim), np.float32)
    for i, u in enumerate(utts):
        padded[i, :lens[i]] = data["test"][u]
    bat = BatchedIvectorExtractor(arrays, device=dev)
    feats = torch.from_numpy(padded).to(dev)
    t0 = time.perf_counter()
    got = bat.extract_batch(feats, lens).double().cpu().numpy()
    batched_s = time.perf_counter() - t0
    offline = float(np.abs(np.stack([tool_iv[u] for u in utts]) - got).max())
    state = bat.init_state(len(utts))
    frames = torch.arange(T, device=dev)
    lens_d = torch.from_numpy(lens).to(dev)
    online, rows = 0.0, 0
    for k, t0 in enumerate(range(0, T, IVECTOR_PERIOD)):
        mask = frames[None, t0:t0 + IVECTOR_PERIOD] < lens_d[:, None]
        state = bat.acc_chunk(state, feats[:, t0:t0 + IVECTOR_PERIOD], mask)
        cur = bat.ivector(state).double().cpu().numpy()
        for i, u in enumerate(utts):
            if t0 < lens[i]:
                want = np.asarray(tool_on[u][k], np.float64)
                want[0] -= ex.prior_offset
                online = max(online, float(np.abs(cur[i] - want).max()))
                rows += 1
    launches = kernel_launch_counts()
    bar = {"offline": 2 * IVECTOR_JAX_BAR["flagship_offline_gap"],
           "online": 2 * IVECTOR_JAX_BAR["flagship_online_gap"]}
    out = {"seconds": time.perf_counter() - t_all, "tool_s": sec,
           "batched_s": batched_s, "offline_max_diff": offline,
           "online_max_diff": online, "online_rows": rows, "bars": bar,
           "utterances": len(utts), "mean_norm": float(np.linalg.norm(
               got, axis=1).mean()), "peak_memory_gb": peak_gb(dev),
           "launches": launches}
    emit("ivector_flagship", **out)
    bars = {"offline": offline <= bar["offline"],
            "online": online <= bar["online"],
            "kernels a-c": not any(launches.values())}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"ivector_flagship: {failed}")
    return out


def ivector_phases(feats: dict = None, test_wav: dict = None,
                   dev: str = "cuda") -> dict:
    """ivector_train, ivector_sid and ivector_flagship over one directory;
    `feats` and `test_wav` are train_scale's (else the corpus is made and
    featurized here).  dev "cpu" runs them on the CPU (the tools with
    --use-gpu=no), to try them at small widths."""
    with tempfile.TemporaryDirectory() as d:
        data = ivector_data(d, feats, test_wav, dev)
        train = run_ivector_train(d, data, dev)
        out = {"ivector_train": train,
               "ivector_sid": run_ivector_sid(d, data, train.pop("final"),
                                              dev),
               "ivector_flagship": run_ivector_flagship(d, data, dev)}
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def tdnn_lstm_graph(feat_dim: int, tdnn_dim: int, cell_dim: int,
                    rec_proj: int, nonrec_proj: int, delay: int,
                    layers: int, num_pdfs: int, seed: int = 0,
                    later_taps=None) -> mdl_io.Nnet3Graph:
    """A TDNN-LSTM in the skeleton that Kaldi's xconfig fast-lstmp-layer
    generates (tests/test_mdl_recurrent.py make_lstmp_graph): `layers`
    times a TDNN layer (affine, ReLU, batchnorm with statistics) and a
    projected LSTM (W_all over Append(x, IfDefined(Offset(r_trunc,
    delay))), the fused LstmNonlinearity over Append(W_all,
    IfDefined(Offset(c_trunc, delay))), dim-ranges c_trunc and m, the
    projection rp whose first rec_proj rows feed back as r_trunc), then
    the output affine.  The first TDNN layer splices the input at -2..2;
    the later ones, inside the recurrent group, splice the previous
    projection at `later_taps`, by default `delay` and 0 (causal: the
    group runs frame by frame, so it cannot look ahead; run_tdnn_lstm_1a's
    -3, 0, 3 raises).  Weights are seeded normals over sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def w(rows, cols):
        return (rng.normal(size=(rows, cols)) / np.sqrt(cols)
                ).astype(np.float32)

    def vec(n, lo, hi):
        return rng.uniform(lo, hi, size=n).astype(np.float32)

    nodes = [mdl_io.Node("input", "input", dim=feat_dim)]
    comps = {}

    def add(name, comp, desc):
        comps[name] = comp
        nodes.append(mdl_io.Node("component", name, component=name,
                                 desc=mdl_io.parse_descriptor(desc)))

    def dim_range(name, src, offset, dim):
        nodes.append(mdl_io.Node("dim-range", name, dim=dim,
                                 dim_offset=offset,
                                 desc=mdl_io.Desc("node", [src])))

    ng = dict(LearningRate=0.001, RankIn=20, RankOut=80, UpdatePeriod=4,
              NumSamplesHistory=2000.0, Alpha=4.0)
    C, R = cell_dim, rec_proj
    prev, prev_dim = "input", feat_dim
    for i in range(1, layers + 1):
        taps = ([-2, -1, 0, 1, 2] if i == 1 else
                list(later_taps or (delay, 0)))
        splice = ", ".join(prev if o == 0 else f"Offset({prev}, {o})"
                           for o in taps)
        add(f"tdnn{i}.affine", mdl_io.NaturalGradientAffineComponent(
            LinearParams=w(tdnn_dim, len(taps) * prev_dim),
            BiasParams=vec(tdnn_dim, -0.1, 0.1), **ng), f"Append({splice})")
        add(f"tdnn{i}.relu", mdl_io.RectifiedLinearComponent(
            Dim=tdnn_dim, Count=0.0), f"tdnn{i}.affine")
        add(f"tdnn{i}.batchnorm", mdl_io.BatchNormComponent(
            Dim=tdnn_dim, BlockDim=tdnn_dim, Epsilon=1e-3, TargetRms=1.0,
            TestMode=True, Count=1000.0, StatsMean=vec(tdnn_dim, 0.2, 0.6),
            StatsVar=vec(tdnn_dim, 0.2, 0.6)), f"tdnn{i}.relu")
        lstm = f"lstm{i}"
        add(f"{lstm}.W_all", mdl_io.NaturalGradientAffineComponent(
            LinearParams=w(4 * C, tdnn_dim + R),
            BiasParams=vec(4 * C, -0.1, 0.1), **ng),
            f"Append(tdnn{i}.batchnorm, "
            f"IfDefined(Offset({lstm}.r_trunc, {delay})))")
        add(f"{lstm}.lstm_nonlin", mdl_io.LstmNonlinearityComponent(
            LearningRate=0.001, Params=vec(3 * C, -0.3, 0.3).reshape(3, C),
            ValueAvg=np.zeros((5, C), np.float32),
            DerivAvg=np.zeros((5, C), np.float32),
            SelfRepairConfig=np.asarray([0.05, 0.05, 0.2, 0.05, 0.2]
                                        + [1e-5] * 5, np.float32),
            SelfRepairProb=np.zeros(5, np.float32), Count=0.0),
            f"Append({lstm}.W_all, "
            f"IfDefined(Offset({lstm}.c_trunc, {delay})))")
        dim_range(f"{lstm}.c_trunc", f"{lstm}.lstm_nonlin", 0, C)
        dim_range(f"{lstm}.m", f"{lstm}.lstm_nonlin", C, C)
        add(f"{lstm}.rp", mdl_io.LinearComponent(
            Params=w(R + nonrec_proj, C), OrthonormalConstraint=0.0,
            UseNaturalGradient=True), f"{lstm}.m")
        dim_range(f"{lstm}.r_trunc", f"{lstm}.rp", 0, R)
        prev, prev_dim = f"{lstm}.rp", R + nonrec_proj
    add("output.affine", mdl_io.NaturalGradientAffineComponent(
        LinearParams=w(num_pdfs, prev_dim),
        BiasParams=np.zeros(num_pdfs, np.float32), **ng), prev)
    nodes.append(mdl_io.Node("output", "output",
                             desc=mdl_io.parse_descriptor("output.affine"),
                             objective="linear"))
    return mdl_io.Nnet3Graph(nodes, comps)


def tdnnf_context(cfg: ChainTdnnfConfig) -> int:
    """Frames of context each side of the exported TDNN-F at the input
    rate (each layer of stride s reads s frames each side; strides after
    the subsampling layer count at the subsampled rate)."""
    return sum(s * (cfg.frame_subsampling_factor
                    if i > cfg.subsample_layer else 1)
               for i, s in enumerate(cfg.time_strides(), start=1))


def read_ark(path: str) -> dict:
    return dict(SequentialTableReader("matrix", f"ark:{path}"))


def write_ark(path: str, entries, holder: str = "matrix") -> None:
    with TableWriter(holder, f"ark:{path}") as w:
        for key, value in entries:
            w.write(key, value)


def run_nnet3_ref_golden(tmp: str) -> dict:
    """nnet3_ref_golden: the reference C++ nnet3-compute output
    (tests/data/ref_golden/tdnn_out.ark) from the port on the card:
    tdnn.raw and tdnn_text.raw through compile_graph, and tdnn.raw through
    the nnet3-compute tool.  nnet3-compute gave the model its context by
    replicating the first and last frame, so the inputs are padded so."""
    feats, ref = read_ark(os.path.join(GOLDEN, "feats.ark")), \
        read_ark(os.path.join(GOLDEN, "tdnn_out.ark"))
    p = GOLDEN_PAD
    padded = {k: np.concatenate([np.repeat(f[:1], p, 0), f,
                                 np.repeat(f[-1:], p, 0)])
              for k, f in feats.items()}
    reset_kernel_counts()
    err = {}
    for name in ("tdnn.raw", "tdnn_text.raw"):
        net = compile_graph(mdl_io.read_raw_nnet3(os.path.join(GOLDEN, name)),
                            device="cuda")
        err[name] = max(
            float(np.abs(net(x[None])[0, p:p + feats[k].shape[0]].cpu()
                         .numpy() - ref[k]).max())
            for k, x in padded.items())
    write_ark(os.path.join(tmp, "golden_feats.ark"), sorted(padded.items()))
    rc = get_tool("nnet3-compute")(
        ["nnet3-compute", os.path.join(GOLDEN, "tdnn.raw"),
         f"ark:{os.path.join(tmp, 'golden_feats.ark')}",
         f"ark:{os.path.join(tmp, 'golden_out.ark')}"])
    out = read_ark(os.path.join(tmp, "golden_out.ark"))
    err["nnet3-compute"] = max(
        float(np.abs(out[k][p:p + f.shape[0]] - ref[k]).max())
        for k, f in feats.items())
    res = {"utterances": len(feats), "max_abs_err": err, "limit": GOLDEN_TOL,
           "tool_rc": rc, "launches": kernel_launch_counts()}
    emit("nnet3_ref_golden", **res)
    if rc != 0 or not max(err.values()) <= GOLDEN_TOL:
        raise SystemExit(f"the port is {err} from the reference golden")
    return res


def run_nnet3_import_flagship(ng: dict, cfg, variables, ivec, fe,
                              tmp: str) -> dict:
    """nnet3_import_flagship: the committed flagship_ng TDNN-F exported
    with flagship_ng.tm to a .mdl, read back, compiled; the 128 test
    utterances of the main path's features and i-vectors scored in float32
    (TF32 off) as nnet3-compute-batch batches them; the subsampled output
    against the native model's on the same batches (interior frames) and
    decoded through the main path's search; 2 lanes against the host
    evaluator."""
    reset_kernel_counts()
    native = chain_tdnnf_from_flax(cfg, variables, device="cuda")
    ctx = tdnnf_context(cfg)
    path = os.path.join(tmp, "flagship_ng.mdl")
    t0 = time.perf_counter()
    mdl_io.write_nnet3_am(path, ng["tm"],
                          mdl_io.chain_tdnnf_to_nnet3(native, variables),
                          left_context=ctx, right_context=ctx)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm, graph, info = mdl_io.read_nnet3_am(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = compile_graph(graph, "output", device="cuda")
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    if tm.num_pdfs != cfg.num_pdfs or info["left_context"] != ctx:
        raise SystemExit("the .mdl read back differs from what was written")

    utts = sorted(ng["test_wav"])
    waves = [mulaw_encode(np.clip(ng["test_wav"][u], -32767, 32767))
             for u in utts]
    with torch.inference_mode():
        feats, nframes = fe.compute_batch_device(waves)
        ivecs = ivec.extract_batch(feats, nframes).float()
    feats_h, ivecs_h = feats.cpu().numpy(), ivecs.cpu().numpy()
    batches = []
    for s in range(0, len(utts), NNET3_BATCH):
        lanes = range(s, min(s + NNET3_BATCH, len(utts)))
        batch = pad_batch([feats_h[i, :nframes[i]] for i in lanes])
        batches.append((lanes, torch.from_numpy(batch).cuda(),
                        torch.from_numpy(ivecs_h[s:s + len(lanes)]).cuda()))
    net(batches[0][1], batches[0][2])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    outs = [net(b, iv) for _l, b, iv in batches]
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_s = sum(len(w) for w in waves) / bench_scale_spec().fs
    prof = profile_call(lambda: net(batches[0][1], batches[0][2]), top=8)

    # the native model on the same batches; interior frames only: it
    # clamps offsets at the subsampled rate, the exported graph at the
    # input rate, so the frames within the context of a batch's edges
    # differ by design
    sub = cfg.frame_subsampling_factor
    margin = -(-ctx // sub) + 1
    worst = 0.0
    T_out = max(-(-int(n) // sub) for n in nframes)
    with torch.inference_mode(), full_f32():
        loglikes = torch.zeros((len(utts), T_out, cfg.num_pdfs),
                               device="cuda")
        for (lanes, b, iv), out in zip(batches, outs):
            got = out[:, ::sub]
            want = native.chain(b, iv)
            if got.shape != want.shape:
                raise SystemExit(f"subsampled {tuple(got.shape)} against "
                                 f"the native {tuple(want.shape)}")
            inner = slice(margin, got.shape[1] - margin)
            worst = max(worst, float((got[:, inner] - want[:, inner])
                                     .abs().max()))
            n = min(got.shape[1], T_out)
            loglikes[lanes.start:lanes.stop, :n] = got[:, :n]
    out_lens = -(-np.asarray(nframes, np.int64) // sub)
    dec, graph_ng = ng["dec"], ng["graph"]
    hyps = dec.decode_batch(loglikes, lengths=out_lens, **NG_SEARCH)
    words = {u: ([] if h is None else [graph_ng.words[w] for w in h[0]])
             for u, h in zip(utts, hyps)}
    wer = wer_of(words, ng["test_txt"])
    errors = word_errors(wer, ng["test_txt"])

    # the host evaluator on 2 lanes of the first batch, padded alike
    lanes0, b0, iv0 = batches[0]
    host_err = 0.0
    for i in range(NNET3_HOST_LANES):
        want = graph.forward(b0[i].cpu().numpy(), ivector=iv0[i].cpu()
                             .numpy())
        host_err = max(host_err, float(np.abs(outs[0][i].cpu().numpy()
                                              - want).max()))
    res = {"mdl_bytes": os.path.getsize(path), "write_s": write_s,
           "read_s": read_s, "compile_s": compile_s, "lanes": len(utts),
           "batch": NNET3_BATCH, "batches": len(batches),
           "frames": int(np.sum(nframes)), "audio_s": audio_s,
           "wall_s": wall_s, "device_ms": device_ms,
           "xrt": audio_s / wall_s, "peak_memory_gb": peak_gb,
           "launches_a_batch": prof["kernel_launches"],
           "profiled_batch_device_ms": prof["device_ms"],
           "profile_top": prof["top"], "context": ctx,
           "interior_margin": margin, "max_abs_err_native": worst,
           "limit": NNET3_TOL, "host_lanes": NNET3_HOST_LANES,
           "max_abs_err_host": host_err,
           "lanes_decoded": sum(h is not None for h in hyps), "wer": wer,
           "word_errors": errors, "wer_reference": NNET3_WER,
           "launches": kernel_launch_counts()}
    emit("nnet3_import_flagship", **res)
    if not worst <= NNET3_TOL or not host_err <= NNET3_TOL:
        raise SystemExit(f"imported model {worst} from the native one, "
                         f"{host_err} from the host evaluator")
    if res["lanes_decoded"] != len(utts):
        raise SystemExit(f"{res['lanes_decoded']}/{len(utts)} lanes decoded")
    ref_errors = word_errors(NNET3_WER, ng["test_txt"])
    if not (abs(wer - NNET3_WER) <= NNET3_WER_BAND
            and abs(errors - ref_errors) <= NNET3_WORDS_BAND):
        raise SystemExit(f"imported model's WER {wer:.3f}% ({errors} "
                         f"errors) against {NNET3_WER:.3f}% ({ref_errors})")
    return {"res": res, "net": net, "path": path, "batch0": batches[0],
            "nframes": nframes, "utts": utts, "feats": feats_h,
            "ivecs": ivecs_h}


def run_nnet3_cli_batch(imp: dict, tmp: str) -> dict:
    """nnet3_cli_batch: NNET3_CLI_UTTS utterances of the main path to an
    ark, `python -m kaldi_tpu_torch.cli nnet3-compute-batch` on the .mdl
    in a process of its own, its output ark torch.equal to the compiled
    module under the same batching."""
    reset_kernel_counts()
    utts, nframes = imp["utts"], imp["nframes"]
    n = NNET3_CLI_UTTS
    feats = [imp["feats"][i, :nframes[i]] for i in range(n)]
    feats_ark, iv_ark, out_ark = (os.path.join(tmp, f) for f in (
        "cli_feats.ark", "cli_ivecs.ark", "cli_out.ark"))
    write_ark(feats_ark, zip(utts[:n], feats))
    write_ark(iv_ark, zip(utts[:n], imp["ivecs"][:n]), holder="vector")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", "nnet3-compute-batch",
         f"--ivectors=ark:{iv_ark}", imp["path"], f"ark:{feats_ark}",
         f"ark:{out_ark}"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    tool_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"nnet3-compute-batch failed:\n{proc.stderr}")
    got = read_ark(out_ark)
    want = imp["net"](torch.from_numpy(pad_batch(feats)).cuda(),
                      torch.from_numpy(imp["ivecs"][:n]).cuda())
    equal = [bool(torch.equal(torch.from_numpy(got[u]),
                              want[i, :feats[i].shape[0]].cpu()))
             for i, u in enumerate(utts[:n])]
    res = {"utterances": n, "tool_s": tool_s, "equal": equal,
           "launches": kernel_launch_counts()}
    emit("nnet3_cli_batch", **res)
    if not all(equal) or sorted(got) != sorted(utts[:n]):
        raise SystemExit("nnet3-compute-batch's ark differs from the module")
    return res


def run_nnet3_recurrent() -> dict:
    """nnet3_recurrent: the TDNN-LSTM (tdnn_lstm_graph at LSTM_SHAPE)
    through the compiled module's frame loop, LSTM_LANES x LSTM_FRAMES of
    seeded 40-dim input; wall by CUDA events, launches a frame (two
    profiled calls of different lengths), peak memory; 2 lanes against the
    host evaluator."""
    reset_kernel_counts()
    graph = tdnn_lstm_graph(**LSTM_SHAPE, seed=SEED)
    net = compile_graph(graph, "output", device="cuda")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(LSTM_LANES, LSTM_FRAMES,
                                          LSTM_SHAPE["feat_dim"]))
                         .astype(np.float32)).cuda()
    net(x[:, :20])                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = net(x)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    short = [profile_call(lambda k=k: net(x[:, :k]), top=6)
             for k in (50, 100)]
    per_frame = (short[1]["kernel_launches"]
                 - short[0]["kernel_launches"]) / 50
    host_err = 0.0
    for i in range(NNET3_HOST_LANES):
        want = graph.forward(x[i].cpu().numpy())
        host_err = max(host_err, float(np.abs(out[i].cpu().numpy()
                                              - want).max()))
    res = {"lanes": LSTM_LANES, "frames": LSTM_FRAMES, **LSTM_SHAPE,
           "group_nodes": len(net._group), "wall_s": wall_s,
           "device_ms": device_ms, "ms_a_frame": device_ms / LSTM_FRAMES,
           "launches_a_frame": per_frame,
           "profiled_launches_50_100": [s["kernel_launches"] for s in short],
           "peak_memory_gb": peak_gb, "max_abs_err_host": host_err,
           "max_abs_out": float(out.abs().max()), "limit": NNET3_TOL,
           "launches": kernel_launch_counts()}
    emit("nnet3_recurrent", **res)
    if not host_err <= NNET3_TOL or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"TDNN-LSTM {host_err} from the host evaluator")
    return res


def nnet3_phases(ng: dict, cfg, variables, ivec, fe) -> dict:
    """The four nnet3 phases; kernels a-c launch 0 times in each."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        golden = run_nnet3_ref_golden(tmp)
        imp = run_nnet3_import_flagship(ng, cfg, variables, ivec, fe, tmp)
        cli = run_nnet3_cli_batch(imp, tmp)
        rec = run_nnet3_recurrent()
    launches = {"nnet3_ref_golden": golden["launches"],
                "nnet3_import_flagship": imp["res"]["launches"],
                "nnet3_cli_batch": cli["launches"],
                "nnet3_recurrent": rec["launches"]}
    if any(any(c.values()) for c in launches.values()):
        raise SystemExit(f"a kernel of another path ran in the nnet3 "
                         f"phases: {launches}")
    r = imp["res"]
    return {"nnet3_import_xrt": r["xrt"],
            "nnet3_import_peak_gb": r["peak_memory_gb"],
            "nnet3_import_wer": r["wer"],
            "nnet3_recurrent_ms_a_frame": rec["ms_a_frame"],
            "nnet3_seconds": time.perf_counter() - t0,
            "launches": launches}


# -- online2 serving over an HCLG ---------------------------------------

def online2_words_txt(path: str, words) -> None:
    with open(path, "w") as f:
        f.writelines(f"{w} {i}\n" for i, w in enumerate(words))


def run_online2_graph(tmp: str, n_utts: int = ONLINE2_UTTS) -> dict:
    """online2_graph: what a Kaldi user brings to the online2 tools, made
    as nnet3_import_flagship makes its .mdl: the legacy flagship_params.npz
    TDNN-F (float32) written by chain_tdnnf_to_nnet3 and write_nnet3_am
    with chain_tm_tree_for's transition model and the model's contexts,
    read back and compiled; the legacy LexChainGraph's flat form written
    as an OpenFst HCLG.fst and read back (every arc and final weight
    equal); words.txt; the first n_utts test utterances of
    BenchCorpusSpec() on the int16 wire as a wav archive."""
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    if fingerprint != LEX_FINGERPRINT:
        raise SystemExit(f"corpus fingerprint {fingerprint}, the JAX "
                         f"package's {LEX_FINGERPRINT}")
    lang, tm, tree = chain_tm_tree_for(lexicon)
    flat = build_decode_graph(lexicon, lm_text, tm, tree,
                              lang=lang).to_flat_graph()
    fst = flat.to_vector_fst()
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0, num_pdfs=tm.num_pdfs,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    variables = load_params(os.path.join(ART, "flagship_params.npz"))
    native = chain_tdnnf_from_flax(cfg, variables, device="cuda")
    ctx = tdnnf_context(cfg)
    mdl = os.path.join(tmp, "final.mdl")
    t0 = time.perf_counter()
    mdl_io.write_nnet3_am(mdl, tm, mdl_io.chain_tdnnf_to_nnet3(native,
                                                                variables),
                          left_context=ctx, right_context=ctx)
    write_s = time.perf_counter() - t0
    del native
    t0 = time.perf_counter()
    tm2, graph, info = mdl_io.read_nnet3_am(mdl)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = compile_graph(graph, "output", device="cuda")
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    hclg = os.path.join(tmp, "HCLG.fst")
    t0 = time.perf_counter()
    with open(hclg, "wb") as f:
        write_fst(f, fst)
    fst_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_fst_file(hclg)
    fst_read_s = time.perf_counter() - t0
    arcs_equal = (back.start == fst.start and back.finals == fst.finals
                  and all([tuple(a) for a in x] == [tuple(a) for a in y]
                          for x, y in zip(back.arcs, fst.arcs)))
    online2_words_txt(os.path.join(tmp, "words.txt"), flat.words)
    utts = sorted(test_wav)[:n_utts]
    waves = {u: np.clip(test_wav[u], -32767, 32767).astype(np.int16)
             for u in utts}
    with TableWriter("wave", f"ark:{os.path.join(tmp, 'wav.ark')}") as w:
        for u in utts:
            w.write(u, WaveData(spec.fs, waves[u]))
    res = {"mdl_bytes": os.path.getsize(mdl), "write_s": write_s,
           "read_s": read_s, "compile_s": compile_s,
           "left_context": info["left_context"],
           "right_context": info["right_context"],
           "num_pdfs": tm2.num_pdfs, "hclg_bytes": os.path.getsize(hclg),
           "states": back.num_states, "arcs": back.num_arcs(),
           "arcs_equal_after_round_trip": arcs_equal,
           "fst_write_s": fst_write_s, "fst_read_s": fst_read_s,
           "words": len(flat.words) - 1, "utterances": len(utts),
           "audio_s": sum(len(w) for w in waves.values()) / spec.fs}
    emit("online2_graph", **res)
    if not arcs_equal or back.num_arcs() != fst.num_arcs():
        raise SystemExit("HCLG.fst read back differs from what was written")
    if (info["left_context"], info["right_context"], tm2.num_pdfs) != \
            (ctx, ctx, cfg.num_pdfs):
        raise SystemExit("the .mdl read back differs from what was written")
    return {"res": res, "dir": tmp, "mdl": mdl, "hclg": hclg, "net": net,
            "fst": back, "tm": tm2, "info": info, "words": flat.words,
            "utts": utts, "waves": waves, "test_txt": test_txt,
            "test_wav": test_wav, "lm_text": lm_text, "spec": spec,
            "lexicon": lexicon, "lang": lang, "tree": tree}


def online2_args(sysd: dict) -> list:
    """The legacy frontend (mfcc_options(spec, 40)) as the tools'
    options, and the chain model's subsampling and scale."""
    opts = mfcc_options(sysd["spec"], num_ceps=40)
    return [f"--num-ceps={opts.num_ceps}",
            f"--num-mel-bins={opts.mel_opts.num_bins}",
            f"--sample-frequency={opts.frame_opts.samp_freq}",
            f"--dither={opts.frame_opts.dither}",
            "--frame-subsampling-factor=3", "--acoustic-scale=1.0"]


def tool_stats(tool: str, stderr: str) -> dict:
    """The `<tool> stats {...}` line an online2 tool logs at its end."""
    tag = f"{tool} stats "
    for line in stderr.splitlines():
        if tag in line:
            return json.loads(line.split(tag, 1)[1])
    raise SystemExit(f"{tool} logged no stats line:\n{stderr[-4000:]}")


def stream_scorer(sysd: dict, utts) -> dict:
    """The online2 tools' scoring in this process: each utterance's
    features through the streaming pipeline in 180-ms pieces of audio and
    an OnlineNnetScorer over the compiled module (the tools' forward),
    against OfflineFeature and the module over the whole utterance;
    device ms and launches of one chunk's forward (the profiler over one
    utterance's chunks, the forward in a range of its own) and the host ms
    of a chunk's scorer call (perf_counter, no sync)."""
    net, info, spec = sysd["net"], sysd["info"], sysd["spec"]
    opts = mfcc_options(spec, num_ceps=40)
    fe = OfflineFeature(opts, device="cuda")
    chunk = int(ONLINE2_CHUNK_S * spec.fs)
    calls = [0]

    def forward(w):
        calls[0] += 1
        with torch.profiler.record_function("online2_forward"):
            return net(w)[:, ::3]

    def stream(u):
        pipe = OnlineFeaturePipeline(OnlineFeature(opts, device="cuda"))
        sc = OnlineNnetScorer(forward, info["left_context"],
                              info["right_context"], 3, device="cuda")
        outs, host_s, done = [], [], [0]

        def step(last: bool) -> None:
            ready = pipe.num_frames_ready()
            t0 = time.perf_counter()
            outs.append(sc.accept_features(pipe.get_frames(done[0], ready)))
            if last:
                outs.append(sc.finish())
            host_s.append(time.perf_counter() - t0)
            done[0] = ready

        wave = sysd["waves"][u]
        for a in range(0, len(wave), chunk):
            pipe.accept_waveform(spec.fs, wave[a:a + chunk])
            step(False)
        pipe.input_finished()
        step(True)
        return (pipe.get_frames(0, done[0]),
                torch.cat([o for o in outs if o.shape[0]]), host_s)

    stream(utts[0])                                         # warm-up
    feat_err = ll_err = 0.0
    host_s = []
    n_frames = 0
    for u in utts:
        f_stream, ll_stream, h = stream(u)
        host_s += h
        f, n = fe.compute_batch_device([sysd["waves"][u]])
        f = f[0, :int(n[0])]
        ll = net(f[None])[0, ::3]
        n_frames += ll.shape[0]
        if ll.shape != ll_stream.shape:
            raise SystemExit(f"{u}: streamed {tuple(ll_stream.shape)} "
                             f"against offline {tuple(ll.shape)}")
        feat_err = max(feat_err, float((torch.from_numpy(f_stream).cuda()
                                        - f).abs().max()))
        ll_err = max(ll_err, float((ll_stream - ll).abs().max()))
    calls[0] = 0
    prof = profile_call(lambda: stream(utts[1]), top=6,
                        ranges=("online2_forward",))
    fwd, n = prof["ranges"]["online2_forward"], max(calls[0], 1)
    return {"features_max_abs_err": feat_err,
            "loglikes_max_abs_err": ll_err, "output_frames": n_frames,
            "forward_calls_profiled": calls[0],
            "device_ms_a_chunk": fwd["device_ms"] / n,
            "launches_a_chunk": fwd["kernel_launches"] / n,
            "features_device_ms_a_chunk": (prof["device_ms"]
                                           - fwd["device_ms"]) / n,
            "host_ms_a_chunk": ms_percentiles(host_s),
            "profile_top": prof["top"]}


def run_online2_wav(sysd: dict, lex_words16: dict) -> dict:
    """online2_wav: `python -m kaldi_tpu_torch.cli
    online2-wav-nnet3-latgen-faster` in a process of its own over the wav
    archive (default chunk 0.18 s and beam); every utterance's words
    equal to the offline reference (the compiled module over the whole
    utterance's features, the host FasterDecoder over the same HCLG.fst
    with the same beam); its RTF and WER, and the utterances agreeing
    with slice_lex_int16's LexChainDecoder words."""
    reset_kernel_counts()
    d, utts = sysd["dir"], sysd["utts"]
    out = os.path.join(d, "words.ark")
    tool = "online2-wav-nnet3-latgen-faster"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", tool,
         *online2_args(sysd), sysd["mdl"], sysd["hclg"],
         f"ark:{os.path.join(d, 'wav.ark')}", f"ark:{out}"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    tool_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{tool} failed:\n{proc.stderr[-4000:]}")
    stats = tool_stats(tool, proc.stderr)
    got = {u: list(v) for u, v in
           SequentialTableReader("int-vector", f"ark:{out}")}
    # the offline reference
    opts = mfcc_options(sysd["spec"], num_ceps=40)
    fe = OfflineFeature(opts, device="cuda")
    dec = FasterDecoder(sysd["fst"], FasterDecoderOptions(beam=ONLINE2_BEAM))
    ref, search_s, frames = {}, 0.0, 0
    for u in utts:
        f, n = fe.compute_batch_device([sysd["waves"][u]])
        ll = sysd["net"](f[:, :int(n[0])])[0, ::3].cpu().numpy()
        t0 = time.perf_counter()
        hyp = dec.decode(ll, sysd["tm"].id2pdf_id, 1.0)
        search_s += time.perf_counter() - t0
        frames += ll.shape[0]
        ref[u] = None if hyp is None else hyp[1]
    differ = [u for u in utts if got.get(u) != ref[u]]
    words = sysd["words"]
    names = {u: [words[w] for w in got.get(u, [])] for u in utts}
    test_txt = {u: sysd["test_txt"][u] for u in utts}
    wer = wer_of(names, test_txt)
    scoring = stream_scorer(sysd, utts)
    res = {"utterances": len(utts), "tool_s": tool_s,
           "rtf": stats["wall_s"] / stats["audio_s"],
           "audio_s": stats["audio_s"], "tool_stats": stats,
           "utterances_equal_offline_reference": len(utts) - len(differ),
           "differing": differ, "wer": wer,
           "word_errors": word_errors(wer, test_txt),
           "ref_words": sum(len(r) for r in test_txt.values()),
           "agree_with_slice_lex_int16": sum(
               names[u] == lex_words16[u] for u in utts),
           "reference_search_ms_a_frame": 1e3 * search_s / max(frames, 1),
           "beam": ONLINE2_BEAM, **scoring,
           "launches": kernel_launch_counts(),
           "tool_launches": stats["kernel_launches"]}
    emit("online2_wav", **res)
    if differ or len(got) != len(utts):
        raise SystemExit(f"{tool}'s words differ from the offline "
                         f"reference in {differ}")
    return {"res": res, "names": names}


def online2_client(host: str, port: int, wave: np.ndarray, chunk: int):
    """One request: int16 PCM in chunk-byte pieces, a half-close, the
    reply read to its end -> (reply, seconds from the last byte sent to
    the first final '\\n')."""
    pcm = wave.astype("<i2").tobytes()
    with socket.create_connection((host, port), timeout=300) as sock:
        sock.settimeout(300)
        for a in range(0, len(pcm), chunk):
            sock.sendall(pcm[a:a + chunk])
        sock.shutdown(socket.SHUT_WR)
        t_last = time.perf_counter()
        reply, latency = b"", None
        while True:
            data = sock.recv(4096)
            if not data:
                break
            reply += data
            if latency is None and b"\n" in data:
                latency = time.perf_counter() - t_last
    return reply.decode(), latency


def run_online2_tcp(sysd: dict, wav: dict) -> dict:
    """online2_tcp: `python -m kaldi_tpu_torch.cli
    online2-tcp-nnet3-decode-faster --num-connections=16` in a process of
    its own; 16 clients stream the utterances of online2_wav, 4
    connections at a time, in 180-ms chunks, half-close and collect the
    reply.  Every client saw a '\\r' partial, and its joined '\\n' finals
    are online2_wav's words."""
    utts = sysd["utts"]
    tool = "online2-tcp-nnet3-decode-faster"
    proc = subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", tool,
         f"--num-connections={len(utts)}", "--port-num=0",
         f"--samp-freq={sysd['spec'].fs}", *online2_args(sysd),
         sysd["mdl"], sysd["hclg"], os.path.join(sysd["dir"], "words.txt")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    killer = threading.Timer(600, proc.kill)
    killer.start()
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        start_s = time.perf_counter() - t0
        if not line.startswith("# listening on"):
            proc.kill()
            raise SystemExit(f"{tool} did not start:\n"
                             f"{proc.communicate()[1][-4000:]}")
        host, port = line.split()[-1].rsplit(":", 1)
        chunk = int(ONLINE2_CHUNK_S * sysd["spec"].fs) * 2
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(ONLINE2_CONC) as pool:
            replies = dict(zip(utts, pool.map(
                lambda u: online2_client(host, int(port), sysd["waves"][u],
                                         chunk), utts)))
        wall_s = time.perf_counter() - t0
        _out, err = proc.communicate(timeout=120)
    finally:
        killer.cancel()
    if proc.returncode != 0:
        raise SystemExit(f"{tool} exited {proc.returncode}:\n{err[-4000:]}")
    stats = tool_stats(tool, err)

    def finals(reply):
        return " ".join(seg.split("\r")[-1] for seg in reply.split("\n")
                        if seg.split("\r")[-1]).split()

    partials = [u for u in utts if "\r" in replies[u][0]]
    equal = [u for u in utts if finals(replies[u][0]) == wav["names"][u]]
    latency = [replies[u][1] for u in utts if replies[u][1] is not None]
    res = {"clients": len(utts), "concurrent": ONLINE2_CONC,
           "server_start_s": start_s, "wall_s": wall_s,
           "audio_s": wav["res"]["audio_s"],
           "xrt": wav["res"]["audio_s"] / wall_s,
           "final_latency_ms": ms_percentiles(latency),
           "clients_with_partials": len(partials),
           "clients_finals_equal_online2_wav": len(equal),
           "scorer_host_ms_a_chunk": 1e3 * stats["scorer_s"]
           / max(stats["chunks"], 1),
           "search_host_ms_a_frame": 1e3 * stats["search_s"]
           / max(stats["frames"], 1),
           "scorer_device_ms_a_chunk": wav["res"]["device_ms_a_chunk"],
           "scorer_launches_a_chunk": wav["res"]["launches_a_chunk"],
           "peak_memory_gb": stats.get("peak_memory_gb"),
           "tool_stats": stats, "launches": stats["kernel_launches"]}
    emit("online2_tcp", **res)
    if len(partials) != len(utts) or len(equal) != len(utts) \
            or len(latency) != len(utts) or stats["errors"]:
        raise SystemExit(f"online2_tcp: {len(partials)} clients with "
                         f"partials, {len(equal)} finals equal, "
                         f"{stats['errors']} server errors")
    return res


def online2_phases(lex_words16: dict, xconfig: bool = True) -> dict:
    """online2_graph, online2_wav and online2_tcp; kernels a-c launch 0
    times in each (in this process and in the tools').  With `xconfig`,
    then the xconfig phases over online2_graph's HCLG.fst and
    utterances (their summary under "xconfig"), then mkgraph_legacy and
    scoring_legacy over online2_graph's files and xconfig_graph's
    checkpoint (under "mkgraph")."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        sysd = run_online2_graph(tmp)
        graph_launches = kernel_launch_counts()
        wav = run_online2_wav(sysd, lex_words16)
        tcp = run_online2_tcp(sysd, wav)
        online2_s = time.perf_counter() - t0
        xcfg = (xconfig_phases(sysd, {"wer": wav["res"]["wer"],
                                      "names": wav["names"]})
                if xconfig else None)
        mkg = mkgraph_phases(sysd, lex_words16) if xconfig else None
        del sysd
    torch.cuda.empty_cache()
    w = wav["res"]
    launches = {"online2_graph": graph_launches,
                "online2_wav": {k: v + w["tool_launches"][k]
                                for k, v in w["launches"].items()},
                "online2_tcp": tcp["launches"]}
    if any(any(c.values()) for c in launches.values()):
        raise SystemExit(f"a kernel of another path ran in the online2 "
                         f"phases: {launches}")
    return {"online2_wav_rtf": w["rtf"], "online2_wav_wer": w["wer"],
            "online2_wav_agree_lex_int16": w["agree_with_slice_lex_int16"],
            "online2_tcp_wall_s": tcp["wall_s"],
            "online2_tcp_latency_ms_p50": tcp["final_latency_ms"]["p50"],
            "online2_search_ms_a_frame": tcp["search_host_ms_a_frame"],
            "online2_seconds": online2_s, "xconfig": xcfg, "mkgraph": mkg,
            "launches": launches}


# ---------------------------------------------------------------------------
# xconfig phases: the legacy TDNN-F as an xconfig checkpoint directory,
# decoded into lattices by nnet3-latgen-faster over online2_graph's
# HCLG.fst, the lattice tools and compute-wer, the -batch and -looped
# variants, and one small-depth model of each xconfig layer family

# the beams of the reference's steps/nnet3/decode.sh; the search is host
# Python (about 1 ms a frame on the CPU), so 16 utterances keep the tool
# near 15 s of search and determinization
XCONFIG_UTTS, XCONFIG_VARIANT_UTTS = 16, 4
LATGEN_ARGS = ["--beam=15", "--lattice-beam=8", "--max-active=7000",
               "--acoustic-scale=1.0"]
# the legacy int16-wire WER of slice_lex_int16 (94 of 1544; PR 9-13) that
# chip_main_path.py --latgen holds the 128 utterances to
SLICE_LEX_INT16_WER, SLICE_LEX_INT16_ERRORS = 100.0 * 94 / 1544, 94
# xconfig_zoo: lanes x frames on the card; the CPU float64 reference runs
# the first ZOO_CPU_LANES lanes (lanes do not mix in eval mode)
ZOO_LANES, ZOO_FRAMES, ZOO_CPU_LANES = 32, 500, 4
# Kaldi's recipes' widths at small depth: run_tdnn_lstm_1a (TDNN-LSTM),
# the GRU and attention variants of the swbd chain recipes, the CNN-TDNN
# front end (cnn_tdnn_1a) and voxceleb's run_xvector.sh.  Tolerance:
# max |card f32 - CPU f64| over max |CPU f64|
ZOO = {
    "tdnn_lstm": (1e-4, """
input dim=40 name=input
relu-batchnorm-layer name=tdnn1 dim=1024 input=Append(-2,-1,0,1,2)
relu-batchnorm-layer name=tdnn2 dim=1024 input=Append(-1,0,1)
fast-lstmp-layer name=lstm1 cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256
relu-batchnorm-layer name=tdnn3 dim=1024 input=Append(-3,0,3)
fast-lstmp-layer name=lstm2 cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256
output-layer name=output dim=3456 include-log-softmax=false
"""),
    "gru": (1e-4, """
input dim=40 name=input
relu-batchnorm-layer name=tdnn1 dim=1024 input=Append(-2,-1,0,1,2)
gru-layer name=gru1 cell-dim=1024 recurrent-projection-dim=256
relu-batchnorm-layer name=tdnn2 dim=1024 input=Append(-3,0,3)
gru-layer name=gru2 cell-dim=1024 recurrent-projection-dim=256
output-layer name=output dim=3456 include-log-softmax=false
"""),
    "attention": (1e-4, """
input dim=40 name=input
relu-batchnorm-layer name=tdnn1 dim=1024 input=Append(-2,-1,0,1,2)
attention-relu-renorm-layer name=att1 num-heads=15 key-dim=40 value-dim=80 num-left-inputs=5 num-right-inputs=2
relu-batchnorm-layer name=tdnn2 dim=1024 input=Append(-3,0,3)
attention-relu-renorm-layer name=att2 num-heads=15 key-dim=40 value-dim=80 num-left-inputs=5 num-right-inputs=2
output-layer name=output dim=3456 include-log-softmax=false
"""),
    "cnn": (1e-4, """
input dim=40 name=input
conv-relu-batchnorm-layer name=cnn1 height-in=40 num-filters-out=64 time-kernel=3 height-kernel=3
conv-relu-batchnorm-layer name=cnn2 height-in=40 num-filters-out=128 time-kernel=3 height-kernel=3 height-subsample-out=2
relu-batchnorm-layer name=tdnn1 dim=1024 input=Append(-1,0,1)
output-layer name=output dim=3456 include-log-softmax=false
"""),
    "xvector": (1e-4, """
input dim=40 name=input
relu-batchnorm-layer name=tdnn1 dim=512 input=Append(-2,-1,0,1,2)
relu-batchnorm-layer name=tdnn2 dim=512 input=Append(-2,0,2)
relu-batchnorm-layer name=tdnn3 dim=512 input=Append(-3,0,3)
relu-batchnorm-layer name=tdnn4 dim=512
relu-batchnorm-layer name=tdnn5 dim=1500
stats-layer name=stats
relu-batchnorm-layer name=tdnn6 dim=512
relu-batchnorm-layer name=tdnn7 dim=512
output-layer name=output dim=7323
"""),
}


def cli(tool: str, *args, timeout: int = 600) -> subprocess.CompletedProcess:
    """`python -m kaldi_tpu_torch.cli <tool> args` in a process of its
    own; exits when it fails."""
    proc = subprocess.run(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", tool, *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise SystemExit(f"{tool} failed:\n{proc.stderr[-4000:]}")
    return proc


def int_words(path: str) -> dict:
    return {u: list(v) for u, v in
            SequentialTableReader("int-vector", f"ark:{path}")}


def run_xconfig_graph(sysd: dict, dev: str = "cuda") -> dict:
    """xconfig_graph: the legacy TDNN-F (flagship_params.npz) as
    chain_tdnnf_xconfig text and a port checkpoint directory, written,
    read back and built; chain_tm_tree_for's transition model as final.tm;
    the MFCCs of online2_graph's utterances (int16 wire, the port's
    frontend) as feats.ark.  On the card the xconfig module's output is
    the native ChainTdnnf's chain head within 1e-4 on every frame."""
    d = os.path.join(sysd["dir"], "xconfig")
    os.makedirs(d, exist_ok=True)
    tm, spec = sysd["tm"], sysd["spec"]
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0, num_pdfs=tm.num_pdfs,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    variables = load_params(os.path.join(ART, "flagship_params.npz"))
    text = chain_tdnnf_xconfig(cfg)
    ckpt = os.path.join(d, "nnet")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, chain_tdnnf_variables_to_xconfig(variables), 0,
                    extra={"xconfig": text})
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _, _ = restore_checkpoint(ckpt)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = xconfig_from_flax(text, state, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    native = chain_tdnnf_from_flax(cfg, variables, device=dev)
    tm_path = os.path.join(d, "final.tm")
    write_kaldi_object(tm.write, tm_path)
    fe = OfflineFeature(mfcc_options(spec, num_ceps=40), device=dev)
    feats, loglikes, err = {}, {}, 0.0
    with torch.no_grad(), full_f32():
        for u in sysd["utts"]:
            f, n = fe.compute_batch_device([sysd["waves"][u]])
            f = f[:, :int(n[0])]
            ll = model({"input": f})["output"][0]
            err = max(err, float((ll - native.chain(f)[0]).abs().max()))
            feats[u] = f[0].cpu().numpy()
            loglikes[u] = ll.cpu().numpy()
    del native
    write_ark(os.path.join(d, "feats.ark"), feats.items())
    res = {"xconfig_layers": len(parse_xconfig(text)),
           "checkpoint_bytes": os.path.getsize(
               os.path.join(ckpt, "step_0", "variables.npz")),
           "write_s": write_s, "read_s": read_s, "build_s": build_s,
           "utterances": len(feats),
           "input_frames": sum(len(f) for f in feats.values()),
           "output_frames": sum(len(v) for v in loglikes.values()),
           "max_abs_err_vs_native": err, "tol": 1e-4}
    emit("xconfig_graph", **res)
    if err > 1e-4:
        raise SystemExit(f"xconfig_graph: the xconfig module is {err} from "
                         "the native TDNN-F")
    return {"res": res, "dir": d, "ckpt": ckpt, "tm_path": tm_path,
            "model": model, "feats": feats, "loglikes": loglikes,
            "context": tdnnf_context(cfg)}


def run_xconfig_latgen(x: dict, sysd: dict, online2: dict = None,
                       gpu: str = "yes") -> dict:
    """xconfig_latgen: `nnet3-latgen-faster` (decode.sh's beams) in a
    process of its own over feats.ark, then `lattice-scale |
    lattice-add-penalty | lattice-best-path` and `compute-wer` as
    processes.  Every lattice written, none undeterminized, each
    lattice-best-path equal to the tool's words, and each utterance's
    words equal to the host FasterDecoder's at beam 15 on the same
    loglikes (or the lattice's best path cheaper than FasterDecoder's)."""
    reset_kernel_counts()
    d, utts, words = x["dir"], sorted(x["feats"]), sysd["words"]
    lat, hyp = os.path.join(d, "lat.ark"), os.path.join(d, "hyp.int")
    tool = "nnet3-latgen-faster"
    t0 = time.perf_counter()
    proc = cli(tool, f"--use-gpu={gpu}", *LATGEN_ARGS, x["tm_path"],
               x["ckpt"], sysd["hclg"], f"ark:{os.path.join(d, 'feats.ark')}",
               f"ark:{lat}", f"ark,t:{hyp}")
    tool_s = time.perf_counter() - t0
    stats = tool_stats(tool, proc.stderr)
    got = int_words(hyp)
    lats = dict(SequentialTableReader("lattice", f"ark:{lat}"))
    best = os.path.join(d, "best.int")
    py = f"{sys.executable} -m kaldi_tpu_torch.cli"
    t0 = time.perf_counter()
    pipe = subprocess.run(
        ["bash", "-o", "pipefail", "-c",
         f"{py} lattice-scale --acoustic-scale=1.0 --lm-scale=1.0 "
         f"ark:{lat} ark:- | {py} lattice-add-penalty --word-ins-penalty=0.0 "
         f"ark:- ark:- | {py} lattice-best-path ark:- ark,t:{best}"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    pipeline_s = time.perf_counter() - t0
    if pipe.returncode != 0:
        raise SystemExit(f"lattice pipeline failed:\n{pipe.stderr[-4000:]}")
    best_words = int_words(best)
    names = {u: [words[w] for w in got.get(u, [])] for u in utts}
    test_txt = {u: sysd["test_txt"][u] for u in utts}
    with TableWriter("token-vector", f"ark,t:{os.path.join(d, 'ref.txt')}") \
            as w:
        for u in utts:
            w.write(u, list(test_txt[u]))
    with TableWriter("token-vector", f"ark,t:{os.path.join(d, 'hyp.txt')}") \
            as w:
        for u in utts:
            w.write(u, names[u])
    wer_line = cli("compute-wer", "--mode=present",
                   f"ark:{os.path.join(d, 'ref.txt')}",
                   f"ark:{os.path.join(d, 'hyp.txt')}").stdout.splitlines()[0]
    errors = int(wer_line.split("[")[1].split("/")[0])
    wer = wer_of(names, test_txt)
    # the host best-path decoder on this process's loglikes
    dec = FasterDecoder(sysd["fst"], FasterDecoderOptions(beam=15.0))
    faults, costs, search_s, frames = [], {}, 0.0, 0
    for u in utts:
        t0 = time.perf_counter()
        fd = dec.decode(x["loglikes"][u], sysd["tm"].id2pdf_id, 1.0)
        search_s += time.perf_counter() - t0
        frames += len(x["loglikes"][u])
        lat_cost = latf.lattice_best_path(lats[u])[2] if u in lats else None
        if fd is None or got.get(u) != fd[1]:
            costs[u] = {"lattice": lat_cost,
                        "faster_decoder": None if fd is None else fd[2]}
            if fd is not None and (lat_cost is None
                                   or not lat_cost < fd[2]):
                faults.append(u)
    f0 = torch.from_numpy(x["feats"][utts[0]][None]).to(x["model"].device)
    prof = {"device_ms": None, "kernel_launches": None, "top": None}
    if f0.is_cuda:
        with torch.no_grad(), full_f32():
            prof = profile_call(lambda: x["model"]({"input": f0}), top=4)
    res = {"utterances": len(utts), "lattices": len(lats),
           "det_fallbacks": stats["det_fallbacks"], "tool_s": tool_s,
           "rtf": stats["rtf"], "tool_stats": stats,
           "forward_span_ms_a_call": stats["forward_span_ms"]
           / max(stats["forward_calls"], 1)
           if stats["forward_span_ms"] is not None else None,
           "forward_profiled": {"frames": len(x["feats"][utts[0]]),
                                "device_ms": prof["device_ms"],
                                "kernel_launches": prof["kernel_launches"],
                                "top": prof["top"]},
           "search_ms_a_frame": 1e3 * stats["search_s"]
           / max(stats["frames"], 1),
           "determinize_ms_a_lattice": 1e3 * stats["determinize_s"]
           / max(stats["utterances"], 1),
           "peak_memory_gb": stats.get("peak_memory_gb"),
           "pipeline_s": pipeline_s,
           "best_path_equal_tool_words": sum(best_words.get(u) == got.get(u)
                                             for u in utts),
           "compute_wer": wer_line, "wer": wer, "word_errors": errors,
           "ref_words": sum(len(r) for r in test_txt.values()),
           "equal_faster_decoder": len(utts) - len(costs),
           "differ_faster_decoder": costs,
           "faster_decoder_search_ms_a_frame": 1e3 * search_s
           / max(frames, 1),
           "launches": kernel_launch_counts(),
           "tool_launches": stats["kernel_launches"]}
    if online2 is not None:
        res.update(online2_wav_wer=online2["wer"],
                   agree_with_online2_wav=sum(names[u] == online2["names"][u]
                                              for u in utts))
    emit("xconfig_latgen", **res)
    if len(lats) != len(utts) or len(got) != len(utts) \
            or stats["det_fallbacks"] or faults \
            or res["best_path_equal_tool_words"] != len(utts) \
            or errors != word_errors(wer, test_txt):
        raise SystemExit(f"xconfig_latgen: {len(lats)}/{len(utts)} "
                         f"lattices, {stats['det_fallbacks']} fallbacks, "
                         f"FasterDecoder faults {faults}, "
                         f"{res['best_path_equal_tool_words']} best paths "
                         f"equal, compute-wer {wer_line!r} against {wer}")
    return {"res": res, "words": got}


def run_xconfig_variants(x: dict, sysd: dict, base: dict,
                         gpu: str = "yes") -> dict:
    """xconfig_latgen_variants: nnet3-latgen-faster-batch
    (--minibatch-size=8) and -looped (the model's 88 frames of context
    each side, subsampling 3) over the first XCONFIG_VARIANT_UTTS
    utterances: the base tool's words, and -batch's interior loglikes (the
    output frames whose context stops before the zero-padded tail) within
    1e-4 of the base forward's."""
    reset_kernel_counts()
    d = x["dir"]
    utts = sorted(x["feats"])[:XCONFIG_VARIANT_UTTS]
    feats4 = os.path.join(d, "feats4.ark")
    write_ark(feats4, ((u, x["feats"][u]) for u in utts))
    ctx = x["context"]
    out, launches = {}, {}
    for tool, extra in (
            ("nnet3-latgen-faster-batch", ["--minibatch-size=8"]),
            ("nnet3-latgen-faster-looped",
             ["--frame-subsampling-factor=3", f"--extra-left-context={ctx}",
              f"--extra-right-context={ctx}"])):
        hyp = os.path.join(d, f"{tool}.int")
        t0 = time.perf_counter()
        proc = cli(tool, f"--use-gpu={gpu}", *LATGEN_ARGS, *extra,
                   x["tm_path"], x["ckpt"], sysd["hclg"], f"ark:{feats4}",
                   f"ark:{os.path.join(d, tool + '.lat')}", f"ark,t:{hyp}")
        stats = tool_stats(tool, proc.stderr)
        got = int_words(hyp)
        out[tool] = {"tool_s": time.perf_counter() - t0,
                     "equal_base_words": sum(got.get(u) == base[u]
                                             for u in utts),
                     "forward_calls": stats["forward_calls"],
                     "forward_span_ms": stats["forward_span_ms"],
                     "search_s": stats["search_s"],
                     "det_fallbacks": stats["det_fallbacks"]}
        launches[tool] = stats["kernel_launches"]
    fwd = _Forward(x["model"])
    err, interior = 0.0, 0
    for key, ll, n_in in batch_loglikes(
            fwd, [(u, x["feats"][u]) for u in utts]):
        n_int = max(0, (n_in - 1 - ctx) // 3 + 1)
        interior += n_int
        err = max(err, float(np.abs(ll[:n_int]
                                    - x["loglikes"][key][:n_int]).max()))
    res = {"utterances": len(utts), **out,
           "batch_interior_frames": interior,
           "batch_interior_max_abs_err": err, "tol": 1e-4,
           "launches": kernel_launch_counts(), "tool_launches": launches}
    emit("xconfig_latgen_variants", **res)
    if any(o["equal_base_words"] != len(utts) for o in out.values()) \
            or err > 1e-4 or not interior:
        raise SystemExit(f"xconfig_latgen_variants: {out}, interior "
                         f"loglikes {err} from the base tool's")
    return res


def randomize_(model, gen: torch.Generator) -> None:
    """Seeded random weights: each weight matrix normal over sqrt of its
    fan-in, biases normal x 0.1, BatchNorm means normal x 0.1 and
    variances uniform in [0.5, 1.5]."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen, dtype=p.dtype)
            p.copy_(z / p[0].numel() ** 0.5 if p.dim() > 1 else 0.1 * z)
        for name, b in model.named_buffers():
            if name.endswith("mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


def run_xconfig_zoo(dev: str = "cuda", lanes: int = ZOO_LANES,
                    frames: int = ZOO_FRAMES,
                    cpu_lanes: int = ZOO_CPU_LANES) -> dict:
    """xconfig_zoo: one model per layer family at its recipe's widths,
    seeded random weights, over lanes x frames on the card in float32
    (TF32 off in matmuls and convolutions), held against the same module
    in float64 on the CPU over the first cpu_lanes lanes.  ms of a
    forward (CUDA events), launches (and launches a frame for the
    recurrent ones) and peak memory (the profiler over one forward)."""
    reset_kernel_counts()
    out, bad = {}, []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i, (name, (tol, text)) in enumerate(ZOO.items()):
            gen = torch.Generator().manual_seed(SEED + i)
            ref = build_xconfig_model(text, device="cpu")
            randomize_(ref, gen)
            x = torch.randn(lanes, frames, 40, generator=gen)
            card = copy.deepcopy(ref).to(dev)
            xd = x.to(dev)
            with torch.no_grad(), full_f32():
                y = card({"input": xd})["output"]
                if dev == "cuda":
                    ms = cuda_ms(lambda: card({"input": xd}), 3)
                    prof = profile_call(lambda: card({"input": xd}), top=3)
                else:
                    ms, prof = None, None
                want = ref.double()({"input": x[:cpu_lanes].double()})[
                    "output"]
            err = float((y[:cpu_lanes].double().cpu() - want).abs().max()
                        / want.abs().max())
            recurrent = any(l.layer_type in ("fast-lstmp-layer", "gru-layer")
                            for l in ref.layers)
            out[name] = {
                "params": sum(p.numel() for p in card.parameters()),
                "shape": list(y.shape), "rel_err": err, "tol": tol,
                "ms": ms, "launches": prof and prof["kernel_launches"],
                "launches_a_frame": (prof["kernel_launches"] / frames
                                     if prof and recurrent else None),
                "peak_memory_gb": prof and prof["peak_memory_gb"],
                "finite": bool(torch.isfinite(y).all())}
            if not err <= tol or not out[name]["finite"]:
                bad.append(name)
            del card, ref, y, want
            if dev == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    res = {"lanes": lanes, "frames": frames, "cpu_lanes": cpu_lanes,
           "families": out, "launches": kernel_launch_counts()}
    emit("xconfig_zoo", **res)
    if bad:
        raise SystemExit(f"xconfig_zoo: {bad} outside their tolerances")
    return res


# ---------------------------------------------------------------------------
# disc_smbr: sequence-discriminative training of the legacy TDNN-F as an
# xconfig checkpoint through the tools, steps/nnet3/align.sh and
# train_discriminative.sh's stages over DISC_UTTS training utterances

DISC_UTTS = 32
DISC_EPOCHS = 2
# Adam's rate for the fine-tuning: at the tool's default (1e-4) both the
# JAX package and the port drive the legacy TDNN-F to a WER near 100%
# (PERF.md section 6)
DISC_LEARNING_RATE = 1e-6
# tools/disc_jax_bar.py: JAX's nnet3-discriminative-train (CPU) over this
# phase's alignment, lattice and feature archives from the same
# checkpoint, its tuned weights decoded by the port's nnet3-latgen-faster
# over the 16 test utterances: 15 errors of 185 words, the untuned
# checkpoint's too
DISC_JAX_BAR = dict(wer=100.0 * 15 / 185, word_errors=15)
DISC_WER_BAND = 0.5


def legacy_train_waves(spec, lexicon, n: int):
    """The first n training utterances of make_corpus(spec) -> (text,
    int16 waves), without synthesising the other ones."""
    from kaldi_tpu_torch.recipes.bench_corpus import (phone_inventory,
                                                      speaker_params,
                                                      synth_utterance)
    inv = phone_inventory(spec)
    sents = make_text(spec, spec.num_train, spec.seed + 1)[:n]
    warps, gains = speaker_params(spec)
    S = len(warps)
    txt = {f"tr{i:04d}": s for i, s in enumerate(sents)}
    waves = {u: np.clip(synth_utterance(s, lexicon, inv, spec, 10_000 + i,
                                        warps[i % S], gains[i % S]),
                        -32767, 32767).astype(np.int16)
             for i, (u, s) in enumerate(txt.items())}
    return txt, waves


def objf_of(out: str) -> tuple:
    """(objective a frame, frames) of nnet3-discriminative-compute-objf."""
    m = re.search(r"objective per frame is (\S+) over (\S+) frames", out)
    if not m:
        raise SystemExit(f"no objective line in:\n{out[-2000:]}")
    return float(m.group(1)), float(m.group(2))


def disc_grad_of(text: str, state: dict, feats_u: np.ndarray,
                 g: np.ndarray, kappa: float, l2: float):
    """grad_of for gradient_agreement: one discriminative step's gradient
    (step_loss with G = g held constant) of the xconfig model of `state`
    built in `dtype` on `dev` -> {parameter name: float64 array}."""
    from kaldi_tpu_torch.nnet3.discriminative_train import step_loss

    def grad_of(dev, dtype):
        model = xconfig_from_flax(text, state, device=dev, dtype=dtype)
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        with full_f32():
            ll = model({"input": torch.from_numpy(feats_u[None]).to(
                dev, dtype)})["output"][0]
            loss = step_loss(ll, torch.from_numpy(g).to(dev, dtype),
                             list(params.values()), kappa, l2)
            grads = torch.autograd.grad(loss, list(params.values()))
        return {k: v.detach().cpu().double().numpy()
                for k, v in zip(params, grads)}
    return grad_of


def run_disc_smbr(x: dict, sysd: dict, untuned_wer: float,
                  export: str = None) -> dict:
    """disc_smbr: over the first DISC_UTTS training utterances of the
    legacy corpus (int16 wire, the port's MFCC on the card),
    compile-train-graphs (L.fst, the chain tree, final.tm),
    nnet3-align-compiled --frame-subsampling-factor=3 with online2_graph's
    final.mdl (the numerator alignments, at the output rate),
    nnet3-latgen-faster with LATGEN_ARGS over xconfig_graph's checkpoint
    (the denominator lattices), nnet3-discriminative-get-egs (whole
    utterances), -copy-egs, -shuffle-egs, -subset-egs, -merge-egs,
    -compute-objf --criterion=smbr, nnet3-discriminative-train
    --criterion=smbr --num-epochs=DISC_EPOCHS
    --learning-rate=DISC_LEARNING_RATE at the lattices' acoustic scale
    (1.0) in a process of its own, -compute-objf again, and
    nnet3-latgen-faster and the WER of the 16 test utterances with the
    tuned checkpoint.  The other tools run in this process.  Then
    one step's gradient on the card against the CPU's float64 with the
    same G (gradient_agreement) and one profiled step.  export: a
    directory to copy the archives tools/disc_jax_bar.py reads to."""
    from kaldi_tpu_torch.decoder.graph import make_lexicon_fst
    from kaldi_tpu_torch.nnet3.discriminative import DiscriminativeOptions
    from kaldi_tpu_torch.nnet3.discriminative_train import (
        DiscTrainOptions, step_loss, utterance_gradient)
    reset_kernel_counts()
    d = os.path.join(x["dir"], "disc")
    os.makedirs(d, exist_ok=True)
    spec, tm, lang = sysd["spec"], sysd["tm"], sysd["lang"]
    t0 = time.perf_counter()
    txt, waves = legacy_train_waves(spec, sysd["lexicon"], DISC_UTTS)
    fe = OfflineFeature(mfcc_options(spec, num_ceps=40), device="cuda")
    feats = {}
    for u in sorted(waves):
        f, n = fe.compute_batch_device([waves[u]])
        feats[u] = f[0, :int(n[0])].cpu().numpy()
    p = {name: os.path.join(d, name) for name in (
        "feats.ark", "text.int", "L.fst", "tree", "graphs.ark", "ali.ark",
        "lat.ark", "egs.ark", "copy.egs", "shuf.egs", "sub.egs",
        "merged.egs", "tuned", "tuned_lat.ark", "tuned.int")}
    write_ark(p["feats.ark"], sorted(feats.items()))
    write_ark(p["text.int"], [(u, [lang.words[w] for w in txt[u]])
                              for u in sorted(txt)], "int-vector")
    with open(p["L.fst"], "wb") as f:
        write_fst(f, make_lexicon_fst(lang, with_disambig=True))
    write_kaldi_object(sysd["tree"].write, p["tree"])
    inputs_s = time.perf_counter() - t0
    sec: dict = {}
    ark = {k: f"ark:{v}" for k, v in p.items()}
    timed_tool(sec, "compile-train-graphs", p["tree"], x["tm_path"],
               p["L.fst"], ark["text.int"], ark["graphs.ark"])
    align_log = timed_tool(sec, "nnet3-align-compiled",
                           "--frame-subsampling-factor=3",
                           "--acoustic-scale=1.0", sysd["mdl"],
                           ark["graphs.ark"], ark["feats.ark"],
                           ark["ali.ark"])
    align_stats = tool_stats("nnet3-align-compiled", align_log)
    den_log = timed_tool(sec, "nnet3-latgen-faster", *LATGEN_ARGS,
                         x["tm_path"], x["ckpt"], sysd["hclg"],
                         ark["feats.ark"], ark["lat.ark"])
    den_stats = tool_stats("nnet3-latgen-faster", den_log)
    timed_tool(sec, "nnet3-discriminative-get-egs", "--num-frames=1000",
               ark["feats.ark"], ark["ali.ark"], ark["lat.ark"],
               ark["egs.ark"])
    timed_tool(sec, "nnet3-discriminative-copy-egs", ark["egs.ark"],
               ark["copy.egs"])
    timed_tool(sec, "nnet3-discriminative-shuffle-egs", "--srand=0",
               ark["copy.egs"], ark["shuf.egs"])
    timed_tool(sec, "nnet3-discriminative-subset-egs", f"--n={DISC_UTTS}",
               ark["shuf.egs"], ark["sub.egs"])
    timed_tool(sec, "nnet3-discriminative-merge-egs",
               f"--minibatch-size={DISC_UTTS}", ark["sub.egs"],
               ark["merged.egs"])
    objf_args = ["--criterion=smbr", "--acoustic-scale=1.0"]
    before = objf_of(timed_tool(
        sec, "nnet3-discriminative-compute-objf", *objf_args, x["ckpt"],
        x["tm_path"], ark["merged.egs"], key="compute-objf (before)"))
    train_log = timed_cli(sec, "nnet3-discriminative-train",
                          "--criterion=smbr", f"--num-epochs={DISC_EPOCHS}",
                          f"--learning-rate={DISC_LEARNING_RATE}",
                          "--acoustic-scale=1.0", x["ckpt"], x["tm_path"],
                          ark["feats.ark"], ark["ali.ark"], ark["lat.ark"],
                          p["tuned"])
    train_stats = tool_stats("nnet3-discriminative-train", train_log)
    after = objf_of(timed_tool(
        sec, "nnet3-discriminative-compute-objf", *objf_args, p["tuned"],
        x["tm_path"], ark["merged.egs"], key="compute-objf (after)"))
    dec_stats = tool_stats("nnet3-latgen-faster", timed_tool(
        sec, "nnet3-latgen-faster", *LATGEN_ARGS, x["tm_path"], p["tuned"],
        sysd["hclg"], f"ark:{os.path.join(x['dir'], 'feats.ark')}",
        ark["tuned_lat.ark"], f"ark,t:{p['tuned.int']}",
        key="nnet3-latgen-faster (tuned)"))
    test_utts = sorted(x["feats"])
    got = int_words(p["tuned.int"])
    test_txt = {u: sysd["test_txt"][u] for u in test_utts}
    names = {u: [sysd["words"][w] for w in got.get(u, [])]
             for u in test_utts}
    wer = wer_of(names, test_txt)
    # what the bars read: alignments at the output rate, one lattice and
    # one whole-utterance example an utterance
    alis = int_words(p["ali.ark"])
    lats = dict(SequentialTableReader("lattice", ark["lat.ark"]))
    egs = dict(SequentialTableReader("degs", ark["merged.egs"]))
    state, meta, _ = restore_checkpoint(x["ckpt"])
    text = meta["xconfig"]
    model = x["model"]
    out_frames = {}
    with torch.no_grad(), full_f32():
        for u in sorted(feats):
            out_frames[u] = int(model({"input": torch.from_numpy(
                feats[u][None]).cuda()})["output"].shape[1])
    lat_frames = {u: max(latf.lattice_state_times(lats[u])) for u in lats}
    rate_ok = sum(len(alis.get(u, [])) == out_frames[u] == lat_frames.get(u)
                  == -(-len(feats[u]) // 3) for u in feats)
    whole = sum(eg.left_context == eg.right_context == 0
                and len(eg.feats) == len(feats[k])
                and eg.num_ali == alis[k] for k, eg in egs.items())
    # one step's gradient: the card's float32 and float64 against the
    # CPU's float64, G from the card's float32 forward of the shortest
    # utterance
    u0 = min(feats, key=lambda u: len(feats[u]))
    d_opts = DiscriminativeOptions(criterion="smbr", acoustic_scale=1.0)
    with torch.no_grad(), full_f32():
        ll0 = model({"input": torch.from_numpy(feats[u0][None]).cuda()})[
            "output"][0].cpu().numpy()
    t0 = time.perf_counter()
    objf0, _T, g0 = utterance_gradient(tm, ll0, alis[u0], lats[u0],
                                       tm.num_pdfs, d_opts)
    host_ms = 1e3 * (time.perf_counter() - t0)
    l2 = DiscTrainOptions().l2
    agree = gradient_agreement(disc_grad_of(text, state, feats[u0], g0, 1.0,
                                            l2))
    # one step of the trainer, profiled: the forward, the backward and
    # the update
    step_model = xconfig_from_flax(text, state, device="cuda")
    params = dict(step_model.named_parameters())
    for prm in params.values():
        prm.requires_grad_(True)
    tx = optim.adam(DISC_LEARNING_RATE)
    opt_state = tx.init(params)
    f0 = torch.from_numpy(feats[u0][None]).cuda()
    g0_t = torch.from_numpy(g0).cuda().float()

    def one_step():
        with full_f32():
            ll = step_model({"input": f0})["output"][0]
            loss = step_loss(ll, g0_t, list(params.values()), 1.0, l2)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                upd, _ = tx.update(dict(zip(params, grads)), opt_state,
                                   params)
                for k in params:
                    params[k].add_(upd[k])
        torch.cuda.synchronize()
    one_step()
    prof = profile_call(one_step, top=4)
    del step_model, params, opt_state
    if export:
        import shutil
        os.makedirs(export, exist_ok=True)
        for name in ("feats.ark", "ali.ark", "lat.ark"):
            shutil.copy(p[name], os.path.join(export, name))
        shutil.copy(os.path.join(x["dir"], "feats.ark"),
                    os.path.join(export, "test_feats.ark"))
        shutil.copy(x["tm_path"], os.path.join(export, "final.tm"))
        shutil.copy(sysd["hclg"], os.path.join(export, "HCLG.fst"))
        with open(os.path.join(export, "train_meta.json"), "w") as f:
            json.dump({"tuned_wer": wer, "untuned_wer": untuned_wer,
                       "epoch_objf": train_stats["epoch_objf"]}, f)
    res = {"utterances": len(feats),
           "input_frames": sum(len(f) for f in feats.values()),
           "aligned": len(alis), "align_failed": align_stats["failed"],
           "output_rate_equal": rate_ok, "lattices": len(lats),
           "lattice_arcs": sum(lat.num_arcs() for lat in lats.values()),
           "den_det_fallbacks": den_stats["det_fallbacks"],
           "egs": len(egs), "whole_utterance_egs": whole,
           "objf_before": before[0], "objf_after": after[0],
           "objf_frames": before[1],
           "train_epoch_objf": train_stats["epoch_objf"],
           "train_steps": train_stats["steps"],
           "train_host_lattice_s": train_stats["host_s"],
           "train_forward_ms_median": train_stats["forward_ms_median"],
           "train_backward_ms_median": train_stats["backward_ms_median"],
           "train_peak_memory_gb": train_stats.get("peak_memory_gb"),
           "tool_s": sec, "inputs_s": inputs_s,
           "align_stats": align_stats, "den_latgen_rtf": den_stats["rtf"],
           "tuned_latgen_rtf": dec_stats["rtf"],
           "wer": wer, "word_errors": word_errors(wer, test_txt),
           "untuned_wer": untuned_wer, "jax_bar": DISC_JAX_BAR,
           "band": DISC_WER_BAND,
           "step_host_lattice_ms": host_ms, "step_utterance": u0,
           "step_objf": objf0,
           "step_profiled": {k: prof[k] for k in (
               "device_ms", "kernel_launches", "peak_memory_gb", "top")},
           "grad_worst": agree["worst"], "grad_worst_leaf":
               agree["worst_leaf"], "grad_f32_bar": agree["f32_bar"],
           "grad_reproducible": agree["reproducible"],
           "launches": kernel_launch_counts(),
           "tool_launches": {k: train_stats["kernel_launches"][k]
                             + align_stats["kernel_launches"][k]
                             + den_stats["kernel_launches"][k]
                             + dec_stats["kernel_launches"][k]
                             for k in train_stats["kernel_launches"]}}
    emit("disc_smbr", **res)
    bad = [name for name, ok in (
        ("every utterance aligned", len(alis) == len(feats)),
        ("alignments at the output rate", rate_ok == len(feats)),
        ("every lattice written", len(lats) == len(feats)),
        ("whole-utterance egs", whole == len(feats)),
        ("objective after >= before", after[0] >= before[0]),
        ("tuned WER within the band of JAX's",
         abs(wer - DISC_JAX_BAR["wer"]) <= DISC_WER_BAND),
        ("tuned WER within the band above the untuned",
         wer <= untuned_wer + DISC_WER_BAND),
        *agree["bars"].items()) if not ok]
    if bad:
        raise SystemExit(f"disc_smbr: {bad}")
    return res


def xconfig_phases(sysd: dict, online2: dict = None) -> dict:
    """xconfig_graph, xconfig_latgen, xconfig_latgen_variants and
    xconfig_zoo; kernels a-c launch 0 times in each (in this process and
    in the tools')."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    x = run_xconfig_graph(sysd)
    graph_launches = kernel_launch_counts()
    lat = run_xconfig_latgen(x, sysd, online2)
    var = run_xconfig_variants(x, sysd, lat["words"])
    disc = run_disc_smbr(x, sysd, lat["res"]["wer"])
    del x
    torch.cuda.empty_cache()
    zoo = run_xconfig_zoo()
    r = lat["res"]
    launches = {"xconfig_graph": graph_launches,
                "xconfig_latgen": {k: v + r["tool_launches"][k]
                                   for k, v in r["launches"].items()},
                "xconfig_latgen_variants": {
                    k: v + sum(t[k] for t in var["tool_launches"].values())
                    for k, v in var["launches"].items()},
                "xconfig_zoo": zoo["launches"],
                "disc_smbr": {k: v + disc["tool_launches"][k]
                              for k, v in disc["launches"].items()}}
    if any(any(c.values()) for c in launches.values()):
        raise SystemExit(f"a kernel of another path ran in the xconfig "
                         f"phases: {launches}")
    return {"xconfig_latgen_wer": r["wer"],
            "xconfig_latgen_rtf": r["rtf"],
            "xconfig_search_ms_a_frame": r["search_ms_a_frame"],
            "disc_smbr": {k: disc[k] for k in (
                "wer", "untuned_wer", "objf_before", "objf_after",
                "tool_s", "train_forward_ms_median",
                "train_backward_ms_median", "train_host_lattice_s")},
            "xconfig_seconds": time.perf_counter() - t0,
            "launches": launches}


# ---------------------------------------------------------------------------
# the graph and scoring tool chains: utils/format_lm.sh and
# utils/mkgraph.sh through the port's tools (tools/mkgraph_steps.py) over
# the legacy lexicon and bigram and online2_graph's .mdl (mkgraph_legacy),
# the 128 legacy test utterances decoded through that HCLG by
# nnet3-latgen-faster on the card, then the tools of steps/score_kaldi.sh,
# steps/get_ctm.sh and steps/lmrescore{,_const_arpa}.sh over the lattices
# (scoring_legacy); the generic recipe's tri1 graph through the same steps
# (mkgraph_template, in the train worker)

# tools/mkgraph_jax_bar.py (JAX CPU): the HCLG that the port's tools build
# on the CPU from the same files (and graph_t, the same built tropical and
# without fstpushspecial), and the JAX package's float32 TDNN-F and
# LatticeFasterDecoder over it on the 128 test utterances (int16 wire):
# the WER of the raw lattices' best paths and of lattice-mbr-decode
MKGRAPH_JAX_BAR = dict(hclg_states=14710, hclg_arcs=68373,
                       graph_t=[14712, 68379],
                       wer=100.0 * 101 / 1544, word_errors=101,
                       mbr_wer=100.0 * 100 / 1544, mbr_word_errors=100,
                       ref_words=1544)
MKGRAPH_WER_BAND, MKGRAPH_WORDS_BAND = 0.5, 8
# score_kaldi.sh's sweep, cut to the chain model's neighbourhood of its
# decoding scale (--acwt 1.0): LM weights and word insertion penalties
SCORE_LM_SCALES, SCORE_PENALTIES = (0.5, 1.0, 1.5), (0.0, 0.5)
# each best path's cost after the rescoring identity and phone-pruned
# determinization, relative
SCORE_COST_REL = 1e-4
# mkgraph_legacy's graphs of one language on the same loglikes: the gaps
# between their best words against the cost terms that part the graphs
# (cost_terms), in the float32 weights of their lattices (on an H100 the
# terms matched the gaps within 2.4e-6; one LG arc of fstpushspecial's
# push is 0.020, so the bar tells a missing arc apart)
GRAPH_TERMS_TOL = 1e-3
CHAIN_FRAME_SHIFT = 0.03


def _names(lang: str) -> dict:
    return {i: w for w, i in
            read_symbol_table(os.path.join(lang, "words.txt")).items()}


def best_path_words(lats: dict, names: dict, lm_scale: float = 1.0,
                    penalty: float = 0.0) -> dict:
    return {u: [names[w] for w in latf.lattice_best_path(
        latf.add_word_ins_penalty(latf.lattice_scale(lat, lm_scale=lm_scale),
                                  penalty))[1]]
            for u, lat in lats.items()}


def words_cost(lat, ids) -> float:
    """The cost of the lattice's best path whose words are ids
    (lattice-compose with their linear acceptor); inf where it has
    none."""
    comp = compose_lattice_fst_op(lat, make_linear_word_acceptor(ids))
    return latf.lattice_best_path(comp)[2] if comp.num_states else np.inf


def crossed_gaps(lat_a, lat_b, names_a: dict, names_b: dict) -> dict:
    """Two lattices of one utterance over two graphs of one language, on
    the same loglikes: each best path (alignment, words, cost) and how far
    above each lattice's best path lies its best path with the other's
    words (inf where it has none)."""
    best_a, best_b = latf.lattice_best_path(lat_a), latf.lattice_best_path(
        lat_b)
    words_a = [names_a[w] for w in best_a[1]]
    words_b = [names_b[w] for w in best_b[1]]
    id_a = {w: i for i, w in names_a.items()}
    id_b = {w: i for i, w in names_b.items()}
    return {"a": best_a, "b": best_b, "words_a": words_a, "words_b": words_b,
            "gap_a": words_cost(lat_a, [id_a[w] for w in words_b])
            - best_a[2],
            "gap_b": words_cost(lat_b, [id_b[w] for w in words_a])
            - best_b[2]}


def g_log_gain(g: VectorFst, ids) -> float:
    """What the log semiring takes off a word sequence's G cost: the log
    sum of G's paths of the words (explicit and epsilon-backoff bigrams)
    less the least of them, <= 0."""
    comp = compose(make_linear_word_acceptor(ids), g)
    n = comp.num_states
    indeg = [0] * n
    for arcs in comp.arcs:
        for a in arcs:
            indeg[a.nextstate] += 1
    order, stack = [], [q for q in range(n) if not indeg[q]]
    while stack:
        q = stack.pop()
        order.append(q)
        for a in comp.arcs[q]:
            indeg[a.nextstate] -= 1
            if not indeg[a.nextstate]:
                stack.append(a.nextstate)
    if len(order) != n:
        raise SystemExit("G composed with a word sequence has a cycle")
    log_d, min_d = [np.inf] * n, [np.inf] * n
    log_d[comp.start] = min_d[comp.start] = 0.0
    total_log = total_min = np.inf
    for q in order:
        for a in comp.arcs[q]:
            d = a.nextstate
            log_d[d] = LogWeight.plus(log_d[d], log_d[q] + a.weight)
            min_d[d] = min(min_d[d], min_d[q] + a.weight)
        if comp.is_final(q):
            total_log = LogWeight.plus(total_log, log_d[q] + comp.finals[q])
            total_min = min(total_min, min_d[q] + comp.finals[q])
    return total_log - total_min


def push_log_rate(before: VectorFst, after: VectorFst) -> float:
    """fstpushspecial's log(lambda): the push adds (n + 1) log(lambda) to
    a path of n arcs (fstext/ops.py push_special), and keeps every arc in
    place; read off the first path that a breadth-first walk from the
    start finds."""
    prev = {before.start: None}
    queue = collections.deque([before.start])
    while queue:
        q = queue.popleft()
        if before.is_final(q):
            break
        for i, a in enumerate(before.arcs[q]):
            if a.nextstate not in prev:
                prev[a.nextstate] = (q, i)
                queue.append(a.nextstate)
    added, n = after.finals[q] - before.finals[q], 0
    while prev[q] is not None:
        q, i = prev[q]
        added += after.arcs[q][i].weight - before.arcs[q][i].weight
        n += 1
    return added / (n + 1)


def cost_terms(lats: dict, lats_t: dict, lats_flat: dict, names: dict,
               flat_names: dict, lexicon: dict, tm, phones: dict,
               g_fst: VectorFst, push_rate: float) -> dict:
    """run_mkgraph_legacy's comparison of the tool graph's lattices
    (lats), graph_t's (lats_t) and the flat form's (lats_flat), on the
    same loglikes.  A path's cost in graph_t is its flat-form cost plus
    ln 2 where it ends without silence (L charges every exit, the flat
    form only the silence) less ln(n) for each word of n pronunciations
    (the flat form's pronunciation cost); in the tool graph it is its
    graph_t cost plus G's log gain of its words (g_log_gain:
    --use-log=true sums G's paths of a word sequence) and
    (m + 1) push_rate, m its arcs in LG (fstpushspecial).  For two of
    these graphs whose best paths' words differ, the gaps of
    crossed_gaps sum to at most the difference of the two best paths'
    terms; an utterance where they exceed it by GRAPH_TERMS_TOL is
    unexplained."""
    sil = phones["SIL"]
    disambig, _ = add_lex_disambig(lexicon)

    def exit_cost(ali) -> float:
        last = [t for t in ali if t][-1]
        return 0.0 if tm.transition_id_to_phone(last) == sil else LN2

    def pron_cost(words) -> float:
        return sum(np.log(len(lexicon[w])) for w in words)

    def lg_arcs(ali, words) -> int:
        """L_disambig's input symbols on the path: its phones, the
        silence disambiguation symbol after each silence, and the #k
        of each pronunciation that has one."""
        segs = [p for p, _, _ in alignment_to_phone_segments(
            [t for t in ali if t], tm)]
        said = [p for p in segs if p != sil]
        m, at = len(segs) + segs.count(sil), 0
        for w in words:
            pron, k = next((pron, k) for pron, k in disambig[w] if
                           said[at:at + len(pron)] == [phones[p]
                                                       for p in pron])
            m += k > 0
            at += len(pron)
        return m

    def log_terms(ali, words) -> float:
        return g_log_gain(g_fst, [word_id[w] for w in words]) + \
            (lg_arcs(ali, words) + 1) * push_rate

    word_id = {w: i for i, w in names.items()}
    out = {"lexicon_costs": {}, "log_semiring": {}, "unexplained": [],
           "flat_words": {}}
    for u in sorted(lats):
        # graph_t (a) against the flat form (b)
        x = crossed_gaps(lats_t[u], lats_flat[u], names, flat_names)
        out["flat_words"][u] = x["words_b"]
        if x["words_a"] != x["words_b"]:
            cover = exit_cost(x["b"][0]) - exit_cost(x["a"][0]) + \
                pron_cost(x["words_a"]) - pron_cost(x["words_b"])
            out["lexicon_costs"][u] = {
                "graph_t": x["words_a"], "flat_form": x["words_b"],
                "gaps": [x["gap_a"], x["gap_b"]], "cover": cover}
            if x["gap_a"] + x["gap_b"] > cover + GRAPH_TERMS_TOL:
                out["unexplained"].append(u)
        # the tool graph (a) against graph_t (b)
        y = crossed_gaps(lats[u], lats_t[u], names, names)
        if y["words_a"] != y["words_b"]:
            cover = log_terms(y["b"][0], y["words_b"]) - \
                log_terms(y["a"][0], y["words_a"])
            out["log_semiring"][u] = {
                "tool_graph": y["words_a"], "graph_t": y["words_b"],
                "gaps": [y["gap_a"], y["gap_b"]], "cover": cover}
            if y["gap_a"] + y["gap_b"] > cover + GRAPH_TERMS_TOL and \
                    u not in out["unexplained"]:
                out["unexplained"].append(u)
    return out


def run_mkgraph_legacy(sysd: dict, lex_words16: dict) -> dict:
    """mkgraph_legacy: format_lm.sh and mkgraph.sh through the tools
    (to_arpa of the legacy bigram, prepare-lang, arpa2fst, then
    mkgraph_steps at the chain model's scales over online2_graph's .mdl),
    the HCLG's size held to the port's tools on the CPU; the 128 test
    utterances on the int16 wire (the port's MFCC on the card) through
    nnet3-latgen-faster --use-gpu=yes --determinize-lattice=false at
    decode.sh's beams over the xconfig checkpoint of xconfig_graph, then
    lattice-determinize (unpruned, as nnet3-latgen-faster determinizes;
    a fallback is the raw lattice kept, logged); the WER held to
    tools/mkgraph_jax_bar.py's, 0 determinization fallbacks.

    The flat form's words: the same language weighed three ways on the
    same forward: the tool graph's lattices above, and, on
    nnet3-compute --use-gpu=yes's output through latgen-faster-mapped at
    the same beams, the tool graph built with tropical determinization
    and no fstpushspecial (graph_t) and online2_graph's flat form; where
    two of them differ in their words, the gaps must be covered by the
    cost terms that part the graphs (cost_terms).  The words against
    lex_int16_words, the batched flat-form decode of slice_lex_int16 (its
    lanes padded to a bucket, whose padding is the acoustic model's right
    context), are reported with the step that parts them."""
    reset_kernel_counts()
    d = os.path.join(sysd["dir"], "mkgraph")
    xdir = os.path.join(sysd["dir"], "xconfig")
    t0 = time.perf_counter()
    inp = mkgraph_steps.legacy_inputs(d, sysd["lexicon"], sysd["lm_text"],
                                      sysd["tm"], sysd["tree"])
    format_s = time.perf_counter() - t0
    graph_in = (inp["lang"], inp["G"], inp["tree"], sysd["mdl"])
    rep = mkgraph_steps.mkgraph(*graph_in, os.path.join(d, "graph"),
                                transition_scale=1.0, self_loop_scale=1.0)
    hclg = os.path.join(d, "graph", "HCLG.fst")
    states, arcs = rep["sizes"]["HCLG.fst"]
    names = _names(inp["lang"])
    utts = sorted(sysd["test_wav"])
    fe = OfflineFeature(mfcc_options(sysd["spec"], num_ceps=40),
                        device="cuda")
    feats = {}
    for u in utts:
        f, n = fe.compute_batch_device(
            [np.clip(sysd["test_wav"][u], -32767, 32767).astype(np.int16)])
        feats[u] = f[0, :int(n[0])].cpu().numpy()
    feats_ark = f"ark:{os.path.join(d, 'feats.ark')}"
    write_ark(os.path.join(d, "feats.ark"), feats.items())
    raw, lat = os.path.join(d, "raw.ark"), os.path.join(d, "lat.ark")
    tool = "nnet3-latgen-faster"
    t0 = time.perf_counter()
    proc = cli(tool, "--use-gpu=yes", "--determinize-lattice=false",
               *LATGEN_ARGS, os.path.join(xdir, "final.tm"),
               os.path.join(xdir, "nnet"), hclg, feats_ark, f"ark:{raw}",
               f"ark,t:{os.path.join(d, 'words.int')}")
    latgen_s = time.perf_counter() - t0
    stats = tool_stats(tool, proc.stderr)
    seconds: dict = {}
    det_log = timed_tool(seconds, "lattice-determinize", f"ark:{raw}",
                         f"ark:{lat}")
    fallbacks = det_log.count("fell back to raw lattice")
    lats = dict(SequentialTableReader("lattice", f"ark:{lat}"))
    got = {u: [names[w] for w in ws] for u, ws in
           int_words(os.path.join(d, "words.int")).items()}
    refs = {u: sysd["test_txt"][u] for u in utts}
    wer = wer_of(got, refs)
    errors = word_errors(wer, refs)
    # graph_t and the flat form on nnet3-compute's loglikes
    rep_t = mkgraph_steps.mkgraph(*graph_in, os.path.join(d, "graph_t"),
                                  transition_scale=1.0, self_loop_scale=1.0,
                                  use_log=False)
    loglikes = f"ark:{os.path.join(d, 'loglikes.ark')}"
    timed_tool(seconds, "nnet3-compute", "--use-gpu=yes",
               os.path.join(xdir, "nnet"), feats_ark, loglikes)
    same_ll = {}
    for key, fst in (("graph_t", os.path.join(d, "graph_t", "HCLG.fst")),
                     ("flat", sysd["hclg"])):
        out = os.path.join(d, f"lat_{key}.ark")
        timed_tool(seconds, "latgen-faster-mapped", *LATGEN_ARGS,
                   os.path.join(xdir, "final.tm"), fst, loglikes,
                   f"ark:{out}", key=f"latgen-faster-mapped {key}")
        same_ll[key] = dict(SequentialTableReader("lattice", f"ark:{out}"))
    graph_dir = os.path.join(d, "graph")
    push_rate = push_log_rate(read_fst_file(f"{graph_dir}/LG2.fst"),
                              read_fst_file(f"{graph_dir}/LG.fst"))
    terms = cost_terms(
        lats, same_ll["graph_t"], same_ll["flat"], names,
        dict(enumerate(sysd["words"])), sysd["lexicon"], sysd["tm"],
        read_symbol_table(os.path.join(inp["lang"], "phones.txt")),
        read_fst_file(inp["G"]), push_rate)
    lexicon_costs = terms["lexicon_costs"]
    log_semiring = terms["log_semiring"]
    differ = {}
    for u in utts:
        if got.get(u) != lex_words16.get(u):
            differ[u] = {"tool_graph": got.get(u),
                         "flat_form": lex_words16.get(u),
                         "parted_by": [
                             step for step, parted in (
                                 ("log_semiring", u in log_semiring),
                                 ("lexicon_costs", u in lexicon_costs),
                                 ("batched_acoustics",
                                  terms["flat_words"][u]
                                  != lex_words16.get(u)))
                             if parted]}
    bar = MKGRAPH_JAX_BAR
    res = {"utterances": len(utts), "lattices": len(lats),
           "hclg_states": states, "hclg_arcs": arcs,
           "cpu_tools_hclg": [bar["hclg_states"], bar["hclg_arcs"]],
           "sizes": rep["sizes"], "context": rep["context"],
           "graph_t": rep_t["sizes"]["HCLG.fst"],
           "cpu_tools_graph_t": bar["graph_t"],
           "format_lm_s": format_s, "format_lm_tool_s": inp["tool_s"],
           "mkgraph_tool_s": rep["tool_s"], "mkgraph_s": rep["total_s"],
           "mkgraph_t_s": rep_t["total_s"],
           "latgen_s": latgen_s, "search_s": stats["search_s"],
           "search_ms_a_frame": 1e3 * stats["search_s"]
           / max(stats["frames"], 1),
           "frames": stats["frames"], "rtf": stats["rtf"],
           "forward_span_ms": stats["forward_span_ms"], "tool_s": seconds,
           "det_fallbacks": fallbacks, "wer": wer, "word_errors": errors,
           "ref_words": sum(len(r) for r in refs.values()),
           "jax_bar": {k: bar[k] for k in ("wer", "word_errors")},
           "equal_graph_t_flat_form": len(utts) - len(lexicon_costs),
           "equal_tool_graph_graph_t": len(utts) - len(log_semiring),
           "push_log_rate": push_rate,
           "lexicon_costs": lexicon_costs, "log_semiring": log_semiring,
           "unexplained": terms["unexplained"],
           "equal_flat_form": len(utts) - len(differ),
           "differ_flat_form": differ,
           "launches": {k: v + stats["kernel_launches"][k]
                        for k, v in kernel_launch_counts().items()}}
    emit("mkgraph_legacy", **res)
    if (states, arcs) != (bar["hclg_states"], bar["hclg_arcs"]) or \
            res["graph_t"] != bar["graph_t"]:
        raise SystemExit(f"mkgraph_legacy: HCLG {states} states {arcs} "
                         f"arcs, graph_t {res['graph_t']}, the port's "
                         f"tools on the CPU {bar['hclg_states']} and "
                         f"{bar['hclg_arcs']}, {bar['graph_t']}")
    if len(lats) != len(utts) or fallbacks or stats["failed"] or any(
            len(v) != len(utts) for v in same_ll.values()):
        raise SystemExit(f"mkgraph_legacy: {len(lats)}/{len(utts)} "
                         f"lattices, {fallbacks} determinization fallbacks")
    if abs(wer - bar["wer"]) > MKGRAPH_WER_BAND or \
            abs(errors - bar["word_errors"]) > MKGRAPH_WORDS_BAND:
        raise SystemExit(f"mkgraph_legacy: WER {wer:.3f}% ({errors} "
                         f"errors), tools/mkgraph_jax_bar.py's "
                         f"{bar['wer']:.3f}% ({bar['word_errors']})")
    if terms["unexplained"]:
        raise SystemExit(f"mkgraph_legacy: words differ between the graphs "
                         f"of one language beyond their cost terms in "
                         f"{terms['unexplained']}")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in mkgraph_legacy: "
                         f"{res['launches']}")
    return {"res": res, "dir": d, "inp": inp, "raw": raw, "lat": lat,
            "lats": lats, "names": names, "refs": refs, "words": got,
            "model": sysd["mdl"], "lexicon": sysd["lexicon"]}


def _same_best_paths(before: dict, after: dict) -> list:
    """Keys whose best path's words change or whose cost moves by more
    than SCORE_COST_REL relative."""
    bad = []
    for u, lat in before.items():
        a = latf.lattice_best_path(lat)
        b = latf.lattice_best_path(after[u]) if u in after else None
        if b is None or b[1] != a[1] or \
                abs(b[2] - a[2]) > SCORE_COST_REL * abs(a[2]):
            bad.append(u)
    return bad


def check_ctm(text: str, best: dict, frames: dict) -> list:
    """Utterances whose CTM words (ids) are not their 1-best's, or whose
    start times fall or leave the utterance."""
    rows: dict = {}
    for line in text.splitlines():
        utt, _ch, start, dur, word = line.split()[:5]
        rows.setdefault(utt, []).append((float(start), float(dur), word))
    bad = []
    for u, words in best.items():
        r = rows.get(u, [])
        starts = [s for s, _, _ in r]
        end = CHAIN_FRAME_SHIFT * frames[u] + 1e-6
        if [w for *_, w in r] != words or starts != sorted(starts) or \
                any(s < 0 or s + dur > end for s, dur, _ in r):
            bad.append(u)
    return bad


def run_scoring_legacy(m: dict) -> dict:
    """scoring_legacy over mkgraph_legacy's lattices, with the tools in
    this process: score_kaldi.sh's sweep (lattice-scale |
    lattice-add-penalty | lattice-best-path) with lattice-mbr-decode at
    each LM weight; get_ctm.sh's chain (lattice-1best,
    lattice-align-words-lexicon over an align lexicon as prepare_lang.sh
    writes phones/align_lexicon.int, nbest-to-ctm) and
    lattice-to-ctm-conf; lattice-determinize-phone-pruned on the raw
    lattices; the rescoring identity (lattice-lmrescore --lm-scale=-1
    with the bigram ARPA, then lattice-lmrescore-const-arpa --lm-scale=1
    with arpa-to-const-arpa of the same ARPA) and lattice-lmrescore-pruned
    with the same pair.  MBR within half a point of the best path and 8
    words of JAX's; every CTM's words the 1-best's, start times
    non-decreasing inside the utterance; every best path kept by the
    rescoring and by phone-pruned determinization, and its cost after
    lattice-lmrescore --lm-scale=-1 lowered by its words' ARPA cost."""
    reset_kernel_counts()
    d, inp, names, refs = m["dir"], m["inp"], m["names"], m["refs"]
    lat, raw = m["lat"], m["raw"]
    seconds: dict = {}

    def wer_of_ark(path: str) -> dict:
        ws = {u: [names[w] for w in v] for u, v in int_words(path).items()}
        wer = wer_of(ws, refs)
        return {"wer": wer, "word_errors": word_errors(wer, refs)}

    sweep, mbr = {}, {}
    for lm in SCORE_LM_SCALES:
        for wip in SCORE_PENALTIES:
            out = os.path.join(d, f"best_{lm}_{wip}.int")
            timed_tool(seconds, "lattice-scale", f"--lm-scale={lm}",
                       f"ark:{lat}", f"ark:{d}/scaled.ark")
            timed_tool(seconds, "lattice-add-penalty",
                       f"--word-ins-penalty={wip}", f"ark:{d}/scaled.ark",
                       f"ark:{d}/pen.ark")
            timed_tool(seconds, "lattice-best-path", f"ark:{d}/pen.ark",
                       f"ark,t:{out}")
            sweep[f"{lm}/{wip}"] = wer_of_ark(out)
        out = os.path.join(d, f"mbr_{lm}.int")
        timed_tool(seconds, "lattice-mbr-decode", f"--lm-scale={lm}",
                   f"ark:{lat}", f"ark,t:{out}",
                   f"ark,t:{d}/risk_{lm}.txt")
        mbr[str(lm)] = wer_of_ark(out)
    best, mbr1 = sweep["1.0/0.0"], mbr["1.0"]
    # get_ctm.sh
    align_lex = mkgraph_steps.align_lexicon(
        m["lexicon"], inp["lang"], os.path.join(d, "align_lexicon.int"))
    timed_tool(seconds, "lattice-1best", f"ark:{lat}", f"ark:{d}/1best.ark")
    timed_tool(seconds, "lattice-align-words-lexicon", align_lex, m["model"],
               f"ark:{d}/1best.ark", f"ark:{d}/aligned.ark")
    timed_tool(seconds, "nbest-to-ctm",
               f"--frame-shift={CHAIN_FRAME_SHIFT}", f"ark:{d}/aligned.ark",
               f"{d}/ctm")
    timed_tool(seconds, "lattice-to-ctm-conf",
               f"--frame-shift={CHAIN_FRAME_SHIFT}", f"ark:{lat}",
               f"{d}/ctm_conf")
    lats = m["lats"]
    best_ids, frames = {}, {}
    for u, one in lats.items():
        ali, ws, _ = latf.lattice_best_path(one)
        best_ids[u] = [str(w) for w in ws]
        frames[u] = sum(1 for t in ali if t)
    bad_ctm = check_ctm(open(f"{d}/ctm").read(), best_ids, frames)
    bad_conf = check_ctm(open(f"{d}/ctm_conf").read(), best_ids, frames)
    # phone-pruned determinization of the raw lattices
    timed_tool(seconds, "lattice-determinize-phone-pruned", m["model"],
               f"ark:{raw}", f"ark:{d}/phone_det.ark")
    raws = dict(SequentialTableReader("lattice", f"ark:{raw}"))
    phone_det = dict(SequentialTableReader("lattice",
                                           f"ark:{d}/phone_det.ark"))
    bad_phone = _same_best_paths(raws, phone_det)
    # the rescoring identity
    lm_words = mkgraph_steps.const_arpa_symbols(
        os.path.join(inp["lang"], "words.txt"),
        os.path.join(d, "words_lm.txt"))
    carpa = os.path.join(d, "G.carpa")
    words_txt = os.path.join(inp["lang"], "words.txt")
    timed_tool(seconds, "arpa-to-const-arpa",
               f"--read-symbol-table={lm_words}", inp["arpa"], carpa)
    timed_tool(seconds, "lattice-lmrescore", "--lm-scale=-1", f"ark:{lat}",
               inp["arpa"], words_txt, f"ark:{d}/nolm.ark")
    timed_tool(seconds, "lattice-lmrescore-const-arpa", "--lm-scale=1",
               f"ark:{d}/nolm.ark", carpa, f"ark:{d}/relm.ark")
    timed_tool(seconds, "lattice-lmrescore-pruned", f"ark:{lat}",
               inp["arpa"], words_txt, carpa, f"ark:{d}/pruned.ark")
    bad_relm = _same_best_paths(lats, dict(SequentialTableReader(
        "lattice", f"ark:{d}/relm.ark")))
    bad_pruned = _same_best_paths(lats, dict(SequentialTableReader(
        "lattice", f"ark:{d}/pruned.ark")))
    # between the two: each best path's cost less its words' cost in the
    # ARPA (backoff where a bigram is absent, </s> included)
    arpa = parse_arpa(open(inp["arpa"]).read())
    nolm = dict(SequentialTableReader("lattice", f"ark:{d}/nolm.ark"))
    bad_nolm = []
    for u, one in lats.items():
        _ali, ws, cost = latf.lattice_best_path(one)
        lm_cost = -np.log(10.0) * arpa.score_sentence_log10(
            [names[w] for w in ws])
        if abs(words_cost(nolm[u], ws) - (cost - lm_cost)) > \
                SCORE_COST_REL * abs(cost):
            bad_nolm.append(u)
    jbar = MKGRAPH_JAX_BAR
    res = {"lattices": len(lats), "sweep": sweep, "mbr": mbr,
           "best_path_wer": best["wer"], "mbr_wer": mbr1["wer"],
           "mbr_word_errors": mbr1["word_errors"],
           "jax_mbr": {k: jbar[k] for k in ("mbr_wer", "mbr_word_errors")},
           "ctm_faults": bad_ctm, "ctm_conf_faults": bad_conf,
           "ctm_lines": len(open(f"{d}/ctm").read().splitlines()),
           "phone_pruned_faults": bad_phone, "rescore_faults": bad_relm,
           "rescore_no_lm_faults": bad_nolm,
           "rescore_pruned_faults": bad_pruned, "tool_s": seconds,
           "seconds": sum(seconds.values()),
           "launches": kernel_launch_counts()}
    emit("scoring_legacy", **res)
    if abs(mbr1["wer"] - best["wer"]) > MKGRAPH_WER_BAND or abs(
            mbr1["word_errors"] - jbar["mbr_word_errors"]) \
            > MKGRAPH_WORDS_BAND:
        raise SystemExit(f"scoring_legacy: MBR WER {mbr1['wer']:.3f}% "
                         f"({mbr1['word_errors']}), best path "
                         f"{best['wer']:.3f}%, JAX's MBR "
                         f"{jbar['mbr_word_errors']} errors")
    if bad_ctm or bad_conf or bad_phone or bad_relm or bad_pruned or \
            bad_nolm:
        raise SystemExit(f"scoring_legacy: CTM {bad_ctm} {bad_conf}, "
                         f"phone-pruned {bad_phone}, rescoring {bad_relm} "
                         f"{bad_pruned}, without the LM {bad_nolm}")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in scoring_legacy: "
                         f"{res['launches']}")
    return res


def mkgraph_phases(sysd: dict, lex_words16: dict) -> dict:
    """mkgraph_legacy and scoring_legacy over online2_graph's files."""
    t0 = time.perf_counter()
    m = run_mkgraph_legacy(sysd, lex_words16)
    s = run_scoring_legacy(m)
    r = m["res"]
    return {"mkgraph_legacy_wer": r["wer"],
            "mkgraph_legacy_hclg": [r["hclg_states"], r["hclg_arcs"]],
            "mkgraph_legacy_equal_flat_form": r["equal_flat_form"],
            "scoring_legacy_mbr_wer": s["mbr_wer"],
            "mkgraph_seconds": time.perf_counter() - t0,
            "launches": {"mkgraph_legacy": r["launches"],
                         "scoring_legacy": s["launches"]}}


def run_mkgraph_template(run: dict) -> dict:
    """mkgraph_template: the generic recipe's tri1 graph (context width
    3) through mkgraph_steps from the recipe's lang, G.fst, tree and
    final.mdl, the test set through gmm-latgen-faster --use-gpu=yes at
    stage 5's options; WER and each utterance's words (at stage 5's LM
    weight and penalty) against the in-process HCLG's lattices of stage
    5."""
    reset_kernel_counts()
    root = run["root"]
    exp, tri1 = f"{root}/exp", f"{root}/exp/tri1"
    rep = mkgraph_steps.mkgraph(f"{exp}/lang", f"{exp}/lang/G.fst",
                                f"{tri1}/tree", f"{tri1}/final.mdl",
                                f"{tri1}/graph_tools")
    seconds: dict = {}
    log = timed_tool(seconds, "gmm-latgen-faster", "--use-gpu=yes",
                     "--acoustic-scale=0.1", "--beam=16", "--lattice-beam=6",
                     f"{tri1}/final.mdl", f"{tri1}/graph_tools/HCLG.fst",
                     f"ark:{root}/test/feats.ark",
                     f"ark:{tri1}/lat_tools.ark")
    stats = tool_stats("gmm-latgen-faster", log)
    names = _names(f"{exp}/lang")
    tri1_res = run["report"]["tri1"]
    lm, wip = tri1_res["lm_scale"], tri1_res["penalty"]
    new = best_path_words(dict(SequentialTableReader(
        "lattice", f"ark:{tri1}/lat_tools.ark")), names, lm, wip)
    old = best_path_words(dict(SequentialTableReader(
        "lattice", f"ark:{tri1}/lat.ark")), names, lm, wip)
    refs = template_run.read_texts(f"{root}/test")
    wer = wer_of(new, refs)
    differ = sorted(u for u in old if new.get(u) != old[u])
    res = {"hclg_states": rep["sizes"]["HCLG.fst"][0],
           "hclg_arcs": rep["sizes"]["HCLG.fst"][1],
           "in_process_hclg": [run["report"]["hclg_states"],
                               run["report"]["hclg_arcs"]],
           "sizes": rep["sizes"], "context": rep["context"],
           "mkgraph_tool_s": rep["tool_s"], "mkgraph_s": rep["total_s"],
           "latgen_s": seconds["gmm-latgen-faster"],
           "det_fallbacks": stats["det_fallbacks"], "rtf": stats["rtf"],
           "lm_scale": lm, "penalty": wip, "wer": wer,
           "word_errors": word_errors(wer, refs), "bar": TEMPLATE_BAR["wer"],
           "utterances": len(new), "differ_in_process": differ,
           "launches": {"mkgraph_template": kernel_launch_counts()}}
    emit("mkgraph_template", **res)
    if abs(wer - TEMPLATE_BAR["wer"]) > 1e-9 or differ or \
            len(new) != len(old) or stats["det_fallbacks"]:
        raise SystemExit(f"mkgraph_template: WER {wer:.3f}%, JAX's "
                         f"{TEMPLATE_BAR['wer']:.3f}%; words differ from "
                         f"the in-process graph's in {differ}")
    if any(res["launches"]["mkgraph_template"].values()):
        raise SystemExit(f"a kernel ran in mkgraph_template: "
                         f"{res['launches']}")
    return res


def lex_int16_words(lex: dict, model, fe) -> dict:
    """slice_lex_int16's words, the test utterances on the int16 wire
    through BatchedOfflinePipeline2 with the LexChain decoder."""
    utts = sorted(lex["test_wav"])
    pipe = BatchedOfflinePipeline2(model, lex["dec"], fe,
                                   sample_rate=lex["spec"].fs, device="cuda")
    outs = pipe.decode_batch([np.clip(lex["test_wav"][u], -32767, 32767)
                              .astype(np.int16) for u in utts])
    return lex_words(lex, utts, outs)


# ---------------------------------------------------------------------------
# the training and the online2 phases beside the main path: three groups,
# each in a process of its own on the same card, whose phases read nothing
# of the main process's

# ---------------------------------------------------------------------------
# the speaker and language back ends and VTLN (the main process, after
# its phases, beside the workers), the synthetic recipe and GMM MMI (the
# train worker, after the template phases)

# backend_lid: logistic-regression-train at its defaults and with mix-up;
# the card's weights within LR_WEIGHT_REL of the largest weight of the
# CPU port's (tests/test_torch_backend.py's tolerance against JAX)
BACKEND_MIX_UP = 48
LR_WEIGHT_REL = 1e-5
# backend_diar: 8 recordings, each the test utterances of 3 speakers
# (the 16 utterances after one another hold 16 speakers: the corpus
# assigns speakers round-robin)
DIAR_SPEAKERS_A_RECORDING = 3
DIAR_THRESHOLD = 0.0
# gmm_vtln: the 31 classes of gmm-init-lvtln (warps 0.85-1.15), each fit
# on LVTLN_UTTS training utterances (4 a speaker); compute-mfcc-feats
# --vtln-warp on VTLN_TOOL_UTTS test utterances, card against CPU
LVTLN_CLASSES, LVTLN_DEFAULT_CLASS, LVTLN_UTTS = 31, 15, 96
VTLN_TOOL_UTTS = 16
VTLN_TOOL_WARPS = (0.85, 0.93, 1.07, 1.15)
# each speaker's LVTLN class: JAX's for all but VTLN_WARP_MISMATCHES
# speakers (a speaker between two classes may fall either side from MFCC
# 2e-3 apart; an H100 run read none), the rest within one class; and
# the warps' correlation with the corpus's own (speaker_params) at most
# VTLN_CORPUS_CORR: the warp that undoes a spectrum stretched by a is
# about 1/a, so the correlation is negative (-0.916 on an H100).  A model
# that put every speaker in one class fails both: 13 of JAX's 24 speakers
# are away from the default class, and a constant has no correlation.
VTLN_WARP_MISMATCHES, VTLN_CORPUS_CORR = 2, -0.8
# the twofeats statistics are float64 sums of float32 posteriors (the
# reference's diagonal-UBM scoring): card against CPU within 1e-6, the
# i-vector tools' bar for a diagonal UBM (tests/test_torch_cuda_ivector.py)
VTLN_MFCC_ATOL, VTLN_MFCC_RTOL, VTLN_STATS_TOL = 2e-3, 1e-4, 1e-6
FMLLR_SPEAKERS = 6
# gmm_mmi: boosted MMI from the JAX recipe's tri1 (tests/data/
# template_tri1, the same system as the bar's) over the port's features of
# MMI_UTTS of the 112 training utterances; the tool chain's first
# iteration against the in-process one's.  synthetic_run trains its chain
# model from the reference recipe's initial draw (SYNTHETIC_CHAIN_INIT):
# each stage's word errors of the 16 test words within
# SYNTHETIC_WORDS_BAND of JAX's, the largest spread read from that draw
# (stage 6: the port 0 on the CPU and on an H100, JAX 1; one word is
# 6.25 points); the port's training adds in a fixed order, so the card
# gives one model.  Stage 6's raw lattices then go through
# lattice-determinize-pruned at the recipe's lattice beam, each best path
# kept.
MMI_UTTS, MMI_BOOST = 24, 0.1
MMI_OBJF_BAND, MMI_TOOL_REL = 2e-3, 1e-6
MMI_TRI1 = os.path.join(REPO, "tests", "data", "template_tri1")
SYNTHETIC_WORDS_BAND, SYNTHETIC_LATTICE_BEAM = 1, 4.0
SYNTHETIC_CHAIN_INIT = os.path.join(REPO, "tests", "data",
                                    "synthetic_chain_init.npz")
# tools/backend_jax_bar.py and tools/mmi_synthetic_jax_bar.py: the JAX
# package on the CPU, the same corpora, options and systems
BACKEND_JAX_BAR = dict(
    lid=dict(final_objf={"default": -2.2808, "mix_up": -2.4359},
             accuracy={"default": 65, "mix_up": 66}),
    diar=dict(num_spk={"reco0": 0, "reco1": 0, "reco2": 0, "reco3": 1,
                       "reco4": 0, "reco5": 0, "reco6": 0, "reco7": 0},
              threshold={"reco0": 1, "reco1": 2, "reco2": 0, "reco3": 1,
                         "reco4": 2, "reco5": 2, "reco6": 0, "reco7": 1}),
    vtln={"spk00": 0.99, "spk01": 0.99, "spk02": 1.01, "spk03": 1.01,
          "spk04": 1.0, "spk05": 1.0, "spk06": 1.01, "spk07": 1.0,
          "spk08": 1.01, "spk09": 1.0, "spk10": 1.0, "spk11": 0.99,
          "spk12": 1.0, "spk13": 1.0, "spk14": 1.0, "spk15": 1.0,
          "spk16": 0.99, "spk17": 1.0, "spk18": 1.0, "spk19": 1.01,
          "spk20": 1.0, "spk21": 1.01, "spk22": 0.99, "spk23": 1.01})
MMI_JAX_BAR = dict(objf=[0.008636209695964282, 0.015699057695676682,
                         0.018502020978607564, 0.0199859386699894],
                   wer_before=dict(wer=0.0, word_errors=0, ref_words=128),
                   wer_after=dict(wer=0.0, word_errors=0, ref_words=128))
SYNTHETIC_JAX_BAR = dict(gmm=dict(wer=0.0, word_errors=0, ref_words=16),
                         chain=dict(wer=6.25, word_errors=1, ref_words=16),
                         online=dict(wer=25.0, word_errors=4, ref_words=16))


def speaker_errors(labels, truth) -> int:
    """Segments whose cluster maps to another speaker under the best
    one-to-one mapping of clusters to speakers."""
    from scipy.optimize import linear_sum_assignment
    clusters, speakers = sorted(set(labels)), sorted(set(truth))
    count = np.zeros((len(clusters), len(speakers)))
    for c, s in zip(labels, truth):
        count[clusters.index(c), speakers.index(s)] += 1
    rows, cols = linear_sum_assignment(-count)
    return int(len(labels) - count[rows, cols].sum())


def backend_data(d: str) -> dict:
    """The --scale corpus (bench_scale_spec(): 384 training and 128 test
    utterances, 24 speakers round-robin) featurized on the card (40-dim
    MFCC), written under d with each set's spk2utt and utt2spk and
    utt2class (the speaker's index); the committed flagship extractor as
    flagship.ie and its 64-Gaussian diagonal UBM as flagship.dubm; each
    set's i-vectors through ivector-extract."""
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    spec = bench_scale_spec()
    sec: dict = {}
    t0 = time.perf_counter()
    _, _, train_wav, _, test_wav, _ = make_corpus(spec)
    sec["corpus"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = OfflineFeature(mfcc_options(spec), device="cuda")
    feats = {"train": mfcc_of(fe, train_wav), "test": mfcc_of(fe, test_wav)}
    sec["mfcc"] = time.perf_counter() - t0
    S = spec.num_speakers

    def spk(u):
        return int(u[2:]) % S

    for name, fs in feats.items():
        keys = sorted(fs)
        write_ark(os.path.join(d, f"{name}.ark"), ((u, fs[u]) for u in keys))
        by: dict = {}
        for u in keys:
            by.setdefault(f"spk{spk(u):02d}", []).append(u)
        with open(os.path.join(d, f"{name}.spk2utt"), "w") as f:
            f.writelines(f"{s} {' '.join(us)}\n" for s, us in sorted(
                by.items()))
        with open(os.path.join(d, f"{name}.utt2class"), "w") as f:
            f.writelines(f"{u} {spk(u)}\n" for u in keys)
    arrays = load_ivector_extractor(os.path.join(ART, "flagship_ng_ivec.npz"))
    ex = IvectorExtractor.from_arrays(arrays)
    write_kaldi_object(ex.write, os.path.join(d, "flagship.ie"))
    write_kaldi_object(ex.ubm.write, os.path.join(d, "flagship.dubm"))
    for name in ("train", "test"):
        timed_tool(sec, "ivector-extract",
                   os.path.join(d, "flagship.ie"),
                   f"ark:{d}/{name}.ark", f"ark:{d}/{name}.ivec")
    return {"feats": feats, "train_wav": train_wav, "test_wav": test_wav,
            "spk": spk, "true_warps": speaker_params(spec)[0], "sec": sec,
            "fe": fe}


def lr_objf(log: str) -> float:
    return float(re.findall(r"final objf (\S+)", log)[-1])


def run_backend_lid(d: str, data: dict) -> dict:
    """backend_lid: the lre07 back end as speaker id over the flagship
    i-vectors: logistic-regression-train on the training i-vectors with
    the speakers as classes, at its defaults (on the card and on the
    CPU) and with --mix-up=BACKEND_MIX_UP; logistic-regression-eval on
    the test i-vectors (top-1 accuracy); logistic-regression-copy to text
    and back to binary.  Bars: each accuracy within 2 test utterances of
    BACKEND_JAX_BAR's; the card's weights within LR_WEIGHT_REL of the
    CPU port's; the copies' weights those of the model; kernels a-c 0
    launches."""
    from kaldi_tpu_torch.ivector.logistic_regression import \
        LogisticRegression
    reset_kernel_counts()
    sec: dict = {}
    t_all = time.perf_counter()

    def p(name):
        return os.path.join(d, name)

    train = ["ark:" + p("train.ivec"), "ark:" + p("train.utt2class")]
    objf = {
        "default": lr_objf(timed_tool(sec, "logistic-regression-train",
                                      *train, p("lid.mdl"))),
        "mix_up": lr_objf(timed_tool(sec, "logistic-regression-train",
                                     f"--mix-up={BACKEND_MIX_UP}", *train,
                                     p("lid48.mdl")))}
    t0 = time.perf_counter()
    ivec_tool(sec, "cpu", "logistic-regression-train", *train,
              p("lid_cpu.mdl"))
    cpu_s = time.perf_counter() - t0
    truth = {u: data["spk"](u) for u in data["feats"]["test"]}
    accuracy, components = {}, {}
    for name, mdl in (("default", "lid.mdl"), ("mix_up", "lid48.mdl")):
        timed_tool(sec, "logistic-regression-eval", p(mdl),
                   "ark:" + p("test.ivec"), "ark:" + p(f"{mdl}.post"))
        post = dict(SequentialTableReader("vector", "ark:" + p(f"{mdl}.post")))
        accuracy[name] = sum(int(np.argmax(v)) == truth[u]
                             for u, v in post.items())
        components[name] = len(read_kaldi_object(LogisticRegression.read,
                                                 p(mdl)).class_of)
    timed_tool(sec, "logistic-regression-copy", "--binary=false",
               p("lid.mdl"), p("lid.txt"))
    timed_tool(sec, "logistic-regression-copy", p("lid.txt"),
               p("lid.bin"))
    model = read_kaldi_object(LogisticRegression.read, p("lid.mdl"))
    cpu = read_kaldi_object(LogisticRegression.read, p("lid_cpu.mdl"))
    copied = read_kaldi_object(LogisticRegression.read, p("lid.bin"))
    card_cpu = _rel_to_largest(model.weights, cpu.weights)
    copy_err = _rel_to_largest(copied.weights, model.weights)
    launches = kernel_launch_counts()
    bar = BACKEND_JAX_BAR["lid"]
    out = {"seconds": time.perf_counter() - t_all, "tool_s": sec,
           "cpu_train_s": cpu_s, "final_objf": objf,
           "jax_final_objf": bar["final_objf"], "accuracy": accuracy,
           "jax_accuracy": bar["accuracy"], "test_utterances": len(truth),
           "components": components, "card_cpu_weight_rel": card_cpu,
           "copy_weight_rel": copy_err, "launches": launches}
    emit("backend_lid", **out)
    bars = {f"accuracy {k}": abs(accuracy[k] - bar["accuracy"][k]) <= 2
            for k in accuracy}
    bars["card = cpu"] = card_cpu <= LR_WEIGHT_REL
    bars["copy"] = copy_err <= 1e-6
    bars["kernels a-c"] = not any(launches.values())
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"backend_lid: {failed}")
    return out


def diar_recordings(test_keys, spk) -> dict:
    """recording -> its utterances: the test utterances of speakers
    r*3 .. r*3+2 for recording r."""
    recos: dict = {}
    for u in sorted(test_keys):
        r = spk(u) // DIAR_SPEAKERS_A_RECORDING
        recos.setdefault(f"reco{r}", []).append(u)
    return recos


def run_backend_diar(d: str, data: dict) -> dict:
    """backend_diar: the callhome diarization back end over the flagship
    i-vectors: ivector-subtract-global-mean and ivector-normalize-length
    of both sets, ivector-compute-plda on the training set's,
    ivector-plda-scoring-dense of each recording (diar_recordings: 8
    recordings of 3 speakers each), agglomerative-cluster with the true
    speaker counts (--reco2num-spk-rspecifier) and with
    --threshold=DIAR_THRESHOLD; the segments whose cluster maps to
    another speaker (speaker_errors), each recording.  Bars: the tool's
    labels equal the in-process agglomerative_cluster's on the same
    archive; each recording's errors within one segment of
    BACKEND_JAX_BAR's; kernels a-c 0 launches."""
    from kaldi_tpu_torch.ivector.cluster import agglomerative_cluster
    reset_kernel_counts()
    sec: dict = {}
    t_all = time.perf_counter()

    def a(name):
        return "ark:" + os.path.join(d, name)

    for name in ("train", "test"):
        timed_tool(sec, "ivector-subtract-global-mean",
                   a(f"{name}.ivec"), a(f"{name}.dcen"))
        timed_tool(sec, "ivector-normalize-length", a(f"{name}.dcen"),
                   a(f"{name}.dnorm"))
    timed_tool(sec, "ivector-compute-plda", a("train.spk2utt"),
               a("train.dnorm"), os.path.join(d, "diar.plda"))
    recos = diar_recordings(data["feats"]["test"], data["spk"])
    with open(os.path.join(d, "reco2utt"), "w") as f:
        f.writelines(f"{r} {' '.join(us)}\n" for r, us in recos.items())
    with open(os.path.join(d, "reco2num"), "w") as f:
        f.writelines(f"{r} {len({data['spk'](u) for u in us})}\n"
                     for r, us in recos.items())
    timed_tool(sec, "ivector-plda-scoring-dense",
               os.path.join(d, "diar.plda"), a("reco2utt"), a("test.dnorm"),
               a("scores"))
    scores = dict(SequentialTableReader("matrix", a("scores")))
    errors, same = {}, True
    for mode, opts, k_of in (
            ("num_spk", ["--reco2num-spk-rspecifier=" + a("reco2num")],
             lambda us: len({data["spk"](u) for u in us})),
            ("threshold", [f"--threshold={DIAR_THRESHOLD}"], lambda us: 0)):
        timed_tool(sec, "agglomerative-cluster", *opts, a("scores"),
                   a("reco2utt"), a(f"labels.{mode}"))
        labels = {u: int(v[0]) for u, v in SequentialTableReader(
            "int-vector", a(f"labels.{mode}"))}
        errors[mode] = {}
        for r, us in recos.items():
            k = k_of(us)
            mine = agglomerative_cluster(
                np.asarray(scores[r]), threshold=DIAR_THRESHOLD,
                num_clusters=k if k > 0 else None)
            same &= [labels[u] for u in us] == [int(x) + 1 for x in mine]
            errors[mode][r] = speaker_errors([labels[u] for u in us],
                                             [data["spk"](u) for u in us])
    launches = kernel_launch_counts()
    bar = BACKEND_JAX_BAR["diar"]
    out = {"seconds": time.perf_counter() - t_all, "tool_s": sec,
           "recordings": {r: sorted({data["spk"](u) for u in us})
                          for r, us in recos.items()},
           "segments": {r: len(us) for r, us in recos.items()},
           "speaker_errors": errors, "jax_speaker_errors": bar,
           "error_share": {m: sum(e.values()) / len(data["feats"]["test"])
                           for m, e in errors.items()},
           "labels_equal_in_process": same, "launches": launches}
    emit("backend_diar", **out)
    bars = {f"{m} {r}": abs(errors[m][r] - bar[m][r]) <= 1
            for m in errors for r in errors[m]}
    bars["labels"] = same
    bars["kernels a-c"] = not any(launches.values())
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"backend_diar: {failed}")
    return out


def lvtln_warps() -> list:
    return [1.0 + 0.01 * (c - LVTLN_DEFAULT_CLASS)
            for c in range(LVTLN_CLASSES)]


def run_gmm_vtln(d: str, data: dict) -> dict:
    """gmm_vtln: compute-mfcc-feats --vtln-warp (VTLN_TOOL_WARPS) and
    --vtln-map (a warp an utterance, one batch of mixed warps) of
    VTLN_TOOL_UTTS test utterances on the card and on the CPU; the linear
    VTLN model over the flagship's diagonal UBM: gmm-init-lvtln --dim=40
    (31 classes), gmm-train-lvtln-special of each class from the
    unwarped and that class's warped MFCC of LVTLN_UTTS training
    utterances (the frontend on the card), gmm-global-est-lvtln-trans of
    each of the 24 training speakers; gmm-global-acc-stats-twofeats
    (unwarped and 0.9-warped MFCC), on the card and on the CPU, and
    gmm-global-est-fmllr of FMLLR_SPEAKERS speakers' 0.9-warped MFCC.
    Bars: the card's
    MFCC within VTLN_MFCC_ATOL/RTOL of the CPU's; each speaker's warp
    within one class of BACKEND_JAX_BAR's and equal to it for all but
    VTLN_WARP_MISMATCHES speakers; the warps' correlation with the
    corpus's at most VTLN_CORPUS_CORR; the twofeats statistics
    within VTLN_STATS_TOL of their largest element; kernels a-c 0
    launches."""
    from kaldi_tpu_torch.gmm.mle import AccumDiagGmm
    reset_kernel_counts()
    sec: dict = {}
    t_all = time.perf_counter()

    def p(name):
        return os.path.join(d, name)

    def a(name):
        return "ark:" + p(name)

    # compute-mfcc-feats with VTLN, card against CPU
    tool_utts = sorted(data["test_wav"])[:VTLN_TOOL_UTTS]
    fs = bench_scale_spec().fs
    with open(p("vtln_wav.scp"), "w") as scp:
        for u in tool_utts:
            with open(p(f"{u}.wav"), "wb") as f:
                WaveData(fs, data["test_wav"][u][None, :]).write(f)
            scp.write(f"{u} {p(u + '.wav')}\n")
    warps = lvtln_warps()
    with open(p("utt2warp"), "w") as f:
        f.writelines(f"{u} {VTLN_TOOL_WARPS[i % len(VTLN_TOOL_WARPS)]}\n"
                     for i, u in enumerate(tool_utts))
    mfcc_opts = ["--sample-frequency=16000", "--num-mel-bins=40",
                 "--num-ceps=40", "--dither=0"]
    mfcc_err = 0.0
    for tag, opt in [(f"w{w}", [f"--vtln-warp={w}"])
                     for w in VTLN_TOOL_WARPS] + [
            ("map", ["--vtln-map=" + a("utt2warp")])]:
        got = {}
        for side in ("cuda", "cpu"):
            ivec_tool(sec, side, "compute-mfcc-feats", *mfcc_opts, *opt,
                      "scp:" + p("vtln_wav.scp"), a(f"{tag}.{side}"))
            got[side] = dict(SequentialTableReader("matrix",
                                                   a(f"{tag}.{side}")))
        for u in tool_utts:
            x, y = np.asarray(got["cuda"][u]), np.asarray(got["cpu"][u])
            over = np.abs(x - y) - VTLN_MFCC_RTOL * np.abs(y)
            mfcc_err = max(mfcc_err, float(over.max()))
    # the LVTLN classes over the flagship UBM
    sub = sorted(data["train_wav"])[:LVTLN_UTTS]
    write_ark(p("sub.ark"), ((u, data["feats"]["train"][u]) for u in sub))
    spk2utt: dict = {}
    for u in sub:
        spk2utt.setdefault(f"spk{data['spk'](u):02d}", []).append(u)
    with open(p("sub.spk2utt"), "w") as f:
        f.writelines(f"{s} {' '.join(us)}\n" for s, us in sorted(
            spk2utt.items()))
    timed_tool(sec, "gmm-init-lvtln", "--dim=40", p("lvtln"))
    t0 = time.perf_counter()
    fe = data["fe"]
    for c, w in enumerate(warps):
        t1 = time.perf_counter()
        f, n = fe.compute_batch_device([data["train_wav"][u] for u in sub],
                                       vtln_warp=w)
        f = f.cpu().numpy()
        write_ark(p("warped.ark"), ((u, f[i, :n[i]])
                                    for i, u in enumerate(sub)))
        sec["warped_mfcc"] = sec.get("warped_mfcc", 0.0) + \
            time.perf_counter() - t1
        timed_tool(sec, "gmm-train-lvtln-special", f"--warp={w}", c,
                   p("lvtln"), p("lvtln"), a("sub.ark"), a("warped.ark"))
        if c == warps.index(0.9):
            shutil.copy(p("warped.ark"), p("warped09.ark"))
    classes_s = time.perf_counter() - t0
    timed_tool(sec, "gmm-global-est-lvtln-trans",
               "--spk2utt=" + a("train.spk2utt"), p("flagship.dubm"),
               p("lvtln"), a("train.ark"), a("lvtln.trans"),
               "ark,t:" + p("spk.warp"))
    spk_warp = {s: float(v) for s, v in SequentialTableReader(
        "float", a("spk.warp"))}
    # the twofeats statistics and the global fMLLR, card against CPU
    stats = {}
    for side in ("cuda", "cpu"):
        ivec_tool(sec, side, "gmm-global-acc-stats-twofeats",
                  p("flagship.dubm"), a("sub.ark"), a("warped09.ark"),
                  p(f"twofeats.{side}"))
        stats[side] = read_kaldi_object(AccumDiagGmm.read,
                                        p(f"twofeats.{side}"))
    stats_err = max(_rel_to_largest(getattr(stats["cuda"], k),
                                    getattr(stats["cpu"], k))
                    for k in ("occupancy", "mean_accs", "var_accs"))
    # the fMLLR update is the reference's host row iteration (~0.5 s a
    # speaker): FMLLR_SPEAKERS of them
    with open(p("fmllr.spk2utt"), "w") as f:
        f.writelines(f"{s} {' '.join(us)}\n" for s, us in sorted(
            spk2utt.items())[:FMLLR_SPEAKERS])
    timed_tool(sec, "gmm-global-est-fmllr",
               "--spk2utt=" + a("fmllr.spk2utt"), p("flagship.dubm"),
               a("warped09.ark"), a("fmllr"))
    fmllr = dict(SequentialTableReader("matrix", a("fmllr")))
    fmllr_dev = max(float(np.abs(W[:, :-1] - np.eye(W.shape[0])).max())
                    for W in fmllr.values())
    launches = kernel_launch_counts()
    bar = BACKEND_JAX_BAR["vtln"]
    true = {f"spk{s:02d}": float(w) for s, w in enumerate(data["true_warps"])}
    out = {"seconds": time.perf_counter() - t_all, "tool_s": sec,
           "classes_s": classes_s, "lvtln_utterances": len(sub),
           "speaker_warps": spk_warp, "jax_speaker_warps": bar,
           "corpus_warps": true,
           "warp_mismatches": sum(abs(spk_warp[s] - bar[s]) > 1e-6
                                  for s in bar),
           "warp_vs_corpus_corr": float(np.corrcoef(
               [spk_warp[s] for s in sorted(true)],
               [true[s] for s in sorted(true)])[0, 1]),
           "mfcc_excess_over_rtol": mfcc_err,
           "twofeats_card_cpu_rel": stats_err,
           "fmllr_speakers": len(fmllr),
           "fmllr_max_offdiag_from_identity": fmllr_dev,
           "launches": launches}
    emit("gmm_vtln", **out)
    bars = {"mfcc": mfcc_err <= VTLN_MFCC_ATOL,
            "twofeats": stats_err <= VTLN_STATS_TOL,
            "kernels a-c": not any(launches.values())}
    bars.update({f"warp {s}": abs(spk_warp[s] - bar[s]) <= 0.01 + 1e-6
                 for s in bar})
    bars["warps as JAX's"] = out["warp_mismatches"] <= VTLN_WARP_MISMATCHES
    bars["warps vs corpus"] = out["warp_vs_corpus_corr"] <= VTLN_CORPUS_CORR
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"gmm_vtln: {failed}")
    return out


def run_synthetic(root: str) -> dict:
    """synthetic_run: recipes/synthetic_run.py (egs/synthetic/run.py)
    stages 0-7 on the card, the chain model from SYNTHETIC_CHAIN_INIT
    (the reference recipe's initial draw): the WER of stage 4 (the mono
    GMM), 6 (the
    exported chain .mdl through nnet3-compute and latgen-faster-mapped,
    the lattice scoring sweep) and 7 (online2-wav-nnet3-latgen-faster),
    each stage's and tool's seconds; then stage 6's raw lattices through
    lattice-determinize-pruned --beam=SYNTHETIC_LATTICE_BEAM.  Bars: each
    stage's word errors within SYNTHETIC_WORDS_BAND of
    SYNTHETIC_JAX_BAR's (on the 16 test words one word is 6.25 points,
    so a band of 2.0 points would admit none); each determinized
    lattice with its raw one's best path; kernels a-c 0 launches."""
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.recipes import synthetic_run
    reset_kernel_counts()
    report: dict = {}
    t0 = time.perf_counter()
    synthetic_run.main(["--dir", root, "--chain-init", SYNTHETIC_CHAIN_INIT],
                       report=report)
    launches = {"synthetic_run": kernel_launch_counts()}
    chain = os.path.join(root, "exp", "chain")
    det_s: dict = {}
    timed_tool(det_s, "lattice-determinize-pruned",
               f"--beam={SYNTHETIC_LATTICE_BEAM}", f"ark:{chain}/lat.ark",
               f"ark:{chain}/det.lat")
    raw, det = (dict(SequentialTableReader(LatticeHolder(),
                                           f"ark:{chain}/{name}"))
                for name in ("lat.ark", "det.lat"))
    det_kept = list(det) == list(raw) and all(
        lattice_best_path(det[u])[1] == lattice_best_path(raw[u])[1]
        for u in raw)
    res = {k: report[k] for k in ("gmm", "chain", "online")}
    out = {"seconds": time.perf_counter() - t0,
           "stage_s": report["stage_s"], "tool_s": report["tool_s"],
           "wer": res, "jax": SYNTHETIC_JAX_BAR,
           "latgen_mapped": report["tool_stats"].get("latgen-faster-mapped"),
           "determinized": {
               "seconds": det_s["lattice-determinize-pruned"],
               "raw_arcs": sum(lat.num_arcs() for lat in raw.values()),
               "det_arcs": sum(lat.num_arcs() for lat in det.values()),
               "best_paths_kept": det_kept},
           "chain_train": report.get("chain_train"), "launches": launches}
    emit("synthetic_run", **out)
    bars = {k: abs(res[k]["word_errors"] -
                   SYNTHETIC_JAX_BAR[k]["word_errors"]) <=
            SYNTHETIC_WORDS_BAND for k in res}
    bars["determinized"] = det_kept
    bars["kernels a-c"] = not any(launches["synthetic_run"].values())
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"synthetic_run: {failed}")
    return out


def backend_phases() -> dict:
    """backend_lid, backend_diar and gmm_vtln over one directory of the
    flagship extractor's data."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        data = backend_data(d)
        emit("backend_data", seconds=time.perf_counter() - t0,
             tool_s=data["sec"], train=len(data["feats"]["train"]),
             test=len(data["feats"]["test"]))
        out = {"backend_lid": run_backend_lid(d, data),
               "backend_diar": run_backend_diar(d, data),
               "gmm_vtln": run_gmm_vtln(d, data)}
        del data
    torch.cuda.empty_cache()
    return out


def mmi_phases() -> dict:
    """gmm_mmi over the generic recipe's corpus (mmi_data)."""
    with tempfile.TemporaryDirectory() as d:
        mmi_data(d)
        out = {"gmm_mmi": run_gmm_mmi(d)}
    torch.cuda.empty_cache()
    return out


def mmi_data(root: str) -> None:
    """What gmm_mmi reads of the generic recipe's run, made here: the
    fabricated corpus at TEMPLATE_UTTS, the lang dir, each set's MFCC
    (the card) and stage 4's G from the ARPA bigram."""
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from kaldi_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa
    from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
    sec: dict = {}
    t0 = time.perf_counter()
    make_standard_corpus(root, *TEMPLATE_UTTS)
    lang = os.path.join(root, "exp", "lang")
    timed_tool(sec, "prepare-lang", f"{root}/lexicon.txt", lang)
    for split in ("train", "test"):
        timed_tool(sec, "compute-mfcc-feats", "--sample-frequency=8000",
                   "--dither=0", f"scp:{root}/{split}/wav.scp",
                   f"ark:{root}/{split}/feats.ark")
    with open(f"{root}/lm.arpa") as f:
        g = arpa_to_fst(parse_arpa(f.read()),
                        read_symbol_table(os.path.join(lang, "words.txt")))
    with open(os.path.join(lang, "G.fst"), "wb") as f:
        write_fst(f, g)
    emit("mmi_data", seconds=time.perf_counter() - t0, tool_s=sec)


def unigram_g(lang, texts: dict) -> VectorFst:
    """make_denlats.sh's weak LM: a one-state G over the training text's
    words, each at -log of its relative count."""
    from kaldi_tpu_torch.fstext.fst import TropicalWeight
    counts = collections.Counter(w for t in texts.values() for w in t)
    total = sum(counts.values())
    g = VectorFst(TropicalWeight)
    s = g.add_state()
    g.set_start(s)
    g.set_final(s)
    for w in sorted(counts):
        g.add_arc(s, Arc(lang.words[w], lang.words[w],
                         float(-np.log(counts[w] / total)), s))
    return g


def mmi_system(root: str):
    """The JAX recipe's tri1 (MMI_TRI1) over the generic recipe's lang,
    read on the card -> (MonoSystem, its TransitionModel file's path)."""
    from kaldi_tpu_torch.decoder.graph import Lang
    lang = Lang(template_run.read_lexicon(f"{root}/lexicon.txt"),
                sil_phone="SIL", sil_prob=0.5)
    tm, am = read_am_gmm(os.path.join(MMI_TRI1, "final.mdl"), device="cuda")
    lang.topo = tm.topo
    tree = read_kaldi_object(ContextDependency.read,
                             os.path.join(MMI_TRI1, "tree"))
    return tmono.MonoSystem(lang, tree, tm, am)


def mmi_wer(sys_, hclg, feats: dict, refs: dict) -> dict:
    hyps = tmono.decode(sys_, hclg, feats, acoustic_scale=0.1)
    w = wer_of(hyps, refs)
    return dict(wer=w, word_errors=word_errors(w, refs))


def gauss_params(am) -> np.ndarray:
    return np.concatenate([np.concatenate([g.get_means().ravel(),
                                           g.get_vars().ravel()])
                           for g in (am.get_pdf(p)
                                     for p in range(am.num_pdfs))])


def run_gmm_mmi(root: str) -> dict:
    """gmm_mmi: boosted MMI (b=MMI_BOOST, TrainMmiOptions' defaults: 4
    iterations, E=2, tau=100) of the JAX recipe's tri1 over the generic
    recipe's features of MMI_UTTS training utterances, the denominator
    lattices over a unigram G of the training text: in process
    (recipes/mmi.py train_mmi, the GMM scored on the card, the lattice
    work on the host), then one iteration from the same model through
    steps/train_mmi.sh's tools (gmm-latgen-faster
    --determinize-lattice=false, gmm-rescore-lattice, lattice-boost-ali,
    lattice-to-post, ali-to-post with the denominator posteriors negated
    beside them as sum-post gives them, gmm-acc-stats2,
    gmm-ismooth-stats, gmm-est-gaussians-ebw, gmm-est-weights-ebw); the
    test set's WER before and after (the recipe's HCLG).  Bars: each
    iteration's objective within MMI_OBJF_BAND of MMI_JAX_BAR's and not
    falling; the WER after no worse than before and within 2.0 points and
    3 words of JAX's (stage 4's G, the recipe's HCLG over this tri1); the
    tools' means and variances within MMI_TOOL_REL
    of the in-process first iteration's (the weights differ: the tools
    update them, train_mmi does not by default); kernels a-c 0
    launches."""
    from kaldi_tpu_torch.cli.gmm_tools import write_am_gmm
    from kaldi_tpu_torch.recipes.mmi import TrainMmiOptions, train_mmi
    reset_kernel_counts()
    sec: dict = {}
    t_all = time.perf_counter()
    d = os.path.join(root, "mmi")
    os.makedirs(d, exist_ok=True)

    def p(name):
        return os.path.join(d, name)

    sys_ = mmi_system(root)
    feats_all = dict(SequentialTableReader("matrix",
                                           f"ark:{root}/train/feats.ark"))
    texts_all = template_run.read_texts(f"{root}/train")
    utts = sorted(feats_all)[:MMI_UTTS]
    feats = {u: feats_all[u] for u in utts}
    texts = {u: texts_all[u] for u in utts}
    test = dict(SequentialTableReader("matrix", f"ark:{root}/test/feats.ark"))
    refs = template_run.read_texts(f"{root}/test")
    g = unigram_g(sys_.lang, texts_all)
    # the recipe's G (stage 4's ARPA bigram) over this tri1
    hclg = tmono.make_hclg(sys_, read_fst_file(f"{root}/exp/lang/G.fst"))
    before = mmi_wer(sys_, hclg, test, refs)
    write_am_gmm(p("0.mdl"), sys_.tm, sys_.am)
    timing: dict = {}
    t0 = time.perf_counter()
    objs = train_mmi(sys_, feats, texts, g, TrainMmiOptions(
        num_iters=1, boost=MMI_BOOST), timing=timing)
    first = gauss_params(sys_.am)
    objs += train_mmi(sys_, feats, texts, g, TrainMmiOptions(
        num_iters=3, boost=MMI_BOOST), timing=timing)
    train_s = time.perf_counter() - t0
    after = mmi_wer(sys_, hclg, test, refs)
    # one iteration through the tools, from 0.mdl
    tsys = mmi_system(root)
    compiler = TrainingGraphCompiler(tsys.tm, tsys.tree, tsys.lang)
    ali = tmono._align_all(tsys, {u: compiler.compile(texts[u])
                                  for u in utts}, feats, 10.0, 0.1, 1.0)
    write_ark(p("feats.ark"), ((u, feats[u]) for u in utts))
    write_ark(p("ali.ark"), ((u, ali[u]) for u in utts), "int-vector")
    with open(p("HCLG.fst"), "wb") as f:
        write_fst(f, tmono.make_hclg(tsys, g))
    gpu = "--use-gpu=yes"
    t0 = time.perf_counter()
    timed_tool(sec, "gmm-latgen-faster", gpu, "--acoustic-scale=0.1",
               "--beam=16", "--lattice-beam=10", "--determinize-lattice=false",
               p("0.mdl"), p("HCLG.fst"), "ark:" + p("feats.ark"),
               "ark:" + p("den.lat"))
    timed_tool(sec, "gmm-rescore-lattice", gpu, p("0.mdl"),
               "ark:" + p("den.lat"), "ark:" + p("feats.ark"),
               "ark:" + p("rescored.lat"))
    timed_tool(sec, "lattice-boost-ali", f"--b={MMI_BOOST}", p("0.mdl"),
               "ark:" + p("rescored.lat"), "ark:" + p("ali.ark"),
               "ark:" + p("boosted.lat"))
    timed_tool(sec, "lattice-to-post", "--acoustic-scale=0.1",
               "ark:" + p("boosted.lat"), "ark:" + p("den.post"))
    timed_tool(sec, "ali-to-post", "ark:" + p("ali.ark"),
               "ark:" + p("num.post"))
    num = dict(SequentialTableReader("posterior", "ark:" + p("num.post")))
    den = dict(SequentialTableReader("posterior", "ark:" + p("den.post")))
    write_ark(p("signed.post"), ((u, [list(n) + [(t, -w) for t, w in dn]
                                      for n, dn in zip(num[u], den[u])])
                                 for u in utts if u in den), "posterior")
    timed_tool(sec, "gmm-acc-stats2", p("0.mdl"), "ark:" + p("feats.ark"),
               "ark:" + p("signed.post"), p("num.acc"), p("den.acc"))
    timed_tool(sec, "gmm-ismooth-stats", "--tau=100", p("num.acc"),
               p("num.acc"), p("snum.acc"))
    timed_tool(sec, "gmm-est-gaussians-ebw", "--E=2", p("0.mdl"),
               p("snum.acc"), p("den.acc"), p("1g.mdl"))
    timed_tool(sec, "gmm-est-weights-ebw", p("1g.mdl"), p("num.acc"),
               p("den.acc"), p("1.mdl"))
    tools_s = time.perf_counter() - t0
    _, tools_am = read_am_gmm(p("1.mdl"), device="cpu")
    tool_rel = _rel_to_largest(gauss_params(tools_am), first)
    launches = kernel_launch_counts()
    bar = MMI_JAX_BAR
    out = {"seconds": time.perf_counter() - t_all, "train_s": train_s,
           "timing": timing, "tools_s": tools_s, "tool_s": sec,
           "utterances": len(utts), "objf": objs, "jax_objf": bar["objf"],
           "wer_before": before, "wer_after": after,
           "jax_wer_before": bar["wer_before"],
           "jax_wer_after": bar["wer_after"],
           "tools_vs_in_process_rel": tool_rel, "launches": launches}
    emit("gmm_mmi", **out)
    bars = {f"objf {i}": abs(o - j) <= MMI_OBJF_BAND
            for i, (o, j) in enumerate(zip(objs, bar["objf"]))}
    bars["objf not falling"] = objs[-1] >= objs[0] - 1e-3
    bars["wer no worse"] = after["word_errors"] <= before["word_errors"]
    bars["wer jax"] = abs(after["wer"] - bar["wer_after"]["wer"]) <= \
        TEMPLATE_WER_BAND and abs(after["word_errors"] - bar["wer_after"][
            "word_errors"]) <= TEMPLATE_WORDS_BAND
    bars["tools"] = tool_rel <= MMI_TOOL_REL
    bars["kernels a-c"] = not any(launches.values())
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise SystemExit(f"gmm_mmi: {failed}")
    return out


# ---------------------------------------------------------------------------
# the other decoders over an HCLG: the dense and beam-sparse device
# decoders, on-the-fly LM composition, incremental determinization and
# grammar FSTs ("decoders" worker group; dense_flat runs in main)

# tools/decoders_jax_bar.py on the CPU: the JAX package's searches over the
# tool HCLG of the 128 legacy test utterances (dense, beam_sparse at its
# defaults, lookahead over HCL o G with the periodic link pruning off:
# the reference's pruning loses 8 best paths there, 100 errors, and the
# port's is upstream's) and the template tri1 system
# (gmm-latgen-biglm-faster from G to its unigrams)
DEC_JAX_BAR = dict(dense=dict(wer=100.0 * 101 / 1544, word_errors=101),
                   beam_sparse=dict(wer=100.0 * 102 / 1544, word_errors=102),
                   lookahead=dict(wer=100.0 * 92 / 1544, word_errors=92),
                   template_biglm=dict(wer=0.0, word_errors=0))
DEC_WER_BAND, DEC_WORDS_BAND = 0.5, 8
DEC_REL = 1e-4              # cost agreement, relative
DEC_CPU_LANES = 16          # dense_hclg's lanes again on the CPU twin
DEC_INC_UTTS = 32           # incremental's utterances (the first, sorted)
DEC_ONLINE_UTTS = 16        # online2-wav-nnet3-latgen-incremental's
DEC_GRAMMAR_UTTS = 32       # grammar's
HOST_SEARCH_MS = 0.710      # the host search's ms a frame (PERF.md §5)


def run_dense_flat(flat64, graph64, loglikes: torch.Tensor, out_lens,
                   dense_hyps) -> dict:
    """dense_flat: DenseViterbiDecoder over the V=64 flat graph
    (graph_direct.to_dense_device_graph), every lane, on slice_viterbi's
    loglikes at its acoustic scale (1.0), against slice_viterbi's decode
    of them (BatchedViterbi, kernel c, launched in slice_viterbi's run and
    counted there; this phase launches no kernel): in every
    lane the cost within DEC_REL relative and the words equal; a lane
    whose two paths cost the same within DEC_REL in float64 (path_cost)
    is reported as a tie, not failed."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    dg = to_dense_device_graph(flat64)
    build_s = time.perf_counter() - t0
    dec = DenseViterbiDecoder(dg, device="cuda")
    lens = np.asarray(out_lens)
    dec.decode_batch(loglikes[:2], 1.0, lengths=lens[:2])     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.decode_batch(loglikes, 1.0, lengths=lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(dec.stats)
    busy = profile_call(lambda: dec.decode_batch(loglikes, 1.0,
                                                 lengths=lens))["device_ms"]
    ll_host = loglikes.cpu().numpy()
    equal, ties, bad = 0, [], []
    for lane, (r, h) in enumerate(zip(out, dense_hyps)):
        tol = DEC_REL * max(1.0, abs(h[2]))
        if r is None or abs(r[2] - h[2]) > tol:
            bad.append(lane)
        elif r[0] == h[1] and r[1] == h[0]:
            equal += 1
        else:
            gap = abs(path_cost(graph64, r[0], r[1], ll_host[lane])
                      - path_cost(graph64, h[1], h[0], ll_host[lane]))
            (ties if gap <= tol else bad).append(lane)
    res = {"lanes": len(out), "lanes_equal": equal, "lanes_tied": ties,
           "lanes_failed": bad, "states": dg.num_states,
           "tiers": [list(t[0].shape) for t in dg.tiers],
           "padded_slots": stats["padded_slots"], "arcs": stats["arcs"],
           "chosen_arcs": stats["chosen_arcs"],
           "frames_padded": stats["frames"], "build_s": build_s,
           "wall_s": wall, "device_busy_ms": busy,
           "ms_a_frame_of_batch": 1e3 * wall / stats["frames"],
           "rel_tolerance": DEC_REL,
           "launches": kernel_launch_counts()}
    emit("dense_flat", **res)
    if bad:
        raise SystemExit(f"dense_flat: lanes {bad} differ from "
                         "BatchedViterbi's beyond a tie")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in dense_flat: {res['launches']}")
    return res


def legacy_test_corpus(d: str) -> dict:
    """The legacy corpus (its fingerprint the JAX package's) and its test
    utterances on the int16 wire, all of them in the wav archive
    d/wav_all.ark."""
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    if fingerprint != LEX_FINGERPRINT:
        raise SystemExit(f"corpus fingerprint {fingerprint}, the JAX "
                         f"package's {LEX_FINGERPRINT}")
    utts = sorted(test_wav)
    waves = {u: np.clip(test_wav[u], -32767, 32767).astype(np.int16)
             for u in utts}
    wav_all = os.path.join(d, "wav_all.ark")
    with TableWriter("wave", f"ark:{wav_all}") as w:
        for u in utts:
            w.write(u, WaveData(spec.fs, waves[u]))
    return {"spec": spec, "lexicon": lexicon, "lm_text": lm_text,
            "test_txt": test_txt, "fingerprint": fingerprint, "utts": utts,
            "waves": waves, "wav_all": f"ark:{wav_all}"}


def decoders_system(d: str) -> dict:
    """decoders_graph: the legacy corpus's HCLG through mkgraph.sh's steps
    (mkgraph_legacy's graph), HCL (the same steps over mkgraph_steps.flat_g)
    and the legacy G for the lookahead tool; the legacy TDNN-F as an
    xconfig checkpoint with final.tm (as xconfig_graph writes it) and as a
    .mdl (as online2_graph writes it); the test utterances' MFCCs on the
    int16 wire (the port's frontend) and nnet3-compute's loglikes of them
    (the ones mkgraph_legacy decodes); a wav archive of the first
    DEC_ONLINE_UTTS, and one of all of them (batched_cuda2's)."""
    corpus = legacy_test_corpus(d)
    spec, lexicon, lm_text, test_txt, fingerprint, utts, waves = (
        corpus[k] for k in ("spec", "lexicon", "lm_text", "test_txt",
                            "fingerprint", "utts", "waves"))
    _lang, tm, tree = chain_tm_tree_for(lexicon)
    t0 = time.perf_counter()
    inp = mkgraph_steps.legacy_inputs(os.path.join(d, "lm"), lexicon,
                                      lm_text, tm, tree)
    graph_in = (inp["tree"], inp["tm"])
    rep = mkgraph_steps.mkgraph(inp["lang"], inp["G"], *graph_in,
                                os.path.join(d, "graph"),
                                transition_scale=1.0, self_loop_scale=1.0)
    gflat = mkgraph_steps.flat_g(inp["lang"], os.path.join(d, "G_flat.fst"))
    rep_hcl = mkgraph_steps.mkgraph(inp["lang"], gflat, *graph_in,
                                    os.path.join(d, "hcl"),
                                    transition_scale=1.0,
                                    self_loop_scale=1.0)
    graph_s = time.perf_counter() - t0
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0, num_pdfs=tm.num_pdfs,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    variables = load_params(os.path.join(ART, "flagship_params.npz"))
    t0 = time.perf_counter()
    nnet = os.path.join(d, "nnet")
    save_checkpoint(nnet, chain_tdnnf_variables_to_xconfig(variables), 0,
                    extra={"xconfig": chain_tdnnf_xconfig(cfg)})
    write_kaldi_object(tm.write, os.path.join(d, "final.tm"))
    native = chain_tdnnf_from_flax(cfg, variables, device="cuda")
    ctx = tdnnf_context(cfg)
    mdl = os.path.join(d, "final.mdl")
    mdl_io.write_nnet3_am(mdl, tm, mdl_io.chain_tdnnf_to_nnet3(native,
                                                                variables),
                          left_context=ctx, right_context=ctx)
    del native
    model_s = time.perf_counter() - t0
    fe = OfflineFeature(mfcc_options(spec, num_ceps=40), device="cuda")
    feats = {}
    for u in utts:
        f, n = fe.compute_batch_device([waves[u]])
        feats[u] = f[0, :int(n[0])].cpu().numpy()
    write_ark(os.path.join(d, "feats.ark"), feats.items())
    seconds: dict = {}
    timed_tool(seconds, "nnet3-compute", "--use-gpu=yes", nnet,
               f"ark:{os.path.join(d, 'feats.ark')}",
               f"ark:{os.path.join(d, 'loglikes.ark')}")
    loglikes = read_ark(os.path.join(d, "loglikes.ark"))
    with TableWriter("wave", f"ark:{os.path.join(d, 'wav.ark')}") as w:
        for u in utts[:DEC_ONLINE_UTTS]:
            w.write(u, WaveData(spec.fs, waves[u]))
    res = {"hclg": rep["sizes"]["HCLG.fst"], "hcl": rep_hcl["sizes"][
               "HCLG.fst"], "graph_s": graph_s, "model_s": model_s,
           "nnet3_compute_s": seconds["nnet3-compute"],
           "utterances": len(utts),
           "frames": sum(len(v) for v in loglikes.values()),
           "num_pdfs": tm.num_pdfs, "corpus_fingerprint": fingerprint}
    emit("decoders_graph", **res)
    if tuple(res["hclg"]) != (MKGRAPH_JAX_BAR["hclg_states"],
                              MKGRAPH_JAX_BAR["hclg_arcs"]):
        raise SystemExit(f"decoders_graph: HCLG {res['hclg']}, the port's "
                         "tools on the CPU "
                         f"{MKGRAPH_JAX_BAR['hclg_states']} states and "
                         f"{MKGRAPH_JAX_BAR['hclg_arcs']} arcs")
    return {"res": res, "dir": d, "hclg": os.path.join(d, "graph",
                                                       "HCLG.fst"),
            "hcl": os.path.join(d, "hcl", "HCLG.fst"), "G": inp["G"],
            "lang": inp["lang"], "names": _names(inp["lang"]),
            "tm": tm, "tm_path": os.path.join(d, "final.tm"), "nnet": nnet,
            "mdl": mdl, "spec": spec, "utts": utts,
            "refs": {u: test_txt[u] for u in utts}, "loglikes": loglikes,
            "feats": f"ark:{os.path.join(d, 'feats.ark')}",
            "loglikes_ark": f"ark:{os.path.join(d, 'loglikes.ark')}",
            "wav": f"ark:{os.path.join(d, 'wav.ark')}",
            "wav_all": corpus["wav_all"]}


def _subset_ark(path: str, src: dict, keys) -> str:
    write_ark(path, ((k, src[k]) for k in keys))
    return f"ark:{path}"


def _wer_bar(phase: str, wer: float, errors: int, bar: dict) -> None:
    if abs(wer - bar["wer"]) > DEC_WER_BAND or \
            abs(errors - bar["word_errors"]) > DEC_WORDS_BAND:
        raise SystemExit(f"{phase}: WER {wer:.3f}% ({errors} errors), "
                         f"tools/decoders_jax_bar.py's {bar['wer']:.3f}% "
                         f"({bar['word_errors']})")


def _lane_batch(sysd: dict):
    utts = sysd["utts"]
    lens = np.array([len(sysd["loglikes"][u]) for u in utts])
    batch = np.zeros((len(utts), int(lens.max()), sysd["tm"].num_pdfs),
                     np.float32)
    for i, u in enumerate(utts):
        batch[i, :lens[i]] = sysd["loglikes"][u]
    return batch, lens


def run_dense_hclg(sysd: dict) -> dict:
    """dense_hclg: DenseViterbiDecoder on the tool HCLG over the test
    utterances' loglikes (all lanes, with their lengths; acoustic scale
    1.0), beside latgen-faster-mapped at decode.sh's beams over the same
    loglikes (the host search): an exact search costs at most the beam
    search's best path (plus DEC_REL), the words equal where the two costs
    agree within DEC_REL; the WER held to tools/decoders_jax_bar.py's;
    DEC_CPU_LANES lanes again on the CPU twin bit-equal (costs and chosen
    arcs); no epsilon closure cut."""
    reset_kernel_counts()
    d = sysd["dir"]
    hclg, tm = read_fst_file(sysd["hclg"]), sysd["tm"]
    t0 = time.perf_counter()
    dg = DenseDeviceGraph.build(hclg, tm.id2pdf_id, num_pdfs=tm.num_pdfs)
    build_s = time.perf_counter() - t0
    batch, lens = _lane_batch(sysd)
    dec = DenseViterbiDecoder(dg, device="cuda")
    dec.decode_batch(batch[:2], 1.0, lengths=lens[:2])       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.decode_batch(batch, 1.0, lengths=lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats, arcs_all = dict(dec.stats), dec.last_arcs
    busy = profile_call(lambda: dec.decode_batch(batch, 1.0,
                                                 lengths=lens))["device_ms"]
    # the CPU twin
    n = min(DEC_CPU_LANES, len(lens))
    t0 = time.perf_counter()
    cpu = DenseViterbiDecoder(dg, device="cpu")
    got_cpu = cpu.decode_batch(batch[:n], 1.0, lengths=lens[:n])
    cpu_s = time.perf_counter() - t0
    card = dec.decode_batch(batch[:n], 1.0, lengths=lens[:n])
    twin_equal = card == got_cpu and np.array_equal(cpu.last_arcs,
                                                    dec.last_arcs)
    # the host search over the same loglikes
    seconds: dict = {}
    lat_path = os.path.join(d, "latgen.ark")
    log = timed_tool(seconds, "latgen-faster-mapped", *LATGEN_ARGS,
                     sysd["tm_path"], sysd["hclg"], sysd["loglikes_ark"],
                     f"ark:{lat_path}")
    lstats = tool_stats("latgen-faster-mapped", log)
    lats = dict(SequentialTableReader("lattice", f"ark:{lat_path}"))
    names, utts = sysd["names"], sysd["utts"]
    host = {u: latf.lattice_best_path(lats[u]) for u in utts if u in lats}
    hyps, above, differ, ties = {}, [], [], []
    for u, r in zip(utts, out):
        if r is None:
            raise SystemExit(f"dense_hclg: {u} has no final state")
        hyps[u] = [names[w] for w in r[0]]
        h = host.get(u)
        if h is None:
            continue
        tol = DEC_REL * max(1.0, abs(h[2]))
        if r[2] > h[2] + tol:
            above.append(u)
        elif abs(r[2] - h[2]) <= tol and r[0] != h[1]:
            differ.append(u)
        elif r[0] != h[1]:
            ties.append({"utt": u, "dense": r[2], "latgen": h[2]})
    wer = wer_of(hyps, sysd["refs"])
    errors = word_errors(wer, sysd["refs"])
    frames = int(lens.sum())
    res = {"utterances": len(utts), "lanes": len(lens),
           "frames_padded": stats["frames"], "frames": frames,
           "tiers": [list(t[0].shape) for t in dg.tiers],
           "padded_slots": stats["padded_slots"], "arcs": stats["arcs"],
           "chosen_arcs": stats["chosen_arcs"],
           "eps_truncated": stats["eps_truncated"], "build_s": build_s,
           "wall_s": wall, "device_busy_ms": busy,
           "ms_a_frame_of_batch": 1e3 * wall / stats["frames"],
           "ms_an_utterance_frame": 1e3 * wall / frames,
           "host_search_ms_a_frame": 1e3 * lstats["search_s"]
           / max(lstats["frames"], 1),
           "host_search_ms_a_frame_pr21": HOST_SEARCH_MS,
           "latgen_s": seconds["latgen-faster-mapped"],
           "above_latgen": above, "equal_cost_other_words": differ,
           "cheaper_than_latgen_other_words": ties,
           "cpu_twin_lanes": n, "cpu_twin_equal": twin_equal,
           "cpu_twin_s": cpu_s, "wer": wer, "word_errors": errors,
           "jax_bar": DEC_JAX_BAR["dense"],
           "launches": kernel_launch_counts()}
    emit("dense_hclg", **res)
    if above or differ:
        raise SystemExit(f"dense_hclg: costs above the beam search's in "
                         f"{above}, other words at the same cost in "
                         f"{differ}")
    if not twin_equal:
        raise SystemExit("dense_hclg: the CPU twin decodes differently")
    if stats["eps_truncated"] or len(lats) != len(utts) or \
            lstats["failed"]:
        raise SystemExit(f"dense_hclg: {stats['eps_truncated']} closures "
                         f"cut, {len(lats)}/{len(utts)} host lattices")
    _wer_bar("dense_hclg", wer, errors, DEC_JAX_BAR["dense"])
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in dense_hclg: {res['launches']}")
    return {"res": res, "out": dict(zip(utts, out)), "hyps": hyps,
            "host": host, "arcs": arcs_all}


def _sparse_groups(sysd: dict) -> dict:
    by_len: dict = {}
    for u in sysd["utts"]:
        by_len.setdefault(len(sysd["loglikes"][u]), []).append(u)
    return by_len


def _sparse_run(dec, sysd: dict, groups: dict) -> tuple:
    out, fails = {}, 0
    for _T, group in sorted(groups.items()):
        res = dec.decode_batch(np.stack([sysd["loglikes"][u]
                                         for u in group]), 1.0)
        fails += dec.stats["traceback_failures"]
        out.update(zip(group, res))
    return out, fails


def run_beam_sparse_hclg(sysd: dict, dense: dict) -> dict:
    """beam_sparse_hclg: BeamSparseDecoder on the same graph and loglikes,
    the lanes grouped by length (the reference has no lane lengths): with
    a capacity of the degree-capped graph's states and an unbounded beam
    it is the exact search (costs within DEC_REL of dense_hclg's, the
    words equal; where the words differ at costs within DEC_REL the two
    paths tie, reported); at the reference's defaults (beam 16, capacity
    2048) no cost lies below the exact one less DEC_REL and the WER is
    held to tools/decoders_jax_bar.py's; no traceback gives up.  The
    card's busy time is read on the longest length group alone."""
    reset_kernel_counts()
    hclg, tm = read_fst_file(sysd["hclg"]), sysd["tm"]
    t0 = time.perf_counter()
    sg = SparseDeviceGraph.build(hclg, tm.id2pdf_id)
    build_s = time.perf_counter() - t0
    groups = _sparse_groups(sysd)
    names, exact = sysd["names"], dense["out"]
    longest = groups[max(groups)]
    ac_long = torch.from_numpy(-np.stack([sysd["loglikes"][u]
                                          for u in longest])).cuda()
    runs = {}
    for key, kw in (("exact", dict(beam=1e9, capacity=sg.num_states)),
                    ("defaults", {})):
        dec = BeamSparseDecoder(sg, device="cuda", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, fails = _sparse_run(dec, sysd, groups)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the card's share: the longest group's device pass alone, then
        # under the profiler (profiling all 68 groups' 10^5-10^6 launches
        # takes minutes)
        t0 = time.perf_counter()
        with torch.inference_mode():
            dec._decode_device(ac_long)
            torch.cuda.synchronize()
            long_s = time.perf_counter() - t0
            busy = profile_call(lambda: dec._decode_device(ac_long))[
                "device_ms"]
        hyps = {u: [names[w] for w in r[0]] if r else [] for u, r in
                out.items()}
        worse, below, other, ties = [], [], [], []
        for u, r in out.items():
            e = exact[u]
            tol = DEC_REL * max(1.0, abs(e[2]))
            if r is None:
                worse.append(u)
                continue
            if r[2] < e[2] - tol:
                below.append(u)
            if key != "exact":
                continue
            if abs(r[2] - e[2]) > tol:
                other.append(u)
            elif r[0] != e[0]:
                # two paths within DEC_REL: a tie that the two searches'
                # float32 sums break apart (beam_sparse keeps costs
                # relative to each frame's minimum)
                ties.append({"utt": u, "beam_sparse": r[2],
                             "dense": e[2]})
        wer = wer_of(hyps, sysd["refs"])
        frames = sum(len(sysd["loglikes"][u]) for u in out)
        runs[key] = {"beam": dec.beam, "capacity": dec.capacity,
                     "wall_s": wall, "longest_group": [len(longest),
                                                       ac_long.shape[1]],
                     "longest_group_device_pass_s": long_s,
                     "longest_group_device_busy_ms": busy,
                     "ms_an_utterance_frame": 1e3 * wall / frames,
                     "traceback_failures": fails, "no_result": worse,
                     "below_exact": below, "differ_from_exact": other,
                     "ties_with_exact": ties,
                     "equal_to_exact": sum(out[u] is not None
                                           and out[u][0] == exact[u][0]
                                           for u in out),
                     "wer": wer, "word_errors": word_errors(
                         wer, sysd["refs"])}
    res = {"states": sg.num_states, "De": sg.e_dst.shape[1],
           "Dn": sg.n_dst.shape[1], "eps_depth": sg.eps_depth,
           "build_s": build_s, "length_groups": len(groups),
           "utterances": len(sysd["utts"]), **runs,
           "jax_bar": DEC_JAX_BAR["beam_sparse"],
           "launches": kernel_launch_counts()}
    emit("beam_sparse_hclg", **res)
    for key, r in runs.items():
        if r["traceback_failures"] or r["below_exact"] or r["no_result"] \
                or (key == "exact" and r["differ_from_exact"]):
            raise SystemExit(f"beam_sparse_hclg ({key}): {r}")
    _wer_bar("beam_sparse_hclg", runs["defaults"]["wer"],
             runs["defaults"]["word_errors"], DEC_JAX_BAR["beam_sparse"])
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in beam_sparse_hclg: "
                         f"{res['launches']}")
    return res


def _interned(log: str) -> int:
    m = re.search(r"(\d+) product states interned", log)
    if m is None:
        raise SystemExit("nnet3-latgen-faster-lookahead logged no interned "
                         "count")
    return int(m.group(1))


def run_lazy_lm(sysd: dict, dense: dict) -> dict:
    """lazy_lm: nnet3-latgen-faster-lookahead over the tool-built HCL
    composed on demand with the legacy G (its WER held to
    tools/decoders_jax_bar.py's, its best paths beside dense_hclg's, the
    product states it interned against the product's bound); then the
    template tri1 system (mkgraph_steps.template_graphs):
    gmm-latgen-biglm-faster with old G = new G writes gmm-latgen-faster's
    lattices byte for byte, and from G to its unigrams its WER is held to
    the JAX tool's."""
    reset_kernel_counts()
    d = sysd["dir"]
    seconds: dict = {}
    words = os.path.join(d, "lookahead.words")
    log = timed_tool(seconds, "nnet3-latgen-faster-lookahead", "--use-gpu=yes",
                     *LATGEN_ARGS, sysd["tm_path"], sysd["nnet"],
                     sysd["hcl"], sysd["G"], sysd["feats"],
                     f"ark:{os.path.join(d, 'lookahead.lat')}",
                     f"ark,t:{words}")
    stats = tool_stats("nnet3-latgen-faster-lookahead", log)
    interned = _interned(log)
    hcl, g = read_fst_file(sysd["hcl"]), read_fst_file(sysd["G"])
    bound = hcl.num_states * g.num_states
    names = sysd["names"]
    got = {u: [names[w] for w in ws] for u, ws in int_words(words).items()}
    wer = wer_of(got, sysd["refs"])
    errors = word_errors(wer, sysd["refs"])
    differ_dense = sorted(u for u in got if got[u] != dense["hyps"][u])
    # the template tri1 system
    t = mkgraph_steps.template_graphs(os.path.join(d, "template"), "yes")
    tdir = os.path.dirname(t["lang"])
    tnames = _names(t["lang"])
    dec_args = ["--acoustic-scale=0.1", "--beam=16", "--lattice-beam=6"]
    out = {}
    for key, tool, lms in (("plain", "gmm-latgen-faster", []),
                           ("same_lm", "gmm-latgen-biglm-faster",
                            [t["G"], t["G"]]),
                           ("unigram", "gmm-latgen-biglm-faster",
                            [t["G"], t["G2"]])):
        lat = os.path.join(tdir, f"{key}.lat")
        timed_tool(seconds, tool, "--use-gpu=yes", *dec_args, t["model"],
                   t["hclg"], *lms, t["feats"], f"ark:{lat}",
                   f"ark,t:{lat}.words", key=f"{tool} {key}")
        hyp = {u: [tnames[w] for w in ws]
               for u, ws in int_words(f"{lat}.words").items()}
        out[key] = {"lat": lat, "wer": wer_of(hyp, t["test_txt"]),
                    "utterances": len(hyp)}
    with open(out["plain"]["lat"], "rb") as a, \
            open(out["same_lm"]["lat"], "rb") as b:
        same_bytes = a.read() == b.read()
    bi = out["unigram"]
    res = {"lookahead": {"wer": wer, "word_errors": errors,
                         "utterances": len(got),
                         "interned": interned, "product_bound": bound,
                         "hcl_states": hcl.num_states,
                         "g_states": g.num_states,
                         "equal_dense_words": len(got) - len(differ_dense),
                         "differ_dense_words": differ_dense,
                         "search_ms_a_frame": 1e3 * stats["search_s"]
                         / max(stats["frames"], 1),
                         "forward_span_ms": stats["forward_span_ms"],
                         "det_fallbacks": stats["det_fallbacks"],
                         "jax_bar": DEC_JAX_BAR["lookahead"]},
           "template": {"hclg": t["report"]["sizes"]["HCLG.fst"],
                        "same_lm_lattices_equal_plain": same_bytes,
                        "plain_wer": out["plain"]["wer"],
                        "biglm_unigram_wer": bi["wer"],
                        "biglm_unigram_word_errors": word_errors(
                            bi["wer"], t["test_txt"]),
                        "utterances": bi["utterances"],
                        "jax_bar": DEC_JAX_BAR["template_biglm"]},
           "tool_s": seconds, "launches": kernel_launch_counts()}
    emit("lazy_lm", **res)
    if not same_bytes:
        raise SystemExit("lazy_lm: gmm-latgen-biglm-faster with old G = new "
                         "G writes other lattices than gmm-latgen-faster")
    if interned >= bound or stats["failed"] or stats["det_fallbacks"] or \
            len(got) != len(sysd["utts"]):
        raise SystemExit(f"lazy_lm: {interned} product states interned of "
                         f"{bound}, {stats['failed']} failed, "
                         f"{len(got)}/{len(sysd['utts'])} decoded")
    _wer_bar("lazy_lm lookahead", wer, errors, DEC_JAX_BAR["lookahead"])
    _wer_bar("lazy_lm biglm", bi["wer"],
             res["template"]["biglm_unigram_word_errors"],
             DEC_JAX_BAR["template_biglm"])
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in lazy_lm: {res['launches']}")
    return res


def _markers(lats: dict) -> int:
    from kaldi_tpu_torch.decoder.incremental import _LABEL_BASE
    return sum(a.olabel >= _LABEL_BASE for lat in lats.values()
               for r in lat.arcs for a in r)


def run_incremental(sysd: dict, dense: dict) -> dict:
    """incremental: latgen-incremental-mapped at decode.sh's beams over the
    first DEC_INC_UTTS utterances' loglikes: each best path (words and
    alignment) equals latgen-faster-mapped's (dense_hclg's host search,
    the same beams; the tokens' costs cross chunks as upstream's do,
    ROADMAP §3); then online2-wav-nnet3-latgen-incremental over the .mdl
    on the first DEC_ONLINE_UTTS waves: each best path's words equal
    latgen-faster-mapped's.  A differing path is reported with its cost
    gap and fails the phase.  No marker label leaks into a lattice;
    max_chunk_links is recorded."""
    reset_kernel_counts()
    d = sysd["dir"]
    utts = sysd["utts"][:DEC_INC_UTTS]
    ll = _subset_ark(os.path.join(d, "ll_inc.ark"), sysd["loglikes"], utts)
    seconds: dict = {}
    lat = os.path.join(d, "inc.lat")
    log = timed_tool(seconds, "latgen-incremental-mapped", *LATGEN_ARGS,
                     sysd["tm_path"], sysd["hclg"], ll, f"ark:{lat}")
    m = re.search(r"max_chunk_links (\d+)", log)
    lats = dict(SequentialTableReader("lattice", f"ark:{lat}"))
    host = dense["host"]
    equal, differ = [], []
    for u in utts:
        a = latf.lattice_best_path(lats[u])
        h = host[u]
        if a[:2] == h[:2]:
            equal.append(u)
        else:
            differ.append({"utt": u, "cost_gap": a[2] - h[2]})
    # the online tool
    olat = os.path.join(d, "online_inc.lat")
    opts = online2_args({"spec": sysd["spec"]})
    olog = timed_tool(seconds, "online2-wav-nnet3-latgen-incremental",
                      "--use-gpu=yes", *opts, "--beam=15", sysd["mdl"],
                      sysd["hclg"], sysd["wav"], f"ark:{olat}")
    om = re.search(r"max_chunk_links (\d+)", olog)
    olats = dict(SequentialTableReader("lattice", f"ark:{olat}"))
    names = sysd["names"]
    online_differ = {}
    for u, l in olats.items():
        a = latf.lattice_best_path(l)
        if a[1] != host[u][1]:
            online_differ[u] = {"words": [names[w] for w in a[1]],
                                "cost_gap": a[2] - host[u][2]}
    res = {"utterances": len(utts), "equal_latgen": len(equal),
           "differ_latgen": differ,
           "max_chunk_links": int(m.group(1)) if m else None,
           "leaked_markers": _markers(lats) + _markers(olats),
           "online_utterances": len(olats),
           "online_max_chunk_links": int(om.group(1)) if om else None,
           "online_differ_latgen": online_differ,
           "tool_s": seconds,
           "ms_an_utterance_frame": 1e3 * seconds[
               "latgen-incremental-mapped"] / sum(
               len(sysd["loglikes"][u]) for u in utts),
           "launches": kernel_launch_counts()}
    emit("incremental", **res)
    if differ or online_differ or res["leaked_markers"] or \
            len(lats) != len(utts) or len(olats) != DEC_ONLINE_UTTS:
        raise SystemExit(f"incremental: best paths other than "
                         f"latgen-faster-mapped's {differ}, online "
                         f"{sorted(online_differ)}, "
                         f"{res['leaked_markers']} marker labels, "
                         f"{len(lats)} + {len(olats)} lattices")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in incremental: {res['launches']}")
    return res


def run_grammar(sysd: dict) -> dict:
    """grammar: make-grammar-fst prepares the tool HCLG as a grammar of one
    FST (--nonterm-phones-offset after the lang's last phone);
    nnet3-latgen-grammar decodes it and nnet3-latgen-faster the HCLG, on
    the first DEC_GRAMMAR_UTTS utterances: the lattices and words equal
    byte for byte."""
    reset_kernel_counts()
    d = sysd["dir"]
    phones = read_symbol_table(os.path.join(sysd["lang"], "phones.txt"))
    offset = max(phones.values()) + 1
    seconds: dict = {}
    prep = os.path.join(d, "HCLG_grammar.fst")
    timed_tool(seconds, "make-grammar-fst",
               f"--nonterm-phones-offset={offset}", sysd["hclg"], prep)
    feats = dict(SequentialTableReader("matrix", sysd["feats"]))
    utts = sysd["utts"][:DEC_GRAMMAR_UTTS]
    sub = _subset_ark(os.path.join(d, "feats_grammar.ark"), feats, utts)
    outs = {}
    for tool, fst in (("nnet3-latgen-grammar", prep),
                      ("nnet3-latgen-faster", sysd["hclg"])):
        lat = os.path.join(d, f"{tool}.lat")
        log = timed_tool(seconds, tool, "--use-gpu=yes", *LATGEN_ARGS,
                         sysd["tm_path"], sysd["nnet"], fst, sub,
                         f"ark:{lat}", f"ark,t:{lat}.words")
        with open(lat, "rb") as f, open(f"{lat}.words", "rb") as w:
            outs[tool] = (f.read(), w.read(), tool_stats(tool, log))
    g, f = outs["nnet3-latgen-grammar"], outs["nnet3-latgen-faster"]
    res = {"utterances": len(utts), "nonterm_phones_offset": offset,
           "lattices_equal": g[0] == f[0], "words_equal": g[1] == f[1],
           "lattice_bytes": len(g[0]),
           "search_ms_a_frame": 1e3 * g[2]["search_s"]
           / max(g[2]["frames"], 1), "tool_s": seconds,
           "launches": kernel_launch_counts()}
    emit("grammar", **res)
    if not (res["lattices_equal"] and res["words_equal"]) or \
            g[2]["utterances"] != len(utts):
        raise SystemExit("grammar: nnet3-latgen-grammar over the prepared "
                         "HCLG differs from nnet3-latgen-faster")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in grammar: {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# the rest of the feature front end and the cudafeat / cudadecoder tools
# ("features" worker group: feats_offline, feats_dither, feats_pitch,
# cudafeat_tools over the legacy corpus's 128 test utterances;
# batched_cuda2 in the decoders group after grammar, over its HCLG)

# tools/features_jax_bar.py on the CPU (JAX): the frame counts of each
# configuration, each utterance's processed pitch (frames, column means)
# and the WER of batched-wav-nnet3-cuda2's pipeline with every third frame
FEATURES_JAX_BAR = os.path.join(REPO, "tests", "data",
                                "features_jax_bar.json")
FEAT_TYPES = ("mfcc", "fbank", "spectrogram", "plp")
FEAT_PITCH_MEAN_TOL = 1e-3      # a column mean against the bar's
FEAT_PITCH_MISSES = 1           # utterances allowed past it (a tied lag)
FEAT_ONLINE_UTTS = 16           # OnlinePitchFeature's, in 0.25 s pieces
FEAT_ONLINE_REVISED = 1e-2      # a finalized frame this far off the offline
FEAT_DITHER = 1.0
EPS32 = float(np.finfo(np.float32).eps)
# batched-wav-nnet3-cuda2 at decode.sh's beams with the models' MFCC
CUDA2_ARGS = ["--dither=0", "--num-ceps=40", "--num-mel-bins=40",
              "--beam=15", "--lattice-beam=8", "--max-active=7000",
              "--max-batch-size=64", "--frame-subsampling-factor=3",
              "--acoustic-scale=1.0"]


def feature_configs() -> list:
    """(name, tool, options) of each offline configuration, as
    tools/features_jax_bar.py names them."""
    out = [(f"{t}{'' if snip else '_nosnip'}", f"compute-{t}-feats",
            ["--dither=0", f"--snip-edges={str(snip).lower()}"])
           for t in FEAT_TYPES for snip in (True, False)]
    out.append(("mfcc40", "compute-mfcc-feats",
                ["--dither=0", "--num-ceps=40", "--num-mel-bins=40"]))
    return out


def feature_excess(kind: str, got: np.ndarray, ref: np.ndarray):
    """(elements past the bar, the worst excess) of a feature type:
    atol 2e-3 / rtol 1e-4, PLP 5e-3 / 1e-3; a spectrogram bin also
    4 eps sqrt(S / P) of float32 FFT rounding (tests/feat_tolerance.py)."""
    ref64 = ref.astype(np.float64)
    if kind == "plp":
        tol = 5e-3 + 1e-3 * np.abs(ref64)
    else:
        tol = 2e-3 + 1e-4 * np.abs(ref64)
    if kind == "spectrogram":
        power = np.exp(ref64[:, 1:])
        tol[:, 1:] += 4 * EPS32 * np.sqrt(power.sum(1, keepdims=True)
                                          / power)
    excess = np.abs(got - ref64) - tol
    return int((excess > 0).sum()), float(excess.max(initial=-1.0))


def features_system(d: str) -> dict:
    """The legacy corpus's 128 test utterances on the int16 wire, as
    decoders_system has them (legacy_test_corpus), and the JAX bar."""
    corpus = legacy_test_corpus(d)
    with open(FEATURES_JAX_BAR) as f:
        bar = json.load(f)
    return {"dir": d, "bar": bar, **{k: corpus[k] for k in
                                     ("spec", "utts", "waves", "wav_all")}}


def run_feats_offline(fsys: dict) -> dict:
    """feats_offline: compute-{mfcc,fbank,spectrogram,plp}-feats over the
    128 utterances at the reference's defaults with --dither=0, each also
    with --snip-edges=false, and MFCC at 40/40, on the card and at
    --use-gpu=no: the frames of each configuration tools/features_jax_bar.
    py's, every element within feature_excess's bar of the CPU's; then a
    batch of 32 utterances of each type on the card: device ms (CUDA
    events, the median of 3 calls) and launches (profiler)."""
    reset_kernel_counts()
    d, bar = fsys["dir"], fsys["bar"]["frames"]
    seconds: dict = {}
    configs = {}
    for name, tool, opts in feature_configs():
        out = {}
        for gpu in ("yes", "no"):
            ark = os.path.join(d, f"{name}.{gpu}.ark")
            timed_tool(seconds, tool, f"--use-gpu={gpu}", *opts,
                       fsys["wav_all"], f"ark:{ark}", key=f"{name}_{gpu}")
            out[gpu] = read_ark(ark)
            os.remove(ark)
        kind = tool.split("-")[1]
        past, worst, frames = 0, -1.0, 0
        for u in fsys["utts"]:
            a, b = out["yes"][u], out["no"][u]
            if a.shape != b.shape:
                raise SystemExit(f"feats_offline: {name} {u} {a.shape} on "
                                 f"the card, {b.shape} on the CPU")
            n, w = feature_excess(kind, a, b)
            past, worst = past + n, max(worst, w)
            frames += a.shape[0]
        configs[name] = {"frames": frames, "bar_frames": bar[name],
                         "dim": int(a.shape[1]), "elements_past_bar": past,
                         "worst_excess": worst}
    batch = [fsys["waves"][u] for u in fsys["utts"][:32]]
    device = {}
    for kind in FEAT_TYPES:
        fe = make_feature_computer(kind, device="cuda")
        fe.opts.frame_opts.dither = 0.0
        fe.compute_batch_device(batch)                    # warm-up
        ms = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            feats, nframes = fe.compute_batch_device(batch)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        prof = profile_call(lambda: fe.compute_batch_device(batch), top=5)
        device[kind] = {"device_ms_median": sorted(ms)[1],
                        "launches": prof["kernel_launches"],
                        "profiled_device_ms": prof["device_ms"],
                        "frames": int(nframes.sum()),
                        "padded_frames": int(feats.shape[0]
                                             * feats.shape[1]),
                        "top_ops": prof.get("by_op", [])[:5]}
    res = {"utterances": len(fsys["utts"]), "configs": configs,
           "device_batch_32": device, "tool_s": seconds,
           "launches": kernel_launch_counts()}
    emit("feats_offline", **res)
    bad = [n for n, c in configs.items()
           if c["frames"] != c["bar_frames"] or c["elements_past_bar"]]
    if bad:
        raise SystemExit(f"feats_offline: {bad} differ in frames from "
                         "tools/features_jax_bar.py's or past the bar of "
                         "--use-gpu=no")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in feats_offline: {res['launches']}")
    return res


def run_feats_dither(fsys: dict) -> dict:
    """feats_dither: the models' MFCC (40/40) with --dither 1.0 on the card
    over the 128 utterances in batches of 32: one seed twice torch.equal,
    another seed different, every coefficient within tests/test_feat.py:
    109's 1.0 of the undithered features; the noise itself over a
    (128, 512, 400) draw (26e6 samples): mean within 0.01 x dither of 0,
    standard deviation within 1% of dither."""
    reset_kernel_counts()
    spec = fsys["spec"]
    plain = OfflineFeature(mfcc_options(spec, num_ceps=40), device="cuda")
    opts = mfcc_options(spec, num_ceps=40)
    opts.frame_opts.dither = FEAT_DITHER
    fe = OfflineFeature(opts, device="cuda")
    equal = differ = True
    worst = 0.0
    utts = fsys["utts"]
    t0 = time.perf_counter()
    for b0 in range(0, len(utts), 32):
        batch = [fsys["waves"][u] for u in utts[b0:b0 + 32]]
        a, n = fe.compute_batch_device(batch, seed=b0 + 1)
        b, _ = fe.compute_batch_device(batch, seed=b0 + 1)
        c, _ = fe.compute_batch_device(batch, seed=b0 + 1000)
        p, _ = plain.compute_batch_device(batch)
        equal &= bool(torch.equal(a, b))
        for i in range(len(batch)):
            differ &= not torch.equal(a[i, :n[i]], c[i, :n[i]])
            worst = max(worst, float((a[i, :n[i]] - p[i, :n[i]])
                                     .abs().max()))
    wall = time.perf_counter() - t0
    noise = dither_noise((128, 512, 400), 7, FEAT_DITHER,
                         torch.device("cuda")).double()
    mean, std = float(noise.mean()), float(noise.std())
    res = {"utterances": len(utts), "seed_twice_equal": equal,
           "other_seed_differs": differ,
           "max_abs_change": worst, "bound": 1.0,
           "noise_draws": noise.numel(), "noise_mean": mean,
           "noise_std": std, "dither": FEAT_DITHER, "wall_s": wall,
           "launches": kernel_launch_counts()}
    emit("feats_dither", **res)
    if not (equal and differ and worst < 1.0
            and abs(mean) < 0.01 * FEAT_DITHER
            and abs(std - FEAT_DITHER) < 0.01 * FEAT_DITHER):
        raise SystemExit("feats_dither: a bar failed")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in feats_dither: {res['launches']}")
    return res


def column_steps(mat: np.ndarray) -> np.ndarray:
    """A bound on each column's error after the CM format (kaldi's
    compressed-matrix.h, one byte with column headers), from the column's
    own values in plain numpy: the percentile headers p0, p25, p75, p100
    (sorted rows 0, n/4, 3n/4, n-1) split it into 64, 128 and 63 steps;
    each header is a uint16 over the matrix's range, off by at most
    two of its units (rounding, and the +1 that keeps headers apart).
    The bound is the widest segment's step with both ends moved out by
    that slop, plus the slop (a value clamped to a moved end)."""
    m = mat.astype(np.float32)
    if m.shape[0] < 5:
        raise SystemExit("column_steps: fewer than 5 rows")
    slop = 2.0 * (float(m.max()) - float(m.min())) / 65535
    srt = np.sort(m.astype(np.float64), axis=0)
    q = m.shape[0] // 4
    p = srt[[0, q, 3 * q, m.shape[0] - 1]]
    return np.max(np.stack([(p[1] - p[0] + 2 * slop) / 64,
                            (p[2] - p[1] + 2 * slop) / 128,
                            (p[3] - p[2] + 2 * slop) / 63]), axis=0) + slop


def run_feats_pitch(fsys: dict) -> dict:
    """feats_pitch: make_mfcc_pitch.sh's pipeline over the 128 utterances
    (compute-mfcc-feats, compute-and-process-kaldi-pitch-feats, paste-feats,
    copy-feats --compress=true): the combined pitch tool byte for byte
    compute-kaldi-pitch-feats then process-kaldi-pitch-feats; each element
    read back from the compressed archive within its column's
    quantisation step; each utterance's pitch frames tools/features_jax_
    bar.py's and its three column means within FEAT_PITCH_MEAN_TOL (at
    most FEAT_PITCH_MISSES utterances past it, each reported with its
    gap); OnlinePitchFeature on FEAT_ONLINE_UTTS utterances in 0.25 s
    pieces: with max_frames_latency past the stream's length bit for bit
    the offline output; at the default latency (30) each utterance's
    frames final before input_finished as many as tools/features_jax_bar.
    py's, as many of them past FEAT_ONLINE_REVISED of the offline output
    as there, and their column means within FEAT_PITCH_MEAN_TOL (at most
    FEAT_PITCH_MISSES utterances missing, each reported); that no
    finalized frame changed is reported too, though OnlinePitchFeature
    copies its finalized frames back on every call; the host seconds."""
    reset_kernel_counts()
    d, bar = fsys["dir"], fsys["bar"]["pitch"]
    fs = f"--sample-frequency={fsys['spec'].fs}"
    seconds: dict = {}
    ark = {k: os.path.join(d, f"{k}.ark") for k in
           ("mfcc", "pitch", "raw", "pitch2", "paste", "comp")}
    timed_tool(seconds, "compute-mfcc-feats", "--use-gpu=yes", fs,
               "--dither=0", "--num-ceps=40", "--num-mel-bins=40",
               fsys["wav_all"], f"ark:{ark['mfcc']}")
    timed_tool(seconds, "compute-and-process-kaldi-pitch-feats", fs,
               fsys["wav_all"], f"ark:{ark['pitch']}")
    timed_tool(seconds, "compute-kaldi-pitch-feats", fs, fsys["wav_all"],
               f"ark:{ark['raw']}")
    timed_tool(seconds, "process-kaldi-pitch-feats", f"ark:{ark['raw']}",
               f"ark:{ark['pitch2']}")
    timed_tool(seconds, "paste-feats", "--length-tolerance=2",
               f"ark:{ark['mfcc']}", f"ark:{ark['pitch']}",
               f"ark:{ark['paste']}")
    timed_tool(seconds, "copy-feats", "--compress=true",
               f"ark:{ark['paste']}", f"ark:{ark['comp']}")
    with open(ark["pitch"], "rb") as f, open(ark["pitch2"], "rb") as g:
        two_step_equal = f.read() == g.read()
    pitch, paste, comp = (read_ark(ark[k]) for k in
                          ("pitch", "paste", "comp"))
    past_step, frames_off, misses = 0, [], {}
    for u in fsys["utts"]:
        x, y = paste[u], comp[u]
        past_step += int((np.abs(y.astype(np.float64) - x)
                          > column_steps(x)[None, :]).sum())
        if pitch[u].shape[0] != bar[u]["frames"]:
            frames_off.append(u)
        gap = float(np.max(np.abs(pitch[u].mean(axis=0)
                                  - np.asarray(bar[u]["means"]))))
        if gap > FEAT_PITCH_MEAN_TOL:
            misses[u] = gap
    # the online pitch, in 0.25 s pieces
    fsamp = fsys["spec"].fs
    piece = int(0.25 * fsamp)
    online = {"utterances": FEAT_ONLINE_UTTS, "piece_s": 0.25}
    obar = fsys["bar"]["online_pitch"]
    online_misses = {}
    for mode, latency in (("whole", 10 ** 9), ("default", 30)):
        t0 = time.perf_counter()
        chunks, changed, equal_offline, t_offline = 0, 0, 0, 0.0
        for u in fsys["utts"][:FEAT_ONLINE_UTTS]:
            w = fsys["waves"][u].astype(np.float32)
            op = OnlinePitchFeature(max_frames_latency=latency)
            finals = []
            for s in range(0, len(w), piece):
                op.accept_waveform(fsamp, w[s:s + piece])
                n = op.num_frames_final
                finals.append(op.get_frames(np.arange(n)).copy())
                chunks += 1
            op.input_finished()
            out = op.get_frames(np.arange(op.num_frames_ready()))
            changed += sum(not np.array_equal(out[:len(f)], f)
                           for f in finals)
            t1 = time.perf_counter()
            offline = compute_and_process_kaldi_pitch(w)
            t_offline += time.perf_counter() - t1
            if mode == "whole":
                equal_offline += np.array_equal(out, offline)
                continue
            final = finals[-1]
            revised = int((np.abs(final - offline[:len(final)]).max(
                axis=1, initial=0.0) > FEAT_ONLINE_REVISED).sum())
            gap = float(np.max(np.abs(final.mean(axis=0)
                                      - np.asarray(obar[u]["means"]))))
            if len(final) != obar[u]["final_frames"] or \
                    revised != obar[u]["revised"] or \
                    gap > FEAT_PITCH_MEAN_TOL:
                online_misses[u] = {"final_frames": len(final),
                                    "revised": revised, "mean_gap": gap}
        t_online = time.perf_counter() - t0 - t_offline
        online[mode] = {"chunks": chunks, "changed_final_frames": changed,
                        "host_s": t_online,
                        "host_ms_a_chunk": 1e3 * t_online / chunks}
        if mode == "whole":
            online[mode]["equal_offline"] = equal_offline
        else:
            online[mode].update(
                misses=online_misses,
                revised=sum(obar[u]["revised"]
                            for u in fsys["utts"][:FEAT_ONLINE_UTTS]))
    res = {"utterances": len(fsys["utts"]), "tool_s": seconds,
           "two_step_equal": two_step_equal,
           "elements_past_step": past_step,
           "pitch_frames_off_bar": frames_off,
           "pitch_mean_misses": misses, "online": online,
           "launches": kernel_launch_counts()}
    emit("feats_pitch", **res)
    if not two_step_equal or past_step or frames_off or \
            len(misses) > FEAT_PITCH_MISSES or \
            online["whole"]["equal_offline"] != FEAT_ONLINE_UTTS or \
            len(online_misses) > FEAT_PITCH_MISSES or \
            online["whole"]["changed_final_frames"] or \
            online["default"]["changed_final_frames"]:
        raise SystemExit("feats_pitch: a bar failed")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in feats_pitch: {res['launches']}")
    return res


def run_cudafeat_tools(fsys: dict) -> dict:
    """cudafeat_tools: the eight cudafeatbin tools on the card over the 128
    utterances.  Forwarding checks, which show that the forwards run (the
    feature tools are the plain computers' runner, the CMVN tools
    apply-cmvn-online; feats_offline holds that runner to the CPU):
    compute-{mfcc,fbank}-feats-cuda and compute-{mfcc,fbank}-online-
    batched-cuda torch.equal to the plain tools at the same batch size
    (dither on: one seed a batch from the same stream), and
    apply-cmvn-online-cuda and apply-batched-cmvn-online-cuda byte for
    byte apply-cmvn-online.  The bar: compute-online-feats-cuda and
    -batched-cuda with the committed flagship_ng_ivec.npz (the main
    path's MFCC, 40/40): their i-vectors torch.equal to
    BatchedIvectorExtractor over the tool's own features and batches."""
    reset_kernel_counts()
    d = fsys["dir"]
    fs = f"--sample-frequency={fsys['spec'].fs}"
    seconds: dict = {}
    res = {"utterances": len(fsys["utts"])}
    for cuda, plain in (("compute-mfcc-feats-cuda", "compute-mfcc-feats"),
                        ("compute-fbank-feats-cuda", "compute-fbank-feats"),
                        ("compute-mfcc-online-batched-cuda",
                         "compute-mfcc-feats"),
                        ("compute-fbank-online-batched-cuda",
                         "compute-fbank-feats")):
        out = {}
        for tool in (cuda, plain):
            ark = os.path.join(d, f"{tool}.ark")
            timed_tool(seconds, tool, "--use-gpu=yes", fs, "--batch-size=64",
                       fsys["wav_all"], f"ark:{ark}")
            out[tool] = read_ark(ark)
        res[cuda] = {"forwarding_equal_plain": (
            len(out[cuda]) == len(fsys["utts"])
            and all(torch.equal(torch.from_numpy(out[cuda][u]),
                                torch.from_numpy(out[plain][u]))
                    for u in fsys["utts"]))}
    mfcc = os.path.join(d, "mfcc13.ark")
    timed_tool(seconds, "compute-mfcc-feats", "--use-gpu=yes", fs,
               "--dither=0", fsys["wav_all"], f"ark:{mfcc}")
    stats = sum(ff.acc_cmvn_stats(m) for m in read_ark(mfcc).values())
    gstats = os.path.join(d, "global_cmvn.mat")
    write_kaldi_object(lambda s, b: io_funcs.write_matrix(s, b, stats),
                       gstats)
    outs = {}
    for tool in ("apply-cmvn-online", "apply-cmvn-online-cuda",
                 "apply-batched-cmvn-online-cuda"):
        ark = os.path.join(d, f"{tool}.ark")
        timed_tool(seconds, tool, gstats, f"ark:{mfcc}", f"ark:{ark}")
        with open(ark, "rb") as f:
            outs[tool] = f.read()
    for tool in ("apply-cmvn-online-cuda", "apply-batched-cmvn-online-cuda"):
        res[tool] = {"forwarding_equal_host_bytes": outs[tool] ==
                     outs["apply-cmvn-online"]}
    ivec = os.path.join(ART, "flagship_ng_ivec.npz")
    bex = BatchedIvectorExtractor(load_ivector_extractor(ivec),
                                  device="cuda")
    period, bsz = 10, 64
    for tool in ("compute-online-feats-cuda",
                 "compute-online-feats-batched-cuda"):
        fa, ia = (os.path.join(d, f"{tool}.{k}.ark") for k in "fi")
        timed_tool(seconds, tool, "--use-gpu=yes", fs, "--dither=0",
                   "--num-ceps=40", "--num-mel-bins=40",
                   f"--ivector-period={period}", f"--batch-size={bsz}",
                   ivec, fsys["wav_all"], f"ark:{fa}", f"ark:{ia}")
        feats, ivecs = read_ark(fa), read_ark(ia)
        equal = True
        utts = fsys["utts"]
        for b0 in range(0, len(utts), bsz):
            part = utts[b0:b0 + bsz]
            lens = np.array([feats[u].shape[0] for u in part])
            batch = np.zeros((len(part), lens.max(), 40), np.float32)
            for i, u in enumerate(part):
                batch[i, :lens[i]] = feats[u]
            state = bex.init_state(len(part))
            rows = [[] for _ in part]
            for c0 in range(0, int(lens.max()), period):
                t = np.arange(c0, min(c0 + period, int(lens.max())))
                state = bex.acc_chunk(
                    state, torch.from_numpy(batch[:, c0:c0 + period]).cuda(),
                    torch.from_numpy(t[None] < lens[:, None]).cuda())
                iv = bex.ivector(state).cpu().numpy()
                for i in range(len(part)):
                    if c0 < lens[i]:
                        rows[i].append(iv[i])
            equal &= all(torch.equal(torch.from_numpy(ivecs[u]),
                                     torch.from_numpy(np.stack(rows[i])))
                         for i, u in enumerate(part))
        res[tool] = {"ivectors_equal_extractor": equal,
                     "ivector_rows": sum(len(v) for v in ivecs.values())}
    bad = [tool for tool, checks in res.items() if tool != "utterances"
           and not all(v for v in checks.values() if isinstance(v, bool))]
    res.update(tool_s=seconds, launches=kernel_launch_counts())
    emit("cudafeat_tools", **res)
    if bad:
        raise SystemExit(f"cudafeat_tools: {bad} differ")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in cudafeat_tools: {res['launches']}")
    return res


def features_phases() -> dict:
    """The features group: feats_offline, feats_dither, feats_pitch and
    cudafeat_tools over the legacy corpus's 128 test utterances, each
    phase's wall beside it."""
    walls, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        fsys = features_system(d)
        for name, fn in (("feats_offline", run_feats_offline),
                         ("feats_dither", run_feats_dither),
                         ("feats_pitch", run_feats_pitch),
                         ("cudafeat_tools", run_cudafeat_tools)):
            t0 = time.perf_counter()
            out[name] = fn(fsys)
            walls[name] = time.perf_counter() - t0
    emit("features_walls", **walls)
    out["walls"] = walls
    return out


def run_batched_cuda2(sysd: dict) -> dict:
    """batched_cuda2: batched-wav-nnet3-cuda2 over the tool HCLG, the .mdl
    and the 128 utterances (CUDA2_ARGS: decode.sh's beams, the models'
    MFCC): the lattices' best paths' WER within DEC_WER_BAND points and
    DEC_WORDS_BAND words of tools/features_jax_bar.py's (JAX's pipeline
    with every third frame; JAX's tool as it stands reads the first third
    of the frames, its WER reported beside); RealTimeX and the tool's
    stats line (feature, forward, search seconds); the card's busy ms
    over a second, profiled run.  Two forwarding checks, which show that
    the forwards run and not what they compute (each tool forwards to
    the other): the -cuda alias's lattices byte for byte -cuda2's, and
    batched-wav-nnet3-cuda-online's words online2-wav-nnet3-latgen-
    faster's on the first DEC_ONLINE_UTTS."""
    reset_kernel_counts()
    d = sysd["dir"]
    with open(FEATURES_JAX_BAR) as f:
        bar = json.load(f)["decode"]
    seconds: dict = {}
    lat = os.path.join(d, "cuda2.lat")
    log = timed_tool(seconds, "batched-wav-nnet3-cuda2", "--use-gpu=yes",
                     *CUDA2_ARGS, sysd["mdl"], sysd["hclg"],
                     sysd["wav_all"], f"ark:{lat}")
    realtimex = float(log.rsplit("RealTimeX:", 1)[1].split()[0])
    stats = tool_stats("batched-wav-nnet3-cuda2", log)
    names = sysd["names"]
    lats = dict(SequentialTableReader("lattice", f"ark:{lat}"))
    hyps = {u: [names[w] for w in latf.lattice_best_path(la)[1]]
            for u, la in lats.items()}
    wer = wer_of(hyps, sysd["refs"])
    errors = word_errors(wer, sysd["refs"])
    alias = os.path.join(d, "cuda.lat")
    timed_tool(seconds, "batched-wav-nnet3-cuda", "--use-gpu=yes",
               *CUDA2_ARGS, sysd["mdl"], sysd["hclg"], sysd["wav_all"],
               f"ark:{alias}")
    with open(lat, "rb") as f, open(alias, "rb") as g:
        alias_equal = f.read() == g.read()
    prof = profile_call(lambda: timed_tool(
        seconds, "batched-wav-nnet3-cuda2", "--use-gpu=yes", *CUDA2_ARGS,
        sysd["mdl"], sysd["hclg"], sysd["wav_all"],
        f"ark:{os.path.join(d, 'cuda2_prof.lat')}", key="profiled"), top=8)
    words = {}
    opts = online2_args({"spec": sysd["spec"]})
    for tool in ("batched-wav-nnet3-cuda-online",
                 "online2-wav-nnet3-latgen-faster"):
        out = os.path.join(d, f"{tool}.words")
        timed_tool(seconds, tool, "--use-gpu=yes", *opts, "--beam=15",
                   sysd["mdl"], sysd["hclg"], sysd["wav"], f"ark,t:{out}")
        with open(out, "rb") as f:
            words[tool] = f.read()
    res = {"utterances": len(lats), "wer": wer, "word_errors": errors,
           "bar_wer": bar["wer"], "bar_word_errors": bar["word_errors"],
           "jax_tool_wer": bar["tool_wer"], "realtimex": realtimex,
           "stats": stats, "wall_s": seconds["batched-wav-nnet3-cuda2"],
           "device_busy_ms": prof["device_ms"],
           "busy_share": prof["device_ms"] / 1e3 / prof["wall_s_profiled"],
           "launches_profiled": prof["kernel_launches"],
           "forwarding_checks": {
               "cuda_lattices_equal_cuda2": alias_equal,
               "cuda_online_words_equal_online2": (
                   words["batched-wav-nnet3-cuda-online"]
                   == words["online2-wav-nnet3-latgen-faster"]),
               "cuda_online_utterances": len(
                   words["batched-wav-nnet3-cuda-online"].splitlines())},
           "tool_s": seconds, "launches": kernel_launch_counts()}
    emit("batched_cuda2", **res)
    if abs(wer - bar["wer"]) > DEC_WER_BAND or \
            abs(errors - bar["word_errors"]) > DEC_WORDS_BAND or \
            len(lats) != len(sysd["utts"]):
        raise SystemExit(f"batched_cuda2: WER {wer:.3f}% ({errors}), "
                         f"tools/features_jax_bar.py's {bar['wer']:.3f}% "
                         f"({bar['word_errors']}), {len(lats)} lattices")
    fwd = res["forwarding_checks"]
    if not (fwd["cuda_lattices_equal_cuda2"]
            and fwd["cuda_online_words_equal_online2"]
            and fwd["cuda_online_utterances"] == DEC_ONLINE_UTTS):
        raise SystemExit(f"batched_cuda2: a forwarding check failed: {fwd}")
    if any(res["launches"].values()):
        raise SystemExit(f"a kernel ran in batched_cuda2: {res['launches']}")
    return res


def decoders_phases() -> dict:
    """The decoders group: decoders_graph, dense_hclg, beam_sparse_hclg,
    lazy_lm, incremental, grammar and batched_cuda2, each phase's wall
    beside it."""
    walls = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sysd = decoders_system(d)
        walls["decoders_graph"] = time.perf_counter() - t0
        out = {"decoders_graph": sysd["res"]}
        t0 = time.perf_counter()
        dense = run_dense_hclg(sysd)
        walls["dense_hclg"] = time.perf_counter() - t0
        out["dense_hclg"] = dense["res"]
        for name, fn in (("beam_sparse_hclg", lambda: run_beam_sparse_hclg(
                             sysd, dense)),
                         ("lazy_lm", lambda: run_lazy_lm(sysd, dense)),
                         ("incremental", lambda: run_incremental(sysd,
                                                                 dense)),
                         ("grammar", lambda: run_grammar(sysd)),
                         ("batched_cuda2", lambda: run_batched_cuda2(
                             sysd))):
            t0 = time.perf_counter()
            out[name] = fn()
            walls[name] = time.perf_counter() - t0
    emit("decoders_walls", **walls)
    out["walls"] = walls
    return out


WORKER_GROUPS = ("train", "scale", "online2", "decoders", "features")


def run_worker_group(group: str) -> dict:
    """The phases of one group -> their results by name: "train" is
    train_lex, the chain tools and the chain frame phases over its system,
    then the generic corpus recipe, the synthetic recipe and GMM MMI
    (mmi_phases); "scale" is train_scale, then the i-vector tool chain
    over its features; "online2" is the online2, xconfig and graph tool
    phases over the legacy graph, after slice_lex_int16's decode
    (lex_int16_words: the words online2_wav and mkgraph_legacy compare
    with); "decoders" is decoders_phases (the dense and beam-sparse
    device decoders, lazy LM composition, incremental determinization and
    grammar FSTs over the tool HCLG, then the batched decode of the
    cudadecoder tools); "features" is features_phases (the rest of the
    feature front end and the cudafeat tools)."""
    if group == "online2":
        lex = build_lex_path()
        words16 = lex_int16_words(lex, *legacy_am(lex))
        del lex
        torch.cuda.empty_cache()
        return {"online2": online2_phases(words16)}
    if group == "train":
        train, sysd = train_phases(SMOKE_TRAIN_EPOCHS)
        chain = chain_cli_phases(sysd)
        frame = chain_frame_phases(sysd)
        del sysd
        torch.cuda.empty_cache()
        return {"train": train, "chain": chain, "frame": frame,
                "template": template_phases(), "mmi": mmi_phases()}
    if group == "decoders":
        # this group ends long before the others (PERF.md §5), and its
        # host work (host searches, the CPU twin's bit-equal check,
        # which no thread count changes) slows them: it yields the host
        os.nice(9)
        torch.set_num_threads(2)
        return {"decoders": decoders_phases()}
    if group == "features":
        # host numpy pitch and the CPU twins' features: it yields the host
        # as the decoders group does
        os.nice(9)
        torch.set_num_threads(2)
        return {"features": features_phases()}
    keep: dict = {}
    scale = train_scale_phases(SMOKE_SCALE_EPOCHS, keep=keep)
    return {"scale": scale, "ivector": ivector_phases(**keep)}


class PhaseWorker:
    """`python3 chip_smoke.py --worker GROUP` leading a process group of
    its own (stop() ends it and every tool it started, and prints the
    JSON lines it had written).  Its JSON lines and its stderr go to files in `d`,
    copied to this process's streams by join(), which returns the
    group's results or exits if it failed.  It keeps torch's default
    host threads: the card-CPU checks' float32 bars are twice the CPU's
    own float32 error, which depends on them."""

    def __init__(self, group: str, d: str):
        self.group = group
        self.paths = {k: os.path.join(d, f"{group}.{k}")
                      for k in ("out", "err", "json")}
        self.joined = False
        with open(self.paths["out"], "w") as out, \
                open(self.paths["err"], "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 group, self.paths["json"], repr(_T0)],
                stdout=out, stderr=err, cwd=REPO, start_new_session=True)

    def poll(self) -> None:
        """Exits now if the worker has already failed."""
        if self.proc.poll() not in (None, 0):
            self.join()

    def join(self) -> dict:
        rc = self.proc.wait()
        self.joined = True
        with open(self.paths["out"]) as f:
            sys.stdout.write(f.read())
        with open(self.paths["err"]) as f:
            sys.stderr.write(f.read())
        sys.stdout.flush()
        sys.stderr.flush()
        if rc != 0:
            raise SystemExit(f"the {self.group} phases failed (exit {rc})")
        with open(self.paths["json"]) as f:
            return json.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        if not self.joined:
            self.joined = True
            with open(self.paths["out"]) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()


def start_workers() -> dict:
    """One PhaseWorker a group, stopped when this process exits (also on
    SIGTERM)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_")
    workers = {g: PhaseWorker(g, d) for g in WORKER_GROUPS}

    def stop_all():
        for w in workers.values():
            w.stop()
        shutil.rmtree(d, ignore_errors=True)

    atexit.register(stop_all)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return workers


def worker_main(group: str, result: str, t0: str) -> int:
    """A worker's process: the group's phases on the card, timed on the
    main process's clock (time.perf_counter is the system's monotonic
    clock), at a lower host priority than the main process's (nice 10),
    whose walls are measured beside it; dies with its parent."""
    global _T0
    _T0 = float(t0)
    os.nice(10)
    with contextlib.suppress(OSError, AttributeError):   # PR_SET_PDEATHSIG
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device for the worker", file=sys.stderr)
        return 2
    emit("worker", group=group, pid=os.getpid(),
         host_threads=torch.get_num_threads())
    res = run_worker_group(group)
    with open(result, "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    rate = hbm_rate(kind)
    emit("card", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         hbm_bytes_per_s=rate, host_threads=torch.get_num_threads())

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    for name, info in built.items():
        print(f"# nvcc {name}:\n{info['log']}", file=sys.stderr)
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: round(i["seconds"], 3) for n, i in built.items()})

    # 3. kernel a against its plain version ---------------------------------
    spec = DirectGraphSpec(vocab=700, num_pdfs=2000)
    t0 = time.perf_counter()
    graph = BlockChainGraph.build(synth_lexicon(spec), synth_bigram(spec),
                                  num_pdfs=spec.num_pdfs)
    decoder = BlockChainDecoder(graph, device="cuda")
    emit("graph", V=graph.V, N=graph.N, Up=decoder.Up, Vp=decoder.Vp,
         states=graph.num_states, seconds=time.perf_counter() - t0)
    small_spec = DirectGraphSpec(vocab=37, num_phones=6, min_pron=1,
                                 max_pron=5, num_pdfs=64, seed=3)
    small = BlockChainDecoder(BlockChainGraph.build(
        synth_lexicon(small_spec), synth_bigram(small_spec), num_pdfs=64),
        device="cuda")
    if not (small.g.end_row < 0).any():
        raise SystemExit("the small graph needs one-phone words")
    a_names = ("new", "bits", "rootexp", "rootarg")
    rows = [check_kernel("block_chain_step", bcs.block_chain_step,
                         bcs.block_chain_step_reference, a_names,
                         step_inputs(dec, B, seed, off), label, B)
            for dec, B, seed, off, label in (
                (decoder, LANES, SEED + 1, 0, "full"),
                (small, 19, SEED + 2, 5, "small_ragged"))]
    emit("kernel_check", ok=True, kernel="block_chain_step", checks=rows)
    args = step_inputs(decoder, LANES, SEED + 3, 0)
    out_new = torch.empty_like(args[0])
    out_bits = torch.empty((decoder.Up, graph.N // 8, LANES),
                           dtype=torch.uint8, device="cuda")
    time_a = time_kernel(
        "block_chain_step",
        lambda: bcs.block_chain_step(*args, new=out_new, bits=out_bits),
        lambda: bcs.block_chain_step_reference(*args), 5,
        *step_cost(decoder, LANES), rate, (decoder.Up, graph.N, LANES))
    del args, out_new, out_bits
    torch.cuda.empty_cache()

    # kernel b (the lattice step) against its plain version
    b_names = ("new", "ent_new", "rc", "ru", "re")
    rows_b = [check_kernel("block_chain_lattice_step",
                           bcl.block_chain_lattice_step,
                           bcl.block_chain_lattice_step_reference, b_names,
                           lattice_step_inputs(dec, B, seed, off, t, ties),
                           label, B, J=LAT_J)
              for dec, B, seed, off, t, ties, label in (
                  (decoder, LANES, SEED + 4, 0, 57, False, "full"),
                  (small, 19, SEED + 5, 5, 9, False, "small_ragged"),
                  (small, 19, SEED + 6, 5, 9, True, "forced_ties"))]
    tie_args = lattice_step_inputs(small, 19, SEED + 6, 5, 9, True)
    rc, ru = bcl.block_chain_lattice_step(*tie_args, J=LAT_J)[2:4]
    passed = bool(((rc[2] == rc[3]) & (ru[2] > ru[3])
                   & (rc[3] < bcs.INF)).any())
    emit("kernel_check", ok=passed, kernel="block_chain_lattice_step",
         checks=rows_b, ties_displaced_entry_passed_its_equals=passed)
    if not passed:
        raise SystemExit("the forced-ties case holds no list in which a "
                         "displaced entry passed its equals")
    del tie_args, rc, ru
    args = lattice_step_inputs(decoder, LANES, SEED + 7, 0, 57)
    out_new, out_ent = torch.empty_like(args[1]), torch.empty_like(args[1])
    time_b = time_kernel(
        "block_chain_lattice_step",
        lambda: bcl.block_chain_lattice_step(*args, J=LAT_J, new=out_new,
                                             ent_new=out_ent),
        lambda: bcl.block_chain_lattice_step_reference(*args, J=LAT_J), 2,
        *lattice_step_cost(decoder, LANES, LAT_J), rate,
        (decoder.Up, graph.N, LANES))
    del args, out_new, out_ent
    torch.cuda.empty_cache()

    # kernel c (the in-arc relaxation) against its plain version: the flat
    # form of the V=64 block-chain graph, shared by all lanes
    t0 = time.perf_counter()
    spec64 = DirectGraphSpec(vocab=64, num_pdfs=2000)
    graph64 = BlockChainGraph.build(synth_lexicon(spec64),
                                    synth_bigram(spec64),
                                    num_pdfs=spec64.num_pdfs)
    flat64 = graph64.to_flat_graph()
    dense = BatchedViterbi(flat64.to_vector_fst(), flat64.tid2pdf,
                           device="cuda")
    _, arrays64, S64, eps64 = dense._prepare(LANES)
    K64 = arrays64["e_in_src"].shape[1]
    full_e, full_c, full_deg, full_ne_deg = relax_inputs(
        arrays64, LANES, spec64.num_pdfs, SEED + 8)
    live = int(full_deg.sum())
    identity64 = tables_identity(arrays64)
    emit("flat_graph", V=graph64.V, states=flat64.num_states,
         arcs=flat64.num_arcs, S_with_dead=S64, K=K64,
         K_eps=arrays64["ne_in_src"].shape[1], eps_iters=eps64,
         live_slots=live, slots=S64 * K64, live_share=live / (S64 * K64),
         walk_slots=live + int((full_deg < K64).sum()),
         long_states=int((full_deg + (full_deg < K64).int()
                          > vr.LONG_WALK).sum()),
         max_in_degree=int(full_deg.max()),
         closure_is_identity=identity64,
         seconds=time.perf_counter() - t0)
    if not identity64:
        raise SystemExit("the V=64 graph has no epsilon arc, yet its "
                         "closure step is not proven the identity")
    ragged = BatchedViterbi((flat_fsts([5, 9, 7, 4]) * 5)[:19],
                            np.concatenate([[0], np.arange(64),
                                            np.arange(64)]),
                            device="cuda")._prepare(19)
    if ragged[2] % 2 == 0 or ragged[1]["e_in_src"].ndim != 3:
        raise SystemExit("the ragged case needs an odd S and per-lane tables")
    ragged_e, _, ragged_deg, _ = relax_inputs(ragged[1], 19, 64, SEED + 9)
    eps_prep = BatchedViterbi(eps_fst(SEED + 10), np.arange(30),
                              device="cuda")._prepare(19)
    _, eps_c, _, eps_deg = relax_inputs(eps_prep[1], 19, 30, SEED + 11)
    live_eps = int(eps_deg.sum())
    if live_eps == 0 or eps_prep[3] < 2:
        raise SystemExit("the epsilon case holds no live epsilon arc")
    # a state whose K slots are all live, a long walk with a dead slot, a
    # state without in-arc, and loglikes whose column 0 is 1e25, so that a
    # dead slot's candidate is not 2e30.  In the decoder's layout 128 and
    # 20 lanes over shared tables take 4 lanes a thread, 19 lanes and one
    # table a lane take one
    deg_e, deg_c, deg_deg, deg_ne_deg = relax_inputs(
        degree_tables(3001, 64, 50, SEED + 12), 20, 50, SEED + 13,
        big_ll0=True)
    if not (bool((deg_deg == 64).any()) and bool((deg_deg == 0).any())
            and bool((deg_ne_deg == 32).any())):
        raise SystemExit("the degree case lacks a state with deg 0 or K")
    deg19_e, deg19_c, _, _ = relax_inputs(
        degree_tables(3001, 64, 50, SEED + 12), 19, 50, SEED + 14,
        big_ll0=True)
    rows_c = []
    for args, deg, label, lanes, kw in (
            (full_e, full_deg, "full_shared_emitting", 4, {}),
            (ragged_e, ragged_deg, "small_ragged_per_lane_emitting", 1, {}),
            (full_c, full_ne_deg, "full_closure_K1", 4, {}),
            (eps_c, eps_deg, "closure_live_epsilon_arcs", 1, {}),
            (full_e, full_deg, "full_scale_0.3", 4, {"acoustic_scale": 0.3}),
            (deg_e, deg_deg, "deg_0_and_K_ll0_1e25_emitting", 4, {}),
            (deg_c, deg_ne_deg, "deg_0_and_K_closure", 4, {}),
            (deg19_e, deg_deg, "deg_0_and_K_ll0_1e25_19_lanes", 1,
             {"acoustic_scale": 0.3}),
            (deg19_c, deg_ne_deg, "deg_0_and_K_closure_19_lanes", 1, {})):
        rows_c += check_relax(args, deg, label, lanes, **kw)
    emit("kernel_check", ok=True, kernel="viterbi_relax", checks=rows_c,
         ragged_S=ragged[2], ragged_K=ragged[1]["e_in_src"].shape[2],
         eps_live_arcs=live_eps)
    # times: first version and live walk in turns, emitting and closure, at
    # the slice's shape; the closure also over an epsilon DAG of 20,001
    # states (the decoder launches no closure over the K=1 all-dead table)
    big_eps = BatchedViterbi(eps_fst(SEED + 15, n=20001), np.arange(30),
                             device="cuda")._prepare(LANES)
    _, big_c, _, big_ne_deg = relax_inputs(big_eps[1], LANES, 30, SEED + 16)
    time_c = time_relax("viterbi_relax", full_e, full_deg, rate,
                        (LANES, S64, K64))
    time_c_closure = time_relax("viterbi_relax_closure", full_c, full_ne_deg,
                                rate,
                                (LANES, S64, arrays64["ne_in_src"].shape[1]))
    time_c_eps = time_relax(
        "viterbi_relax_closure_epsilon_dag", big_c, big_ne_deg, rate,
        (LANES, big_eps[2], big_eps[1]["ne_in_src"].shape[1]),
        live_arcs=int(big_ne_deg.sum()))
    del full_e, full_c, ragged_e, eps_c, deg_e, deg_c, deg19_e, deg19_c
    del big_c, big_eps
    torch.cuda.empty_cache()

    # 4. the slice at full width --------------------------------------------
    cfg, variables, model, ivec, fe = flagship_am()
    pipe = BatchedOfflinePipeline2(model, decoder, fe,
                                   ivector_extractor=ivec, device="cuda")
    rng = np.random.default_rng(SEED)
    waves = [synth_wave(rng) for _ in range(LANES)]

    t0 = time.perf_counter()
    pipe.decode_batch(waves)                                 # warm-up
    emit("warmup", seconds=time.perf_counter() - t0)
    bucket = fe.stage_batch(waves)[3]
    T_out = -(-bucket // cfg.frame_subsampling_factor)
    runs, outs = [], None
    for it in range(3):
        stats = PipelineStats()
        bcs.launches = 0
        outs = pipe.decode_batch(waves, stats=stats)
        launches = bcs.launches
        n_ok = sum(o is not None for o in outs)
        run = {"iter": it, "lanes_decoded": n_ok, "lanes": LANES,
               "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
               "feat_s": stats.feat_s, "am_s": stats.am_s,
               "search_s": stats.search_s, "xrt": stats.xrt,
               "launches": {"block_chain_step": launches}}
        emit("slice", **run)
        runs.append(run)
        if launches != T_out:
            raise SystemExit(f"block_chain_step launched {launches} times "
                             f"in one decode_batch, expected {T_out}")
        if n_ok != LANES:
            raise SystemExit(f"only {n_ok}/{LANES} lanes decoded")
        if not all(np.isfinite(o[1]) and len(o[0]) > 0 for o in outs):
            raise SystemExit("a lane has a non-finite cost or no words")

    # the same 8 lanes, kernel step vs plain step, on the same loglikes
    feats, nframes = fe.compute_batch_device(waves)
    loglikes, out_lens = pipe.loglikes(feats, nframes)
    if tuple(loglikes.shape) != (LANES, T_out, cfg.num_pdfs) or \
            not bool(torch.isfinite(loglikes).all()):
        raise SystemExit(f"bad loglikes {tuple(loglikes.shape)}")
    # the bf16 AM against the same model in float32 on 4 lanes: bf16 keeps
    # ~3 digits, and 17 layers measured 0.5% of max|f32| on the CPU
    pipe32 = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(cfg, variables, device="cuda"), decoder, fe,
        ivector_extractor=ivec, device="cuda")
    ll32, _ = pipe32.loglikes(feats[:4], nframes[:4])
    am_err = float((loglikes[:4] - ll32).abs().max() / ll32.abs().max())
    emit("am_check", lanes=4, max_abs_err_of_max=am_err, limit=3e-2)
    if not am_err < 3e-2:
        raise SystemExit(f"bf16 AM is {am_err} of max|f32| from float32")
    plain_dec = BlockChainDecoder(graph, device="cuda",
                                  step=bcs.block_chain_step_reference)
    k_hyps = decoder.decode_batch(loglikes[:8], lengths=out_lens[:8])
    p_hyps = plain_dec.decode_batch(loglikes[:8], lengths=out_lens[:8])
    same = [k == p for k, p in zip(k_hyps, p_hyps)]
    emit("plain_step_check", lanes=8, equal=same,
         words_lane0=k_hyps[0][0][:12], cost_lane0=k_hyps[0][2],
         matches_main_run=[k[0] == o[0] for k, o in zip(k_hyps, outs)])
    if not all(same):
        raise SystemExit("kernel and plain step decode differently")

    walls = sorted(r["wall_s"] for r in runs)
    prof = profile_call(lambda: pipe.decode_batch(waves))
    emit("profile", busy_share_of_median_wall=prof["device_ms"] / 1e3
         / walls[1], **prof)
    online = run_slice_online(decoder, loglikes, out_lens)

    # 5. the main path: the n-gram search over the V=20,000 graph ----------
    ng = build_ng_path()
    ng_res = run_ng_slice(ng, model, ivec, fe)
    # the online2, xconfig and training phases (5b'-5f below) start now,
    # beside the rest, once the kernels' and the main path's times are
    # taken
    workers = start_workers()
    ng_cpu_check(ng, ng_res["loglikes"], ng_res["out_lens"])
    cross_check_ng(ng)
    ng_lat = run_ng_lattice(ng, model, ivec, fe, ng_res["loglikes"],
                            ng_res["out_lens"])
    ng_lattice_cpu_check(ng, ng_res["loglikes"], ng_res["out_lens"])
    # the main path online: streaming, the recorded result, the batcher
    ng_online = run_online_ng(ng, model, ivec, fe)
    run_online_stream_offline(ng, ng_res["loglikes"], ng_res["out_lens"],
                              ng_res["outs"],
                              ng_res["runs"][-1]["word_errors"])
    ng_batcher = run_online_batcher(ng, ng_res["loglikes"],
                                    ng_res["out_lens"])
    ng_walls = sorted(r["wall_s"] for r in ng_res["runs"])
    ng_runs = ng_res["runs"]
    del ng_res
    torch.cuda.empty_cache()

    # 5a. Kaldi nnet3 models: the reference golden, the flagship from a
    # .mdl through the main path's search, the CLI, a TDNN-LSTM ----------
    nnet3 = nnet3_phases(ng, cfg, variables, ivec, fe)
    del ng
    torch.cuda.empty_cache()

    # 5b. the legacy path: LexChainDecoder over the V=200 bigram graph -----
    legacy = legacy_phases(ng_lat.pop("lattices"))

    # (5b'. online2 serving and the xconfig phases: the "online2" worker)
    del legacy["words_int16"]

    for w in workers.values():
        w.poll()

    # 6. block-chain lattice mode, BC_LAT_LANES of the lanes ---------------
    del k_hyps, p_hyps, plain_dec, pipe32, ll32
    # one call, under the profiler, is the timed call (the host assembly
    # makes a lattice call long; the best-path calls above warmed the
    # frontend, the model and the card).  Kernel b's checks and times above
    # ran at full width
    lat_runs, lat_outs = [], None
    n_lat = BC_LAT_LANES
    for it in range(1):
        stats, lat_stats = PipelineStats(), {}
        bcl.launches = 0
        holder = []
        prof = profile_call(lambda: holder.append(pipe.decode_batch(
            waves[:n_lat], stats=stats, generate_lattices=True,
            lattice_beam=LAT_BEAM, lat_stats=lat_stats)))
        lat_outs = holder[0]
        launches = bcl.launches
        n_ok = sum(o is not None for o in lat_outs)
        run = {"iter": it, "lattices": n_ok, "lanes": n_lat,
               "audio_s": stats.total_audio_s, "wall_s": stats.wall_s,
               "feat_s": stats.feat_s, "am_s": stats.am_s,
               "search_s": stats.search_s, "xrt": stats.xrt,
               "lat_stats": lat_stats,
               "launches": {"block_chain_lattice_step": launches}}
        emit("slice_lattice", **run)
        lat_runs.append(run)
        if launches != T_out:
            raise SystemExit(f"block_chain_lattice_step launched {launches} "
                             f"times in one decode_batch, expected {T_out}")
        # as in the reference, a narrow beam can leave a lane without a
        # lattice (no final word end that the per-frame beam keeps
        # connected to the start); a few lanes in a hundred do so here
        if n_ok < 0.95 * n_lat:
            raise SystemExit(f"only {n_ok}/{n_lat} lattices")
    lat_wall = min(r["wall_s"] for r in lat_runs)
    emit("profile_lattice", busy_share_of_best_wall=prof["device_ms"] / 1e3
         / lat_wall, **prof)
    # Each lane's lattice best path against the best-path decode of the
    # same waves (a batch of another size can take other bf16 GEMMs in the
    # model: about 0.1 of a lane's cost).  A lattice holds real paths no
    # dearer than the best path plus the beam, so its best path costs at
    # least the Viterbi cost and at most that plus the beam (relative
    # tolerance 1e-3).  As in the reference, the lattice's final states
    # are word ends reached in the last frame that survive the per-frame
    # beam, so the Viterbi path itself can be missing; most lanes must hold
    # it (equal cost).
    n_same_cost = n_same_words = 0
    have = [lo for lo in lat_outs if lo is not None]
    lat_best = pipe.decode_batch(waves[:n_lat])
    for lane, (lo, o) in enumerate(zip(lat_outs, lat_best)):
        if lo is None:
            continue
        tol = 1e-3 * max(1.0, abs(o[1]))
        if not o[1] - tol <= lo[1] <= o[1] + LAT_BEAM + tol:
            raise SystemExit(f"lane {lane}: lattice best path costs {lo[1]}, "
                             f"the best-path decode {o[1]}")
        n_same_cost += abs(lo[1] - o[1]) <= tol
        n_same_words += lo[0] == o[0]
    arcs = sorted(lo[2].num_arcs() for lo in have)
    # a path takes one arc a frame, so a lattice with more arcs than the
    # utterance has frames holds alternatives
    emit("lattice_check", lanes=n_lat, lattices=len(have),
         lanes_cost_equal=n_same_cost, lanes_words_equal=n_same_words,
         rel_tolerance=1e-3, arcs_median=arcs[len(arcs) // 2],
         states_median=sorted(lo[2].num_states
                              for lo in have)[len(have) // 2],
         frames_max=int(out_lens.max()))
    if 2 * n_same_cost <= n_lat:
        raise SystemExit(f"only {n_same_cost}/{n_lat} lattices hold the "
                         "best-path decode")
    if not arcs[len(arcs) // 2] > int(out_lens.max()):
        raise SystemExit("the median lattice holds no alternative")
    del lat_outs, have

    # one lane, kernel step vs plain step, on the same loglikes; the two
    # steps agree bit for bit, so the lattices should too: the stated
    # tolerance on weights is 1e-6
    plain_dec = BlockChainDecoder(
        graph, device="cuda",
        lattice_step=bcl.block_chain_lattice_step_reference)
    lat_kw = dict(lengths=out_lens[:1], lattice_beam=LAT_BEAM, J=LAT_J)
    k_lats = decoder.decode_batch_lattice(loglikes[:1], **lat_kw)
    t0 = time.perf_counter()
    p_lats = plain_dec.decode_batch_lattice(loglikes[:1], **lat_kw)
    plain_s = time.perf_counter() - t0
    if any(k is None for k in k_lats):
        raise SystemExit("a lane of the plain-step comparison has no "
                         "lattice")
    diff = max(lattice_diff(k, p) for k, p in zip(k_lats, p_lats))
    emit("plain_lattice_check", lanes=1, max_weight_diff=diff, limit=1e-6,
         states=[k.num_states for k in k_lats], plain_seconds=plain_s)
    if not diff <= 1e-6:
        raise SystemExit("kernel and plain lattice step give different "
                         "lattices")
    del k_lats, p_lats, plain_dec

    # 7. the flat-graph slice: BatchedViterbi over the V=64 graph -----------
    # the V=64 graph's closure step is proven the identity (flat_graph
    # above), so a run is one emitting launch a frame
    n_relax = T_out
    stage_names = ("_prepare", "_forward", "_to_host", "_traceback")
    stage_s: dict = {}
    timed_methods(dense, stage_names, stage_s)
    timed_methods(tbv, ("_viterbi_device",), stage_s)
    dense.run(loglikes, out_lens)                            # warm-up
    dense_runs, dense_hyps = [], None
    for it in range(3):
        stage_s.clear()
        vr.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_hyps = dense.run(loglikes, out_lens)
        wall = time.perf_counter() - t0
        launches = vr.launches
        n_ok = sum(h is not None for h in dense_hyps)
        run = {"iter": it, "lanes_decoded": n_ok, "lanes": LANES,
               "frames": T_out, "audio_s": runs[0]["audio_s"],
               "wall_s": wall, "xrt_search_only": runs[0]["audio_s"] / wall,
               "prepare_s": stage_s["_prepare"],
               "frame_loop_s": stage_s["_forward"],
               "device_loop_s": stage_s["_viterbi_device"],
               "loop_ms_a_launch": stage_s["_viterbi_device"] * 1e3
               / max(launches, 1),
               "to_host_s": stage_s["_to_host"],
               "traceback_s": stage_s["_traceback"],
               "launches": {"viterbi_relax": launches}}
        emit("slice_viterbi", **run)
        dense_runs.append(run)
        if launches != n_relax:
            raise SystemExit(f"viterbi_relax launched {launches} times in "
                             f"one run, expected {n_relax}")
        if n_ok != LANES:
            raise SystemExit(f"only {n_ok}/{LANES} lanes decoded")
        if not all(np.isfinite(h[2]) and len(h[1]) > 0
                   and len(h[0]) == n for h, n in zip(dense_hyps, out_lens)):
            raise SystemExit("a lane has a non-finite cost, no words or an "
                             "alignment of the wrong length")
    dense_walls = sorted(r["wall_s"] for r in dense_runs)
    # the profiler gives the kernel's own time in the run, where each
    # launch reads a new frame of loglikes and writes a new table row
    prof = profile_call(lambda: dense.run(loglikes, out_lens),
                        per_launch_of="relax_live<false, 4>")
    run_device_ms = prof["ms_per_launch"]["relax_live<false, 4>"]
    emit("profile_viterbi", busy_share_of_median_wall=prof["device_ms"] / 1e3
         / dense_walls[1], kernel_share_of_median_wall=(
             prof["device_ms"] - prof["copy_ms"]) / 1e3 / dense_walls[1],
         **prof)

    # the frame loop as the first version made it, for the same result:
    # every launch fully checked, all K slots walked, the closure launched
    first = BatchedViterbi(flat64.to_vector_fst(), flat64.tid2pdf,
                           device="cuda",
                           relax=vr.each_call(relax_all_slots))
    first_s: dict = {}
    timed_methods(first, stage_names, first_s)
    proven = tbv.closure_is_identity
    tbv.closure_is_identity = lambda *a: False
    try:
        first.run(loglikes, out_lens)                        # warm-up
        first_runs = []
        for it in range(2):
            first_s.clear()
            stage_s.clear()
            vr.launches = 0
            first_hyps = first.run(loglikes, out_lens)
            # the module's `_viterbi_device` reports into stage_s
            first_runs.append({
                "frame_loop_s": first_s["_forward"],
                "device_loop_s": stage_s["_viterbi_device"],
                "launches": vr.launches})
    finally:
        tbv.closure_is_identity = proven
    emit("slice_viterbi_first_version", runs=first_runs,
         equal_to_the_live_walk=first_hyps == dense_hyps,
         frame_loop_s_live_walk=[r["frame_loop_s"] for r in dense_runs],
         device_loop_s_live_walk=[r["device_loop_s"] for r in dense_runs])
    if first_hyps != dense_hyps:
        raise SystemExit("the first version and the live walk decode "
                         "differently")
    if first_runs[-1]["launches"] != T_out + (T_out + 1) * eps64:
        raise SystemExit(f"the first version launched "
                         f"{first_runs[-1]['launches']} times")
    del first, first_hyps

    # the block-chain decoder (kernel a) and the host token-passing decoder
    # on the same graph and loglikes.  Equal words and tids are expected;
    # where they differ, the two paths must be a tie (see TIE_REL)
    dec64 = BlockChainDecoder(graph64, device="cuda")
    bcs.launches = 0
    t0 = time.perf_counter()
    chain_hyps = dec64.decode_batch(loglikes, lengths=out_lens)
    chain_s = time.perf_counter() - t0
    chain_launches = bcs.launches
    ll_host = loglikes.cpu().numpy()

    def agree(lane, ali, words, cost, other):
        """'equal', 'tied' or exits: `other` is (ali, words, cost)."""
        tol = 1e-3 * max(1.0, abs(other[2]))
        if abs(cost - other[2]) >= tol:
            raise SystemExit(f"lane {lane}: costs {cost} and {other[2]}")
        if words == other[1] and ali == other[0]:
            return "equal"
        ll_b = ll_host[lane]
        gap = abs(path_cost(graph64, words, ali, ll_b)
                  - path_cost(graph64, other[1], other[0], ll_b))
        if gap > TIE_REL * max(1.0, abs(cost)):
            raise SystemExit(f"lane {lane}: two decoders give different "
                             f"paths {gap} apart in float64")
        return "tied"

    verdicts = []
    for lane, (c, d) in enumerate(zip(chain_hyps, dense_hyps)):
        if c is None:
            raise SystemExit(f"lane {lane}: the block-chain decoder failed")
        verdicts.append(agree(lane, c[1], c[0], c[2], d))
    host = FasterDecoder(flat64.to_vector_fst(),
                         FasterDecoderOptions(beam=1e9, max_active=10 ** 9))
    t0 = time.perf_counter()
    host_verdicts = []
    for lane in range(2):
        h = host.decode(ll_host[lane, :out_lens[lane]], flat64.tid2pdf)
        if h is None:
            raise SystemExit(f"lane {lane}: the host decoder failed")
        host_verdicts.append(agree(lane, h[0], h[1], h[2], dense_hyps[lane]))
    emit("cross_check", lanes=LANES, lanes_equal=verdicts.count("equal"),
         lanes_tied=verdicts.count("tied"), tie_rel=TIE_REL,
         cost_rel_tolerance=1e-3, block_chain_seconds=chain_s,
         launches={"block_chain_step": chain_launches},
         host_lanes=host_verdicts, host_seconds=time.perf_counter() - t0,
         words_lane0=dense_hyps[0][1][:12], cost_lane0=dense_hyps[0][2])
    if chain_launches != T_out:
        raise SystemExit(f"block_chain_step launched {chain_launches} times")
    if 2 * verdicts.count("equal") <= LANES:
        raise SystemExit("most lanes differ between the two decoders")
    dense_flat = run_dense_flat(flat64, graph64, loglikes, out_lens,
                                dense_hyps)

    # forced alignment: one graph a lane, cut from the flat graph along the
    # lane's decoded words.  It holds the lane's best path, so the
    # per-lane-table form of the kernel must give tids and cost back
    t0 = time.perf_counter()
    subs = [lane_subgraph(graph64, flat64, h[1]) for h in dense_hyps]
    aligner = BatchedViterbi(subs, flat64.tid2pdf, device="cuda")
    build_s = time.perf_counter() - t0
    ali_prep = aligner._prepare(LANES)
    ali_identity = tables_identity(ali_prep[1])
    n_relax_ali = T_out if ali_identity else T_out + (T_out + 1) * ali_prep[3]
    # the kernel alone at the alignment shape (one table a lane), first
    # version and live walk in turns
    ali_e, _, ali_deg, _ = relax_inputs(ali_prep[1], LANES, spec64.num_pdfs,
                                        SEED + 17)
    time_ali = time_relax("viterbi_relax_per_lane_tables", ali_e, ali_deg,
                          rate, tuple(ali_prep[1]["e_in_src"].shape))
    del ali_e, ali_deg
    vr.launches = 0
    t0 = time.perf_counter()
    ali_hyps = aligner.run(loglikes, out_lens)
    ali_s = time.perf_counter() - t0
    ali_launches = vr.launches
    n_same = 0
    for lane, (a, d) in enumerate(zip(ali_hyps, dense_hyps)):
        if a is None or a[0] != d[0] or a[1] != d[1] or \
                abs(a[2] - d[2]) > 1e-3 * max(1.0, abs(d[2])):
            raise SystemExit(f"lane {lane}: alignment over its sub-graph "
                             "differs from the decode")
        n_same += a[2] == d[2]
    sizes = sorted(g.num_states for g in subs)
    emit("alignment", lanes=LANES, lanes_tids_equal=LANES,
         lanes_cost_bit_equal=int(n_same), cost_rel_tolerance=1e-3,
         states_min=sizes[0], states_median=sizes[LANES // 2],
         states_max=sizes[-1], graphs_seconds=build_s, run_seconds=ali_s,
         closure_is_identity=ali_identity,
         kernel_ms_a_launch=time_ali["ms"],
         kernel_first_version_ms_a_launch=time_ali["first_version_ms"],
         launches={"viterbi_relax": ali_launches})
    if ali_launches != n_relax_ali:
        raise SystemExit(f"viterbi_relax launched {ali_launches} times in "
                         f"the alignment run, expected {n_relax_ali}")

    # the same 8 lanes with the plain relaxation
    plain_dense = BatchedViterbi(flat64.to_vector_fst(), flat64.tid2pdf,
                                 device="cuda",
                                 relax=vr.each_call(vr.relax_padded))
    vr.launches = 0
    t0 = time.perf_counter()
    p_hyps = plain_dense.run(loglikes[:8], out_lens[:8])
    same = [p == d for p, d in zip(p_hyps, dense_hyps)]
    emit("plain_relax_check", lanes=8, equal=same,
         kernel_launches=vr.launches, plain_seconds=time.perf_counter() - t0)
    if not all(same) or vr.launches:
        raise SystemExit("kernel and plain relaxation decode differently")

    # 5b'-5f, from the workers (run_worker_group): "online2" is online2
    # serving over the legacy graph's HCLG.fst through the tools, then the
    # xconfig phases (nnet3-latgen-faster, the lattice tools, disc_smbr);
    # "train" is the legacy training recipe end to end and its card-CPU
    # check, chain training through the tools over its system, then the
    # generic corpus recipe (stages 0-7 at its defaults, then stage 8, over
    # one directory) and the synthetic recipe; "scale" is the --scale
    # training recipe decoded
    # through the main path, then the i-vector tool chain over its corpus
    # (the UBMs and the extractor, the sid back end, the flagship extractor
    # through the tools); the train worker ends with GMM MMI.  Meanwhile
    # this process runs the speaker and language back ends and VTLN over
    # the flagship extractor's data (backend_phases)
    for w in workers.values():
        w.poll()
    backend = backend_phases()
    res = {}
    for w in workers.values():
        res.update(w.join())
    online2, train, chain, frame, template, scale, ivector, decoders, \
        features = (res[k] for k in (
            "online2", "train", "chain", "frame", "template", "scale",
            "ivector", "decoders", "features"))
    backend = {**backend, **res["mmi"]}

    # 8. tables -------------------------------------------------------------
    emit("summary", wall_s_median=walls[1], xrt_median=runs[0]["audio_s"]
         / walls[1], lattice_wall_s=[r["wall_s"] for r in lat_runs],
         lattice_xrt=[r["xrt"] for r in lat_runs],
         viterbi_wall_s_median=dense_walls[1],
         ng_wall_s_median=ng_walls[1],
         ng_xrt_median=ng_runs[0]["audio_s"] / ng_walls[1],
         ng_wer=ng_runs[-1]["wer"], ng_lattice_wall_s=ng_lat["wall_s"],
         ng_lattice_xrt=ng_lat["xrt"],
         ng_lattice_wer=ng_lat["wer_lattice_best_path"],
         online_wall_s=online["wall_s"],
         online_ng_xrt=ng_online["value"],
         online_ng_chunk_ms_p50=ng_online["chunk_ms_p50"],
         online_ng_finalize_ms_max=ng_online["finalize_ms_max"],
         online_ng_wer=ng_online["wer"],
         online_batcher_wer=ng_batcher["wer"],
         online_batcher_endpointed=ng_batcher["endpointed"],
         **{k: v for k, v in legacy.items() if k != "launches"},
         train={k: v for k, v in train.items() if k != "launches"},
         chain_cli={k: v for k, v in chain.items() if k != "launches"},
         chain_frame={k: v for k, v in frame.items() if k != "launches"},
         train_scale={k: v for k, v in scale.items() if k != "launches"},
         **{name: {k: v for k, v in phase.items() if k != "launches"}
            for name, phase in template.items()},
         **{name: {k: v for k, v in phase.items() if k != "launches"}
            for name, phase in ivector.items()},
         **{name: {k: v for k, v in phase.items() if k != "launches"}
            for name, phase in backend.items()},
         **{k: v for k, v in nnet3.items() if k != "launches"},
         **{k: v for k, v in online2.items()
            if k not in ("launches", "xconfig", "mkgraph")},
         **{k: v for k, v in online2["xconfig"].items() if k != "launches"},
         **{k: v for k, v in online2["mkgraph"].items() if k != "launches"},
         dense_flat={k: v for k, v in dense_flat.items() if k != "launches"},
         **{name: {k: v for k, v in phase.items() if k != "launches"}
            for name, phase in decoders.items() if name != "walls"},
         decoders_walls=decoders["walls"],
         **{name: {k: v for k, v in phase.items() if k != "launches"}
            for name, phase in features.items() if name != "walls"},
         features_walls=features["walls"],
         seconds_total=time.perf_counter() - t_start)
    kernels = []
    for name, replaces, timed, checks, launches in (
            ("block_chain_step", "kaldi_tpu/decoder/block_chain.py:345",
             time_a, rows, runs[-1]["launches"]["block_chain_step"]),
            ("block_chain_lattice_step",
             "kaldi_tpu/decoder/block_chain.py:547", time_b, rows_b,
             lat_runs[-1]["launches"]["block_chain_lattice_step"]),
            ("viterbi_relax", "kaldi_tpu/ops/pallas_viterbi.py:93", time_c,
             rows_c, dense_runs[-1]["launches"]["viterbi_relax"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kaldi_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in checks),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None})
    kernels[0]["launches_online"] = \
        online["launches"]["block_chain_step"]
    for k in kernels:
        k["launches_legacy"] = sum(counts[k["name"]] for counts in
                                   legacy["launches"].values())
        k["launches_train"] = sum(counts[k["name"]] for counts in
                                  train["launches"].values())
        k["launches_train_scale"] = sum(counts[k["name"]] for counts in
                                        scale["launches"].values())
        k["launches_chain_cli"] = sum(counts[k["name"]] for counts in
                                      chain["launches"].values())
        for phase, counts in frame["launches"].items():
            k[f"launches_{phase}"] = counts[k["name"]]
        k["launches_disc_smbr"] = \
            online2["xconfig"]["launches"]["disc_smbr"][k["name"]]
        k["launches_nnet3"] = sum(counts[k["name"]] for counts in
                                  nnet3["launches"].values())
        k["launches_online2"] = sum(counts[k["name"]] for counts in
                                    online2["launches"].values())
        k["launches_xconfig"] = sum(counts[k["name"]] for counts in
                                    online2["xconfig"]["launches"].values())
        for phase, counts in online2["mkgraph"]["launches"].items():
            k[f"launches_{phase}"] = counts[k["name"]]
        for phase, res in template.items():
            k[f"launches_{phase}"] = sum(counts[k["name"]] for counts in
                                         res["launches"].values())
        for phase, res in (*ivector.items(), *backend.items()):
            k[f"launches_{phase}"] = res["launches"][k["name"]]
        k["launches_dense_flat"] = dense_flat["launches"][k["name"]]
        for phase, res in (*decoders.items(), *features.items()):
            if "launches" in res:
                k[f"launches_{phase}"] = res["launches"][k["name"]]
    kernels[-1].update(
        ms_clock=time_c["clock"], run_device_ms=run_device_ms,
        first_version_ms=time_c["first_version_ms"],
        padded_bound_ms=time_c["bounds"]["padded"]["bound_ms"],
        host_ms_a_launch=time_c["host_ms_a_launch"],
        closure_ms=time_c_closure["ms"],
        closure_first_version_ms=time_c_closure["first_version_ms"],
        closure_plain_ms=time_c_closure["plain_ms"],
        closure_bound_ms=time_c_closure["bound_ms"],
        closure_padded_bound_ms=time_c_closure["bounds"]["padded"]["bound_ms"],
        closure_epsilon_dag_ms=time_c_eps["ms"],
        closure_epsilon_dag_first_version_ms=time_c_eps["first_version_ms"],
        closure_epsilon_dag_bound_ms=time_c_eps["bound_ms"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(*sys.argv[2:5]))
    sys.exit(main())
