#!/usr/bin/env python3
"""Smoke test of the kaldi_tpu_torch port on one NVIDIA GPU.

Drives the port's main path at full width: 128 lanes x 5 s of seeded
mu-law audio -> MFCC -> i-vectors -> the committed flagship_ng chain
TDNN-F (17 x 1536, bf16) -> exact block-chain Viterbi over the
V=700 DirectGraphSpec graph (2,215,861 states), through
BatchedOfflinePipeline2.decode_batch.

Phases, one JSON line each (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from kaldi_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's full shape and at a small ragged shape (torch.equal),
     and their times;
  4. the slice: one warm-up decode_batch, three timed ones with the
     kernel launch counts read around each; the bf16 AM against float32
     on 4 lanes; 8 lanes decoded again with the plain step (equal words,
     tids and costs); one decode_batch under torch.profiler (device time
     by kernel, busy share, peak memory);
  5. the kernel table; the last line is {"ok": true, "device": ...}.

Run: python3 chip_smoke.py   (needs CUDA; exits nonzero without it)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from kaldi_tpu_torch.decoder.batched_pipeline2 import (
    BatchedOfflinePipeline2, PipelineStats)
from kaldi_tpu_torch.decoder.block_chain import (BlockChainDecoder,
                                                 BlockChainGraph)
from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                  synth_bigram, synth_lexicon)
from kaldi_tpu_torch.feat.frontend import (MfccOptions, OfflineFeature,
                                           mulaw_encode)
from kaldi_tpu_torch.feat.mel import MelBanksOptions
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.ops import _build
from kaldi_tpu_torch.ops import block_chain_step as bcs
from kaldi_tpu_torch.recipes.bench_corpus import (load_ivector_extractor,
                                                  load_params)

REPO = os.path.dirname(os.path.abspath(__file__))
ART = os.path.join(REPO, "egs", "bench_corpus")
SEED = 0
LANES, UTT_S, FS = 128, 5.0, 16000
# published device-memory rates (bytes/s) by card name; H100 SXM default
HBM_RATE = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12)]
FP32_OPS = 67e12          # H100 SXM float32 outside the tensor cores


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def step_cost(dec: BlockChainDecoder, B: int):
    """Bytes a step must move (each input read once, each output written
    once) and the adds/compares it must do, at batch B."""
    Up, N, Vp = dec.Up, dec.g.N, dec.Vp
    plane = Up * N * B
    bytes_in = 4 * plane + 4 * Up * B + 2 * 4 * N * B + N + 4 * Up * Vp \
        + 4 * Vp + B
    bytes_out = 4 * plane + plane // 8 + 2 * 4 * Vp * B
    ops = 4 * plane + 2 * N * B + 2 * Up * Vp * B
    return bytes_in + bytes_out, ops


def check_step(dec: BlockChainDecoder, B: int, seed: int, n_inactive: int,
               label: str) -> dict:
    args = step_inputs(dec, B, seed, n_inactive)
    got = bcs.block_chain_step(*args)
    want = bcs.block_chain_step_reference(*args)
    torch.cuda.synchronize()
    names = ("new", "bits", "rootexp", "rootarg")
    equal = {n: bool(torch.equal(g, w)) for n, g, w in zip(names, got, want)}
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    row = {"shape": label, "B": B, "equal": equal, "max_abs_err": err}
    if not all(equal.values()):
        emit("kernel_check", ok=False, **row)
        raise SystemExit(f"block_chain_step differs from its plain version "
                         f"at {label}: {equal}")
    return row


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
         hbm_bytes_per_s=rate)

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
    rows = [check_step(decoder, LANES, SEED + 1, 0, "full"),
            check_step(small, 19, SEED + 2, 5, "small_ragged")]
    emit("kernel_check", ok=True, kernel="block_chain_step", checks=rows)
    args = step_inputs(decoder, LANES, SEED + 3, 0)
    out_new = torch.empty_like(args[0])
    out_bits = torch.empty((decoder.Up, graph.N // 8, LANES),
                           dtype=torch.uint8, device="cuda")

    def kernel_once():
        bcs.block_chain_step(*args, new=out_new, bits=out_bits)

    def plain_once():
        bcs.block_chain_step_reference(*args)

    for _ in range(3):
        kernel_once()
    plain_once()
    torch.cuda.synchronize()
    k_ms = cuda_ms(kernel_once, 20)
    p_ms = cuda_ms(plain_once, 5)
    k_ms_2 = cuda_ms(kernel_once, 20)
    nbytes, nops = step_cost(decoder, LANES)
    bytes_ms, ops_ms = nbytes / rate * 1e3, nops / FP32_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit("kernel_time", kernel="block_chain_step",
         shape=[decoder.Up, graph.N, LANES], ms=k_ms, ms_repeat=k_ms_2,
         plain_ms=p_ms, bound_ms=bound_ms, bytes=nbytes, ops=nops,
         bytes_ms=bytes_ms, ops_ms=ops_ms,
         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
         achieved_bytes_per_s=nbytes / (k_ms * 1e-3))
    del args, out_new, out_bits
    torch.cuda.empty_cache()

    # 4. the slice at full width --------------------------------------------
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=32, num_pdfs=2000,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    variables = load_params(os.path.join(ART, "flagship_ng_params.npz"))
    model = chain_tdnnf_from_flax(cfg, variables, dtype=torch.bfloat16,
                                  device="cuda")
    ivec = BatchedIvectorExtractor(load_ivector_extractor(
        os.path.join(ART, "flagship_ng_ivec.npz")), device="cuda")
    opts = MfccOptions(frame_opts=FrameExtractionOptions(samp_freq=FS,
                                                         dither=0.0),
                       mel_opts=MelBanksOptions(num_bins=40))
    opts.num_ceps = 40
    fe = OfflineFeature(opts, device="cuda")
    pipe = BatchedOfflinePipeline2(model, decoder, fe,
                                   ivector_extractor=ivec, device="cuda")
    rng = np.random.default_rng(SEED)
    n = int(FS * UTT_S)
    t = np.arange(n) / FS
    waves = []
    for _ in range(LANES):
        f0 = rng.uniform(100, 300)
        voiced = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                     / k for k in range(1, 12))
        envelope = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        x = 4000 * voiced * envelope + rng.normal(size=n) * 800
        waves.append(mulaw_encode(np.clip(x, -32767, 32767)))

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

    # where one decode_batch spends the card's time
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.decode_batch(waves)
        prof_wall = time.perf_counter() - t0
    # device-side events only (a host op's device time repeats its
    # kernels')
    by_name = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(ms for ms, _, _ in by_name)
    emit("profile", wall_s_profiled=prof_wall, device_ms=device_ms,
         busy_share_of_median_wall=device_ms / 1e3 / sorted(
             r["wall_s"] for r in runs)[1],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         top=[{"ms": ms, "calls": c, "name": k[:70]}
              for ms, c, k in by_name[:10]])

    # 5. tables -------------------------------------------------------------
    walls = sorted(r["wall_s"] for r in runs)
    emit("summary", wall_s_median=walls[1], xrt_median=runs[0]["audio_s"]
         / walls[1], kernel_ms=k_ms, bound_ms=bound_ms, plain_ms=p_ms,
         seconds_total=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "block_chain_step", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/block_chain_step.cu",
        "replaces": "kaldi_tpu/decoder/block_chain.py:345",
        "launches": runs[-1]["launches"]["block_chain_step"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
