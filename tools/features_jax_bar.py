#!/usr/bin/env python3
"""The bars of chip_smoke.py's feature phases (feats_offline, feats_pitch,
batched_cuda2): the JAX package's feature tools and its
batched-wav-nnet3-cuda2 on the CPU over the legacy corpus's 128 test
utterances (the default BenchCorpusSpec(), V=200, the int16 wire as a
wav archive, 555.8 s of 16 kHz audio).

  frames      compute-{mfcc,fbank,spectrogram,plp}-feats at the
              reference's defaults with --dither=0, each also with
              --snip-edges=false, and MFCC at the models' 40 cepstra over
              40 bins: each configuration's frames over the 128
              utterances;
  pitch       compute-and-process-kaldi-pitch-feats: each utterance's
              frame count and the means of its three columns;
  online_pitch
              OnlinePitchFeature at its default max_frames_latency on the
              first 16 utterances fed 0.25 s at a time: each one's frames
              final before input_finished, the means of their three
              columns, and how many of them are more than 1e-2 off the
              offline output (a finalized frame is not the offline one:
              the latency window cuts the Viterbi backtrace short);
  decode      batched-wav-nnet3-cuda2 at --dither=0 with the models' MFCC
              (40/40) over the tool HCLG of tools/mkgraph_jax_bar.py
              (mkgraph.sh's steps through the port's tools on the CPU)
              and the committed flagship_params.npz TDNN-F (17 x 1536) as
              a .mdl written by the JAX package's mdl_io, at decode.sh's
              beams (15, lattice beam 8, 7000 active), --max-batch-size=64:
              the lattices' best paths' WER.  The tool takes the first
              1/3 of the model's input-rate output frames where the
              decoder needs every third (a fault of the reference's tool:
              `tool_wer` shows it); `wer` is the same pipeline of JAX
              pieces (its frontend, `compile_graph` under jax.jit over the
              same zero-padded batches, `LatticeFasterDecoder`) with every
              third frame taken, the port's bar.

Prints one JSON line; --out FILE also writes it there (chip_smoke.py reads
tests/data/features_jax_bar.json, this script's output).  --only SECTION
computes that section alone and updates it in --out's file.

Run: JAX_PLATFORMS=cpu python tools/features_jax_bar.py
     [--out tests/data/features_jax_bar.json] [--only online_pitch]
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

TYPES = ("mfcc", "fbank", "spectrogram", "plp")
DECODE = ["--dither=0", "--num-ceps=40", "--num-mel-bins=40", "--beam=15",
          "--lattice-beam=8", "--max-active=7000", "--max-batch-size=64",
          "--frame-subsampling-factor=3", "--acoustic-scale=1.0"]

ONLINE_UTTS, ONLINE_PIECE_S, ONLINE_REVISED = 16, 0.25, 1e-2


def feature_configs():
    """(name, tool, options) of each offline feature configuration."""
    out = []
    for t in TYPES:
        for snip in (True, False):
            out.append((f"{t}{'' if snip else '_nosnip'}",
                        f"compute-{t}-feats",
                        ["--dither=0", f"--snip-edges={str(snip).lower()}"]))
    out.append(("mfcc40", "compute-mfcc-feats",
                ["--dither=0", "--num-ceps=40", "--num-mel-bins=40"]))
    return out


def run_tool(tool: str, argv) -> str:
    from kaldi_tpu.cli import get_tool
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = get_tool(tool)([tool, *argv])
    if rc != 0:
        raise RuntimeError(f"{tool} failed\n{err.getvalue()}")
    return err.getvalue()


def online_pitch(waves: dict, fs: float) -> dict:
    """The online_pitch section: OnlinePitchFeature's frames final before
    input_finished, their column means and the ones past ONLINE_REVISED
    of compute_and_process_kaldi_pitch, an utterance."""
    from kaldi_tpu.feat.pitch import compute_and_process_kaldi_pitch
    from kaldi_tpu.online.features import OnlinePitchFeature
    piece = int(ONLINE_PIECE_S * fs)
    out = {}
    for u in sorted(waves)[:ONLINE_UTTS]:
        w = waves[u].astype(np.float32)
        op = OnlinePitchFeature()
        for s in range(0, len(w), piece):
            op.accept_waveform(fs, w[s:s + piece])
        n_final = max(0, op.num_frames_ready() - op.max_frames_latency
                      - op.process_opts.normalization_right_context)
        op.input_finished()
        final = op.get_frames(np.arange(n_final))
        off = compute_and_process_kaldi_pitch(w)[:n_final]
        out[u] = {"final_frames": n_final,
                  "means": [float(x) for x in final.mean(axis=0)],
                  "revised": int((np.abs(final - off).max(axis=1)
                                  > ONLINE_REVISED).sum())}
    return out


def repaired_decode(mdl: str, hclg_path: str, waves: dict, names: dict,
                    refs: dict) -> dict:
    """batched-wav-nnet3-cuda2's pipeline of JAX pieces with every third
    output frame -> WER, word errors, frames."""
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.lat.functions import lattice_best_path
    from kaldi_tpu.nnet3.jax_bridge import compile_graph
    from kaldi_tpu.nnet3.mdl_io import read_nnet3_any
    from kaldi_tpu.recipes.bench_corpus import wer_of
    tm, graph, _ = read_nnet3_any(mdl)
    dec = LatticeFasterDecoder(read_fst_file(hclg_path),
                               LatticeFasterDecoderOptions(
                                   beam=15.0, lattice_beam=8.0,
                                   max_active=7000))
    opts = MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0))
    opts.num_ceps = 40
    opts.mel_opts.num_bins = 40
    fe = OfflineFeature(opts)
    fwd = jax.jit(compile_graph(graph))
    utts = sorted(waves)
    hyps, frames = {}, 0
    for b0 in range(0, len(utts), 64):
        part = utts[b0:b0 + 64]
        feats = fe.compute_batch([waves[u].astype(np.float32)
                                  for u in part])
        t_max = -(-max(f.shape[0] for f in feats) // 8) * 8
        batch = np.zeros((len(part), t_max, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            batch[i, :f.shape[0]] = f
        out = np.asarray(fwd(jnp.asarray(batch)))
        for i, u in enumerate(part):
            ll = out[i, :feats[i].shape[0]:3]
            frames += ll.shape[0]
            lat = dec.decode(ll, tm.id2pdf_id, 1.0)
            hyps[u] = ([] if lat is None else
                       [names[w] for w in lattice_best_path(lat)[1]])
    wer = wer_of(hyps, refs)
    return {"wer": wer, "word_errors": round(
        wer * sum(len(r) for r in refs.values()) / 100.0), "frames": frames,
        "utterances": len(hyps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--only", choices=["online_pitch"],
                    help="compute this section alone and update it in "
                    "--out's file")
    args = ap.parse_args()
    if args.only and not args.out:
        ap.error("--only needs --out")
    import jax
    from kaldi_tpu.feat.wave import WaveData
    from kaldi_tpu.lat.functions import lattice_best_path
    from kaldi_tpu.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu.nnet3 import mdl_io as JM
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, chain_tm_tree_for, corpus_fingerprint, load_params,
        make_corpus, wer_of)
    from kaldi_tpu.util.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from mkgraph_jax_bar import build_graph
    seconds = {}
    t0 = time.time()
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    utts = sorted(test_wav)
    waves = {u: np.clip(test_wav[u], -32767, 32767).astype(np.int16)
             for u in utts}
    tmp = tempfile.mkdtemp(prefix="features_bar_")
    wav = f"ark:{os.path.join(tmp, 'wav.ark')}"
    with TableWriter("wave", wav) as w:
        for u in utts:
            w.write(u, WaveData(spec.fs, waves[u][None, :]))
    seconds["corpus"] = time.time() - t0

    t0 = time.time()
    online = online_pitch(waves, spec.fs)
    seconds["online_pitch"] = time.time() - t0
    if args.only:
        with open(args.out) as f:
            res = json.load(f)
        res["online_pitch"] = online
        res["seconds"]["online_pitch"] = seconds["online_pitch"]
        return write(res, args.out)

    t0 = time.time()
    frames = {}
    for name, tool, opts in feature_configs():
        ark = f"ark:{os.path.join(tmp, name + '.ark')}"
        run_tool(tool, [*opts, wav, ark])
        frames[name] = sum(m.shape[0] for _k, m in
                           SequentialTableReader("matrix", ark))
    seconds["frames"] = time.time() - t0

    t0 = time.time()
    pitch_ark = f"ark:{os.path.join(tmp, 'pitch.ark')}"
    run_tool("compute-and-process-kaldi-pitch-feats",
             [f"--sample-frequency={spec.fs}", wav, pitch_ark])
    pitch = {u: {"frames": int(m.shape[0]),
                 "means": [float(x) for x in m.mean(axis=0)]}
             for u, m in SequentialTableReader("matrix", pitch_ark)}
    seconds["pitch"] = time.time() - t0

    t0 = time.time()
    g = build_graph(os.path.join(tmp, "lm"), lexicon, lm_text)
    names = {i: w for w, i in
             read_symbol_table(os.path.join(g["lang"], "words.txt")).items()}
    _lang, tm, _tree = chain_tm_tree_for(lexicon)
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=tm.num_pdfs,
                           frame_subsampling_factor=3, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8)
    variables = load_params(os.path.join(REPO, "egs", "bench_corpus",
                                         "flagship_params.npz"))
    ctx = sum(s * (cfg.frame_subsampling_factor
                   if i > cfg.subsample_layer else 1)
              for i, s in enumerate(cfg.time_strides(), start=1))
    mdl = os.path.join(tmp, "final.mdl")
    JM.write_nnet3_am(mdl, tm, JM.chain_tdnnf_to_nnet3(
        ChainTdnnf(cfg, train=False), variables), left_context=ctx,
        right_context=ctx)
    seconds["graph_model"] = time.time() - t0
    refs = {u: test_txt[u] for u in utts}
    n_words = sum(len(r) for r in refs.values())

    t0 = time.time()
    lat = f"ark:{os.path.join(tmp, 'lat.ark')}"
    log = run_tool("batched-wav-nnet3-cuda2",
                   [*DECODE, mdl, g["hclg"], wav, lat])
    hyps = {u: [names[w] for w in lattice_best_path(la)[1]]
            for u, la in SequentialTableReader(LatticeHolder(), lat)}
    tool_wer = wer_of(hyps, refs)
    realtimex = float(log.rsplit("RealTimeX:", 1)[1].split()[0])
    seconds["tool"] = time.time() - t0

    t0 = time.time()
    decode = repaired_decode(mdl, g["hclg"], waves, names, refs)
    seconds["decode"] = time.time() - t0

    res = {"utterances": len(utts),
           "audio_s": sum(len(w) for w in waves.values()) / spec.fs,
           "corpus_fingerprint": fingerprint, "frames": frames,
           "pitch": pitch, "online_pitch": online,
           "decode": dict(decode, ref_words=n_words,
                          tool_wer=tool_wer,
                          tool_word_errors=round(tool_wer * n_words / 100.0),
                          tool_decoded=len(hyps),
                          tool_realtimex_cpu=realtimex),
           "decode_args": DECODE, "backend": jax.default_backend(),
           "seconds": seconds}
    return write(res, args.out)


def write(res: dict, out) -> int:
    line = json.dumps(res)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
