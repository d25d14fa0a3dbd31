#!/usr/bin/env python3
"""The legacy training recipe of the JAX package, once, on the CPU: the
bar that the PyTorch port's `train_lex` phase (chip_smoke.py) is held to.

Runs what `egs/bench_corpus/train.py` without `--scale` runs (its
`main()`), writing nothing into `egs/`: `train_system` over the default
BenchCorpusSpec() corpus (MFCC, the mono GMM at 8 iterations and 500
Gaussians, the beam-10 alignment, LF-MMI chain training of the 17 x 1536
TDNN-F over the monophone chain topology: 8 epochs, minibatch 32, chunk
150, tolerance 5/5, learning rate 7e-4 to 1e-4, l2 5e-5, leaky-HMM 0.1),
then the decode of the 128 test utterances through
BatchedOfflinePipeline2 and LexChainDecoder over `build_decode_graph`,
with the float32 weights as `main()` decodes them and again with the
weights rounded to bf16 (the legacy serving path's model).

Prints one JSON line: both WERs, the word errors, the chain objective of
every epoch, the mono GMM's average loglike of every iteration (the last
one is the trained GMM's), the aligner used, the chunks and steps, the
stage seconds and the corpus fingerprint.  --out DIR also writes the
trained weights there as params.npz (the format of `save_params`).

Run: JAX_PLATFORMS=cpu python tools/legacy_train_jax_bar.py [--out DIR]
"""

import argparse
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPOCHS = 8      # train.py main()'s chain epochs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the trained params.npz here")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import kaldi_tpu.recipes.chain as chain_mod
    import kaldi_tpu.recipes.mono as mono_mod
    from kaldi_tpu.chain.objective import ChainTrainingOptions
    from kaldi_tpu.decoder.batched_pipeline2 import BatchedOfflinePipeline2
    from kaldi_tpu.decoder.lexchain import LexChainDecoder
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.native import get_lib
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, build_decode_graph, corpus_fingerprint,
        mfcc_options, save_params, train_system, wer_of)
    from kaldi_tpu.recipes.chain import ChainTrainOptions

    # the recipes report their objectives only through `log`
    epoch_objf, mono_ll, chunks = [], [], []

    def capture(orig):
        def log(msg):
            m = re.match(r"chain epoch \d+: objf/frame (\S+)", msg)
            if m:
                epoch_objf.append(float(m.group(1)))
            m = re.match(r"avg loglike/frame (\S+)", msg)
            if m:
                mono_ll.append(float(m.group(1)))
            m = re.match(r"chain-topo training: (\d+) chunks", msg)
            if m:
                chunks.append(int(m.group(1)))
            orig(msg)
        return log
    chain_mod.log = capture(chain_mod.log)
    mono_mod.log = capture(mono_mod.log)

    spec = BenchCorpusSpec()
    num_pdfs = 2 * (spec.num_phones + 1)
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=num_pdfs, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8,
                           frame_subsampling_factor=3)
    opts = ChainTrainOptions(
        num_epochs=EPOCHS, learning_rate=7e-4,
        final_learning_rate=1e-4, minibatch_size=32, chunk_width=150,
        left_tolerance=5, right_tolerance=5,
        chain=ChainTrainingOptions(l2_regularize=5e-5,
                                   leaky_hmm_coefficient=0.1,
                                   xent_regularize=0.1))
    t0 = time.time()
    sysd = train_system(spec, cfg=cfg, chain_opts=opts, num_ceps=40)
    train_s = time.time() - t0
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_params(os.path.join(args.out, "params.npz"), sysd["variables"])

    t0 = time.time()
    graph = build_decode_graph(sysd["lexicon"], sysd["lm_text"],
                               sysd["chain_tm"], sysd["chain_tree"],
                               lang=sysd["lang"])
    utts = sorted(sysd["test_wav"])
    waves = [sysd["test_wav"][u] for u in utts]
    variables = sysd["variables"]
    wers = {}
    for name, params in (
            ("f32", variables["params"]),
            ("bf16", jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                  variables["params"]))):
        pipe = BatchedOfflinePipeline2(
            ChainTdnnf(cfg, train=False), params,
            variables.get("batch_stats", {}), LexChainDecoder(graph),
            OfflineFeature(mfcc_options(spec)), acoustic_scale=1.0,
            sample_rate=spec.fs)
        out = pipe.decode_batch(waves)
        hyps = {u: ([] if o is None else [graph.words[w] for w in o[0]])
                for u, o in zip(utts, out)}
        wers[name] = wer_of(hyps, sysd["test_txt"])
    decode_s = time.time() - t0
    n_words = sum(len(r) for r in sysd["test_txt"].values())
    print(json.dumps({
        "wer": wers["f32"], "wer_bf16": wers["bf16"],
        "word_errors": round(wers["f32"] * n_words / 100.0),
        "word_errors_bf16": round(wers["bf16"] * n_words / 100.0),
        "ref_words": n_words, "epoch_objf": epoch_objf,
        "mono_avg_loglike": mono_ll,
        "aligner": "native" if get_lib() is not None else "FasterDecoder",
        "chunks": chunks[-1] if chunks else None,
        "steps": (chunks[-1] // 32) * EPOCHS if chunks else None,
        "epochs": EPOCHS, "num_pdfs": num_pdfs,
        "corpus_fingerprint": corpus_fingerprint(
            spec, sysd["lexicon"], sysd["test_txt"], sysd["test_wav"],
            sysd["lm_text"]),
        "backend": jax.default_backend(), "train_s": train_s,
        "decode_s": decode_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
