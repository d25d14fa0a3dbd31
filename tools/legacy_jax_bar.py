#!/usr/bin/env python3
"""The legacy LexChain path of the JAX package, once, on the CPU: the bar
that the PyTorch port's `slice_lex` phase (chip_smoke.py) is held to.

Builds what `bench.py --legacy` builds (bench.py main_legacy): the
default BenchCorpusSpec() corpus without training audio, the chain
transition model and monophone tree of `chain_tm_tree_for`, the
LexChainGraph of `build_decode_graph`, LexChainDecoder (exact search),
the committed flagship_params.npz TDNN-F (17 x 1536, no i-vectors) in
bf16 and the 40-cepstra MFCC frontend, and decodes the 128 test
utterances in one decode_batch call, on the mu-law wire (bench.py's
default) or on the int16 wire.  Prints one JSON line: the WER, the word
errors, the words, the lanes decoded, the graph's sizes and the corpus
fingerprint.  --out FILE also writes each utterance's words.

The mu-law wire zero-pads each utterance to its batch's bucket with byte
0, which decodes to a large constant: a frame that holds only padding
gives rounding-noise cepstra, and these frames are the acoustic model's
right context of a lane's last frames.  The int16 wire pads with exact
zeros.

Run: JAX_PLATFORMS=cpu python tools/legacy_jax_bar.py [--wire int16]
     [--out FILE]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write each utterance's words here")
    ap.add_argument("--wire", choices=("mulaw", "int16"), default="mulaw")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.decoder.batched_pipeline2 import BatchedOfflinePipeline2
    from kaldi_tpu.decoder.lexchain import LexChainDecoder
    from kaldi_tpu.feat.frontend import OfflineFeature, mulaw_encode
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, build_decode_graph, chain_tm_tree_for,
        corpus_fingerprint, load_params, make_corpus, mfcc_options, wer_of)
    t0 = time.time()
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    lang, tm, tree = chain_tm_tree_for(lexicon)
    graph = build_decode_graph(lexicon, lm_text, tm, tree, lang=lang)
    decoder = LexChainDecoder(graph)
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=tm.num_pdfs,
                           frame_subsampling_factor=3, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8)
    variables = load_params(os.path.join(REPO, "egs", "bench_corpus",
                                         "flagship_params.npz"))
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16)
        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x,
        variables["params"])
    pipe = BatchedOfflinePipeline2(
        ChainTdnnf(cfg, train=False), params, variables["batch_stats"],
        decoder, OfflineFeature(mfcc_options(spec, num_ceps=40)),
        acoustic_scale=1.0, sample_rate=spec.fs)
    utts = sorted(test_wav)
    clipped = [np.clip(test_wav[u], -32767, 32767) for u in utts]
    waves = [mulaw_encode(w) if args.wire == "mulaw" else w.astype(np.int16)
             for w in clipped]
    build_s = time.time() - t0
    t0 = time.time()
    out = pipe.decode_batch(waves)
    decode_s = time.time() - t0
    hyps = {u: ([] if o is None else [graph.words[w] for w in o[0]])
            for u, o in zip(utts, out)}
    wer = wer_of(hyps, test_txt)
    n_words = sum(len(r) for r in test_txt.values())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hyps, f)
    print(json.dumps({
        "wer": wer, "word_errors": round(wer * n_words / 100.0),
        "ref_words": n_words,
        "lanes_decoded": sum(o is not None for o in out),
        "lanes": len(utts), "vocab": graph.V, "N": graph.N,
        "P": graph.P, "states": graph.num_states,
        "explicit_bigrams": graph.lm.num_explicit,
        "num_pdfs": graph.num_pdfs, "corpus_fingerprint": fingerprint,
        "wire": args.wire,
        "backend": jax.default_backend(), "build_s": build_s,
        "decode_s": decode_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
