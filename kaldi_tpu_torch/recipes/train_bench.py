"""Train the legacy bench-corpus system and decode its test set (the
port's counterpart of `egs/bench_corpus/train.py` without `--scale`).

The default BenchCorpusSpec() corpus (V=200, 384 training and 128 test
utterances) -> 40-cepstra MFCC -> the mono GMM (8 iterations, 500
Gaussians) -> the beam-10 alignment -> LF-MMI training of the flagship
TDNN-F (17 x 1536, bottleneck 160, prefinal 256, subsampling 3, no
i-vectors) over the monophone chain topology (50 pdfs): 8 epochs,
minibatch 32, chunk 150, tolerance 5/5, learning rate 7e-4 falling to
1e-4, l2 5e-5, leaky-HMM 0.1.  The trained weights go to
`<out>/params.npz` (the format of `save_params`), and the 128 test
utterances are decoded through BatchedOfflinePipeline2 and
LexChainDecoder over `build_decode_graph`, with the weights in bf16 as
the legacy serving path runs them; `<out>/meta.json` records the WER, and
the same JSON is printed.  Runs on CUDA unless --device cpu is given.

Run: python -m kaldi_tpu_torch.recipes.train_bench --out DIR
     [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from kaldi_tpu_torch.chain.objective import ChainTrainingOptions
from kaldi_tpu_torch.decoder.batched_pipeline2 import BatchedOfflinePipeline2
from kaldi_tpu_torch.decoder.lexchain import LexChainDecoder
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes.bench_corpus import (
    BenchCorpusSpec, build_decode_graph, corpus_fingerprint, mfcc_options,
    save_params, train_system, wer_of)
from kaldi_tpu_torch.recipes.chain import ChainTrainOptions


def flagship_config(spec: BenchCorpusSpec) -> ChainTdnnfConfig:
    """The flagship LibriSpeech TDNN-F trunk (run_tdnn_1d.sh: 17 layers,
    1536 hidden, 160 bottleneck) with the corpus's pdf count."""
    return ChainTdnnfConfig(feat_dim=40, num_pdfs=2 * (spec.num_phones + 1),
                            hidden_dim=1536, bottleneck_dim=160,
                            prefinal_dim=256, num_layers=17,
                            subsample_layer=8, frame_subsampling_factor=3)


def train_options(epochs: int = 8) -> ChainTrainOptions:
    """The chain options of train.py main()."""
    return ChainTrainOptions(
        num_epochs=epochs, learning_rate=7e-4, final_learning_rate=1e-4,
        minibatch_size=32, chunk_width=150, left_tolerance=5,
        right_tolerance=5,
        chain=ChainTrainingOptions(l2_regularize=5e-5,
                                   leaky_hmm_coefficient=0.1,
                                   xent_regularize=0.1))


def decode_test(sysd: dict, cfg: ChainTdnnfConfig,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> dict:
    """The 128 test utterances (float waves, as train.py main() passes
    them) through BatchedOfflinePipeline2 with the trained weights in
    `dtype` -> {"wer", "word_errors", "lanes_decoded", "seconds"}."""
    dev = resolve_device(device)
    spec = sysd["spec"]
    graph = build_decode_graph(sysd["lexicon"], sysd["lm_text"],
                               sysd["chain_tm"], sysd["chain_tree"],
                               lang=sysd["lang"])
    pipe = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(cfg, sysd["variables"], dtype, dev),
        LexChainDecoder(graph, device=dev),
        OfflineFeature(mfcc_options(spec), device=dev), acoustic_scale=1.0,
        sample_rate=spec.fs, device=dev)
    utts = sorted(sysd["test_wav"])
    t0 = time.perf_counter()
    out = pipe.decode_batch([sysd["test_wav"][u] for u in utts])
    seconds = time.perf_counter() - t0
    hyps = {u: ([] if o is None else [graph.words[w] for w in o[0]])
            for u, o in zip(utts, out)}
    wer = wer_of(hyps, sysd["test_txt"])
    n_words = sum(len(r) for r in sysd["test_txt"].values())
    return {"wer": wer, "word_errors": round(wer * n_words / 100.0),
            "ref_words": n_words,
            "lanes_decoded": sum(o is not None for o in out),
            "seconds": seconds}


def train_and_decode(out_dir: str, epochs: int = 8,
                     device: DeviceLike = None,
                     spec: Optional[BenchCorpusSpec] = None,
                     cfg: Optional[ChainTdnnfConfig] = None,
                     stats: Optional[dict] = None) -> dict:
    """Train, write <out_dir>/params.npz and meta.json, decode the test
    set -> the meta dict.  stats, when given, receives `train_system`'s
    and the decode's numbers."""
    spec = BenchCorpusSpec() if spec is None else spec
    cfg = flagship_config(spec) if cfg is None else cfg
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    sysd = train_system(spec, cfg=cfg, chain_opts=train_options(epochs),
                        num_ceps=40, device=device, stats=stats)
    stats["train_s"] = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, "params.npz"), sysd["variables"])
    t0 = time.perf_counter()
    stats["decode"] = decode_test(sysd, cfg, torch.bfloat16, device)
    stats["decode_s"] = time.perf_counter() - t0
    meta = {"wer": round(stats["decode"]["wer"], 2),
            "num_pdfs": cfg.num_pdfs, "config": "flagship",
            "epochs": epochs,
            "corpus_hash": corpus_fingerprint(
                spec, sysd["lexicon"], sysd["test_txt"], sysd["test_wav"],
                sysd["lm_text"])}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    stats["system"] = sysd
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for params.npz and meta.json")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)
    meta = train_and_decode(args.out, device=args.device)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
