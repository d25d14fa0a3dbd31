"""Train the vocabulary-scale bench system and decode its test set through
the main path (the port's counterpart of `egs/bench_corpus/train.py
--scale`, `main_scale`).

The `bench_scale_spec()` corpus (V=20,000, 31 phones, 384 training and
128 test utterances, 24 speakers) -> 40-cepstra MFCC -> the mono GMM
(8 iterations, 500 Gaussians) -> the beam-10 alignment -> a diag-UBM
i-vector extractor (64 Gaussians, dimension 32) and each training
utterance's offset-removed i-vector -> a triphone tree over word-internal
windows (at most 2000 leaves, min gain 30) -> the window-LM denominator
-> LF-MMI training of the flagship TDNN-F (17 x 1536, bottleneck 160,
prefinal 256, subsampling 3, i-vector input) over the tree's pdfs: 16
epochs, minibatch 32, chunk 150, tolerance 5/5, learning rate 7e-4
falling to 1e-4, l2 5e-5, leaky-HMM 0.1 (xent_regularize 0.1 is set but,
as in the reference, no xent targets are fed, so the term is skipped).
Writes `<out>/params.npz`, `ivec.npz`, `chain.tm`, `chain.tree` (the
trained transition model and tree, Kaldi binary) and `meta.json` (the
keys `main_scale` writes), then decodes the 128 test utterances
through BatchedOfflinePipeline2 with the trained extractor and
NgramLexDecoder over `build_decode_graph_ng(prune_bi=2, prune_tri=3)`
(pool 128, beam 16), the weights in bf16 as the main path runs them.
Runs on CUDA unless --device cpu is given.

Run: python -m kaldi_tpu_torch.recipes.train_scale --out DIR
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
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexDecoder
from kaldi_tpu_torch.device import DeviceLike, resolve_device
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes.bench_corpus import (
    BenchCorpusSpec, bench_scale_spec, build_decode_graph_ng,
    corpus_fingerprint, mfcc_options, save_ivector_extractor, save_params,
    train_system, wer_of)
from kaldi_tpu_torch.recipes.chain import ChainTrainOptions
from kaldi_tpu_torch.util.kaldi_io import write_kaldi_object

IVECTOR_DIM = 32
SEARCH = dict(prune_k=128, prune_beam=16.0, exact_topk=False)
LM_PRUNE = dict(prune_bi=2, prune_tri=3)


def scale_config(num_pdfs: int,
                 ivector_dim: int = IVECTOR_DIM) -> ChainTdnnfConfig:
    """The flagship TDNN-F trunk (run_tdnn_1d.sh: 17 layers, 1536 hidden,
    160 bottleneck) with i-vector input over the tree's pdfs."""
    return ChainTdnnfConfig(feat_dim=40, ivector_dim=ivector_dim,
                            num_pdfs=num_pdfs, hidden_dim=1536,
                            bottleneck_dim=160, prefinal_dim=256,
                            num_layers=17, subsample_layer=8,
                            frame_subsampling_factor=3)


def train_options(epochs: int = 16) -> ChainTrainOptions:
    """The chain options of train.py main_scale()."""
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
    """The 128 test utterances (float waves, as main_scale passes them)
    through BatchedOfflinePipeline2 with the trained weights in `dtype`,
    the trained extractor and NgramLexDecoder over the trained tree ->
    {"wer", "word_errors", "ref_words", "lanes_decoded", "states",
    "graph_s", "seconds"}."""
    dev = resolve_device(device)
    spec = sysd["spec"]
    t0 = time.perf_counter()
    graph = build_decode_graph_ng(sysd["lexicon"], sysd["lm_text"],
                                  sysd["chain_tm"], sysd["chain_tree"],
                                  lang=sysd["lang"], **LM_PRUNE)
    graph_s = time.perf_counter() - t0
    ex = sysd["ivector_extractor"]
    pipe = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(cfg, sysd["variables"], dtype, dev),
        NgramLexDecoder(graph, device=dev),
        OfflineFeature(mfcc_options(spec), device=dev), acoustic_scale=1.0,
        sample_rate=spec.fs, search_kwargs=dict(SEARCH),
        ivector_extractor=(None if ex is None else BatchedIvectorExtractor(
            ex.arrays(), device=dev)),
        device=dev)
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
            "states": graph.num_states, "graph_s": graph_s,
            "seconds": seconds}


def train_and_decode(out_dir: str, epochs: int = 16,
                     device: DeviceLike = None,
                     spec: Optional[BenchCorpusSpec] = None,
                     config=None, max_leaves: int = 2000,
                     min_gain: float = 30.0,
                     ivector_dim: int = IVECTOR_DIM,
                     stats: Optional[dict] = None) -> dict:
    """Train, write <out_dir>/{params.npz, ivec.npz, chain.tm, chain.tree,
    meta.json}, decode the test set -> the meta dict.  config: a factory
    num_pdfs -> ChainTdnnfConfig (`scale_config` by default).  stats, when
    given, receives `train_system`'s and the decode's numbers (graph_s,
    decode_s, "decode") and the trained system ("system")."""
    spec = bench_scale_spec() if spec is None else spec
    if config is None:
        def config(num_pdfs):
            return scale_config(num_pdfs, ivector_dim)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    sysd = train_system(spec, cfg=config, chain_opts=train_options(epochs),
                        num_ceps=40, ctx=True, max_leaves=max_leaves,
                        min_gain=min_gain, ivector_dim=ivector_dim,
                        device=device, stats=stats)
    stats["train_s"] = time.perf_counter() - t0
    num_pdfs = sysd["chain_tm"].num_pdfs
    cfg = config(num_pdfs)
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, "params.npz"), sysd["variables"])
    if sysd["ivector_extractor"] is not None:
        save_ivector_extractor(os.path.join(out_dir, "ivec.npz"),
                               sysd["ivector_extractor"])
    write_kaldi_object(sysd["chain_tm"].write,
                       os.path.join(out_dir, "chain.tm"))
    write_kaldi_object(sysd["chain_tree"].write,
                       os.path.join(out_dir, "chain.tree"))
    t0 = time.perf_counter()
    dec = decode_test(sysd, cfg, torch.bfloat16, device)
    stats["decode"] = dec
    stats["graph_s"] = dec["graph_s"]
    stats["decode_s"] = time.perf_counter() - t0 - dec["graph_s"]
    meta = {"wer": round(dec["wer"], 2), "num_pdfs": num_pdfs,
            "config": "flagship-ng", "epochs": epochs, "vocab": spec.vocab,
            "noise": spec.noise, "f2_gap": spec.f2_gap,
            "states": dec["states"],
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
                    help="directory for the trained files and meta.json")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)
    meta = train_and_decode(args.out, device=args.device)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
