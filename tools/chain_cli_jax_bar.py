#!/usr/bin/env python3
"""Kaldi chain training through the JAX package's command-line tools,
once, on the CPU: the bar that the PyTorch port's `chain_cli` phase
(chip_smoke.py) is held to.

Makes the inputs that `chain_cli` takes from `train_lex`, with the JAX
package's own stages of the same recipe (`train_system` of
kaldi_tpu/recipes/bench_corpus.py up to its alignment): the default
BenchCorpusSpec() corpus, 40-cepstra MFCC, the mono GMM (8 iterations,
500 Gaussians), the beam-10 alignment, the chain transition model and
monophone tree of `make_chain_system`, and the alignments converted to
chain transition-ids for frame subsampling (`chain_ali_repeated`).
Writes them as a Kaldi user has them (tree, 0.trans_mdl, feats.ark,
ali.ark, phones.ark), then runs the tools as chain_cli runs them:

  chain-est-phone-lm -> chain-make-den-fst -> nnet3-chain-get-egs (tool
  defaults: chunk 140, contexts 13, subsampling 3) ->
  nnet3-chain-shuffle-egs -> nnet3-chain-subset-egs --n=64 ->
  nnet3-chain-train (17 x 1536, bottleneck 160, minibatch 32, 4 epochs)
  -> nnet3-chain-compute-prob on the subset

and decodes the 128 test utterances with the trained raw nnet (the host
evaluator at the input rate, every third frame) through LexChainDecoder
over `build_decode_graph`.

The JAX trainer writes its BatchNorm moving averages (momentum 0.99),
which lag the weights; the port's trainer writes the statistics Kaldi's
RecomputeStats gives the final weights (one pass over the egs in
training mode, each BatchNorm's input pooled over all frames).  So the
raw is decoded twice: as the JAX tool wrote it ("wer_exported") and with
its statistics recomputed the port's way from the same weights ("wer",
the bar).  Prints one JSON line: both WERs and word errors, the egs, the
steps, the final training objective, both compute-prob objectives and
the stage seconds.

Run: JAX_PLATFORMS=cpu python tools/chain_cli_jax_bar.py [--out DIR]
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# chain_cli's options (chip_smoke.py CHAIN_CLI_*)
TRAIN_ARGS = ["--hidden-dim=1536", "--bottleneck-dim=160", "--num-layers=17",
              "--minibatch-size=32", "--num-epochs=4"]
SUBSET = 64


def chain_ali_repeated(ali, mono_tm, chain_tm):
    """A mono alignment as chain transition-ids as Kaldi's `convert-ali
    --frame-subsampling-factor=3 --repeat-frames=true` gives it (chain_cli's
    ali_sub.ark): converted at the output rate (each phone at least one
    frame, its forward transition first; `mono_ali_to_chain_ali`), each
    output frame repeated 3 times.  Every three input frames then hold
    one output frame, so the subsampling of nnet3-chain-get-egs keeps
    each phone's forward transition at any chunk offset."""
    from kaldi_tpu.recipes.chain import mono_ali_to_chain_ali
    return [t for t in mono_ali_to_chain_ali(ali, mono_tm, chain_tm, 3)
            for _ in range(3)]


def recompute_batch_stats(model, variables, egs_rspecifier, minibatch_size):
    """The port's recompute_batch_stats (kaldi_tpu_torch/parallel/
    trainer.py) on the JAX model: one pass over the trainer's minibatches
    (the stored context trimmed) in training mode, each BatchNorm's input
    pooled over every frame in float64 -> new batch_stats."""
    import copy

    import flax.linen as nn
    import jax.numpy as jnp
    from kaldi_tpu.nnet3.components import BatchNorm
    from kaldi_tpu.nnet3.egs import merged_minibatches
    sums = {}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, BatchNorm) and \
                context.method_name == "__call__":
            x = np.asarray(args[0], np.float64)
            x = x.reshape(-1, x.shape[-1])
            acc = sums.setdefault(context.module.scope.path, [0, 0.0, 0.0])
            acc[0] += x.shape[0]
            acc[1] = acc[1] + x.sum(0)
            acc[2] = acc[2] + (x * x).sum(0)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(intercept):
        for batch in merged_minibatches(egs_rspecifier, minibatch_size,
                                        drop_last=False):
            lc, rc = batch["left_context"], batch["right_context"]
            feats = batch["feats"][:, lc:batch["feats"].shape[1] - rc
                                   if rc else None]
            model.apply(variables, jnp.asarray(feats),
                        mutable=["batch_stats"])
    stats = copy.deepcopy(variables["batch_stats"])
    for path, (n, s1, s2) in sums.items():
        node = stats
        for k in path:
            node = node[k]
        mean = s1 / n
        node["bn"]["mean"] = mean.astype(np.float32)
        node["bn"]["var"] = np.maximum(s2 / n - mean * mean,
                                       0.0).astype(np.float32)
    return stats


def run(tool, *args):
    """One tool through the registry, its log captured -> stderr text."""
    from kaldi_tpu.cli import get_tool
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = get_tool(tool)([tool] + [str(a) for a in args])
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}")
    return err.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="keep the files here (default: a "
                    "temporary directory)")
    args = ap.parse_args()
    import jax
    import kaldi_tpu.nnet3.mdl_io as jmdl
    from kaldi_tpu.chain.supervision import alignment_to_phone_segments
    from kaldi_tpu.decoder.graph import TrainingGraphCompiler
    from kaldi_tpu.decoder.lexchain import LexChainDecoder
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.nnet3.mdl_io import read_raw_nnet3
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, build_decode_graph, build_lang, corpus_fingerprint,
        make_corpus, mfcc_options, wer_of)
    from kaldi_tpu.recipes.chain import make_chain_system
    from kaldi_tpu.recipes.mono import TrainMonoOptions, _align_all, \
        train_mono
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.table import TableWriter

    stage_s = {}
    t0 = time.time()
    spec = BenchCorpusSpec()
    lexicon, train_txt, train_wav, test_txt, test_wav, lm_text = \
        make_corpus(spec)
    lang = build_lang(lexicon)
    comp = OfflineFeature(mfcc_options(spec, 40))
    feats = dict(zip(train_wav, comp.compute_batch(list(train_wav.values()))))
    gmm = train_mono(lang, feats, train_txt,
                     TrainMonoOptions(num_iters=8, totgauss=500))
    compiler = TrainingGraphCompiler(gmm.tm, gmm.tree, lang)
    graphs = {u: compiler.compile(train_txt[u]) for u in feats}
    alis = _align_all(gmm, graphs, feats, 10.0, 0.1, 1.0)
    chain_tm, chain_tree = make_chain_system(lang, gmm.tm)
    stage_s["inputs"] = time.time() - t0

    with contextlib.ExitStack() as stack:
        d = args.out or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(d, exist_ok=True)
        kaldi_io.write_kaldi_object(chain_tree.write, f"{d}/tree")
        kaldi_io.write_kaldi_object(chain_tm.write, f"{d}/0.trans_mdl")
        with TableWriter("matrix", f"ark:{d}/feats.ark") as w:
            for u in sorted(feats):
                w.write(u, feats[u])
        with TableWriter("int-vector", f"ark:{d}/ali.ark") as w, \
                TableWriter("int-vector", f"ark:{d}/phones.ark") as wp:
            for u in sorted(alis):
                w.write(u, chain_ali_repeated(alis[u], gmm.tm, chain_tm))
                wp.write(u, [s[0] for s in alignment_to_phone_segments(
                    alis[u], gmm.tm)])

        t0 = time.time()
        run("chain-est-phone-lm", f"ark:{d}/phones.ark", f"{d}/phone_lm.fst")
        run("chain-make-den-fst", f"{d}/tree", f"{d}/0.trans_mdl",
            f"{d}/phone_lm.fst", f"{d}/den.fst", f"{d}/normalization.fst")
        log = run("nnet3-chain-get-egs", f"{d}/0.trans_mdl",
                  f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                  f"ark:{d}/egs.ark")
        n_egs = int(re.search(r"(\d+) examples", log).group(1))
        run("nnet3-chain-shuffle-egs", f"ark:{d}/egs.ark",
            f"ark:{d}/egs_shuf.ark")
        run("nnet3-chain-subset-egs", f"--n={SUBSET}",
            f"ark:{d}/egs_shuf.ark", f"ark:{d}/egs_sub.ark")
        stage_s["egs"] = time.time() - t0
        t0 = time.time()
        # the trainer's exporter, wrapped to keep the model and weights
        export = jmdl.chain_tdnnf_to_nnet3
        trained = {}

        def keep(model, variables=None):
            trained.update(model=model, variables=variables)
            return export(model, variables)
        jmdl.chain_tdnnf_to_nnet3 = keep
        try:
            log = run("nnet3-chain-train", *TRAIN_ARGS, f"{d}/den.fst",
                      f"ark:{d}/egs_shuf.ark", f"{d}/final.raw")
        finally:
            jmdl.chain_tdnnf_to_nnet3 = export
        m = re.search(r"(\d+) steps, final objf (\S+)", log)
        steps, train_objf = int(m.group(1)), float(m.group(2))
        stage_s["train"] = time.time() - t0
        t0 = time.time()
        variables = dict(trained["variables"])
        variables["batch_stats"] = recompute_batch_stats(
            trained["model"], variables, f"ark:{d}/egs_shuf.ark", 32)
        jmdl.write_raw_nnet3(export(trained["model"], variables),
                             f"{d}/final_recomputed.raw")
        stage_s["recompute"] = time.time() - t0
        t0 = time.time()
        prob = {}
        for name in ("final", "final_recomputed"):
            log = run("nnet3-chain-compute-prob", f"{d}/{name}.raw",
                      f"{d}/den.fst", f"ark:{d}/egs_sub.ark")
            prob[name] = float(re.search(r"is (\S+) per frame",
                                         log).group(1))
        stage_s["compute_prob"] = time.time() - t0
        raws = {name: read_raw_nnet3(f"{d}/{name}.raw")
                for name in ("final", "final_recomputed")}

    t0 = time.time()
    graph = build_decode_graph(lexicon, lm_text, chain_tm, chain_tree,
                               lang=lang)
    utts = sorted(test_wav)
    test_feats = comp.compute_batch([test_wav[u] for u in utts])
    n_words = sum(len(r) for r in test_txt.values())
    wers = {}
    for name, raw in raws.items():
        outs = [raw.forward(np.asarray(f, np.float32))[::3]
                for f in test_feats]
        lens = [o.shape[0] for o in outs]
        ll = np.zeros((len(outs), max(lens), outs[0].shape[1]), np.float32)
        for i, o in enumerate(outs):
            ll[i, :lens[i]] = o
        hyps = LexChainDecoder(graph).decode_batch(ll, lengths=lens)
        wers[name] = (wer_of({u: ([] if h is None else
                                  [graph.words[w] for w in h[0]])
                              for u, h in zip(utts, hyps)}, test_txt),
                      sum(h is not None for h in hyps))
    stage_s["decode"] = time.time() - t0
    wer, lanes = wers["final_recomputed"]
    print(json.dumps({
        "wer": wer, "word_errors": round(wer * n_words / 100.0),
        "ref_words": n_words, "lanes_decoded": lanes,
        "wer_exported": wers["final"][0],
        "word_errors_exported": round(wers["final"][0] * n_words / 100.0),
        "egs": n_egs, "steps": steps, "train_objf": train_objf,
        "compute_prob_objf": prob["final_recomputed"],
        "compute_prob_objf_exported": prob["final"], "subset": SUBSET,
        "train_args": TRAIN_ARGS,
        "corpus_fingerprint": corpus_fingerprint(
            spec, lexicon, test_txt, test_wav, lm_text),
        "backend": jax.default_backend(), "stage_s": stage_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
