#!/usr/bin/env python3
"""The bar of chip_smoke.py's mkgraph_legacy and scoring_legacy phases:
the legacy path's test set decoded by the JAX package on the CPU through
the HCLG that the port's tools build (tools/mkgraph_steps.py).

The graph: the default BenchCorpusSpec() corpus (V=200, no training
audio), its bigram (`build_decode_graph`'s BigramBackoffLm.from_counts)
written by to_arpa, prepare-lang and arpa2fst, and mkgraph.sh's steps
over the chain monophone tree and transition model of
`chain_tm_tree_for`, at the chain model's scales (transition and
self-loop scale 1.0), all through the port's tools on the CPU.  The
search: the JAX package's `kaldi_tpu.nnet3.models.ChainTdnnf` over the
committed flagship_params.npz (17 x 1536, float32) on each test
utterance alone (the int16 wire, the JAX frontend with
mfcc_options(spec, 40)), and the JAX package's LatticeFasterDecoder at
steps/nnet3/decode.sh's beams (15, lattice beam 8, 7000 active) over
that HCLG.fst read by kaldi_tpu's openfst_io, as nnet3-latgen-faster
runs it: the words are the raw lattice's best path, MBR runs on the
determinized lattice (lattice-mbr-decode at its defaults).

Prints one JSON line: the WER and word errors of the best path and of
MBR, the HCLG's size and each intermediate's, the size of the same
graph built with tropical determinization and no fstpushspecial
(graph_t, `mkgraph(..., use_log=False)`), the decoded utterances and
the corpus fingerprint.  --out FILE also writes each utterance's words
(best path and MBR).

Run: JAX_PLATFORMS=cpu python tools/mkgraph_jax_bar.py [--out FILE]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def build_graph(d: str, lexicon, lm_text) -> dict:
    """The port's tools on the CPU: the legacy lang, G and HCLG in d."""
    from mkgraph_steps import legacy_inputs, mkgraph
    from kaldi_tpu_torch.recipes.bench_corpus import chain_tm_tree_for
    _lang, tm, tree = chain_tm_tree_for(lexicon)
    inp = legacy_inputs(d, lexicon, lm_text, tm, tree)
    graph_in = (inp["lang"], inp["G"], inp["tree"], inp["tm"])
    rep = mkgraph(*graph_in, os.path.join(d, "graph"), transition_scale=1.0,
                  self_loop_scale=1.0)
    rep_t = mkgraph(*graph_in, os.path.join(d, "graph_t"),
                    transition_scale=1.0, self_loop_scale=1.0, use_log=False)
    return dict(inp, report=rep, report_t=rep_t,
                hclg=os.path.join(d, "graph", "HCLG.fst"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write each utterance's words here")
    args = ap.parse_args()
    import jax
    from kaldi_tpu.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.lat.functions import determinize_lattice, lattice_best_path
    from kaldi_tpu.lat.sausages import MinimumBayesRisk
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, chain_tm_tree_for, corpus_fingerprint, load_params,
        make_corpus, mfcc_options, wer_of)
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    t0 = time.time()
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    _lang, tm, _tree = chain_tm_tree_for(lexicon)
    tmp = tempfile.mkdtemp(prefix="mkgraph_bar_")
    g = build_graph(tmp, lexicon, lm_text)
    graph_s = time.time() - t0
    hclg = read_fst_file(g["hclg"])
    names = {i: w for w, i in
             read_symbol_table(os.path.join(g["lang"], "words.txt")).items()}
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=tm.num_pdfs,
                           frame_subsampling_factor=3, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8)
    variables = load_params(os.path.join(REPO, "egs", "bench_corpus",
                                         "flagship_params.npz"))
    model = ChainTdnnf(cfg, train=False)
    forward = jax.jit(lambda v, f: model.apply(v, f)[0])
    fe = OfflineFeature(mfcc_options(spec, num_ceps=40))
    dec = LatticeFasterDecoder(hclg, LatticeFasterDecoderOptions(
        beam=15.0, lattice_beam=8.0, max_active=7000))
    utts = sorted(test_wav)
    best, mbr, frames = {}, {}, 0
    t0 = time.time()
    for u in utts:
        wave = np.clip(test_wav[u], -32767, 32767).astype(np.int16)
        feats = fe.compute(wave.astype(np.float32))
        ll = np.asarray(forward(variables, feats[None]))[0]
        frames += len(ll)
        raw = dec.decode(ll, tm.id2pdf_id, 1.0)
        if raw is None:
            best[u] = mbr[u] = []
            continue
        best[u] = [names[w] for w in lattice_best_path(raw)[1]]
        mbr[u] = [names[w] for w in
                  MinimumBayesRisk(determinize_lattice(raw)).get_one_best()]
    decode_s = time.time() - t0
    refs = {u: test_txt[u] for u in utts}
    n_words = sum(len(r) for r in refs.values())
    wer, mbr_wer = wer_of(best, refs), wer_of(mbr, refs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"best": best, "mbr": mbr}, f)
    rep = g["report"]
    print(json.dumps({
        "wer": wer, "word_errors": round(wer * n_words / 100.0),
        "mbr_wer": mbr_wer, "mbr_word_errors": round(mbr_wer * n_words
                                                     / 100.0),
        "ref_words": n_words, "utterances": len(utts), "frames": frames,
        "hclg_states": hclg.num_states, "hclg_arcs": hclg.num_arcs(),
        "sizes": rep["sizes"], "context": rep["context"],
        "graph_t": g["report_t"]["sizes"]["HCLG.fst"],
        "corpus_fingerprint": fingerprint,
        "backend": jax.default_backend(), "graph_s": graph_s,
        "decode_s": decode_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
