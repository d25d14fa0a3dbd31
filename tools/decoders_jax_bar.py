#!/usr/bin/env python3
"""The bars of chip_smoke.py's decoder phases (dense_hclg,
beam_sparse_hclg, lazy_lm, incremental): the JAX package's decoders on
the CPU over the graphs that the port's tools build
(tools/mkgraph_steps.py), on the JAX package's loglikes.

The legacy graph and loglikes are tools/mkgraph_jax_bar.py's: the
default BenchCorpusSpec() corpus (V=200), its bigram G and HCLG through
mkgraph.sh's steps at the chain model's scales (14,710 states, 68,373
arcs), and the JAX package's ChainTdnnf over the committed
flagship_params.npz (17 x 1536, float32) on each of the 128 test
utterances (the int16 wire, the JAX frontend).  On them:

  dense        `DenseViterbiDecoder` over `DenseDeviceGraph.build(HCLG)`,
               the 128 utterances as lanes with their lengths;
  beam_sparse  `BeamSparseDecoder` at its defaults (beam 16, capacity
               2048) over `SparseDeviceGraph.build(HCLG)`, the lanes
               grouped by length (the reference has no lane lengths);
  lookahead    `LatticeFasterDecoder` (beams 15 / 8, 7000 active) over
               `LazyComposeFst(HCL, G)`, HCL being the same steps over a
               flat G (one state, every word at cost 0), as
               nnet3-latgen-faster-lookahead runs it, with the periodic
               link pruning off (the bar): the reference's periodic
               pruning measures a link against the frontier's best
               token and loses best paths (the port's pruning is
               upstream's, tests/test_torch_lattice_decoder.py
               test_reference_pruning_fault); at the default interval
               too, reported beside it;
  incremental  `LatticeIncrementalDecoder` (the same beams, 50-frame
               chunks) on the first INC_UTTS utterances, beside
               `LatticeFasterDecoder` over the HCLG: their best paths.

The template corpus (recipes/template_corpus.py, 112/32 utterances): the
lang, the MFCCs (--use-gpu=no), G from lm.arpa and G2 from its unigrams,
and the HCLG of tests/data/template_tri1 through the port's tools; then
the JAX package's gmm-latgen-faster over the HCLG and
gmm-latgen-biglm-faster from G to G2 (--acoustic-scale=0.1 --beam=16
--lattice-beam=6): their WERs.

Prints one JSON line of WERs, word errors and counts; --out DIR also
writes words.json there (each utterance's words of each search).

Run: JAX_PLATFORMS=cpu python tools/decoders_jax_bar.py [--out DIR]
     [--skip dense,beam_sparse,lookahead,incremental,template]
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

INC_UTTS = 32
LATGEN = dict(beam=15.0, lattice_beam=8.0, max_active=7000)
TEMPLATE_DECODE = ["--acoustic-scale=0.1", "--beam=16", "--lattice-beam=6"]


def template_bar(d: str) -> dict:
    """mkgraph_steps.template_graphs on the CPU; the JAX package's
    gmm-latgen-faster and gmm-latgen-biglm-faster (G to G2) over them ->
    their WERs."""
    from kaldi_tpu.cli import get_tool as jtool
    from kaldi_tpu.recipes.bench_corpus import wer_of
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from kaldi_tpu_torch.util.table import SequentialTableReader
    from mkgraph_steps import template_graphs
    t = template_graphs(d, "no")
    names = {i: w for w, i in
             read_symbol_table(os.path.join(t["lang"], "words.txt")).items()}
    refs = t["test_txt"]
    out = {"hclg": t["report"]["sizes"]["HCLG.fst"]}
    for key, tool, lms in (("latgen", "gmm-latgen-faster", []),
                           ("biglm", "gmm-latgen-biglm-faster",
                            [t["G"], t["G2"]])):
        words = os.path.join(d, f"{key}.words")
        argv = [tool, *TEMPLATE_DECODE, t["model"], t["hclg"], *lms,
                t["feats"], f"ark:{os.path.join(d, key + '.lat')}",
                f"ark,t:{words}"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            if jtool(tool)(argv) != 0:
                raise RuntimeError(f"{tool} failed\n{err.getvalue()}")
        hyps = {u: [names[w] for w in ws] for u, ws in
                SequentialTableReader("int-vector", f"ark:{words}")}
        wer = wer_of(hyps, refs)
        out[key] = {"wer": wer, "word_errors": round(
            wer * sum(len(r) for r in refs.values()) / 100.0),
            "utterances": len(hyps)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write words.json here")
    ap.add_argument("--skip", default="", help="comma-separated parts")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))
    import jax
    from kaldi_tpu.decoder.beam_sparse import (BeamSparseDecoder,
                                               SparseDeviceGraph)
    from kaldi_tpu.decoder.biglm import BackoffWordFst, LazyComposeFst
    from kaldi_tpu.decoder.dense_relax import (DenseDeviceGraph,
                                               DenseViterbiDecoder)
    from kaldi_tpu.decoder.incremental import LatticeIncrementalDecoder
    from kaldi_tpu.decoder.lattice_decoder import (
        LatticeFasterDecoder, LatticeFasterDecoderOptions)
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.lat.functions import lattice_best_path
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    from kaldi_tpu.recipes.bench_corpus import (
        BenchCorpusSpec, chain_tm_tree_for, corpus_fingerprint, load_params,
        make_corpus, mfcc_options, wer_of)
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from mkgraph_jax_bar import build_graph
    from mkgraph_steps import flat_g, mkgraph
    out, words_out, seconds = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="decoders_bar_")
    if "template" not in skip:
        t0 = time.time()
        out["template"] = template_bar(os.path.join(tmp, "template"))
        seconds["template"] = time.time() - t0
    t0 = time.time()
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, test_wav, lm_text = make_corpus(
        spec, train_audio=False)
    fingerprint = corpus_fingerprint(spec, lexicon, test_txt, test_wav,
                                     lm_text)
    _lang, tm, _tree = chain_tm_tree_for(lexicon)
    g = build_graph(tmp, lexicon, lm_text)
    hclg = read_fst_file(g["hclg"])
    names = {i: w for w, i in
             read_symbol_table(os.path.join(g["lang"], "words.txt")).items()}
    seconds["graph"] = time.time() - t0
    cfg = ChainTdnnfConfig(feat_dim=40, num_pdfs=tm.num_pdfs,
                           frame_subsampling_factor=3, hidden_dim=1536,
                           bottleneck_dim=160, prefinal_dim=256,
                           num_layers=17, subsample_layer=8)
    variables = load_params(os.path.join(REPO, "egs", "bench_corpus",
                                         "flagship_params.npz"))
    model = ChainTdnnf(cfg, train=False)
    forward = jax.jit(lambda v, f: model.apply(v, f)[0])
    fe = OfflineFeature(mfcc_options(spec, num_ceps=40))
    utts = sorted(test_wav)
    refs = {u: test_txt[u] for u in utts}
    n_words = sum(len(r) for r in refs.values())
    t0 = time.time()
    lls = {}
    for u in utts:
        wave = np.clip(test_wav[u], -32767, 32767).astype(np.int16)
        feats = fe.compute(wave.astype(np.float32))
        lls[u] = np.asarray(forward(variables, feats[None]))[0]
    seconds["forward"] = time.time() - t0
    tid2pdf = np.asarray(tm.id2pdf_id)

    def score(key: str, hyps: dict, extra=None) -> None:
        wer = wer_of(hyps, {u: refs[u] for u in hyps})
        n = sum(len(refs[u]) for u in hyps)
        out[key] = dict(extra or {}, wer=wer,
                        word_errors=round(wer * n / 100.0), ref_words=n,
                        utterances=len(hyps))
        words_out[key] = hyps

    if "dense" not in skip:
        t0 = time.time()
        dg = DenseDeviceGraph.build(hclg, tid2pdf, num_pdfs=tm.num_pdfs)
        T = max(len(v) for v in lls.values())
        batch = np.zeros((len(utts), T, tm.num_pdfs), np.float32)
        for i, u in enumerate(utts):
            batch[i, :len(lls[u])] = lls[u]
        res = DenseViterbiDecoder(dg).decode_batch(
            batch, 1.0, lengths=[len(lls[u]) for u in utts])
        score("dense", {u: [names[w] for w in r[0]] if r else []
                        for u, r in zip(utts, res)},
              {"costs": {u: r[2] for u, r in zip(utts, res) if r}})
        seconds["dense"] = time.time() - t0
    if "beam_sparse" not in skip:
        t0 = time.time()
        sg = SparseDeviceGraph.build(hclg, tid2pdf)
        dec = BeamSparseDecoder(sg)
        hyps, costs = {}, {}
        by_len = {}
        for u in utts:
            by_len.setdefault(len(lls[u]), []).append(u)
        for T, group in sorted(by_len.items()):
            res = dec.decode_batch(np.stack([lls[u] for u in group]), 1.0)
            for u, r in zip(group, res):
                hyps[u] = [names[w] for w in r[0]] if r else []
                if r:
                    costs[u] = r[2]
        score("beam_sparse", hyps, {"groups": len(by_len), "costs": costs,
                                    "states": sg.num_states,
                                    "eps_depth": sg.eps_depth})
        seconds["beam_sparse"] = time.time() - t0
    opts = LatticeFasterDecoderOptions(**LATGEN)
    if "lookahead" not in skip:
        t0 = time.time()
        hcl_dir = os.path.join(tmp, "hcl")
        os.makedirs(hcl_dir, exist_ok=True)
        gflat = flat_g(g["lang"], os.path.join(hcl_dir, "G_flat.fst"))
        rep = mkgraph(g["lang"], gflat, g["tree"], g["tm"], hcl_dir,
                      transition_scale=1.0, self_loop_scale=1.0)
        lazy = LazyComposeFst(read_fst_file(os.path.join(hcl_dir,
                                                         "HCLG.fst")),
                              BackoffWordFst(read_fst_file(g["G"])))
        by_interval = {}
        for interval in (0, opts.prune_interval):
            dec = LatticeFasterDecoder(lazy, LatticeFasterDecoderOptions(
                **LATGEN, prune_interval=interval))
            hyps = {}
            for u in utts:
                lat = dec.decode(lls[u], tid2pdf, 1.0)
                hyps[u] = [names[w] for w in lattice_best_path(lat)[1]] \
                    if lat is not None else []
            by_interval[interval] = hyps
        wer25 = wer_of(by_interval[opts.prune_interval], refs)
        score("lookahead", by_interval[0], {
            "hcl": rep["sizes"]["HCLG.fst"], "interned": len(lazy._keys),
            "prune_interval": 0,
            f"wer_prune_interval_{opts.prune_interval}": wer25,
            f"word_errors_prune_interval_{opts.prune_interval}": round(
                wer25 * n_words / 100.0)})
        seconds["lookahead"] = time.time() - t0
    if "incremental" not in skip:
        t0 = time.time()
        inc = LatticeIncrementalDecoder(hclg, opts, chunk_frames=50)
        ref = LatticeFasterDecoder(hclg, opts)
        hyps, differ, links = {}, {}, 0
        for u in utts[:INC_UTTS]:
            a = lattice_best_path(inc.decode(lls[u], tid2pdf, 1.0))
            links = max(links, inc.stats["max_chunk_links"])
            b = lattice_best_path(ref.decode(lls[u], tid2pdf, 1.0))
            hyps[u] = [names[w] for w in a[1]]
            if a[:2] != b[:2]:
                differ[u] = {"incremental_cost": a[2], "latgen_cost": b[2]}
        score("incremental", hyps, {"differ_from_latgen": differ,
                                    "max_chunk_links": links})
        seconds["incremental"] = time.time() - t0
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "words.json"), "w") as f:
            json.dump(words_out, f)
    print(json.dumps(dict(out, corpus_fingerprint=fingerprint,
                          hclg=[hclg.num_states, hclg.num_arcs()],
                          utterances=len(utts), ref_words=n_words,
                          backend=jax.default_backend(), seconds=seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
