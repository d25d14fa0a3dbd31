#!/usr/bin/env python3
"""The host lattice decode of nnet3-latgen-faster on the CPU, the JAX
package's against the port's, over the utterances chip_smoke.py's
xconfig_latgen decodes.

Builds what the online2 and xconfig phases build: the default
BenchCorpusSpec() corpus without training audio, chain_tm_tree_for's
transition model, the legacy graph's flat form (the HCLG.fst), and the
committed flagship_params.npz TDNN-F in float32 on the CPU, whose
outputs over the first --utts test utterances (int16 wire) are the
loglikes.  Then, at decode.sh's beams (15, lattice beam 8, max-active
7000):
  - the JAX package's LatticeFasterDecoder and determinize_lattice:
    seconds, raw lattice states, determinization fallbacks;
  - the same decoder without its periodic link pruning
    (prune_interval=0), where its pruning fault cannot bite;
  - the port's LatticeFasterDecoder and determinize_lattice: seconds,
    raw states, fallbacks, and whether each lattice, lattice_prune'd to
    the lattice beam, equals the unpruned JAX one up to a relabeling.
Prints one JSON line.  These are times on this machine's CPU, not the
card's.

Run: JAX_PLATFORMS=cpu python tools/latgen_cpu_probe.py [--utts 16]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    args = ap.parse_args(argv)

    from kaldi_tpu.decoder import lattice_decoder as JD
    from kaldi_tpu.lat import functions as JLF
    from kaldi_tpu_torch.decoder import lattice_decoder as TD
    from kaldi_tpu_torch.feat.frontend import OfflineFeature
    from kaldi_tpu_torch.lat import functions as TLF
    from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                              chain_tdnnf_from_flax)
    from kaldi_tpu_torch.recipes.bench_corpus import (BenchCorpusSpec,
                                                      build_decode_graph,
                                                      chain_tm_tree_for,
                                                      load_params,
                                                      make_corpus,
                                                      mfcc_options)
    from kaldi_tpu.fstext.openfst_io import read_fst_file as jax_read
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
    from test_torch_lattice_decoder import relabeled
    spec = BenchCorpusSpec()
    lexicon, _, _, _, test_wav, lm_text = make_corpus(spec,
                                                      train_audio=False)
    lang, tm, tree = chain_tm_tree_for(lexicon)
    flat = build_decode_graph(lexicon, lm_text, tm, tree,
                              lang=lang).to_flat_graph().to_vector_fst()
    with tempfile.TemporaryDirectory() as tmp:
        hclg = os.path.join(tmp, "HCLG.fst")
        with open(hclg, "wb") as f:
            write_fst(f, flat)
        fst, jfst = read_fst_file(hclg), jax_read(hclg)
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0, num_pdfs=tm.num_pdfs)
    model = chain_tdnnf_from_flax(cfg, load_params(os.path.join(
        REPO, "egs", "bench_corpus", "flagship_params.npz")), device="cpu")
    fe = OfflineFeature(mfcc_options(spec, 40), device="cpu")
    loglikes = []
    with torch.no_grad():
        for u in sorted(test_wav)[:args.utts]:
            f, n = fe.compute_batch_device(
                [np.clip(test_wav[u], -32767, 32767).astype(np.int16)])
            loglikes.append(model.chain(f[:, :int(n[0])])[0].numpy())
    tid2pdf = np.asarray(tm.id2pdf_id)
    beams = dict(beam=15.0, lattice_beam=8.0, max_active=7000)
    out = {"utterances": len(loglikes),
           "frames": int(sum(len(x) for x in loglikes)), "beams": beams}
    runs = {"jax": JD.LatticeFasterDecoder(
                jfst, JD.LatticeFasterDecoderOptions(**beams)),
            "jax_no_periodic_pruning": JD.LatticeFasterDecoder(
                jfst, JD.LatticeFasterDecoderOptions(prune_interval=0,
                                                     **beams)),
            "port": TD.LatticeFasterDecoder(
                fst, TD.LatticeFasterDecoderOptions(**beams))}
    lats = {}
    for name, dec in runs.items():
        t0 = time.perf_counter()
        lats[name] = [dec.decode(ll, tid2pdf, 1.0) for ll in loglikes]
        search_s = time.perf_counter() - t0
        det = JLF if name.startswith("jax") else TLF
        t0 = time.perf_counter()
        fallbacks = sum(det.determinize_lattice(lat) is lat
                        for lat in lats[name])
        out[name] = {"search_s": search_s,
                     "search_ms_a_frame": 1e3 * search_s / out["frames"],
                     "determinize_s": time.perf_counter() - t0,
                     "det_fallbacks": fallbacks,
                     "raw_states": sum(lat.num_states
                                       for lat in lats[name])}
    out["port_equal_jax_no_periodic_pruning"] = sum(
        relabeled(TLF.lattice_prune(p, beams["lattice_beam"]))
        == relabeled(JLF.lattice_prune(j, beams["lattice_beam"]))
        for p, j in zip(lats["port"], lats["jax_no_periodic_pruning"]))
    out["jax_best_cost_above_port"] = sum(
        JLF.lattice_best_path(j)[2] > TLF.lattice_best_path(p)[2] + 1e-4
        for p, j in zip(lats["port"], lats["jax"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
