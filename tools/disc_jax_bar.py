#!/usr/bin/env python3
"""Sequence-discriminative (sMBR) training through the JAX package's
nnet3-discriminative-train, once, on the CPU: the WER bar that the
PyTorch port's `disc_smbr` phase (chip_smoke.py) is held to.

Reads what `chip_main_path.py --disc` exports from the card
(_chip/disc_smbr/: the 32 training utterances' features, their
nnet3-align-compiled alignments and nnet3-latgen-faster denominator
lattices, the 16 test utterances' features, final.tm and the legacy
HCLG.fst), so that the JAX trainer reads the same bytes as the port's.
The starting checkpoint is the one `xconfig_graph` writes: the legacy
17 x 1536 TDNN-F (egs/bench_corpus/flagship_params.npz) as
chain_tdnnf_xconfig text, saved here as a JAX orbax checkpoint with the
same arrays.  Then:

  nnet3-discriminative-train --criterion=smbr --num-epochs=2
  --learning-rate=1e-6 --acoustic-scale=1.0 (the JAX tool, in this
  process; --learning-rate N trains at another rate)

and the tuned weights, converted by tools/jax_checkpoint_to_torch.py,
decoded over the 16 test utterances by the port's nnet3-latgen-faster
(--use-gpu=no, disc_smbr's beams): the JAX package's own latgen keeps
its link-pruning fault (ROADMAP.md section 3).  The untuned checkpoint
is decoded the same way.  Prints one JSON line: both WERs and word
errors, JAX's epoch objectives, the card's (from the export) and the
seconds.

Run: JAX_PLATFORMS=cpu python tools/disc_jax_bar.py [--dir DIR]
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# chip_smoke.py's LATGEN_ARGS, DISC_EPOCHS and DISC_LEARNING_RATE
LATGEN_ARGS = ["--beam=15", "--lattice-beam=8", "--max-active=7000",
               "--acoustic-scale=1.0"]
EPOCHS = 2
LEARNING_RATE = 1e-6


def run(get_tool, tool, *args) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = get_tool(tool)([tool] + [str(a) for a in args])
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}:\n{err.getvalue()[-4000:]}")
    return err.getvalue()


def decode(port_tool, d, ckpt, words, test_txt) -> dict:
    """The port's nnet3-latgen-faster of the export's test features with
    the checkpoint `ckpt` -> its WER."""
    from kaldi_tpu_torch.recipes.bench_corpus import wer_of
    from kaldi_tpu_torch.util.table import SequentialTableReader
    hyp = ckpt + ".int"
    run(port_tool, "nnet3-latgen-faster", "--use-gpu=no", *LATGEN_ARGS,
        os.path.join(d, "final.tm"), ckpt, os.path.join(d, "HCLG.fst"),
        f"ark:{os.path.join(d, 'test_feats.ark')}", "ark:/dev/null",
        f"ark,t:{hyp}")
    got = {k: list(v) for k, v in SequentialTableReader("int-vector",
                                                         f"ark:{hyp}")}
    utts = sorted(got)
    refs = {u: test_txt[u] for u in utts}
    names = {u: [words[w] for w in got[u]] for u in utts}
    wer = wer_of(names, refs)
    return {"wer": wer, "utterances": len(utts),
            "word_errors": round(wer * sum(len(r) for r in refs.values())
                                 / 100.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=os.path.join(REPO, "_chip",
                                                  "disc_smbr"),
                    help="the export of chip_main_path.py --disc")
    ap.add_argument("--learning-rate", type=float, default=LEARNING_RATE,
                    help="nnet3-discriminative-train's --learning-rate")
    args = ap.parse_args()
    d = os.path.abspath(args.dir)
    t_all = time.perf_counter()
    from kaldi_tpu.cli import get_tool as jax_tool
    from kaldi_tpu.parallel.checkpoint import save_checkpoint as jax_save
    from kaldi_tpu_torch.cli import get_tool as port_tool
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    from kaldi_tpu_torch.nnet3.models import ChainTdnnfConfig
    from kaldi_tpu_torch.nnet3.xconfig import (
        chain_tdnnf_variables_to_xconfig, chain_tdnnf_xconfig)
    from kaldi_tpu_torch.parallel.checkpoint import save_checkpoint
    from kaldi_tpu_torch.recipes.bench_corpus import (
        BenchCorpusSpec, build_decode_graph, chain_tm_tree_for, load_params,
        make_corpus)
    tm = read_kaldi_object(TransitionModel.read,
                           os.path.join(d, "final.tm"))
    cfg = ChainTdnnfConfig(feat_dim=40, ivector_dim=0, num_pdfs=tm.num_pdfs,
                           hidden_dim=1536, bottleneck_dim=160,
                           prefinal_dim=256, num_layers=17,
                           subsample_layer=8, frame_subsampling_factor=3)
    text = chain_tdnnf_xconfig(cfg)
    variables = chain_tdnnf_variables_to_xconfig(load_params(os.path.join(
        REPO, "egs", "bench_corpus", "flagship_params.npz")))
    # the test transcripts and the graph's words, as online2_graph makes
    # them
    spec = BenchCorpusSpec()
    lexicon, _, _, test_txt, _, lm_text = make_corpus(spec,
                                                      train_audio=False)
    lang, ctm, ctree = chain_tm_tree_for(lexicon)
    words = build_decode_graph(lexicon, lm_text, ctm, ctree,
                               lang=lang).to_flat_graph().words
    with tempfile.TemporaryDirectory() as tmp:
        jax_in, jax_out = os.path.join(tmp, "jax_in"), os.path.join(
            tmp, "jax_out")
        port_in, port_out = os.path.join(tmp, "untuned"), os.path.join(
            tmp, "tuned")
        jax_save(jax_in, variables, 0, extra={"xconfig": text})
        save_checkpoint(port_in, variables, 0, extra={"xconfig": text})
        t0 = time.perf_counter()
        log = run(jax_tool, "nnet3-discriminative-train", "--criterion=smbr",
                  f"--num-epochs={EPOCHS}", "--acoustic-scale=1.0",
                  f"--learning-rate={args.learning_rate}", jax_in,
                  os.path.join(d, "final.tm"),
                  f"ark:{os.path.join(d, 'feats.ark')}",
                  f"ark:{os.path.join(d, 'ali.ark')}",
                  f"ark:{os.path.join(d, 'lat.ark')}", jax_out)
        train_s = time.perf_counter() - t0
        objf = [float(ln.rsplit(" ", 1)[1]) for ln in log.splitlines()
                if "objf/frame" in ln]
        spec_conv = importlib.util.spec_from_file_location(
            "jax_checkpoint_to_torch",
            os.path.join(REPO, "tools", "jax_checkpoint_to_torch.py"))
        conv = importlib.util.module_from_spec(spec_conv)
        spec_conv.loader.exec_module(conv)
        conv.convert(jax_out, port_out)
        t0 = time.perf_counter()
        tuned = decode(port_tool, d, port_out, words, test_txt)
        untuned = decode(port_tool, d, port_in, words, test_txt)
        decode_s = time.perf_counter() - t0
    card = {}
    meta = os.path.join(d, "train_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            card = json.load(f)
    print(json.dumps({"learning_rate": args.learning_rate,
                      "jax_tuned": tuned, "untuned": untuned,
                      "jax_epoch_objf": objf, "card": card,
                      "train_s": train_s, "decode_s": decode_s,
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
