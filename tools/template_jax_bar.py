#!/usr/bin/env python3
"""The generic corpus recipe, egs/template/run.py stages 0-5, with the JAX
package on the CPU: the bar that the PyTorch port's `template_gmm` phase
(chip_smoke.py) is held to.

Writes the fabricated corpus of `kaldi_tpu_torch/recipes/template_corpus.py`
(112 train and 32 test utterances by default), runs the reference's
recipe over it with the recipe's own defaults (--num-leaves 100
--tot-gauss 200, 13 cepstra, deltas) and stops when stage 6 begins:

  stage 0  validate-data-dir, prepare-lang, validate-lang
  stage 1  compute-mfcc-feats, compute-cmvn-stats
  stage 2  the mono GMM through the tools
  stage 3  tri1 (train_deltas in process)
  stage 4  G from the ARPA LM, the HCLG
  stage 5  gmm-latgen-faster and the lm-scale x penalty sweep

Prints one JSON line: the best WER and its word errors (from the
recipe's tri1/hyp.txt against the test text), the best lm-scale and
penalty, the HCLG's states and arcs, the pdfs and Gaussians of
mono/final.mdl and tri1/final.mdl, and each stage's seconds.

Run: JAX_PLATFORMS=cpu python tools/template_jax_bar.py [--out DIR]
"""

import argparse
import contextlib
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "egs", "template"))


class _Stage6(Exception):
    pass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--n-train", type=int, default=112)
    ap.add_argument("--n-test", type=int, default=32)
    args = ap.parse_args()
    import run as template_run
    from kaldi_tpu.cli.gmm_tools import read_am_gmm
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.util.edit_distance import WerStats
    from kaldi_tpu.util.table import SequentialTableReader
    from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

    root = args.out or tempfile.mkdtemp(prefix="template_bar_")
    make_standard_corpus(root, args.n_train, args.n_test)
    marks = []
    said = []

    def staged_print(*a, **kw):
        msg = " ".join(str(x) for x in a)
        m = re.match(r"=== stage (\d+)", msg)
        if m:
            marks.append((int(m.group(1)), time.perf_counter()))
            if int(m.group(1)) >= 6:
                raise _Stage6()
        said.append(msg)
        print(*a, **kw, file=sys.stderr)

    template_run.print = staged_print
    t0 = time.perf_counter()
    argv = ["--train", os.path.join(root, "train"),
            "--test", os.path.join(root, "test"),
            "--lexicon", os.path.join(root, "lexicon.txt"),
            "--arpa", os.path.join(root, "lm.arpa"),
            "--dir", os.path.join(root, "exp")]
    try:
        with contextlib.redirect_stdout(sys.stderr):
            template_run.main(argv)
    except _Stage6:
        pass
    t_end = marks[-1][1] if marks and marks[-1][0] >= 6 \
        else time.perf_counter()
    exp = os.path.join(root, "exp")
    refs = dict(SequentialTableReader("token-vector",
                                      f"ark:{root}/test/text"))
    hyps = dict(SequentialTableReader("token-vector",
                                      f"ark:{exp}/tri1/hyp.txt"))
    stats = WerStats()
    for utt, ref in refs.items():
        stats.add(ref, hyps.get(utt, []))
    best = re.search(r"best scoring: lm-scale (\S+) penalty (\S+)",
                     "\n".join(said))
    hclg = read_fst_file(os.path.join(exp, "tri1", "HCLG.fst"))
    models = {}
    for name in ("mono", "tri1"):
        _tm, am = read_am_gmm(os.path.join(exp, name, "final.mdl"))
        models[name] = {"pdfs": am.num_pdfs, "gaussians": am.num_gauss()}
    stage_s = {}
    ends = [t for _, t in marks[1:]] + [t_end]
    for (st, start), end in zip(marks, ends):
        if st <= 5:
            stage_s[str(st)] = end - start
    print(json.dumps({
        "wer": stats.wer, "word_errors": stats.errors,
        "ref_words": stats.ref_words,
        "lm_scale": float(best.group(1)) if best else None,
        "penalty": float(best.group(2)) if best else None,
        "hclg_states": hclg.num_states, "hclg_arcs": hclg.num_arcs(),
        "mono": models["mono"], "tri1": models["tri1"],
        "n_train": args.n_train, "n_test": args.n_test,
        "stage_s": stage_s, "seconds": t_end - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
