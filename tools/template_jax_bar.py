#!/usr/bin/env python3
"""The generic corpus recipe, egs/template/run.py, with the JAX package on
the CPU: the bars that the PyTorch port's `template_gmm`,
`template_lda_sat` and `template_chain_e2e` phases (chip_smoke.py) are
held to.

Writes the fabricated corpus of `kaldi_tpu_torch/recipes/template_corpus.py`
(112 train and 32 test utterances by default) and runs the reference's
recipe over it with the recipe's own defaults (--num-leaves 100
--tot-gauss 200, 13 cepstra), through stage 7 (what the recipe runs by
default), then stage 8 alone on the same directory with --chain-epochs N:

  stage 0  validate-data-dir, prepare-lang, validate-lang
  stage 1  compute-mfcc-feats, compute-cmvn-stats
  stage 2  the mono GMM through the tools
  stage 3  tri1 (train_deltas in process)
  stage 4  G from the ARPA LM, the HCLG
  stage 5  gmm-latgen-faster and the lm-scale x penalty sweep
  stage 6  tri2: LDA+MLLT on tri1's alignments, decoded
  stage 7  tri3: SAT, the two-pass fMLLR decode
  stage 8  the flat-start e2e chain TDNN-F, decoded

Prints one JSON line: the WER and word errors of stages 5-8 (stages 5-7
from the recipe's tri1, tri2 and tri3 hyp.txt against the test text,
stage 8 from the recipe's report line), stage 5's best lm-scale and
penalty, the HCLG's states and arcs, the pdfs and Gaussians of
mono, tri1, tri2 and tri3, final.mat's shape, the number of train
speaker transforms, stage 8's epoch objectives, and each stage's
seconds.  With --chain-epochs 0 it stops after stage 7.

Run: JAX_PLATFORMS=cpu python tools/template_jax_bar.py [--out DIR]
     [--chain-epochs N] [--stage S]
(--stage 8 --out DIR reuses a directory that stages 0-7 filled.)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--n-train", type=int, default=112)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--chain-epochs", type=int, default=10)
    ap.add_argument("--stage", type=int, default=0,
                    help="0: stages 0-7, then stage 8; 8: stage 8 alone")
    args = ap.parse_args()
    import numpy as np

    import run as template_run
    from kaldi_tpu.base import io_funcs as iof
    from kaldi_tpu.cli.gmm_tools import read_am_gmm
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.recipes import chain as jchain
    from kaldi_tpu.recipes import lda_mllt
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.edit_distance import WerStats
    from kaldi_tpu.util.table import SequentialTableReader
    from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

    root = args.out or tempfile.mkdtemp(prefix="template_bar_")
    if args.stage == 0:
        make_standard_corpus(root, args.n_train, args.n_test)
    marks = []
    said = []

    def staged_print(*a, **kw):
        msg = " ".join(str(x) for x in a)
        m = re.match(r"=== stage (\d+)", msg)
        if m:
            marks.append((int(m.group(1)), time.perf_counter()))
        said.append(msg)
        print(*a, **kw, file=sys.stderr)

    epoch_objf = []
    chain_log = jchain.log

    def chain_log_kept(msg):
        m = re.match(r"chain-e2e epoch \d+: objf/frame (\S+)", msg)
        if m:
            epoch_objf.append(float(m.group(1)))
        chain_log(msg)

    sat = {}
    train_sat = lda_mllt.train_sat

    def train_sat_kept(*a, **kw):
        sys_, transforms = train_sat(*a, **kw)
        sat["speakers"] = len(transforms)
        return sys_, transforms

    template_run.print = staged_print
    jchain.log = chain_log_kept
    lda_mllt.train_sat = train_sat_kept
    argv = ["--train", os.path.join(root, "train"),
            "--test", os.path.join(root, "test"),
            "--lexicon", os.path.join(root, "lexicon.txt"),
            "--arpa", os.path.join(root, "lm.arpa"),
            "--dir", os.path.join(root, "exp")]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        if args.stage == 0:
            template_run.main(argv)
        if args.chain_epochs:
            chain_wer = template_run.main(
                argv + ["--stage", "8",
                        "--chain-epochs", str(args.chain_epochs)])
    t_end = time.perf_counter()
    exp = os.path.join(root, "exp")
    refs = dict(SequentialTableReader("token-vector",
                                      f"ark:{root}/test/text"))
    out = {"n_train": args.n_train, "n_test": args.n_test}
    if args.stage == 0:
        for stage, name in ((5, "tri1"), (6, "tri2"), (7, "tri3")):
            hyps = dict(SequentialTableReader(
                "token-vector", f"ark:{exp}/{name}/hyp.txt"))
            stats = WerStats()
            for utt, ref in refs.items():
                stats.add(ref, hyps.get(utt, []))
            out[f"stage{stage}"] = {"wer": stats.wer,
                                    "word_errors": stats.errors,
                                    "ref_words": stats.ref_words}
        best = re.search(r"best scoring: lm-scale (\S+) penalty (\S+)",
                         "\n".join(said))
        out["lm_scale"] = float(best.group(1)) if best else None
        out["penalty"] = float(best.group(2)) if best else None
        hclg = read_fst_file(os.path.join(exp, "tri1", "HCLG.fst"))
        out.update(hclg_states=hclg.num_states, hclg_arcs=hclg.num_arcs())
        for name in ("mono", "tri1", "tri2", "tri3"):
            _tm, am = read_am_gmm(os.path.join(exp, name, "final.mdl"))
            out[name] = {"pdfs": am.num_pdfs, "gaussians": am.num_gauss()}
        mat = kaldi_io.read_kaldi_object(
            iof.read_matrix, os.path.join(exp, "tri2", "final.mat"))
        out["final_mat"] = list(np.shape(mat))
        out["train_speaker_transforms"] = sat.get("speakers")
    if args.chain_epochs:
        line = [s for s in said if s.startswith("chain (e2e flat-start)")]
        m = re.search(r"%WER \S+ \[ (\d+) / (\d+)", line[-1])
        out["stage8"] = {"wer": chain_wer, "word_errors": int(m.group(1)),
                         "ref_words": int(m.group(2)),
                         "chain_epochs": args.chain_epochs,
                         "epoch_objf": epoch_objf}
    stage_s = {}
    ends = [t for _, t in marks[1:]] + [t_end]
    for (st, start), end in zip(marks, ends):
        stage_s[str(st)] = end - start
    out.update(stage_s=stage_s, seconds=t_end - t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
