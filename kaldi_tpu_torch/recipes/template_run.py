"""The generic corpus recipe over standard Kaldi data directories, stages
0-5 (port of `egs/template/run.py`; the egs/*/s5 stage structure,
mini_librispeech-shaped):

  stage 0: validate the data dirs, prepare the lang dir from the lexicon
  stage 1: MFCC features (and CMVN stats)
  stage 2: monophone training (flat start + EM, through the tools)
  stage 3: triphone training (train_deltas in process: tree stats, the
           tree, EM with realignment)
  stage 4: the decoding graph (G compiled from an ARPA LM, the HCLG)
  stage 5: decode (gmm-latgen-faster) and the lm-scale x penalty sweep

Point it at directories in the standard layout (wav.scp, text, utt2spk;
lexicon.txt 'WORD p1 p2 ...'; an ARPA LM):

  python -m kaldi_tpu_torch.recipes.template_run --train data/train \\
      --test data/test --lexicon data/local/lexicon.txt \\
      --arpa data/local/lm.arpa --dir exp [--use-gpu=no]

The tools run in process through `kaldi_tpu_torch.cli.get_tool`, as the
reference's `sh` runs them; MFCC and the GMM log-likelihoods are on the
card unless --use-gpu=no.  `main` returns stage 5's best WER and writes
tri1/hyp.txt.  Stages 6-8 (LDA+MLLT, SAT, the flat-start chain model)
are not ported: --stage 6 or higher raises.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import sys
import time
from typing import Dict, List, Optional

from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

LM_SCALES = (0.5, 1.0, 1.5, 2.0)
PENALTIES = (0.0, 0.5, 1.0)


class _Run:
    """Runs tools in process and keeps what the run reports: each
    stage's and each tool's seconds, each tool's `<tool> stats {...}`
    line, the utterances aligned in each pass and the aligner's failures
    in process."""

    def __init__(self):
        self.report: Dict = {"stage_s": {}, "tool_s": {}, "tool_stats": {},
                             "aligned": [], "align_failures": 0}

    def sh(self, tool: str, *args) -> str:
        """Run `tool`; its stderr is passed through (and returned), its
        stats line kept.  A status other than 0 raises."""
        err = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                rc = get_tool(tool)([tool] + [str(a) for a in args])
        finally:
            sys.stderr.write(err.getvalue())
        tool_s = self.report["tool_s"]
        tool_s[tool] = tool_s.get(tool, 0.0) + time.perf_counter() - t0
        text = err.getvalue()
        m = re.search(re.escape(tool) + r" stats (\{.*\})", text)
        if m:
            self.report["tool_stats"][tool] = json.loads(m.group(1))
        if rc != 0:
            raise SystemExit(f"{tool} failed with status {rc}")
        return text


class _CountFailures(logging.Handler):
    def __init__(self, report: Dict):
        super().__init__(logging.WARNING)
        self.report = report

    def emit(self, record: logging.LogRecord) -> None:
        if record.getMessage().startswith("alignment failed"):
            self.report["align_failures"] += 1


def read_texts(data_dir: str) -> Dict[str, List[str]]:
    out = {}
    with open(os.path.join(data_dir, "text")) as f:
        for line in f:
            parts = line.split()
            out[parts[0]] = parts[1:]
    return out


def read_lexicon(path: str) -> Dict[str, List[List[str]]]:
    lexicon: Dict[str, List[List[str]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                lexicon.setdefault(parts[0], []).append(parts[1:])
    return lexicon


def _count(rspecifier: str, holder: str = "int-vector") -> int:
    return sum(1 for _ in SequentialTableReader(holder, rspecifier))


def main(argv: Optional[List[str]] = None,
         report: Optional[Dict] = None) -> float:
    """Runs stages --stage..5; returns stage 5's best WER.  `report`, if
    given, receives the run's seconds and counters (see `_Run`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", required=True)
    ap.add_argument("--test", required=True)
    ap.add_argument("--lexicon", required=True)
    ap.add_argument("--arpa", required=True)
    ap.add_argument("--dir", default="exp")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--sample-frequency", type=float, default=8000.0)
    ap.add_argument("--num-leaves", type=int, default=100)
    ap.add_argument("--tot-gauss", type=int, default=200)
    ap.add_argument("--chain-epochs", type=int, default=0,
                    help="stage 8's epochs (not ported; must stay 0)")
    ap.add_argument("--use-gpu", default="yes", choices=("yes", "no"),
                    help="yes: MFCC and GMM scoring on the CUDA card "
                    "(fail without one); no: on the CPU")
    args = ap.parse_args(argv)
    if args.stage >= 6 or args.chain_epochs:
        raise NotImplementedError(
            "stages 6-8 of egs/template/run.py (LDA+MLLT, SAT, the "
            "flat-start chain model) are not ported yet (ROADMAP item 14)")
    run = _Run()
    if report is not None:
        report.update(run.report)
        run.report = report
    sh = run.sh
    gpu = f"--use-gpu={args.use_gpu}"
    device = "cpu" if args.use_gpu == "no" else None
    d = args.dir
    os.makedirs(d, exist_ok=True)
    lang = os.path.join(d, "lang")
    mono = os.path.join(d, "mono")
    tri1 = os.path.join(d, "tri1")
    stage_s = run.report["stage_s"]

    if args.stage <= 0:
        print("=== stage 0: validate + prepare_lang ===")
        t0 = time.perf_counter()
        sh("validate-data-dir", args.train)
        sh("validate-data-dir", args.test)
        sh("prepare-lang", args.lexicon, lang)
        sh("validate-lang", lang)
        stage_s["0"] = time.perf_counter() - t0

    if args.stage <= 1:
        print("=== stage 1: features ===")
        t0 = time.perf_counter()
        for sd in (args.train, args.test):
            sh("compute-mfcc-feats", gpu,
               f"--sample-frequency={args.sample_frequency}", "--dither=0",
               f"scp:{sd}/wav.scp", f"ark,scp:{sd}/feats.ark,{sd}/feats.scp")
            sh("compute-cmvn-stats", f"ark:{sd}/feats.ark",
               f"ark:{sd}/cmvn.ark")
        stage_s["1"] = time.perf_counter() - t0

    if args.stage <= 2:
        print("=== stage 2: mono ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
        os.makedirs(mono, exist_ok=True)
        words = read_symbol_table(os.path.join(lang, "words.txt"))
        with TableWriter("int-vector", f"ark:{args.train}/text.int") as w:
            for utt, toks in read_texts(args.train).items():
                w.write(utt, [words[t] for t in toks])
        dim = 13
        sh("gmm-init-mono", f"--train-feats=ark:{args.train}/feats.ark",
           f"{lang}/topo", dim, f"{mono}/0.mdl", f"{mono}/tree")
        sh("compile-train-graphs", "--self-loop-scale=0.1",
           f"{mono}/tree", f"{mono}/0.mdl", f"{lang}/L_disambig.fst",
           f"ark:{args.train}/text.int", f"ark:{mono}/graphs.ark")
        sh("align-equal-compiled", f"ark:{mono}/graphs.ark",
           f"ark:{args.train}/feats.ark", f"ark:{mono}/ali.ark")
        sh("gmm-acc-stats-ali", f"{mono}/0.mdl",
           f"ark:{args.train}/feats.ark", f"ark:{mono}/ali.ark",
           f"{mono}/0.acc")
        sh("gmm-est", "--min-gaussian-occupancy=3",
           f"--mix-up={args.tot_gauss // 4}",
           f"{mono}/0.mdl", f"{mono}/0.acc", f"{mono}/1.mdl")
        n_train = _count(f"ark:{args.train}/text.int")
        mdl = "1.mdl"
        for it in range(1, 7):
            sh("gmm-align-compiled", gpu, "--beam=10", "--acoustic-scale=0.1",
               f"{mono}/{mdl}", f"ark:{mono}/graphs.ark",
               f"ark:{args.train}/feats.ark", f"ark:{mono}/ali.ark")
            n_ali = _count(f"ark:{mono}/ali.ark")
            run.report["aligned"].append(n_ali)
            run.report["align_failures"] += n_train - n_ali
            sh("gmm-acc-stats-ali", f"{mono}/{mdl}",
               f"ark:{args.train}/feats.ark", f"ark:{mono}/ali.ark",
               f"{mono}/{it}.acc")
            sh("gmm-est", "--min-gaussian-occupancy=3",
               f"--mix-up={args.tot_gauss // 2}",
               f"{mono}/{mdl}", f"{mono}/{it}.acc", f"{mono}/{it + 1}.mdl")
            mdl = f"{it + 1}.mdl"
        os.replace(os.path.join(mono, mdl), os.path.join(mono, "final.mdl"))
        sh("gmm-info", f"{mono}/final.mdl")
        stage_s["2"] = time.perf_counter() - t0

    if args.stage <= 3:
        print("=== stage 3: tri1 (deltas) ===")
        t0 = time.perf_counter()
        # the reference drives this from steps/train_deltas.sh; here the
        # equivalent recipe (recipes/deltas.py) over the same artifacts
        from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm, write_am_gmm
        from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
        from kaldi_tpu_torch.recipes.deltas import (TrainDeltasOptions,
                                                    train_deltas)
        from kaldi_tpu_torch.recipes.mono import MonoSystem, _align_all
        from kaldi_tpu_torch.tree.context_dep import ContextDependency
        from kaldi_tpu_torch.util import kaldi_io
        os.makedirs(tri1, exist_ok=True)
        lang_obj = Lang(read_lexicon(args.lexicon), sil_phone="SIL",
                        sil_prob=0.5)
        tm, am = read_am_gmm(f"{mono}/final.mdl", device=device)
        lang_obj.topo = tm.topo
        tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                          f"{mono}/tree")
        mono_sys = MonoSystem(lang_obj, tree, tm, am)
        feats = dict(SequentialTableReader(
            "matrix", f"ark:{args.train}/feats.ark"))
        texts = read_texts(args.train)
        compiler = TrainingGraphCompiler(tm, tree, lang_obj)
        graphs = {u: compiler.compile(texts[u]) for u in feats}
        counter = _CountFailures(run.report)
        mono_log = logging.getLogger("kaldi_tpu_torch.recipes.mono")
        mono_log.addHandler(counter)
        try:
            ali = _align_all(mono_sys, graphs, feats, 10.0, 0.1, 1.0)
            run.report["aligned"].append(len(ali))
            tri_sys = train_deltas(
                lang_obj, feats, texts, mono_sys, ali,
                TrainDeltasOptions(num_leaves=args.num_leaves,
                                   totgauss=args.tot_gauss))
        finally:
            mono_log.removeHandler(counter)
        write_am_gmm(f"{tri1}/final.mdl", tri_sys.tm, tri_sys.am)
        kaldi_io.write_kaldi_object(tri_sys.tree.write, f"{tri1}/tree")
        stage_s["3"] = time.perf_counter() - t0

    if args.stage <= 4:
        print("=== stage 4: graph (ARPA G) ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
        from kaldi_tpu_torch.decoder.graph import Lang, make_decoding_graph
        from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
        from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
        from kaldi_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa
        from kaldi_tpu_torch.tree.context_dep import ContextDependency
        from kaldi_tpu_torch.util import kaldi_io
        words = read_symbol_table(os.path.join(lang, "words.txt"))
        with open(args.arpa) as f:
            lm = parse_arpa(f.read())
        with open(os.path.join(lang, "G.fst"), "wb") as f:
            write_fst(f, arpa_to_fst(lm, words))
        lang_obj = Lang(read_lexicon(args.lexicon), sil_phone="SIL",
                        sil_prob=0.5)
        tm, _am = read_am_gmm(f"{tri1}/final.mdl", device="cpu")
        lang_obj.topo = tm.topo
        tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                          f"{tri1}/tree")
        gfst = read_fst_file(os.path.join(lang, "G.fst"))
        hclg = make_decoding_graph(lang_obj, gfst, tree, tm)
        with open(os.path.join(tri1, "HCLG.fst"), "wb") as f:
            write_fst(f, hclg)
        run.report["hclg_states"] = hclg.num_states
        run.report["hclg_arcs"] = hclg.num_arcs()
        stage_s["4"] = time.perf_counter() - t0

    print("=== stage 5: decode + score ===")
    t0 = time.perf_counter()
    sh("gmm-latgen-faster", gpu, "--acoustic-scale=0.1", "--beam=16",
       "--lattice-beam=6",
       f"{tri1}/final.mdl", f"{tri1}/HCLG.fst",
       f"ark:{args.test}/feats.ark", f"ark:{tri1}/lat.ark")
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from kaldi_tpu_torch.lat.functions import (add_word_ins_penalty,
                                               lattice_best_path,
                                               lattice_scale)
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.util.edit_distance import WerStats
    words = read_symbol_table(os.path.join(lang, "words.txt"))
    names = {i: w for w, i in words.items()}
    refs = read_texts(args.test)
    lats = dict(SequentialTableReader(LatticeHolder(),
                                      f"ark:{tri1}/lat.ark"))
    best = None
    best_hyps = None
    for lm_scale in LM_SCALES:
        for wip in PENALTIES:
            stats = WerStats()
            hyps = {}
            for utt, lat in lats.items():
                scaled = add_word_ins_penalty(
                    lattice_scale(lat, lm_scale=lm_scale), wip)
                _, wids, _ = lattice_best_path(scaled)
                hyps[utt] = [names[i] for i in wids]
                stats.add(refs[utt], hyps[utt])
            if best is None or stats.wer < best[0].wer:
                best = (stats, lm_scale, wip)
                best_hyps = hyps
    stats, lm_scale, wip = best
    print(f"best scoring: lm-scale {lm_scale} penalty {wip}")
    with TableWriter("token-vector", f"ark:{tri1}/hyp.txt") as w:
        for utt, toks in best_hyps.items():
            w.write(utt, toks)
    sh("compute-wer", "--mode=present", f"ark:{args.test}/text",
       f"ark:{tri1}/hyp.txt")
    stage_s["5"] = time.perf_counter() - t0
    run.report.update(wer=stats.wer, word_errors=stats.errors,
                      ref_words=stats.ref_words, lattices=len(lats),
                      lm_scale=lm_scale, penalty=wip)
    return stats.wer


if __name__ == "__main__":
    print(f"%WER {main():.2f}")
