"""The generic corpus recipe over standard Kaldi data directories (port of
`egs/template/run.py`; the egs/*/s5 stage structure,
mini_librispeech-shaped):

  stage 0: validate the data dirs, prepare the lang dir from the lexicon
  stage 1: MFCC features (and CMVN stats)
  stage 2: monophone training (flat start + EM, through the tools)
  stage 3: triphone training (train_deltas in process: tree stats, the
           tree, EM with realignment)
  stage 4: the decoding graph (G compiled from an ARPA LM, the HCLG)
  stage 5: decode (gmm-latgen-faster) and the lm-scale x penalty sweep
  stage 6: tri2, LDA+MLLT training on tri1's alignments, and its decode
  stage 7: tri3, SAT (per-speaker fMLLR) and the two-pass adapted decode
  stage 8: the flat-start e2e LF-MMI TDNN-F and its decode
           (with --chain-epochs N)

Point it at directories in the standard layout (wav.scp, text, utt2spk;
lexicon.txt 'WORD p1 p2 ...'; an ARPA LM):

  python -m kaldi_tpu_torch.recipes.template_run --train data/train \\
      --test data/test --lexicon data/local/lexicon.txt \\
      --arpa data/local/lm.arpa --dir exp [--chain-epochs N] [--use-gpu=no]

The tools run in process through `kaldi_tpu_torch.cli.get_tool`, as the
reference's `sh` runs them.  MFCC, the GMM log-likelihoods, the LDA,
MLLT and fMLLR statistics and the feature transforms, and the chain
model's training and scoring are on the card unless --use-gpu=no; the
searches and the small solves stay on the host, as in the reference.
`main` returns, as the reference does, tri3's WER (stage 7) or, with
--chain-epochs N, the chain model's (stage 8), and writes each system's
files under --dir (tri1, tri2 and tri3's hyp.txt among them).
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
    line, the utterances aligned in each pass, the aligner's and the
    decoder's failures in process, and each system's results under its
    directory's name ("tri1", "tri2", "tri3", "chain")."""

    def __init__(self):
        self.report: Dict = {"stage_s": {}, "tool_s": {}, "tool_stats": {},
                             "aligned": [], "align_failures": 0,
                             "decode_failures": 0}

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
        msg = record.getMessage()
        if msg.startswith("alignment failed"):
            self.report["align_failures"] += 1
        elif msg.startswith("decode failed"):
            self.report["decode_failures"] += 1


@contextlib.contextmanager
def _counting_failures(report: Dict):
    """Count the in-process aligner's and decoder's failures
    (recipes/mono.py's warnings) into `report`."""
    counter = _CountFailures(report)
    mono_log = logging.getLogger("kaldi_tpu_torch.recipes.mono")
    mono_log.addHandler(counter)
    try:
        yield
    finally:
        mono_log.removeHandler(counter)


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


def read_utt2spk(data_dir: str) -> Dict[str, str]:
    out = {}
    with open(os.path.join(data_dir, "utt2spk")) as f:
        for line in f:
            u, spk = line.split()
            out[u] = spk
    return out


def _read_g(d: str):
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    return read_fst_file(os.path.join(d, "lang", "G.fst"))


def _tri1_system(args, device):
    """(lang, tri1's MonoSystem on `device`, train feats, train texts,
    tri1's alignments of the train set): the common start of stages 6
    and 7."""
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
    from kaldi_tpu_torch.recipes.mono import MonoSystem, _align_all
    from kaldi_tpu_torch.tree.context_dep import ContextDependency
    from kaldi_tpu_torch.util import kaldi_io
    tri1 = os.path.join(args.dir, "tri1")
    lang_obj = Lang(read_lexicon(args.lexicon), sil_phone="SIL",
                    sil_prob=0.5)
    tm, am = read_am_gmm(f"{tri1}/final.mdl", device=device)
    lang_obj.topo = tm.topo
    tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                      f"{tri1}/tree")
    tri1_sys = MonoSystem(lang_obj, tree, tm, am)
    feats = dict(SequentialTableReader(
        "matrix", f"ark:{args.train}/feats.ark"))
    texts = read_texts(args.train)
    compiler = TrainingGraphCompiler(tm, tree, lang_obj)
    graphs = {u: compiler.compile(texts[u]) for u in feats}
    ali = _align_all(tri1_sys, graphs, feats, 10.0, 0.1, 1.0)
    return lang_obj, tri1_sys, feats, texts, ali


def _score(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]):
    from kaldi_tpu_torch.util.edit_distance import WerStats
    stats = WerStats()
    for utt, ref in refs.items():
        stats.add(ref, hyps[utt])
    return stats


def _result(stats, **extra) -> Dict:
    return dict(wer=stats.wer, word_errors=stats.errors,
                ref_words=stats.ref_words, **extra)


def main(argv: Optional[List[str]] = None,
         report: Optional[Dict] = None) -> Optional[float]:
    """Runs stages --stage..7, and 8 with --chain-epochs N (or --stage 8);
    returns the last stage's WER as the reference does: tri3's (stage 7)
    or the chain model's (stage 8).  `report`, if given, receives the
    run's seconds, counters and results (see `_Run`) and "wer", the WER
    returned."""
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
                    help="run stage 8 (flat-start e2e chain) with "
                    "this many epochs (0 = skip)")
    ap.add_argument("--use-gpu", default="yes", choices=("yes", "no"),
                    help="yes: the device work on the CUDA card (fail "
                    "without one); no: on the CPU")
    args = ap.parse_args(argv)
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
    wer = None

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
        with _counting_failures(run.report):
            ali = _align_all(mono_sys, graphs, feats, 10.0, 0.1, 1.0)
            run.report["aligned"].append(len(ali))
            tri_sys = train_deltas(
                lang_obj, feats, texts, mono_sys, ali,
                TrainDeltasOptions(num_leaves=args.num_leaves,
                                   totgauss=args.tot_gauss))
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

    if args.stage <= 5:
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
        run.report["tri1"] = _result(stats, lattices=len(lats),
                                     lm_scale=lm_scale, penalty=wip)
        wer = stats.wer

    if args.stage <= 6:
        print("=== stage 6: tri2 (LDA+MLLT) ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.base import io_funcs as iof
        from kaldi_tpu_torch.cli.gmm_tools import write_am_gmm
        from kaldi_tpu_torch.feat.functions import splice_frames
        from kaldi_tpu_torch.recipes.lda_mllt import (TrainLdaMlltOptions,
                                                      train_lda_mllt,
                                                      transform_all)
        from kaldi_tpu_torch.recipes.mono import decode, make_hclg
        from kaldi_tpu_torch.util import kaldi_io
        tri2 = os.path.join(d, "tri2")
        os.makedirs(tri2, exist_ok=True)
        with _counting_failures(run.report):
            lang_obj, tri1_sys, feats, texts, ali = _tri1_system(args,
                                                                 device)
            run.report["aligned"].append(len(ali))
            opts = TrainLdaMlltOptions(
                num_iters=6, totgauss=args.tot_gauss,
                num_leaves=args.num_leaves, realign_iters=(2, 4),
                tree_min_gain=20.0, lda_dim=min(20, 13 * 5),
                splice_left=2, splice_right=2, mllt_iters=(1, 2))
            sys2, transform, _tf = train_lda_mllt(lang_obj, feats, texts,
                                                  tri1_sys, ali, opts)
            write_am_gmm(f"{tri2}/final.mdl", sys2.tm, sys2.am)
            kaldi_io.write_kaldi_object(sys2.tree.write, f"{tri2}/tree")
            kaldi_io.write_kaldi_object(
                lambda st, b: iof.write_matrix(st, b, transform),
                f"{tri2}/final.mat")
            test_feats = dict(SequentialTableReader(
                "matrix", f"ark:{args.test}/feats.ark"))
            sf_t = transform_all({u: splice_frames(f, 2, 2)
                                  for u, f in test_feats.items()},
                                 transform, sys2.am.device)
            hclg2 = make_hclg(sys2, _read_g(d))
            hyps = decode(sys2, hclg2, sf_t, acoustic_scale=0.1)
        stats = _score(read_texts(args.test), hyps)
        print(f"tri2 (LDA+MLLT): {stats.report()}")
        with TableWriter("token-vector", f"ark:{tri2}/hyp.txt") as w:
            for utt, toks in hyps.items():
                w.write(utt, toks)
        sh("compute-wer", "--mode=present", f"ark:{args.test}/text",
           f"ark:{tri2}/hyp.txt")
        stage_s["6"] = time.perf_counter() - t0
        run.report["tri2"] = _result(
            stats, pdfs=sys2.am.num_pdfs, gaussians=sys2.am.num_gauss(),
            final_mat=list(transform.shape),
            hclg_states=hclg2.num_states, hclg_arcs=hclg2.num_arcs())
        wer = stats.wer

    if args.stage <= 7:
        print("=== stage 7: tri3 (SAT) + fMLLR two-pass decode ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.cli.gmm_tools import write_am_gmm
        from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                     FasterDecoderOptions)
        from kaldi_tpu_torch.recipes.lda_mllt import (TrainSatOptions,
                                                      adapt_all,
                                                      speaker_fmllr_accs,
                                                      train_sat)
        from kaldi_tpu_torch.recipes.mono import (_batch_loglikes, decode,
                                                  make_hclg)
        from kaldi_tpu_torch.util import kaldi_io
        tri3 = os.path.join(d, "tri3")
        os.makedirs(tri3, exist_ok=True)
        with _counting_failures(run.report):
            lang_obj, tri1_sys, feats, texts, ali = _tri1_system(args,
                                                                 device)
            run.report["aligned"].append(len(ali))
            sys3, spk_transforms = train_sat(
                lang_obj, feats, texts, read_utt2spk(args.train), tri1_sys,
                ali, TrainSatOptions(num_iters=5, totgauss=args.tot_gauss,
                                     num_leaves=args.num_leaves,
                                     realign_iters=(2, 4),
                                     tree_min_gain=20.0,
                                     fmllr_iters=(1, 3),
                                     fmllr_min_count=50.0))
            write_am_gmm(f"{tri3}/final.mdl", sys3.tm, sys3.am)
            kaldi_io.write_kaldi_object(sys3.tree.write, f"{tri3}/tree")
            # two-pass adapted decode (steps/decode_fmllr.sh): the first
            # pass unadapted, each test speaker's fMLLR from its first-pass
            # alignments, the re-decode of the transformed features
            hclg3 = make_hclg(sys3, _read_g(d))
            test_feats = dict(SequentialTableReader(
                "matrix", f"ark:{args.test}/feats.ark"))
            test_u2s = read_utt2spk(args.test)
            dec = FasterDecoder(hclg3, FasterDecoderOptions(beam=16.0))
            lls = _batch_loglikes(sys3, test_feats)
            first_ali = {}
            for i, (u, f) in enumerate(test_feats.items()):
                res = dec.decode(lls[i, :f.shape[0]], sys3.tm.id2pdf_id, 0.1)
                if res is not None:
                    first_ali[u] = res[0]
            test_W = {spk: accs.update(min_count=50.0)[0]
                      for spk, accs in speaker_fmllr_accs(
                          sys3, test_feats, first_ali, test_u2s).items()}
            adapted = adapt_all(test_feats, test_u2s, test_W,
                                sys3.am.device)
            hyps = decode(sys3, hclg3, adapted, acoustic_scale=0.1)
        stats = _score(read_texts(args.test), hyps)
        print(f"tri3 (SAT, fMLLR 2-pass): {stats.report()}")
        with TableWriter("token-vector", f"ark:{tri3}/hyp.txt") as w:
            for utt, toks in hyps.items():
                w.write(utt, toks)
        sh("compute-wer", "--mode=present", f"ark:{args.test}/text",
           f"ark:{tri3}/hyp.txt")
        stage_s["7"] = time.perf_counter() - t0
        run.report["tri3"] = _result(
            stats, pdfs=sys3.am.num_pdfs, gaussians=sys3.am.num_gauss(),
            train_speakers=len(spk_transforms), test_speakers=len(test_W),
            first_pass=len(first_ali))
        wer = stats.wer
        if args.chain_epochs <= 0:
            run.report["wer"] = wer
            return wer

    if args.stage <= 8:
        print("=== stage 8: chain (flat-start e2e LF-MMI) ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.decoder.graph import Lang, make_decoding_graph
        from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                     FasterDecoderOptions)
        from kaldi_tpu_torch.recipes.chain import (ChainTrainOptions,
                                                   nnet_log_likes,
                                                   train_chain_e2e)
        from kaldi_tpu_torch.util.edit_distance import WerStats
        os.makedirs(os.path.join(d, "chain"), exist_ok=True)
        lang_obj = Lang(read_lexicon(args.lexicon), sil_phone="SIL",
                        sil_prob=0.5)
        lang_obj.make_topology()
        feats = dict(SequentialTableReader(
            "matrix", f"ark:{args.train}/feats.ark"))
        texts = read_texts(args.train)
        train = {}
        t_train = time.perf_counter()
        model, variables, _den, chain_tm, chain_tree = train_chain_e2e(
            lang_obj, feats, texts,
            opts=ChainTrainOptions(num_epochs=args.chain_epochs,
                                   learning_rate=2e-3, minibatch_size=4),
            device=device, stats=train)
        train["train_s"] = time.perf_counter() - t_train
        lang_obj.topo = chain_tm.topo
        hclg = make_decoding_graph(lang_obj, _read_g(d), chain_tree,
                                   chain_tm, transition_scale=1.0,
                                   self_loop_scale=1.0)
        test_feats = dict(SequentialTableReader(
            "matrix", f"ark:{args.test}/feats.ark"))
        scores = nnet_log_likes(model, variables, test_feats)
        dec = FasterDecoder(hclg, FasterDecoderOptions(beam=24.0))
        refs = read_texts(args.test)
        best = None
        for ac in (0.5, 1.0):
            stats = WerStats()
            for utt, ref in refs.items():
                res = dec.decode(scores[utt], chain_tm.id2pdf_id,
                                 acoustic_scale=ac)
                hyp = [] if res is None else \
                    [lang_obj.word_names[w] for w in res[1]]
                stats.add(ref, hyp)
            if best is None or stats.wer < best[0].wer:
                best = (stats, ac)
        print(f"chain (e2e flat-start): {best[0].report()}")
        stage_s["8"] = time.perf_counter() - t0
        run.report["chain"] = _result(
            best[0], acoustic_scale=best[1], hclg_states=hclg.num_states,
            hclg_arcs=hclg.num_arcs(), train=train)
        wer = best[0].wer
    run.report["wer"] = wer
    return wer


if __name__ == "__main__":
    wer = main()
    if wer is not None:
        print(f"%WER {wer:.2f}")
