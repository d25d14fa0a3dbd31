"""The yesno-equivalent demo recipe (port of `egs/synthetic/run.py`;
parity: egs/yesno/s5/run.sh), end to end on synthesized audio, the
smallest full pipeline:

  stage 0: data prep (synthesize wavs, write wav.scp/text/utt2spk,
           lexicon -> lang directory)
  stage 1: MFCC features + CMVN stats
  stage 2: monophone GMM training (flat start + EM, through the tools)
  stage 3: HCLG graph build
  stage 4: decoding + scoring (WER)
  stage 5: chain TDNN-F training (GMM alignments -> LF-MMI with
           time-tolerant supervision; the trained net is exported in the
           reference's nnet3 .mdl format)
  stage 6: chain decode through the tools (nnet3-compute on the
           exported .mdl -> latgen-faster-mapped -> the scoring sweep)
  stage 7: online streaming decode of the exported chain .mdl
           (online2-wav-nnet3-latgen-faster) + scoring

Run:  python -m kaldi_tpu_torch.recipes.synthetic_run [--stage N]
          [--dir exp_dir] [--chain-init weights.npz] [--use-gpu=no]

The tools run in process through `kaldi_tpu_torch.cli.get_tool`, as the
reference's `sh` runs them; MFCC, the GMM log-likelihoods and the chain
model's training and forward are on the card unless --use-gpu=no, the
searches on the host.  The corpus is the reference's
(`tests/test_mono_e2e.py` `make_corpus`, copied here: the same samples
from the same seeds).

Stage 6 keeps every third row of nnet3-compute's output, as the
reference does: the exported .mdl's network is evaluated at every input
frame (a Kaldi nnet3-compute at --frame-subsampling-factor=1 does the
same), and the chain model's outputs belong at every third.  Its
latgen-faster-mapped writes the raw lattices (--determinize-lattice=false):
the reference's unpruned determinization blows past its 100,000-state
limit on each of these lattices and, after about two minutes of host
time an utterance, writes the raw lattice all the same (ROADMAP.md §3),
so the scoring sweep reads the same lattices."""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.recipes.template_run import _Run, _score, read_texts
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

FS = 8000.0
WORD_TONES = {"YES": (350.0, 900.0), "NO": (1600.0, 2600.0)}
LEXICON = {"YES": [["Y"]], "NO": [["N"]]}


# -- the corpus (a copy of tests/test_mono_e2e.py's) ------------------------

def synth_utterance(words, seed):
    """Each word = 0.25s two-tone segment; 0.25s silence between (long
    enough that silence must be modeled by SIL, not stretched word
    states)."""
    rng = np.random.default_rng(seed)

    def sil(n):
        return 60.0 * rng.normal(size=n)

    parts = [sil(int(0.3 * FS))]
    for w in words:
        n = int(0.25 * FS)
        t = np.arange(n) / FS
        f1, f2 = WORD_TONES[w]
        seg = (2500 * np.sin(2 * np.pi * f1 * t)
               + 1500 * np.sin(2 * np.pi * f2 * t)
               + 60 * rng.normal(size=n))
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                         / (0.02 * FS))
        parts.append(seg * env)
        parts.append(sil(int(0.25 * FS)))
    return np.concatenate(parts).astype(np.float32)


def make_corpus(num_train=10, num_test=4, words_per_utt=4):
    """-> (train texts, train waves, test texts, test waves)."""
    rng = np.random.default_rng(42)

    def draw():
        return [("YES", "NO")[rng.integers(2)] for _ in range(words_per_utt)]

    train = {f"tr{i:02d}": draw() for i in range(num_train)}
    test = {f"te{i:02d}": draw() for i in range(num_test)}
    train_wav = {u: synth_utterance(ws, i)
                 for i, (u, ws) in enumerate(train.items())}
    test_wav = {u: synth_utterance(ws, 1000 + i)
                for i, (u, ws) in enumerate(test.items())}
    return train, train_wav, test, test_wav


def unigram_g(lang, words=("YES", "NO")):
    """A one-state G over `words`, each at cost log(len(words))."""
    from kaldi_tpu_torch.fstext.fst import Arc, TropicalWeight, VectorFst
    g = VectorFst(TropicalWeight)
    s = g.add_state()
    g.set_start(s)
    g.set_final(s)
    cost = float(np.log(len(words)))
    for w in words:
        wid = lang.words[w]
        g.add_arc(s, Arc(wid, wid, cost, s))
    return g


def synth_corpus(d: str, fs: float = FS
                 ) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    """Write data/{train,test} (wavs, wav.scp, text, utt2spk) and
    data/lexicon.txt under `d` -> (train texts, test texts)."""
    from kaldi_tpu_torch.feat.wave import WaveData
    train_txt, train_wav, test_txt, test_wav = make_corpus(
        num_train=12, num_test=4)
    for split, wavs, txt in (("train", train_wav, train_txt),
                             ("test", test_wav, test_txt)):
        sd = os.path.join(d, "data", split)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, "wav.scp"), "w") as scp, \
                open(os.path.join(sd, "text"), "w") as text, \
                open(os.path.join(sd, "utt2spk"), "w") as u2s:
            for utt, wav in sorted(wavs.items()):
                p = os.path.join(sd, f"{utt}.wav")
                with open(p, "wb") as f:
                    WaveData(fs, wav[None, :]).write(f)
                scp.write(f"{utt} {p}\n")
                text.write(f"{utt} {' '.join(txt[utt])}\n")
                u2s.write(f"{utt} global\n")
    with open(os.path.join(d, "data", "lexicon.txt"), "w") as f:
        f.write("YES Y\nNO N\n")
    return train_txt, test_txt


# -- the stages ---------------------------------------------------------------

def _lang_obj(tm):
    from kaldi_tpu_torch.decoder.graph import Lang
    lang_obj = Lang(LEXICON, sil_phone="SIL", sil_prob=0.5)
    lang_obj.topo = tm.topo
    return lang_obj


def _names(lang: str) -> Dict[int, str]:
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    words = read_symbol_table(os.path.join(lang, "words.txt"))
    return {i: w for w, i in words.items()}


def _write_hyps(names, words_rspec: str, hyp_wspec: str
                ) -> Dict[str, List[str]]:
    hyps = {utt: [names[i] for i in ids] for utt, ids in
            SequentialTableReader("int-vector", words_rspec)}
    with TableWriter("token-vector", hyp_wspec) as w:
        for utt, toks in hyps.items():
            w.write(utt, toks)
    return hyps


def _score_all(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]):
    """WerStats of every reference; an utterance with no hypothesis (a
    failed decode) scores as empty."""
    return _score(refs, {u: hyps.get(u, []) for u in refs})


def _result(stats) -> Dict:
    return dict(wer=stats.wer, word_errors=stats.errors,
                ref_words=stats.ref_words)


def main(argv: Optional[List[str]] = None,
         report: Optional[Dict] = None) -> Optional[float]:
    """Runs stages --stage..7 -> stage 7's WER.  `report`, if given,
    receives each stage's and each tool's seconds, the tools' stats
    lines, and the WER of stages 4, 6 and 7 ("gmm", "chain",
    "online")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--dir", default="exp_synthetic")
    ap.add_argument("--chain-epochs", type=int, default=10)
    ap.add_argument("--chain-init", default="",
                    help="the chain model's initial weights, an .npz in "
                    "flax's layout ('params/...' and 'batch_stats/...' "
                    "keys; e.g. the reference recipe's draw); by default "
                    "the port's seeded draw")
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
    fs = FS
    lang = os.path.join(d, "lang")
    exp = os.path.join(d, "exp", "mono")
    chain_dir = os.path.join(d, "exp", "chain")
    stage_s = run.report["stage_s"]
    wer = None

    if args.stage <= 0:
        print("=== stage 0: data prep ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.decoder.lang_dir import prepare_lang
        synth_corpus(d, fs)
        prepare_lang(os.path.join(d, "data", "lexicon.txt"), lang,
                     sil_phone="SIL")
        stage_s["0"] = time.perf_counter() - t0

    if args.stage <= 1:
        print("=== stage 1: features ===")
        t0 = time.perf_counter()
        for split in ("train", "test"):
            sd = os.path.join(d, "data", split)
            sh("compute-mfcc-feats", gpu, f"--sample-frequency={fs}",
               "--dither=0", f"scp:{sd}/wav.scp",
               f"ark,scp:{sd}/feats.ark,{sd}/feats.scp")
            sh("compute-cmvn-stats", f"ark:{sd}/feats.ark",
               f"ark:{sd}/cmvn.ark")
        stage_s["1"] = time.perf_counter() - t0

    if args.stage <= 2:
        print("=== stage 2: mono training ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
        os.makedirs(exp, exist_ok=True)
        td = os.path.join(d, "data", "train")
        words = read_symbol_table(os.path.join(lang, "words.txt"))
        with TableWriter("int-vector", f"ark:{td}/text.int") as w:
            for utt, toks in read_texts(td).items():
                w.write(utt, [words[t] for t in toks])
        sh("gmm-init-mono", f"--train-feats=ark:{td}/feats.ark",
           f"{lang}/topo", 13, f"{exp}/0.mdl", f"{exp}/tree")
        sh("compile-train-graphs", "--self-loop-scale=0.1",
           f"{exp}/tree", f"{exp}/0.mdl", f"{lang}/L_disambig.fst",
           f"ark:{td}/text.int", f"ark:{exp}/graphs.ark")
        sh("align-equal-compiled", f"ark:{exp}/graphs.ark",
           f"ark:{td}/feats.ark", f"ark:{exp}/ali.ark")
        sh("gmm-acc-stats-ali", f"{exp}/0.mdl", f"ark:{td}/feats.ark",
           f"ark:{exp}/ali.ark", f"{exp}/0.acc")
        sh("gmm-est", "--min-gaussian-occupancy=3", "--mix-up=20",
           f"{exp}/0.mdl", f"{exp}/0.acc", f"{exp}/1.mdl")
        mdl = "1.mdl"
        for it in range(1, 6):
            sh("gmm-align-compiled", gpu, "--beam=10",
               "--acoustic-scale=0.1", f"{exp}/{mdl}",
               f"ark:{exp}/graphs.ark", f"ark:{td}/feats.ark",
               f"ark:{exp}/ali.ark")
            sh("gmm-acc-stats-ali", f"{exp}/{mdl}", f"ark:{td}/feats.ark",
               f"ark:{exp}/ali.ark", f"{exp}/{it}.acc")
            sh("gmm-est", "--min-gaussian-occupancy=3", "--mix-up=30",
               f"{exp}/{mdl}", f"{exp}/{it}.acc", f"{exp}/{it + 1}.mdl")
            mdl = f"{it + 1}.mdl"
        os.replace(os.path.join(exp, mdl), os.path.join(exp, "final.mdl"))
        sh("gmm-info", f"{exp}/final.mdl")
        stage_s["2"] = time.perf_counter() - t0

    if args.stage <= 3:
        print("=== stage 3: graph ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
        from kaldi_tpu_torch.decoder.graph import make_decoding_graph
        from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
        from kaldi_tpu_torch.fstext.fst import Arc, TropicalWeight, VectorFst
        from kaldi_tpu_torch.fstext.openfst_io import (read_fst_file,
                                                       write_fst)
        from kaldi_tpu_torch.tree.context_dep import ContextDependency
        from kaldi_tpu_torch.util import kaldi_io
        words = read_symbol_table(os.path.join(lang, "words.txt"))
        g = VectorFst(TropicalWeight)
        s = g.add_state()
        g.set_start(s)
        g.set_final(s)
        for wname in ("YES", "NO"):
            g.add_arc(s, Arc(words[wname], words[wname],
                             float(np.log(2.0)), s))
        with open(os.path.join(lang, "G.fst"), "wb") as f:
            write_fst(f, g)
        tm, _am = read_am_gmm(f"{exp}/final.mdl", device="cpu")
        tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                          f"{exp}/tree")
        gfst = read_fst_file(os.path.join(lang, "G.fst"))
        hclg = make_decoding_graph(_lang_obj(tm), gfst, tree, tm)
        with open(os.path.join(exp, "HCLG.fst"), "wb") as f:
            write_fst(f, hclg)
        stage_s["3"] = time.perf_counter() - t0

    if args.stage <= 4:
        print("=== stage 4: decode + score ===")
        t0 = time.perf_counter()
        sd = os.path.join(d, "data", "test")
        sh("gmm-latgen-faster", gpu, "--acoustic-scale=0.1", "--beam=16",
           f"{exp}/final.mdl", f"{exp}/HCLG.fst", f"ark:{sd}/feats.ark",
           f"ark:{exp}/lat.ark", f"ark:{exp}/words.ark")
        hyps = _write_hyps(_names(lang), f"ark:{exp}/words.ark",
                           f"ark:{exp}/hyp.txt")
        sh("compute-wer", "--mode=present", f"ark:{sd}/text",
           f"ark:{exp}/hyp.txt")
        stats = _score_all(read_texts(sd), hyps)
        run.report["gmm"] = _result(stats)
        wer = stats.wer
        stage_s["4"] = time.perf_counter() - t0

    if args.stage <= 5:
        print("=== stage 5: chain TDNN-F training ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
        from kaldi_tpu_torch.decoder.graph import (TrainingGraphCompiler,
                                                   make_decoding_graph)
        from kaldi_tpu_torch.fstext.openfst_io import (read_fst_file,
                                                       write_fst)
        from kaldi_tpu_torch.nnet3.mdl_io import (chain_tdnnf_to_nnet3,
                                                  write_nnet3_am)
        from kaldi_tpu_torch.nnet3.models import ChainTdnnfConfig
        from kaldi_tpu_torch.recipes.chain import (ChainTrainOptions,
                                                   train_chain_topo)
        from kaldi_tpu_torch.recipes.mono import MonoSystem, _align_all
        from kaldi_tpu_torch.tree.context_dep import ContextDependency
        from kaldi_tpu_torch.util import kaldi_io
        os.makedirs(chain_dir, exist_ok=True)
        td = os.path.join(d, "data", "train")
        tm, am = read_am_gmm(f"{exp}/final.mdl", device=device)
        tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                          f"{exp}/tree")
        lang_obj = _lang_obj(tm)
        gmm_sys = MonoSystem(lang_obj, tree, tm, am)
        feats = dict(SequentialTableReader("matrix", f"ark:{td}/feats.ark"))
        texts = read_texts(td)
        compiler = TrainingGraphCompiler(tm, tree, lang_obj)
        graphs = {u: compiler.compile(texts[u]) for u in feats}
        ali = _align_all(gmm_sys, graphs, feats, 10.0, 0.1, 1.0)
        cfg = ChainTdnnfConfig(feat_dim=13,
                               num_pdfs=2 * len(lang_obj.phones),
                               hidden_dim=64, bottleneck_dim=16,
                               prefinal_dim=32, num_layers=4,
                               subsample_layer=2,
                               frame_subsampling_factor=3)
        opts = ChainTrainOptions(num_epochs=args.chain_epochs,
                                 learning_rate=2e-3, minibatch_size=4,
                                 chunk_width=60, left_tolerance=5,
                                 right_tolerance=5)
        chain_stats: Dict = {}
        init = None
        if args.chain_init:
            from kaldi_tpu_torch.recipes.bench_corpus import load_params
            init = load_params(args.chain_init)
        model, variables, _den, chain_tm, chain_tree = train_chain_topo(
            gmm_sys, feats, ali, cfg, opts, device=device,
            stats=chain_stats, variables=init)
        run.report["chain_train"] = {
            k: v for k, v in chain_stats.items()
            if isinstance(v, (int, float, str))}
        graph_nn = chain_tdnnf_to_nnet3(model, variables)
        write_nnet3_am(os.path.join(chain_dir, "final.mdl"), chain_tm,
                       graph_nn, left_context=9, right_context=9)
        lang_obj.topo = chain_tm.topo
        gfst = read_fst_file(os.path.join(lang, "G.fst"))
        hclg = make_decoding_graph(lang_obj, gfst, chain_tree, chain_tm,
                                   transition_scale=1.0,
                                   self_loop_scale=1.0)
        with open(os.path.join(chain_dir, "HCLG.fst"), "wb") as f:
            write_fst(f, hclg)
        stage_s["5"] = time.perf_counter() - t0

    if args.stage <= 6:
        print("=== stage 6: chain decode + score ===")
        t0 = time.perf_counter()
        from kaldi_tpu_torch.lat.functions import (add_word_ins_penalty,
                                                   lattice_best_path,
                                                   lattice_scale)
        from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
        from kaldi_tpu_torch.util.edit_distance import WerStats
        sd = os.path.join(d, "data", "test")
        sh("nnet3-compute", gpu, f"{chain_dir}/final.mdl",
           f"ark:{sd}/feats.ark", f"ark:{chain_dir}/scores_full.ark")
        # the network runs at every input frame: keep every 3rd row
        with TableWriter("matrix", f"ark:{chain_dir}/scores.ark") as w:
            for utt, m in SequentialTableReader(
                    "matrix", f"ark:{chain_dir}/scores_full.ark"):
                w.write(utt, m[::3])
        # the raw lattices: the reference's unpruned determinization
        # passes 100,000 states on every one of them and writes the raw
        # lattice after minutes of host time (ROADMAP.md §3)
        sh("latgen-faster-mapped", "--acoustic-scale=1.0", "--beam=14",
           "--lattice-beam=4", "--max-active=2000",
           "--determinize-lattice=false",
           f"{chain_dir}/final.mdl", f"{chain_dir}/HCLG.fst",
           f"ark:{chain_dir}/scores.ark", f"ark:{chain_dir}/lat.ark",
           f"ark:{chain_dir}/words.ark")
        # the scoring sweep over lm-scale x word-insertion penalty on the
        # lattices (steps/scoring/score_kaldi.sh)
        names = _names(lang)
        refs = read_texts(sd)
        lats = dict(SequentialTableReader(LatticeHolder(),
                                          f"ark:{chain_dir}/lat.ark"))
        best = None
        for lm_scale in (0.5, 1.0, 1.5):
            for wip in (0.0, 0.5, 1.0, 2.0):
                stats = WerStats()
                hyps = {}
                for utt, lat in lats.items():
                    scaled = lattice_scale(lat, lm_scale=lm_scale)
                    scaled = add_word_ins_penalty(scaled, wip)
                    _, wids, _ = lattice_best_path(scaled)
                    hyps[utt] = [names[i] for i in wids]
                    stats.add(refs[utt], hyps[utt])
                if best is None or stats.wer < best[0].wer:
                    best = (stats, lm_scale, wip, hyps)
        stats, lm_scale, wip, best_hyps = best
        print(f"best scoring: lm-scale {lm_scale} penalty {wip}")
        with TableWriter("token-vector", f"ark:{chain_dir}/hyp.txt") as w:
            for utt, toks in best_hyps.items():
                w.write(utt, toks)
        sh("compute-wer", "--mode=present", f"ark:{sd}/text",
           f"ark:{chain_dir}/hyp.txt")
        run.report["chain"] = dict(_result(stats), lm_scale=lm_scale,
                                   penalty=wip,
                                   decoded=len(lats), utterances=len(refs))
        wer = stats.wer
        stage_s["6"] = time.perf_counter() - t0

    if args.stage <= 7:
        print("=== stage 7: online streaming chain decode ===")
        t0 = time.perf_counter()
        sd = os.path.join(d, "data", "test")
        sh("online2-wav-nnet3-latgen-faster", gpu,
           f"--sample-frequency={fs}", "--dither=0",
           "--acoustic-scale=1.0", "--frame-subsampling-factor=3",
           "--beam=14", "--word-ins-penalty=2.0",
           f"{chain_dir}/final.mdl", f"{chain_dir}/HCLG.fst",
           f"scp:{sd}/wav.scp", f"ark:{chain_dir}/online_words.ark")
        hyps = _write_hyps(_names(lang), f"ark:{chain_dir}/online_words.ark",
                           f"ark:{chain_dir}/online_hyp.txt")
        sh("compute-wer", "--mode=present", f"ark:{sd}/text",
           f"ark:{chain_dir}/online_hyp.txt")
        stats = _score_all(read_texts(sd), hyps)
        run.report["online"] = _result(stats)
        wer = stats.wer
        stage_s["7"] = time.perf_counter() - t0

    if report is not None:
        report["wer"] = wer
    return wer


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
