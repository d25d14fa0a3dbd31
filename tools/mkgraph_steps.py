"""utils/mkgraph.sh's steps through the port's graph tools, in process.

The tools are run through `kaldi_tpu_torch.cli.get_tool` in mkgraph.sh's
order, each reading and writing files in `out_dir`:

  1. fsttablecompose L_disambig.fst G.fst | fstdeterminizestar
     --use-log=true | fstminimizeencoded | fstpushspecial > LG.fst
  2. fstcomposecontext --context-width=N --central-position=P
     --read-disambig-syms=phones/disambig.int
     --write-disambig-syms=disambig_ilabels.int ilabels LG.fst > CLG.fst
  3. make-h-transducer --disambig-syms-out=disambig_tid.int
     --transition-scale=T ilabels tree model > Ha.fst;
     fsttablecompose Ha.fst CLG.fst | fstdeterminizestar --use-log=true
     | fstrmsymbols disambig_tid.int | fstrmepslocal
     | fstminimizeencoded > HCLGa.fst
  4. add-self-loops --self-loop-scale=S model HCLGa.fst > HCLG.fst

N and P are read from the tree, as mkgraph.sh reads them with tree-info.
G's backoff arcs are epsilon (arpa2fst without --disambig-symbol), as
the JAX package's `make_decoding_graph` makes them.  With use_log=False
both determinizations are tropical and fstcopy takes fstpushspecial's
place: the graph that weighs paths as `make_decoding_graph` does.

`flat_g` writes the one-state G over a lang's words at cost 0 that
makes mkgraph's steps give HCL (the graph the lookahead decoder
composes with G on demand); `unigram_arpa` cuts an ARPA LM to its
unigrams (a second LM for the biglm decoders); `template_graphs` runs
the template recipe's corpus, lang, features and LMs through the tools
and builds the tri1 HCLG of tests/data/template_tri1.

Used by chip_smoke.py, tools/mkgraph_jax_bar.py,
tools/decoders_jax_bar.py and the tests:

    from mkgraph_steps import mkgraph
    report = mkgraph("data/lang", "data/lang/G.fst", "exp/tri1/tree",
                     "exp/tri1/final.mdl", "exp/tri1/graph")
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# (output file, tool, arguments); {d} is out_dir, the rest mkgraph fills
STEPS = (
    ("LG0.fst", "fsttablecompose", ("{lang}/L_disambig.fst", "{G}")),
    ("LG1.fst", "fstdeterminizestar", ("--use-log=true", "{d}/LG0.fst")),
    ("LG2.fst", "fstminimizeencoded", ("{d}/LG1.fst",)),
    ("LG.fst", "fstpushspecial", ("{d}/LG2.fst",)),
    ("CLG.fst", "fstcomposecontext",
     ("--context-width={N}", "--central-position={P}",
      "--read-disambig-syms={lang}/phones/disambig.int",
      "--write-disambig-syms={d}/disambig_ilabels.int", "{d}/ilabels",
      "{d}/LG.fst")),
    ("Ha.fst", "make-h-transducer",
     ("--disambig-syms-out={d}/disambig_tid.int", "--transition-scale={T}",
      "{d}/ilabels", "{tree}", "{model}")),
    ("HCLGa0.fst", "fsttablecompose", ("{d}/Ha.fst", "{d}/CLG.fst")),
    ("HCLGa1.fst", "fstdeterminizestar", ("--use-log=true",
                                          "{d}/HCLGa0.fst")),
    ("HCLGa2.fst", "fstrmsymbols", ("{d}/disambig_tid.int",
                                    "{d}/HCLGa1.fst")),
    ("HCLGa3.fst", "fstrmepslocal", ("{d}/HCLGa2.fst",)),
    ("HCLGa.fst", "fstminimizeencoded", ("{d}/HCLGa3.fst",)),
    ("HCLG.fst", "add-self-loops", ("--self-loop-scale={S}", "{model}",
                                    "{d}/HCLGa.fst")),
)


def _tree_context(tree_path: str):
    from kaldi_tpu_torch.tree.context_dep import ContextDependency
    from kaldi_tpu_torch.util import kaldi_io
    tree = kaldi_io.read_kaldi_object(ContextDependency.read, tree_path)
    return tree.context_width(), tree.central_position()


def tropical_steps():
    """STEPS with tropical determinization and fstcopy in
    fstpushspecial's place."""
    return tuple(
        (out, "fstcopy" if tool == "fstpushspecial" else tool,
         tuple(a for a in args if a != "--use-log=true"))
        for out, tool, args in STEPS)


def mkgraph(lang_dir: str, g_fst: str, tree: str, model: str, out_dir: str,
            transition_scale: float = 1.0, self_loop_scale: float = 0.1,
            use_log: bool = True) -> Dict:
    """Builds out_dir/HCLG.fst; returns {"context": [N, P], "sizes":
    {file: [states, arcs]}, "tool_s": [[tool, seconds], ...],
    "total_s": seconds}.  A tool that fails raises."""
    from kaldi_tpu_torch.cli import get_tool
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    os.makedirs(out_dir, exist_ok=True)
    N, P = _tree_context(tree)
    fill = {"d": out_dir, "lang": lang_dir, "G": g_fst, "tree": tree,
            "model": model,
            "N": N, "P": P, "T": transition_scale, "S": self_loop_scale}
    report: Dict = {"context": [N, P], "sizes": {}, "tool_s": []}
    t_all = time.perf_counter()
    for out_name, tool, args in STEPS if use_log else tropical_steps():
        argv = [tool] + [a.format(**fill) for a in args]
        argv.append(os.path.join(out_dir, out_name))
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = get_tool(tool)(argv)
        report["tool_s"].append([tool, time.perf_counter() - t0])
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv)}: exit {rc}\n"
                               f"{err.getvalue()}")
        fst = read_fst_file(os.path.join(out_dir, out_name))
        report["sizes"][out_name] = [fst.num_states, fst.num_arcs()]
    report["total_s"] = time.perf_counter() - t_all
    return report


def write_lexicon(path: str, lexicon) -> None:
    """lexicon.txt as prepare-lang reads it: a line a pronunciation."""
    with open(path, "w") as f:
        for word in sorted(lexicon):
            for pron in lexicon[word]:
                f.write(f"{word} {' '.join(pron)}\n")


def format_lm(d: str, lexicon, arpa_text: str) -> Dict:
    """utils/prepare_lang.sh and utils/format_lm.sh through the tools:
    d/lexicon.txt, d/lm.arpa, d/lang (prepare-lang) and d/lang/G.fst
    (arpa2fst over lang/words.txt, epsilon backoff).  Returns the paths
    and each tool's seconds."""
    from kaldi_tpu_torch.cli import get_tool
    os.makedirs(d, exist_ok=True)
    lex, arpa, lang = (os.path.join(d, "lexicon.txt"),
                       os.path.join(d, "lm.arpa"), os.path.join(d, "lang"))
    write_lexicon(lex, lexicon)
    with open(arpa, "w") as f:
        f.write(arpa_text)
    g = os.path.join(lang, "G.fst")
    tool_s = []
    for argv in (["prepare-lang", lex, lang],
                 ["arpa2fst", f"--read-symbol-table={lang}/words.txt", arpa,
                  g]):
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = get_tool(argv[0])(argv)
        tool_s.append([argv[0], time.perf_counter() - t0])
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv)}: exit {rc}\n"
                               f"{err.getvalue()}")
    return {"lexicon": lex, "arpa": arpa, "lang": lang, "G": g,
            "tool_s": tool_s}


def legacy_inputs(d: str, lexicon, lm_text, tm, tree) -> Dict:
    """The legacy path's graph inputs: the bigram of `build_decode_graph`
    (BigramBackoffLm.from_counts over sorted(lexicon)) written by
    to_arpa, the lang and G of `format_lm`, the chain monophone tree
    (d/tree) and the transition model alone (d/final.tm, which the graph
    tools read as they read a .mdl)."""
    from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
    from kaldi_tpu_torch.util import kaldi_io
    lm = BigramBackoffLm.from_counts(lm_text, sorted(lexicon))
    out = format_lm(d, lexicon, lm.to_arpa())
    out["tree"] = os.path.join(d, "tree")
    kaldi_io.write_kaldi_object(tree.write, out["tree"])
    out["tm"] = os.path.join(d, "final.tm")
    kaldi_io.write_kaldi_object(tm.write, out["tm"])
    return out


def const_arpa_symbols(words_txt: str, out: str) -> str:
    """words.txt with <s> and </s> after the words, as upstream's
    prepare_lang.sh writes it: the symbols arpa-to-const-arpa reads (the
    lang directory's words.txt has neither)."""
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    table = read_symbol_table(words_txt)
    top = max(table.values())
    with open(out, "w") as f:
        f.writelines(f"{w} {i}\n" for w, i in
                     [*table.items(), ("<s>", top + 1), ("</s>", top + 2)])
    return out


def align_lexicon(lexicon, lang_dir: str, out: str) -> str:
    """phones/align_lexicon.int as upstream's prepare_lang.sh writes it
    for lattice-align-words-lexicon: `word word phone...` a
    pronunciation, ids from the lang directory, and the optional
    silence as `0 0 SIL`."""
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    words = read_symbol_table(os.path.join(lang_dir, "words.txt"))
    phones = read_symbol_table(os.path.join(lang_dir, "phones.txt"))
    with open(out, "w") as f:
        f.write(f"0 0 {phones['SIL']}\n")
        for word in sorted(lexicon):
            for pron in lexicon[word]:
                ids = " ".join(str(phones[p]) for p in pron)
                f.write(f"{words[word]} {words[word]} {ids}\n")
    return out


def flat_g(lang_dir: str, out: str) -> str:
    """A one-state G (final, cost 0) with a loop of cost 0 for every word
    of the lang's words.txt; with it mkgraph's steps give HCL."""
    from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
    from kaldi_tpu_torch.fstext.fst import Arc, TropicalWeight, VectorFst
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    words = read_symbol_table(os.path.join(lang_dir, "words.txt"))
    g = VectorFst(TropicalWeight)
    s = g.add_state()
    g.set_start(s)
    g.set_final(s)
    for w, i in sorted(words.items(), key=lambda kv: kv[1]):
        if i > 0 and not w.startswith("#") and w not in ("<s>", "</s>"):
            g.add_arc(s, Arc(i, i, 0.0, s))
    with open(out, "wb") as f:
        write_fst(f, g)
    return out


def unigram_arpa(arpa: str) -> str:
    """The unigram section of an ARPA LM as an LM of its own, backoff
    weights dropped."""
    unis = [u for u in arpa.split("\\1-grams:", 1)[1]
            .split("\\2-grams:")[0].strip().splitlines() if u.strip()]
    out = ["\\data\\", f"ngram 1={len(unis)}", "", "\\1-grams:"]
    out += [" ".join(u.split()[:2]) for u in unis]
    return "\n".join(out + ["", "\\end\\", ""])


TEMPLATE_UTTS = (112, 32)


def template_graphs(d: str, use_gpu: str) -> Dict:
    """The template recipe's corpus (recipes/template_corpus.py at its
    112/32 utterances), prepare-lang, the test set's MFCCs
    (compute-mfcc-feats --use-gpu=<use_gpu>, the recipe's options), G
    from lm.arpa and G2 from its unigrams (arpa2fst), and the HCLG of
    tests/data/template_tri1 (mkgraph at the recipe's scales), all in d
    through the tools.  Returns the paths and the test transcripts."""
    from kaldi_tpu_torch.cli import get_tool
    from kaldi_tpu_torch.recipes.template_corpus import (FS,
                                                         make_standard_corpus)
    _train, test_txt = make_standard_corpus(d, *TEMPLATE_UTTS)
    lang, test = os.path.join(d, "lang"), os.path.join(d, "test")
    tri1 = os.path.join(REPO, "tests", "data", "template_tri1")
    with open(os.path.join(d, "lm.arpa")) as f:
        arpa = f.read()
    with open(os.path.join(d, "lm_uni.arpa"), "w") as f:
        f.write(unigram_arpa(arpa))
    t0 = time.perf_counter()
    for argv in (["prepare-lang", os.path.join(d, "lexicon.txt"), lang],
                 ["compute-mfcc-feats", f"--use-gpu={use_gpu}",
                  f"--sample-frequency={FS}", "--dither=0",
                  f"scp:{test}/wav.scp", f"ark:{test}/feats.ark"],
                 ["arpa2fst", f"--read-symbol-table={lang}/words.txt",
                  os.path.join(d, "lm.arpa"), os.path.join(lang, "G.fst")],
                 ["arpa2fst", f"--read-symbol-table={lang}/words.txt",
                  os.path.join(d, "lm_uni.arpa"),
                  os.path.join(lang, "G2.fst")]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = get_tool(argv[0])(argv)
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv)}: exit {rc}\n"
                               f"{err.getvalue()}")
    tools_s = time.perf_counter() - t0
    rep = mkgraph(lang, os.path.join(lang, "G.fst"), f"{tri1}/tree",
                  f"{tri1}/final.mdl", os.path.join(d, "graph"))
    return {"lang": lang, "G": os.path.join(lang, "G.fst"),
            "G2": os.path.join(lang, "G2.fst"),
            "feats": f"ark:{test}/feats.ark", "model": f"{tri1}/final.mdl",
            "hclg": os.path.join(d, "graph", "HCLG.fst"), "report": rep,
            "tools_s": tools_s, "test_txt": test_txt}
