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

Used by chip_smoke.py, tools/mkgraph_jax_bar.py and the tests:

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
