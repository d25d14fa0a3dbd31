"""mkgraph.sh through the port's tools (tools/mkgraph_steps.py), on the
CPU: the JAX recipe's tri1 at context width 3 (tests/data/template_tri1)
and a small chain system at width 1 over a lexicon with optional
silence, homophones, alternative pronunciations and shared prefixes.

The four reference faults this path meets are shown on the JAX package
and repaired in the port (ROADMAP.md section 3):
  1. prepare-lang's phones.txt and phones/disambig.int list #0 alone
     while L_disambig.fst carries more disambiguation symbols;
  2. fstcomposecontext at width 1 writes the disambiguation symbols as
     (sym,) ilabel entries, on which make-h-transducer raises;
  3. fstcomposecontext at width 3 leaves each disambiguation symbol's
     raw id on the CLG, where it names a phone window, and writes no
     (-sym,) entries;
  4. add-self-loops raises where fstminimizeencoded has merged states
     reached by different transition-states.
The port's graphs: the width-1 HCLG equal, weights within 1e-5, to
JAX's tools fed the full disambiguation list and the port's ilabel-info;
each graph, built with tropical determinization and without
fstpushspecial, giving the best path and cost of the in-process
`make_decoding_graph` on every seeded input; mkgraph.sh's own order
(--use-log=true, fstpushspecial) giving its words where one path leads
(log determinization sums G's explicit and epsilon-backoff paths of a
word pair, and fstpushspecial spreads the leftover weight over the arcs:
its costs differ by design)."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.decoder import graph as jgraph
from kaldi_tpu.fstext.openfst_io import read_fst_file as jread
from kaldi_tpu.fstext.openfst_io import write_fst as jwrite
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.cli.gmm_tools import _read_tm
from kaldi_tpu_torch.cli.graph_tools import read_ilabel_info
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
from kaldi_tpu_torch.recipes.bench_corpus import chain_tm_tree_for
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

sys.path.insert(0, os.path.dirname(__file__))
from chain_lattices import PRONS, SENTENCES, mkgraph_steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRI1 = os.path.join(REPO, "tests", "data", "template_tri1")


def run(get, *argv):
    with contextlib.redirect_stderr(io.StringIO()):
        return get(argv[0])([str(a) for a in argv])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The width-1 chain system: lang and G through the port's
    prepare-lang and arpa2fst, the chain monophone tree and transition
    model, HCLG through the tools at the chain model's scales."""
    d = tmp_path_factory.mktemp("chain1")
    lang, tm, tree = chain_tm_tree_for(PRONS)
    inp = mkgraph_steps.legacy_inputs(str(d), PRONS, SENTENCES, tm, tree)
    args = (inp["lang"], inp["G"], inp["tree"], inp["tm"])
    rep = mkgraph_steps.mkgraph(*args, str(d / "graph"), 1.0, 1.0)
    rep_t = mkgraph_steps.mkgraph(*args, str(d / "graph_t"), 1.0, 1.0,
                                  use_log=False)
    return dict(d=d, inp=inp, tm=tm, tree=tree, lang=lang, rep=rep,
                rep_t=rep_t)


@pytest.fixture(scope="module")
def tri1(tmp_path_factory):
    d = tmp_path_factory.mktemp("tri1")
    make_standard_corpus(str(d))
    assert run(ttool, "prepare-lang", d / "lexicon.txt", d / "lang") == 0
    assert run(ttool, "arpa2fst", f"--read-symbol-table={d}/lang/words.txt",
               d / "lm.arpa", d / "lang" / "G.fst") == 0
    args = (str(d / "lang"), str(d / "lang" / "G.fst"), f"{TRI1}/tree",
            f"{TRI1}/final.mdl")
    rep = mkgraph_steps.mkgraph(*args, str(d / "graph"))
    rep_t = mkgraph_steps.mkgraph(*args, str(d / "graph_t"), use_log=False)
    return dict(d=d, rep=rep, rep_t=rep_t)


# -- the reference's faults, on the JAX package -----------------------------

def test_fault1_jax_disambig_list_misses_l_disambig_inputs(tmp_path):
    lex = tmp_path / "lexicon.txt"
    mkgraph_steps.write_lexicon(str(lex), PRONS)
    for side, get in (("j", jtool), ("t", ttool)):
        assert run(get, "prepare-lang", lex, tmp_path / side) == 0
    for side in ("j", "t"):
        listed = {int(x) for x in
                  (tmp_path / side / "phones" / "disambig.int").read_text()
                  .split()}
        names = [line.split()[0] for line in
                 (tmp_path / side / "phones.txt").read_text().splitlines()]
        L = read_fst_file(str(tmp_path / side / "L_disambig.fst"))
        used = {a.ilabel for arcs in L.arcs for a in arcs
                if a.ilabel >= min(listed)}
        if side == "j":
            assert len(listed) == 1 and not used <= listed
            assert [n for n in names if n.startswith("#")] == ["#0"]
        else:
            assert used <= listed and len(listed) == len(used) + 1
            assert [n for n in names if n.startswith("#")] == \
                [f"#{k}" for k in range(len(listed))]
    # words.txt stays the reference's, without #0
    assert (tmp_path / "t" / "words.txt").read_bytes() == \
        (tmp_path / "j" / "words.txt").read_bytes()


def test_fault2_jax_make_h_transducer_raises_at_width_1(chain):
    g = chain["d"] / "graph"
    dis = f"{chain['inp']['lang']}/phones/disambig.int"
    assert run(jtool, "fstcomposecontext", "--context-width=1",
               "--central-position=0", f"--read-disambig-syms={dis}",
               g / "il.j", g / "LG.fst", g / "CLG.j") == 0
    with pytest.raises(Exception, match="topology"):
        run(jtool, "make-h-transducer", g / "il.j", chain["inp"]["tree"],
            chain["inp"]["tm"], g / "Ha.j")
    info = read_ilabel_info(str(g / "ilabels"))
    disambig = [int(x) for x in open(dis).read().split()]
    assert [i for i, w in enumerate(info) if w and w[0] < 0] == \
        [d for d in disambig if d < len(info)]
    assert (g / "CLG.j").read_bytes() == (g / "CLG.fst").read_bytes()


def test_fault3_jax_context_keeps_raw_disambig_ids_at_width_3(tri1):
    g = tri1["d"] / "graph"
    lang = tri1["d"] / "lang"
    assert run(jtool, "fstcomposecontext", "--context-width=3",
               "--central-position=1",
               f"--read-disambig-syms={lang}/phones/disambig.int",
               f"--write-disambig-syms={g}/dis.j", g / "il.j",
               g / "LG.fst", g / "CLG.j") == 0
    assert (g / "dis.j").read_text() == ""
    info_j = read_ilabel_info(str(g / "il.j"))
    assert not any(w and w[0] < 0 for w in info_j)
    clg = read_fst_file(str(g / "CLG.j"))
    sil_disambig = max(int(x) for x in
                       (lang / "phones" / "disambig.int").read_text().split())
    labels = {a.ilabel for arcs in clg.arcs for a in arcs}
    # the disambiguation arc's label names a phone window
    assert sil_disambig in labels and len(info_j[sil_disambig]) == 3
    info_t = read_ilabel_info(str(g / "ilabels"))
    assert info_t[:len(info_j)] == info_j
    assert [w[0] for w in info_t[len(info_j):]] == \
        [-int(x) for x in (lang / "phones" / "disambig.int").read_text()
         .split()]
    assert (g / "disambig_ilabels.int").read_text().split() == \
        [str(i) for i in range(len(info_j), len(info_t))]


def test_fault4_jax_add_self_loops_raises_after_minimization(tri1):
    g = tri1["d"] / "graph"
    with pytest.raises(ValueError, match="inconsistent incoming"):
        run(jtool, "add-self-loops", f"{TRI1}/final.mdl", g / "HCLGa.fst",
            g / "HCLG.j")
    hclga = read_fst_file(str(g / "HCLGa.fst"))
    hclg = read_fst_file(str(g / "HCLG.fst"))
    assert hclg.num_states > hclga.num_states      # states were split


# -- the port's graphs --------------------------------------------------------

def test_width1_hclg_equals_jax_tools_fed_the_full_lists(chain):
    """JAX's tools in mkgraph.sh's order, fed the port's lang directory
    (every disambiguation symbol listed) and, at make-h-transducer, the
    port's ilabel-info: the same HCLG, weights within 1e-5."""
    d, g = chain["d"], chain["d"] / "graph"
    inp = chain["inp"]
    jd = d / "jax_graph"
    jd.mkdir()
    steps = [("LG0", "fsttablecompose", f"{inp['lang']}/L_disambig.fst",
              inp["G"]),
             ("LG1", "fstdeterminizestar", "--use-log=true", jd / "LG0"),
             ("LG2", "fstminimizeencoded", jd / "LG1"),
             ("LG", "fstpushspecial", jd / "LG2"),
             ("CLG", "fstcomposecontext", "--context-width=1",
              "--central-position=0",
              f"--read-disambig-syms={inp['lang']}/phones/disambig.int",
              jd / "il.jax", jd / "LG"),
             ("Ha", "make-h-transducer",
              f"--disambig-syms-out={jd}/tid.int", "--transition-scale=1.0",
              g / "ilabels", inp["tree"], inp["tm"]),
             ("HCLGa0", "fsttablecompose", jd / "Ha", jd / "CLG"),
             ("HCLGa1", "fstdeterminizestar", "--use-log=true",
              jd / "HCLGa0"),
             ("HCLGa2", "fstrmsymbols", jd / "tid.int", jd / "HCLGa1"),
             ("HCLGa3", "fstrmepslocal", jd / "HCLGa2"),
             ("HCLGa", "fstminimizeencoded", jd / "HCLGa3"),
             ("HCLG", "add-self-loops", "--self-loop-scale=1.0", inp["tm"],
              jd / "HCLGa")]
    for out, *argv in steps[:-1]:
        assert run(jtool, *argv, jd / out) == 0, argv
    # fault 4 ends JAX's chain here; the port splits the merged states
    with pytest.raises(ValueError, match="inconsistent incoming"):
        run(jtool, *steps[-1][1:], jd / "HCLG")
    jh, th = jread(str(jd / "HCLGa")), read_fst_file(str(g / "HCLGa.fst"))
    assert (th.num_states, th.start) == (jh.num_states, jh.start)
    ta = [(s, a.ilabel, a.olabel, a.nextstate) for s in range(th.num_states)
          for a in th.arcs[s]]
    ja = [(s, a.ilabel, a.olabel, a.nextstate) for s in range(jh.num_states)
          for a in jh.arcs[s]]
    assert ta == ja
    np.testing.assert_allclose(
        [a.weight for arcs in th.arcs for a in arcs],
        [a.weight for arcs in jh.arcs for a in arcs], rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.finals, jh.finals, rtol=0, atol=1e-5)
    hclg = read_fst_file(str(g / "HCLG.fst"))
    assert chain["rep"]["context"] == [1, 0]
    assert chain["rep"]["sizes"]["HCLG.fst"] == [hclg.num_states,
                                                 hclg.num_arcs()]


def _decode_pair(hclg_a, hclg_b, tm, seed, n=12, peaked=False):
    """Best paths of two graphs on the same seeded loglikes: random, or
    peaked on the pdfs of graph a's best path on random ones."""
    rng = np.random.default_rng(seed)
    opts = FasterDecoderOptions(beam=1e9)
    out = []
    for _ in range(n):
        T = int(rng.integers(15, 50))
        ll = (3.0 * rng.standard_normal((T, tm.num_pdfs))).astype(np.float32)
        if peaked:
            ali = FasterDecoder(hclg_a, opts).decode(ll, tm.id2pdf_id)[0]
            ll = (0.1 * rng.standard_normal(ll.shape)).astype(np.float32)
            ll[np.arange(T), tm.id2pdf_id[ali]] += 8.0
        a = FasterDecoder(hclg_a, opts).decode(ll, tm.id2pdf_id)
        b = FasterDecoder(hclg_b, opts).decode(ll, tm.id2pdf_id)
        out.append((a, b))
    return out


def _in_process(lexicon, g_path, tree, tm, tmp, **kw):
    """JAX's make_decoding_graph, through an OpenFst file."""
    from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
    from kaldi_tpu.tree.context_dep import ContextDependency as JCd
    from kaldi_tpu.util import kaldi_io as jio
    jtm = jio.read_kaldi_object(JTm.read, tm)
    jtree = jio.read_kaldi_object(JCd.read, tree)
    lang = jgraph.Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    lang.topo = jtm.topo
    hclg = jgraph.make_decoding_graph(lang, jread(g_path), jtree, jtm, **kw)
    path = os.path.join(tmp, "inproc.fst")
    with open(path, "wb") as f:
        jwrite(f, hclg)
    return read_fst_file(path)


def _lexicon_of(path):
    lex = {}
    for line in open(path):
        w, *pron = line.split()
        lex.setdefault(w, []).append(pron)
    return lex


@pytest.mark.parametrize("system", ["chain", "tri1"])
def test_tropical_tool_graph_equals_in_process(chain, tri1, system,
                                               tmp_path):
    if system == "chain":
        s = chain
        lexicon, g, tree, tm_path = (PRONS, s["inp"]["G"], s["inp"]["tree"],
                                     s["inp"]["tm"])
        kw = dict(transition_scale=1.0, self_loop_scale=1.0)
    else:
        s = tri1
        lexicon = _lexicon_of(str(s["d"] / "lexicon.txt"))
        g, tree, tm_path = (str(s["d"] / "lang" / "G.fst"), f"{TRI1}/tree",
                            f"{TRI1}/final.mdl")
        kw = {}
    tm = _read_tm(tm_path)
    ref = _in_process(lexicon, g, tree, tm_path, str(tmp_path), **kw)
    tool = read_fst_file(str(s["d"] / "graph_t" / "HCLG.fst"))
    for a, b in _decode_pair(ref, tool, tm, seed=1):
        assert a[1] == b[1] and a[0] == b[0]
        assert abs(a[2] - b[2]) <= 1e-4 * max(1.0, abs(a[2]))


@pytest.mark.parametrize("system", ["chain", "tri1"])
def test_mkgraph_order_graph_words(chain, tri1, system, tmp_path):
    s = chain if system == "chain" else tri1
    tm = _read_tm(s["inp"]["tm"] if system == "chain"
                  else f"{TRI1}/final.mdl")
    ref = read_fst_file(str(s["d"] / "graph_t" / "HCLG.fst"))
    tool = read_fst_file(str(s["d"] / "graph" / "HCLG.fst"))
    prons = {i: w for w, i in read_symbol_table(
        str(s["d"] / "lang" / "words.txt")).items()}
    lexicon = _lexicon_of(str(s["d"] / "lexicon.txt"))
    for a, b in _decode_pair(ref, tool, tm, seed=2, peaked=True):
        # one alignment; a word may differ only for a homophone, whose
        # choice the LM alone makes
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            assert x == y or set(map(tuple, lexicon[prons[x]])) & \
                set(map(tuple, lexicon[prons[y]]))
    hclg = tool
    assert max(a.ilabel for arcs in hclg.arcs for a in arcs) <= \
        tm.num_transition_ids
    sizes = s["rep"]["sizes"]
    assert sizes["HCLG.fst"] == [hclg.num_states, hclg.num_arcs()]
    assert [t for t, _ in s["rep"]["tool_s"]] == \
        [t for _, t, _ in mkgraph_steps.STEPS]


def test_tool_graph_against_the_lexchain_flat_form(chain):
    """The legacy path's flat form (LexChainGraph.to_flat_graph, the
    graph online2 and latgen serve) against the tool-built graph with
    tropical determinization and no fstpushspecial: the same words and
    alignment on every seeded input, the costs apart by the lexicons'
    two differences: the reference's L charges the last word's exit,
    0.693 with silence or without, where the flat form charges it only
    for the silence; the flat form charges ln(n) for a word of n
    pronunciations, where L charges none."""
    from kaldi_tpu_torch.recipes.bench_corpus import build_decode_graph
    lang, tm, tree = chain["lang"], chain["tm"], chain["tree"]
    flat = build_decode_graph(PRONS, SENTENCES, tm, tree,
                              lang=lang).to_flat_graph()
    tool = read_fst_file(str(chain["d"] / "graph_t" / "HCLG.fst"))
    sil = lang.phones["SIL"]
    names = {i: w for w, i in read_symbol_table(
        str(chain["d"] / "lang" / "words.txt")).items()}
    seen = set()
    for a, b in _decode_pair(flat.to_vector_fst(), tool, tm, seed=3, n=16,
                             peaked=True):
        words = [names[w] for w in b[1]]
        assert a[0] == b[0] and [flat.words[w] for w in a[1]] == words
        last_sil = tm.transition_id_to_phone(a[0][-1]) == sil
        prons = sum(np.log(len(PRONS[w])) for w in words)
        seen.add((last_sil, prons > 0))
        want = (0.0 if last_sil else np.log(2.0)) - prons
        assert abs(b[2] - a[2] - want) < 1e-4
    # both kinds of ending, words with one pronunciation and with two
    assert {x for x, _ in seen} == {y for _, y in seen} == {True, False}
