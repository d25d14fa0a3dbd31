"""Port parity: the graph tools of mkgraph.sh and format_lm.sh
(`cli/fst_tools.py`, `cli/graph_tools.py`) against the JAX package's
tools, on the CPU: each tool's output file byte for byte on the template
recipe's lexicon, its ARPA and the JAX recipe's tri1 (tests/data/
template_tri1), its exit status and what it prints; the log semiring in
the <KtFst> container; the FST functions the tools stand on
(`fstext/ops.py`) against JAX's on seeded random FSTs.

Where the JAX tools meet a reference fault (ROADMAP.md section 3) the
inputs are ones on which the reference works, and
tests/test_torch_mkgraph_tools.py shows the fault."""

import contextlib
import io
import math
import os
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.fstext import fst as jfst
from kaldi_tpu.fstext import ops as jops
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.fstext import fst as tfst
from kaldi_tpu_torch.fstext import ops as tops
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from mkgraph_steps import mkgraph  # noqa: E402

TRI1 = os.path.join(REPO, "tests", "data", "template_tri1")


class _Stdout(io.StringIO):
    """A text stdout with the binary `buffer` the tools' streams test."""
    buffer = io.BytesIO()


def run(get, name, *args):
    """A tool in process -> (exit status, stdout)."""
    out = _Stdout()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = get(name)([name, *map(str, args)])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The template corpus's lang directory and G (the port's
    prepare-lang and arpa2fst) and every file of mkgraph.sh's steps over
    the JAX recipe's tri1, built by the port's tools."""
    d = tmp_path_factory.mktemp("fst_tools")
    make_standard_corpus(str(d))
    assert run(ttool, "prepare-lang", d / "lexicon.txt", d / "lang")[0] == 0
    assert run(ttool, "arpa2fst", f"--read-symbol-table={d}/lang/words.txt",
               d / "lm.arpa", d / "lang" / "G.fst")[0] == 0
    mkgraph(str(d / "lang"), str(d / "lang" / "G.fst"), f"{TRI1}/tree",
            f"{TRI1}/final.mdl", str(d / "graph"))
    (d / "sym_in").write_text("7\n")
    (d / "sym_out").write_text("9\n")
    (d / "words_in").write_text("1\n3\n")
    return d


def both(work, name, *args, out_name="out"):
    """Runs `name` in each package, the output file last; asserts equal
    exit status, stdout and output bytes."""
    res = []
    for side, get in (("j", jtool), ("t", ttool)):
        out = work / f"{name}.{out_name}.{side}"
        rc, text = run(get, name, *[str(a).format(out=out) for a in args])
        res.append((rc, text, out.read_bytes() if out.exists() else None))
    assert res[0] == res[1]
    assert res[0][0] == 0
    return res[1]


G = "{w}/graph"
CASES = {
    "fstcopy": [("{w}/lang/L_disambig.fst", "{out}")],
    "fstaddselfloops": [("{w}/sym_in", "{w}/sym_out",
                         "{w}/lang/L_disambig.fst", "{out}")],
    "fstrmsymbols": [("{w}/sym_in", "{w}/lang/L_disambig.fst", "{out}"),
                     ("--remove-arcs=true", "{w}/sym_in",
                      "{w}/lang/L_disambig.fst", "{out}"),
                     ("--apply-to-output=true", "--penalty=1.5",
                      "{w}/words_in", "{w}/lang/L_disambig.fst", "{out}"),
                     (f"{G}/disambig_tid.int", f"{G}/HCLGa1.fst", "{out}")],
    "fstrmepslocal": [(f"{G}/HCLGa2.fst", "{out}"),
                      ("{w}/lang/L.fst", "{out}")],
    "fstdeterminizestar": [(f"{G}/LG0.fst", "{out}"),
                           ("--use-log=true", f"{G}/LG0.fst", "{out}"),
                           ("--use-log=true", "--delta=0.01",
                            f"{G}/HCLGa0.fst", "{out}")],
    "fstminimizeencoded": [(f"{G}/LG1.fst", "{out}"),
                           ("--delta=0.001", f"{G}/HCLGa3.fst", "{out}")],
    "fsttablecompose": [("{w}/lang/L_disambig.fst", "{w}/lang/G.fst",
                         "{out}"),
                        ("--connect=false", f"{G}/Ha.fst", f"{G}/CLG.fst",
                         "{out}")],
    "fstpushspecial": [(f"{G}/LG2.fst", "{out}"),
                       ("--delta=0.001", "{w}/lang/G.fst", "{out}")],
    "fstcomposecontext": [("--context-width=3", "--central-position=1",
                           "{out}", f"{G}/LG.fst", "{w}/ctx.fst"),
                          ("--context-width=2", "--central-position=1",
                           "{out}", f"{G}/LG.fst", "{w}/ctx.fst"),
                          ("--context-width=1", "--central-position=0",
                           "{out}", f"{G}/LG.fst", "{w}/ctx.fst")],
    "arpa2fst": [("--read-symbol-table={w}/lang/words.txt", "{w}/lm.arpa",
                  "{out}"),
                 ("{w}/lm.arpa", "{out}")],
    "make-h-transducer": [("--transition-scale=0.5", f"{G}/ilabels",
                           f"{TRI1}/tree", f"{TRI1}/final.mdl", "{out}"),
                          ("--disambig-syms-out={w}/tid.int",
                           f"{G}/ilabels", f"{TRI1}/tree",
                           f"{TRI1}/final.mdl", "{out}")],
    "add-self-loops": [("--self-loop-scale=1.0", f"{TRI1}/final.mdl",
                        f"{G}/HCLGa3.fst", "{out}"),
                       (f"{TRI1}/final.mdl", f"{G}/HCLGa2.fst", "{out}")],
}


@pytest.mark.parametrize("name,k", [(n, k) for n, cases in CASES.items()
                                    for k in range(len(cases))])
def test_graph_tool_bytes(work, name, k):
    args = [a.replace("{w}", str(work)) for a in CASES[name][k]]
    rc, _, data = both(work, name, *args, out_name=str(k))
    assert data, "no output written"
    if name == "fstcomposecontext":
        # the CLG beside the ilabel-info file
        assert (work / "ctx.fst").exists()


def test_fstcomposecontext_fst_bytes(work):
    """The CLG itself, at each width, without disambiguation symbols
    (with them the port repairs the reference: test_torch_mkgraph_tools)."""
    for n, p in ((3, 1), (1, 0)):
        outs = []
        for get, side in ((jtool, "j"), (ttool, "t")):
            out = work / f"clg{n}.{side}"
            assert run(get, "fstcomposecontext", f"--context-width={n}",
                       f"--central-position={p}", work / f"il{n}.{side}",
                       work / "graph" / "LG.fst", out)[0] == 0
            outs.append((out.read_bytes(),
                         (work / f"il{n}.{side}").read_bytes()))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("delta", [0.01, 1e-6])
def test_fstisstochastic(work, delta):
    for f in ("lang/G.fst", "graph/LG.fst", "graph/HCLG.fst"):
        for log in ("true", "false"):
            args = (f"--delta={delta}", f"--test-in-log={log}", work / f)
            assert run(jtool, "fstisstochastic", *args) == \
                run(ttool, "fstisstochastic", *args)


def test_tools_refuse_bad_arguments(work):
    for name in ("fstcopy", "fsttablecompose", "arpa2fst",
                 "make-h-transducer", "add-self-loops", "fstcomposecontext"):
        assert run(ttool, name, *["x"] * 5)[0] == 1
    with pytest.raises(Exception, match="disambiguation symbols"):
        run(ttool, "fstaddselfloops", work / "sym_in", work / "lang" /
            "phones" / "disambig.int", work / "lang" / "L.fst",
            work / "bad.fst")


def test_tools_pipe_through_stdin_and_stdout(work, monkeypatch):
    """fstcopy with no arguments reads stdin and writes stdout, as in a
    pipe (the reference's _in_out helpers)."""
    data = (work / "lang" / "L.fst").read_bytes()
    out = io.BytesIO()

    class _Std:
        def __init__(self, b):
            self.buffer = b

    monkeypatch.setattr(sys, "stdin", _Std(io.BytesIO(data)))
    monkeypatch.setattr(sys, "stdout", _Std(out))
    assert ttool("fstcopy")(["fstcopy"]) == 0
    assert out.getvalue() == data


# -- the log semiring and the FST functions ---------------------------------

def test_log_weight_plus_and_container():
    for a, b in ((0.5, 1.25), (3.0, 3.0), (math.inf, 2.0), (7.0, math.inf),
                 (-1.0, 40.0)):
        assert tfst.LogWeight.plus(a, b) == jfst.LogWeight.plus(a, b)
    for sr in ("TropicalWeight", "LogWeight", "LatticeWeight"):
        t, j = _random_pair(5, sr=sr)
        tb, jb = io.BytesIO(), io.BytesIO()
        t.write(tb)
        j.write(jb)
        assert tb.getvalue() == jb.getvalue()
        back = tfst.VectorFst.read(io.BytesIO(tb.getvalue()))
        jback = jfst.VectorFst.read(io.BytesIO(jb.getvalue()))
        assert back.semiring is getattr(tfst, sr)
        assert _arcs(back) == _arcs(jback) and back.finals == jback.finals


def _random_pair(seed, n=8, labels=5, eps_share=0.3, sr="TropicalWeight",
                 acyclic=False):
    """The same random FST in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for mod in (tfst, jfst):
        semiring = getattr(mod, sr)
        f = mod.VectorFst(semiring)
        f.add_states(n)
        f.set_start(0)
        out.append(f)
    for s in range(n):
        for _ in range(int(rng.integers(1, 4))):
            il = 0 if rng.random() < eps_share else int(rng.integers(1,
                                                                      labels))
            ol = 0 if rng.random() < eps_share else int(rng.integers(1,
                                                                      labels))
            ns = (int(rng.integers(s + 1, n + 1)) if acyclic
                  else int(rng.integers(0, n)))
            if ns >= n:
                continue
            w = float(np.round(rng.uniform(0.1, 3), 3))
            w = (w, float(np.round(rng.uniform(0, 2), 3))) \
                if sr == "LatticeWeight" else w
            for f, mod in zip(out, (tfst, jfst)):
                f.add_arc(s, mod.Arc(il, ol, w, ns))
    for s in rng.choice(n, 3, replace=False):
        w = float(np.round(rng.uniform(0, 1), 3))
        w = (w, 0.5) if sr == "LatticeWeight" else w
        for f in out:
            f.finals[int(s)] = w
    return out


def _arcs(f):
    return [(s, a.ilabel, a.olabel, a.weight, a.nextstate)
            for s in range(f.num_states) for a in f.arcs[s]]


def _same(t, j):
    assert (t.num_states, t.start) == (j.num_states, j.start)
    assert _arcs(t) == _arcs(j)
    assert t.finals == j.finals


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_project_and_remove_eps_local(seed):
    for out_side in (False, True):
        t, j = _random_pair(seed)
        _same(tops.project(t, out_side), jops.project(j, out_side))
    t, j = _random_pair(seed)
    _same(tops.remove_eps_local(t), jops.remove_eps_local(j))


@pytest.mark.parametrize("seed", SEEDS)
def test_shortest_distance_and_path(seed):
    t, j = _random_pair(seed)
    for rev in (False, True):
        assert tops.shortest_distance(t, rev) == jops.shortest_distance(j,
                                                                        rev)
    _same(tops.shortest_path(t), jops.shortest_path(j))
    t, j = _random_pair(seed, sr="LatticeWeight", acyclic=True)
    _same(tops.shortest_path(t), jops.shortest_path(j))


@pytest.mark.parametrize("seed", SEEDS)
def test_equal_paths_and_replace(seed):
    t, j = _random_pair(seed, acyclic=True)
    t2, j2 = _random_pair(seed + 100, acyclic=True)
    assert tops.equal_paths(t, t2) == jops.equal_paths(j, j2)
    assert tops.equal_paths(t, tops.rm_epsilon(t.copy()))
    subs = [_random_pair(seed + 200 + k, n=4, acyclic=True)
            for k in range(2)]
    _same(tops.replace_fst(t, {2: subs[0][0], 3: subs[1][0]}),
          jops.replace_fst(j, {2: subs[0][1], 3: subs[1][1]}))


@pytest.mark.parametrize("seed", SEEDS)
def test_push_special(seed):
    t, j = _random_pair(seed, eps_share=0.0)
    tp, jp = tops.push_special(t), jops.push_special(j)
    assert (tp.num_states, tp.start) == (jp.num_states, jp.start)
    assert [a[:3] + a[4:] for a in _arcs(tp)] == \
        [a[:3] + a[4:] for a in _arcs(jp)]
    np.testing.assert_allclose([a[3] for a in _arcs(tp)],
                               [a[3] for a in _arcs(jp)], rtol=0, atol=0)
    assert tp.finals == jp.finals


@pytest.mark.parametrize("seed", SEEDS)
def test_determinize_star_in_the_log_semiring(seed):
    t, j = _random_pair(seed, sr="LogWeight", acyclic=True, eps_share=0.2)
    tt, jj = _random_pair(seed, acyclic=True, eps_share=0.2)
    for f in (t, j):
        for arcs in f.arcs:
            for a in arcs:          # functional: output = input
                a.olabel = a.ilabel
    for f in (tt, jj):
        for arcs in f.arcs:
            for a in arcs:
                a.olabel = a.ilabel
    _same(tops.determinize_star(t), jops.determinize_star(j))
    # the log semiring sums what the tropical one takes the least of
    td = tops.determinize_star(tt)
    assert td.semiring is tfst.TropicalWeight
    _same(td, jops.determinize_star(jj))
