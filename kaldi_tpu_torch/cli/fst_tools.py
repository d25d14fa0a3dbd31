"""The graph tools of mkgraph.sh and format_lm.sh (ports of
`kaldi_tpu/cli/fst_tools.py`'s fstcopy, fstisstochastic, fstaddselfloops,
fstrmsymbols, fstrmepslocal, fstdeterminizestar, fstminimizeencoded,
fsttablecompose, fstcomposecontext and arpa2fst, and of
`kaldi_tpu/cli/misc_tools.py`'s fstpushspecial; parity: fstbin/*.cc,
lmbin/arpa2fst.cc).  Host-side: each reads and writes OpenFst binary
FSTs, "-" standing for stdin or stdout, as in a pipe.
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base import io_funcs
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.fstext.context import context_expand
from kaldi_tpu_torch.fstext.fst import Arc, LogWeight, TropicalWeight, VectorFst
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
from kaldi_tpu_torch.fstext.ops import (compose, connect, determinize_star,
                                        minimize_encoded, push_special,
                                        remove_eps_local)
from kaldi_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions


def _write_fst_out(fst: VectorFst, wxfilename: str) -> None:
    with kaldi_io.output_stream(wxfilename) as f:
        write_fst(f, fst)


def _in_out(po, first: int = 1):
    fin = po.get_arg(first) if po.num_args() >= first else "-"
    fout = po.get_arg(first + 1) if po.num_args() >= first + 1 else "-"
    return fin, fout


def _read_int_list(rxfilename: str) -> List[int]:
    with kaldi_io.input_stream(rxfilename) as f:
        return [int(tok) for tok in f.read().decode("utf-8").split()]


def fstcopy(argv: List[str]) -> int:
    po = ParseOptions("Copy a single FST (binary or text input)\n"
                      "Usage: fstcopy [<fst-in> [<fst-out>]]")
    po.read(argv)
    if po.num_args() > 2:
        po.print_usage()
        return 1
    fin, fout = _in_out(po)
    _write_fst_out(read_fst_file(fin), fout)
    return 0


def fstisstochastic(argv: List[str]) -> int:
    po = ParseOptions(
        "Checks whether an FST is stochastic (every state's arc+final "
        "weights sum to One), prints the min/max deviation, and exits "
        "0 iff within --delta (fstbin/fstisstochastic.cc)\n"
        "Usage: fstisstochastic [<fst-in>]")
    delta = po.register_value("delta", 0.01, "Maximum error to accept.")
    test_in_log = po.register_value(
        "test-in-log", True, "Test stochasticity in log semiring.")
    po.read(argv)
    if po.num_args() > 1:
        po.print_usage()
        return 1
    fst = read_fst_file(po.get_arg(1) if po.num_args() >= 1 else "-")
    sr = LogWeight if bool(test_in_log[0]) else TropicalWeight
    mn, mx = 0.0, 0.0
    for s in range(fst.num_states):
        tot = sr.zero
        for a in fst.arcs[s]:
            tot = sr.plus(tot, float(a.weight))
        if fst.finals[s] != TropicalWeight.zero:
            tot = sr.plus(tot, float(fst.finals[s]))
        mn = min(mn, tot)
        mx = max(mx, tot)
    print(f"{mn:g} {mx:g}")
    d = float(delta[0])
    return 0 if (abs(mn) <= d and abs(mx) <= d) else 1


def fstaddselfloops(argv: List[str]) -> int:
    po = ParseOptions(
        "Adds self-loops to states of an FST to propagate "
        "disambiguation symbols through it.  They are added on each "
        "final state and each state with non-epsilon output symbols "
        "on at least one arc out of the state "
        "(fstext/pre-determinize-inl.h:601)\n"
        "Usage: fstaddselfloops <in-disambig-list> <out-disambig-list> "
        "[<in.fst> [<out.fst>]]")
    po.read(argv)
    if po.num_args() < 2 or po.num_args() > 4:
        po.print_usage()
        return 1
    isyms = _read_int_list(po.get_arg(1))
    osyms = _read_int_list(po.get_arg(2))
    if len(isyms) != len(osyms):
        raise KaldiTpuError("mismatch in size of disambiguation symbols")
    if any(x <= 0 for x in isyms + osyms):
        raise KaldiTpuError("disambiguation symbols must be > 0")
    fin, fout = _in_out(po, 3)
    fst = read_fst_file(fin)
    one = fst.semiring.one
    for s in range(fst.num_states):
        needs = fst.finals[s] != fst.semiring.zero
        if not needs:
            needs = any(a.olabel != 0 for a in fst.arcs[s])
        if needs:
            for i, o in zip(isyms, osyms):
                fst.add_arc(s, Arc(i, o, one, s))
    _write_fst_out(fst, fout)
    return 0


def fstrmsymbols(argv: List[str]) -> int:
    po = ParseOptions(
        "With no options, replaces a subset of symbols with epsilon "
        "wherever they appear on the input side of an FST; "
        "--remove-arcs removes such arcs, --penalty adds a cost "
        "(fstbin/fstrmsymbols.cc)\n"
        "Usage: fstrmsymbols [options] <in-disambig-list> "
        "[<in.fst> [<out.fst>]]")
    apply_out = po.register_value(
        "apply-to-output", False,
        "If true, apply to the output, not the input, side")
    remove_arcs = po.register_value(
        "remove-arcs", False, "Remove arcs instead of relabeling")
    penalty = po.register_value(
        "penalty", 0.0, "Add this cost to arcs with a listed symbol "
        "instead of relabeling")
    po.read(argv)
    if po.num_args() < 1 or po.num_args() > 3:
        po.print_usage()
        return 1
    syms = set(_read_int_list(po.get_arg(1)))
    fin, fout = _in_out(po, 2)
    fst = read_fst_file(fin)
    out_side = bool(apply_out[0])

    def hit(a):
        return (a.olabel if out_side else a.ilabel) in syms

    if bool(remove_arcs[0]):
        for s in range(fst.num_states):
            fst.arcs[s] = [a for a in fst.arcs[s] if not hit(a)]
        connect(fst)
    elif float(penalty[0]) != 0.0:
        pen = float(penalty[0])
        for s in range(fst.num_states):
            for a in fst.arcs[s]:
                if hit(a):
                    a.weight = fst.semiring.times(a.weight, pen)
    else:
        for s in range(fst.num_states):
            for a in fst.arcs[s]:
                if hit(a):
                    if out_side:
                        a.olabel = 0
                    else:
                        a.ilabel = 0
    _write_fst_out(fst, fout)
    return 0


def fstrmepslocal(argv: List[str]) -> int:
    po = ParseOptions(
        "Removes some (but not all) epsilons locally, in a way that "
        "preserves equivalence (fstbin/fstrmepslocal.cc)\n"
        "Usage: fstrmepslocal [<in.fst> [<out.fst>]]")
    po.read(argv)
    if po.num_args() > 2:
        po.print_usage()
        return 1
    fin, fout = _in_out(po)
    _write_fst_out(remove_eps_local(read_fst_file(fin)), fout)
    return 0


def fstdeterminizestar(argv: List[str]) -> int:
    po = ParseOptions(
        "Removes epsilons and determinizes in one step "
        "(fstbin/fstdeterminizestar.cc)\n"
        "Usage: fstdeterminizestar [<in.fst> [<out.fst>]]")
    delta = po.register_value("delta", 1e-4,
                              "Delta value used to determine "
                              "equivalence of weights")
    max_states = po.register_value(
        "max-states", 0, "Maximum number of states (0 = no limit)")
    use_log = po.register_value(
        "use-log", False, "Determinize in log semiring")
    po.read(argv)
    if po.num_args() > 2:
        po.print_usage()
        return 1
    fin, fout = _in_out(po)
    fst = read_fst_file(fin)
    if bool(use_log[0]):
        fst.semiring = LogWeight
    ms = int(max_states[0]) or 10_000_000
    out = determinize_star(fst, delta=float(delta[0]), max_states=ms)
    out.semiring = TropicalWeight
    _write_fst_out(out, fout)
    return 0


def fstminimizeencoded(argv: List[str]) -> int:
    po = ParseOptions(
        "Minimizes an FST after encoding (label, weight) pairs — "
        "applicable to non-deterministic FSTs "
        "(fstbin/fstminimizeencoded.cc)\n"
        "Usage: fstminimizeencoded [<in.fst> [<out.fst>]]")
    delta = po.register_value("delta", 1e-4,
                              "Delta likelihood for quantization")
    po.read(argv)
    if po.num_args() > 2:
        po.print_usage()
        return 1
    fin, fout = _in_out(po)
    _write_fst_out(minimize_encoded(read_fst_file(fin),
                                    delta=float(delta[0])), fout)
    return 0


def fsttablecompose(argv: List[str]) -> int:
    po = ParseOptions(
        "Composes two FSTs (fstbin/fsttablecompose.cc; the table-"
        "matcher optimization is an implementation detail — the "
        "composition semantics are standard)\n"
        "Usage: fsttablecompose <fst1-in> <fst2-in> [<fst-out>]")
    connect_opt = po.register_value(
        "connect", True, "If true, trim the result")
    po.read(argv)
    if po.num_args() < 2 or po.num_args() > 3:
        po.print_usage()
        return 1
    f1 = read_fst_file(po.get_arg(1))
    f2 = read_fst_file(po.get_arg(2))
    out = compose(f1, f2)
    if bool(connect_opt[0]):
        connect(out)
    _write_fst_out(out, po.get_arg(3) if po.num_args() >= 3 else "-")
    return 0


def fstpushspecial(argv: List[str]) -> int:
    po = ParseOptions(
        "Push weights so every state's total outgoing mass is equal\n"
        "(works on FSTs whose weights don't sum to one, e.g. HCLG)\n"
        "Usage: fstpushspecial [options] [<fst-in> [<fst-out>]]")
    delta = po.register_value("delta", 1e-4, "Convergence threshold")
    po.read(argv)
    if po.num_args() > 2:
        po.print_usage()
        return 1
    fst = read_fst_file(po.get_arg(1) if po.num_args() >= 1 else "-")
    _write_fst_out(push_special(fst, delta[0]),
                   po.get_arg(2) if po.num_args() == 2 else "-")
    return 0


def fstcomposecontext(argv: List[str]) -> int:
    po = ParseOptions(
        "Composes an LG FST on the left with a dynamically-created "
        "context FST C, writing the ilabel-info of the result "
        "(fstbin/fstcomposecontext.cc, fstext/context-fst.h)\n"
        "Usage: fstcomposecontext <ilabels-output-file> "
        "[<in.fst> [<out.fst>]]")
    context_width = po.register_value("context-width", 3,
                                      "Size of phone context window")
    central_position = po.register_value(
        "central-position", 1,
        "Designated central position in context window")
    read_dis = po.register_value(
        "read-disambig-syms", "",
        "File with list of disambiguation symbols in the input")
    write_dis = po.register_value(
        "write-disambig-syms", "",
        "File to write the remapped disambiguation symbols")
    po.read(argv)
    if po.num_args() < 1 or po.num_args() > 3:
        po.print_usage()
        return 1
    disambig = _read_int_list(read_dis[0]) if read_dis[0] else []
    fin, fout = _in_out(po, 2)
    lg = read_fst_file(fin)
    clg, ilabel_info = context_expand(
        lg, N=int(context_width[0]), P=int(central_position[0]),
        disambig_syms=disambig)
    # ilabel-info format (fstext/context-fst.cc WriteILabelInfo):
    # int32 count, then per entry an int32 vector
    with kaldi_io.output_stream(po.get_arg(1)) as f:
        io_funcs.init_output_stream(f, True)
        io_funcs.write_int32(f, True, len(ilabel_info))
        for entry in ilabel_info:
            io_funcs.write_int_vector(f, True, list(entry))
    if write_dis[0]:
        # disambig syms map to the ilabel-info entries (-sym,)
        with kaldi_io.output_stream(write_dis[0]) as f:
            for i, entry in enumerate(ilabel_info):
                if len(entry) == 1 and entry[0] < 0:
                    f.write(f"{i}\n".encode())
    _write_fst_out(clg, fout)
    return 0


def arpa2fst(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert an ARPA format language model into a word acceptor "
        "FST (lmbin/arpa2fst.cc)\n"
        "Usage: arpa2fst [options] <arpa-rxfilename> <fst-wxfilename>")
    disambig = po.register_value(
        "disambig-symbol", "",
        "Disambiguation symbol to put on backoff arcs (e.g. #0); "
        "empty means epsilon")
    symtab = po.register_value(
        "read-symbol-table", "", "Word symbol table (words.txt)")
    bos = po.register_value("bos-symbol", "<s>",
                            "Beginning of sentence symbol")
    eos = po.register_value("eos-symbol", "</s>",
                            "End of sentence symbol")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    with kaldi_io.input_stream(po.get_arg(1)) as f:
        lm = parse_arpa(f.read().decode("utf-8", errors="replace"))
    if symtab[0]:
        word_to_id = read_symbol_table(symtab[0])
    else:
        vocab = sorted({w for order in lm.ngrams for ng in order
                        for w in ng})
        word_to_id = {w: i + 1 for i, w in enumerate(vocab)}
    backoff_label = 0
    if disambig[0]:
        if disambig[0] not in word_to_id:
            raise KaldiTpuError(
                f"disambig symbol {disambig[0]!r} not in symbol table")
        backoff_label = word_to_id[disambig[0]]
    fst = arpa_to_fst(lm, word_to_id, bos=bos[0], eos=eos[0],
                      backoff_label=backoff_label)
    _write_fst_out(fst, po.get_arg(2))
    return 0
