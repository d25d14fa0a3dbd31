"""make-h-transducer and add-self-loops (ports of
`kaldi_tpu/cli/tail6_tools.py`'s tools; parity:
bin/make-h-transducer.cc, bin/add-self-loops.cc): the H level of
mkgraph.sh's by-hand route.  Host-side.  The model arguments are read
for their TransitionModel only, as Kaldi's tools read them.
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.cli.fst_tools import _write_fst_out
from kaldi_tpu_torch.cli.gmm_tools import _read_tm
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
from kaldi_tpu_torch.hmm import hmm_utils
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions


def read_ilabel_info(rxfilename: str) -> List[tuple]:
    """The ilabel-info file that fstcomposecontext writes."""
    with kaldi_io.input_stream(rxfilename) as f:
        b = iof.init_input_stream(f)
        count = iof.read_int32(f, b)
        return [tuple(iof.read_int_vector(f, b)) for _ in range(count)]


def make_h_transducer(argv: List[str]) -> int:
    po = ParseOptions(
        "Make the Ha transducer (transition-ids, self-loops excluded, "
        "to context-dependent-phone ilabel indices; "
        "make-h-transducer.cc).\n"
        "Usage: make-h-transducer [options] <ilabel-info-file> "
        "<tree-in> <model-in> [<H-out>]")
    transition_scale = po.register_value(
        "transition-scale", 1.0, "Scale on transition probabilities "
        "(excluding self-loops)")
    disambig_out = po.register_value(
        "disambig-syms-out", "", "File to write the H-side "
        "disambiguation symbol ids")
    po.read(argv)
    if po.num_args() < 3 or po.num_args() > 4:
        po.print_usage()
        return 1
    ilabel_info = read_ilabel_info(po.get_arg(1))
    tree = kaldi_io.read_kaldi_object(ContextDependency.read,
                                      po.get_arg(2))
    tm = _read_tm(po.get_arg(3))
    ha, disambig = hmm_utils.make_h_transducer(
        ilabel_info, tree, tm, transition_scale=transition_scale[0])
    if disambig_out[0]:
        with open(disambig_out[0], "w") as f:
            for d in disambig:
                f.write(f"{d}\n")
    _write_fst_out(ha, po.get_arg(4) if po.num_args() == 4 else "-")
    log(f"made H transducer: {ha.num_states} states, "
        f"{len(disambig)} disambig syms")
    return 0


def add_self_loops(argv: List[str]) -> int:
    po = ParseOptions(
        "Add self-loops (reorder=true) and undo the 1-p_self "
        "renormalization at the given scale (add-self-loops.cc).\n"
        "Usage: add-self-loops [options] <model-in> [<fst-in> "
        "[<fst-out>]]")
    self_loop_scale = po.register_value(
        "self-loop-scale", 0.1, "Scale on self-loop log-probs")
    po.read(argv)
    if po.num_args() < 1 or po.num_args() > 3:
        po.print_usage()
        return 1
    tm = _read_tm(po.get_arg(1))
    fst = read_fst_file(po.get_arg(2) if po.num_args() >= 2 else "-")
    out = hmm_utils.add_self_loops(fst, tm,
                                   self_loop_scale=self_loop_scale[0])
    _write_fst_out(out, po.get_arg(3) if po.num_args() == 3 else "-")
    return 0
