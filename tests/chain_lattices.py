"""Seeded lattices of a small chain system for the lattice tools' tests:
the width-1 chain system of test_torch_mkgraph_tools.py (optional
silence, homophones, alternative pronunciations), its HCLG built by
the port's tools (tools/mkgraph_steps.py), and the port's
LatticeFasterDecoder on loglikes peaked along random paths of that
graph, determinized as nnet3-latgen-faster determinizes them.  The
weights are random floats, so no two paths tie exactly."""

import os
import sys

import numpy as np

from kaldi_tpu_torch.decoder.lattice_decoder import (
    LatticeFasterDecoder, LatticeFasterDecoderOptions)
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
from kaldi_tpu_torch.lat.functions import determinize_lattice
from kaldi_tpu_torch.recipes.bench_corpus import chain_tm_tree_for
from kaldi_tpu_torch.util.table import TableWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import mkgraph_steps  # noqa: E402

PRONS = {"A": [["AH"], ["EY"]], "B": [["B", "IY"]], "BEE": [["B", "IY"]],
         "BE": [["B", "IY"]], "C": [["S", "IY"]], "SEA": [["S", "IY"]],
         "SEAT": [["S", "IY", "T"]], "CAT": [["K", "AE", "T"]]}
# the homophones' counts differ (B 4, BEE 2, BE 1; C 3, SEA 1), so no two
# of their paths tie
SENTENCES = [["A", "CAT"], ["SEA", "B"], ["BEE", "SEAT", "A"], ["C", "BE"],
             ["CAT", "C", "SEAT"], ["A", "B", "C"], ["B", "A", "CAT"],
             ["B", "BEE", "C", "B"]]


def build_chain_system(d: str) -> dict:
    """lang, G, tree, final.tm and graph/HCLG.fst under d."""
    lang, tm, tree = chain_tm_tree_for(PRONS)
    inp = mkgraph_steps.legacy_inputs(d, PRONS, SENTENCES, tm, tree)
    rep = mkgraph_steps.mkgraph(inp["lang"], inp["G"], inp["tree"],
                                inp["tm"], os.path.join(d, "graph"),
                                1.0, 1.0)
    return dict(inp, tm_obj=tm, tree_obj=tree, lang_obj=lang, report=rep,
                hclg=os.path.join(d, "graph", "HCLG.fst"))


def write_lattices(system: dict, path: str, n: int = 8, seed: int = 0,
                   lattice_beam: float = 5.0,
                   determinize: bool = True) -> dict:
    """n utterances' lattices (determinized, or the decoder's raw
    state-level ones) -> ark at `path`; returns them by key."""
    tm = system["tm_obj"]
    hclg = read_fst_file(system["hclg"])
    rng = np.random.default_rng(seed)
    best = FasterDecoder(hclg, FasterDecoderOptions(beam=1e9))
    dec = LatticeFasterDecoder(hclg, LatticeFasterDecoderOptions(
        beam=15.0, lattice_beam=lattice_beam))
    out = {}
    for u in range(n):
        T = int(rng.integers(20, 45))
        ll = (3.0 * rng.standard_normal((T, tm.num_pdfs))).astype(np.float32)
        ali = best.decode(ll, tm.id2pdf_id)[0]
        ll = rng.standard_normal(ll.shape).astype(np.float32)
        ll[np.arange(T), tm.id2pdf_id[ali]] += 4.0
        lat = dec.decode(ll, tm.id2pdf_id, 1.0)
        out[f"utt{u:02d}"] = determinize_lattice(lat) if determinize else lat
    with TableWriter("lattice", f"ark:{path}") as w:
        for k, lat in out.items():
            w.write(k, lat)
    return out
