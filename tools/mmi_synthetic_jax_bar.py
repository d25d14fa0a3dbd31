#!/usr/bin/env python3
"""The JAX package on the CPU: the bars that the PyTorch port's
`gmm_mmi` and `synthetic_run` phases (chip_smoke.py) are held to, and
the two small files those phases start from.

gmm_mmi: the generic corpus recipe (egs/template/run.py, through
`tools/template_jax_bar.py --chain-epochs 0 --out DIR`, or that DIR if
given) gives the tri1 system; its final.mdl and tree are copied to
--tri1-out (tests/data/template_tri1: the port's phase runs MMI from the
same system).  Then boosted MMI with the JAX package's `train_mmi`
(b=0.1, TrainMmiOptions' defaults: 4 iterations, E=2, tau=100) over the
first 24 training utterances, the denominator lattices over a unigram G
of the whole training text (make_denlats.sh's weak LM), the boost
replaced by lattice-boost-ali's (the package's own `_boost_lattice`
lowers the cost of the arcs that match the numerator, the opposite sign;
ROADMAP.md §3); the test set's WER before and after through the recipe's
HCLG.

synthetic_run: egs/synthetic/run.py stages 0-7 with the chain model's
initial weights written to --chain-init-out first (the draw the
reference's `_fit_chain` makes from PRNGKey(0), in flax's layout; the
port's phase trains from them) and the WER of stages 4, 6 and 7.  The
reference's latgen-faster-mapped determinizes each lattice without
pruning, passes 100,000 states on every one of these lattices and writes
the raw lattice after minutes of host time; here its
`determinize_lattice` returns the raw lattice at once, the same file.

Prints one JSON line: MMI_JAX_BAR's and SYNTHETIC_JAX_BAR's numbers and
each part's seconds.

Run: JAX_PLATFORMS=cpu python tools/mmi_synthetic_jax_bar.py
     [--template-dir DIR] [--out DIR] [--tri1-out DIR] [--chain-init-out F]
"""

import argparse
import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MMI_UTTS, MMI_BOOST, MMI_ITERS = 24, 0.1, 4


def repaired_boost(lat, alignment, tm, boost):
    """lattice-boost-ali's boost on a JAX lattice, in place: each arc's
    graph cost lowered by boost x its frame's phone error."""
    from kaldi_tpu.lat.functions import lattice_state_times
    times = lattice_state_times(lat)
    ref = [tm.transition_id_to_phone(t) for t in alignment]
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            if a.ilabel != 0 and times[s] < len(ref):
                err = float(tm.transition_id_to_phone(a.ilabel) !=
                            ref[times[s]])
                a.weight = (a.weight[0] - boost * err, a.weight[1])


def read_texts(path):
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            out[parts[0]] = parts[1:]
    return out


def wer(refs, hyps):
    from kaldi_tpu.util.edit_distance import WerStats
    st = WerStats()
    for u, r in refs.items():
        st.add(r, hyps.get(u, []))
    return {"wer": st.wer, "word_errors": st.errors,
            "ref_words": st.ref_words}


def mmi_bar(tdir: str) -> dict:
    from kaldi_tpu.cli.gmm_tools import read_am_gmm
    from kaldi_tpu.decoder.graph import Lang
    from kaldi_tpu.fstext.fst import Arc, TropicalWeight, VectorFst
    from kaldi_tpu.fstext.openfst_io import read_fst_file
    from kaldi_tpu.recipes import mmi as jmmi
    from kaldi_tpu.recipes.mono import MonoSystem, decode
    from kaldi_tpu.tree import ContextDependency
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.table import SequentialTableReader
    lexicon = {}
    with open(os.path.join(tdir, "lexicon.txt")) as f:
        for line in f:
            parts = line.split()
            lexicon.setdefault(parts[0], []).append(parts[1:])
    lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    tm, am = read_am_gmm(os.path.join(tdir, "exp", "tri1", "final.mdl"))
    lang.topo = tm.topo
    tree = kaldi_io.read_kaldi_object(
        ContextDependency.read, os.path.join(tdir, "exp", "tri1", "tree"))
    sys_ = MonoSystem(lang, tree, tm, am)
    feats_all = dict(SequentialTableReader(
        "matrix", f"ark:{tdir}/train/feats.ark"))
    texts_all = read_texts(os.path.join(tdir, "train", "text"))
    utts = sorted(feats_all)[:MMI_UTTS]
    feats = {u: np.asarray(feats_all[u]) for u in utts}
    texts = {u: texts_all[u] for u in utts}
    test = {u: np.asarray(f) for u, f in SequentialTableReader(
        "matrix", f"ark:{tdir}/test/feats.ark")}
    refs = read_texts(os.path.join(tdir, "test", "text"))
    counts = collections.Counter(w for t in texts_all.values() for w in t)
    total = sum(counts.values())
    g = VectorFst(TropicalWeight)
    s = g.add_state()
    g.set_start(s)
    g.set_final(s)
    for w in sorted(counts):
        g.add_arc(s, Arc(lang.words[w], lang.words[w],
                         float(-np.log(counts[w] / total)), s))
    hclg = read_fst_file(os.path.join(tdir, "exp", "tri1", "HCLG.fst"))
    before = wer(refs, decode(sys_, hclg, test, acoustic_scale=0.1))
    jmmi._boost_lattice = repaired_boost
    objs = jmmi.train_mmi(sys_, feats, texts, g, jmmi.TrainMmiOptions(
        num_iters=MMI_ITERS, boost=MMI_BOOST))
    after = wer(refs, decode(sys_, hclg, test, acoustic_scale=0.1))
    return {"objf": [float(o) for o in objs], "wer_before": before,
            "wer_after": after, "utterances": len(utts),
            "pdfs": tm.num_pdfs, "gaussians": am.num_gauss()}


def synthetic_bar(d: str, chain_init_out: str) -> dict:
    import jax
    import jax.numpy as jnp
    import run as synthetic_recipe
    from kaldi_tpu.lat import functions as latf
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    # the recipe's chain model (egs/synthetic/run.py:199-204); 3 phones
    cfg = ChainTdnnfConfig(feat_dim=13, num_pdfs=6, hidden_dim=64,
                           bottleneck_dim=16, prefinal_dim=32, num_layers=4,
                           subsample_layer=2, frame_subsampling_factor=3)
    v = ChainTdnnf(cfg, train=True).init(jax.random.PRNGKey(0),
                                         jnp.zeros((2, 60, 13)))
    flat = {}

    def walk(node, prefix):
        for k, x in node.items():
            if isinstance(x, dict) or hasattr(x, "items"):
                walk(x, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(x)

    walk({"params": v["params"], "batch_stats": v["batch_stats"]}, "")
    if chain_init_out:
        os.makedirs(os.path.dirname(os.path.abspath(chain_init_out)),
                    exist_ok=True)
        np.savez(chain_init_out, **flat)
    latf.determinize_lattice = lambda lat: lat
    argv = sys.argv
    sys.argv = ["run.py", "--dir", d]
    try:
        with contextlib.redirect_stdout(sys.stderr):
            synthetic_recipe.main()
    finally:
        sys.argv = argv
    from kaldi_tpu.util.table import SequentialTableReader
    refs = read_texts(os.path.join(d, "data", "test", "text"))

    def hyps(path):
        return {u: list(v) for u, v in SequentialTableReader(
            "token-vector", f"ark:{path}")}

    return {"gmm": wer(refs, hyps(os.path.join(d, "exp", "mono",
                                               "hyp.txt"))),
            "chain": wer(refs, hyps(os.path.join(d, "exp", "chain",
                                                 "hyp.txt"))),
            "online": wer(refs, hyps(os.path.join(d, "exp", "chain",
                                                  "online_hyp.txt")))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--template-dir", default="",
                    help="a finished `tools/template_jax_bar.py "
                    "--chain-epochs 0 --out DIR` (else it runs here)")
    ap.add_argument("--out", default="", help="keep the files here")
    ap.add_argument("--tri1-out", default="",
                    help="copy tri1's final.mdl and tree here")
    ap.add_argument("--chain-init-out", default="",
                    help="write the synthetic chain model's initial "
                    "weights here (.npz)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(REPO, "egs", "synthetic"))
    res: dict = {"stage_s": {}}
    with contextlib.ExitStack() as stack:
        out = args.out or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(out, exist_ok=True)
        tdir = args.template_dir
        t0 = time.perf_counter()
        if not tdir:
            tdir = os.path.join(out, "template")
            subprocess.run([sys.executable, os.path.join(
                REPO, "tools", "template_jax_bar.py"), "--chain-epochs", "0",
                "--out", tdir], check=True, stdout=sys.stderr)
        res["stage_s"]["template"] = time.perf_counter() - t0
        if args.tri1_out:
            os.makedirs(args.tri1_out, exist_ok=True)
            for name in ("final.mdl", "tree"):
                shutil.copy(os.path.join(tdir, "exp", "tri1", name),
                            os.path.join(args.tri1_out, name))
        t0 = time.perf_counter()
        res["mmi"] = mmi_bar(tdir)
        res["stage_s"]["mmi"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["synthetic"] = synthetic_bar(os.path.join(out, "synthetic"),
                                         args.chain_init_out)
        res["stage_s"]["synthetic"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
