"""Port parity, on the CPU: the decoder-variant tools of
`kaldi_tpu_torch/cli/decoders2_tools.py` (gmm-decode-simple,
gmm-latgen-simple, gmm-decode-biglm-faster, gmm-latgen-biglm-faster,
gmm-latgen-map, latgen-incremental-mapped) against the JAX package's
tools, run as tests/test_cli_decoders2.py runs them, on the JAX
package's monophone system over its synthetic YES/NO corpus.

The port scores the GMMs itself (float32 products that round apart from
the reference's numpy ones), so for the byte comparisons its
`AmDiagGmm.log_likes_device` is handed the JAX package's loglikes of the
same features (as tests/test_torch_mkgraph.py does): the searches, the
determinization and the writers then see the same input, and every
archive is compared byte for byte.  The lattice tools run with
--prune-interval=0 on both sides: the port's periodic link pruning is
upstream's, not the reference's (tests/test_torch_lattice_decoder.py).
latgen-incremental-mapped's lattices are compared where nothing is
pruned (the first 24 frames at beams of 1e4): the port's incremental
decoder carries the tokens' costs across chunks, a repaired reference
fault (tests/test_torch_incremental.py), so where the beams cut, its
lattices may differ; at the reference test's beams its words are JAX's.
One more case runs the port's own GMM scoring to the transcripts.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.util.table import SequentialTableReader


def run(side, tool, *args):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and \
        tool != "latgen-incremental-mapped" else []
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exited {rc}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from test_mono_e2e import FS, make_corpus, unigram_g

    from kaldi_tpu.cli.gmm_tools import write_am_gmm
    from kaldi_tpu.decoder.graph import Lang
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.fstext.fst import Arc, TropicalWeight, VectorFst
    from kaldi_tpu.fstext.openfst_io import write_fst
    from kaldi_tpu.gmm.am_diag_gmm import AmDiagGmm
    from kaldi_tpu.recipes.mono import (TrainMonoOptions, make_hclg,
                                        train_mono)
    from kaldi_tpu.util.table import TableWriter
    d = tmp_path_factory.mktemp("decoders2")
    train_txt, train_wav, test_txt, test_wav = make_corpus(
        num_train=8, num_test=3)
    comp = OfflineFeature(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=FS, dither=0.0)))
    tf = dict(zip(train_wav, comp.compute_batch(list(train_wav.values()))))
    sf = dict(zip(test_wav, comp.compute_batch(list(test_wav.values()))))
    lang = Lang({"YES": [["Y"]], "NO": [["N"]]}, sil_phone="SIL",
                sil_prob=0.5)
    lang.make_topology()
    sys_ = train_mono(lang, tf, train_txt,
                      TrainMonoOptions(num_iters=4, totgauss=24,
                                       realign_iters=(1, 2, 3)))
    write_am_gmm(f"{d}/final.mdl", sys_.tm, sys_.am)
    g = unigram_g(lang)
    with open(f"{d}/G.fst", "wb") as f:
        write_fst(f, g)
    with open(f"{d}/HCLG.fst", "wb") as f:
        write_fst(f, make_hclg(sys_, g))
    # the reference test's second LM: every weight doubled
    g2 = VectorFst(TropicalWeight)
    g2.add_states(g.num_states)
    g2.start = g.start
    for s in range(g.num_states):
        g2.finals[s] = g.finals[s]
        for a in g.arcs[s]:
            g2.add_arc(s, Arc(a.ilabel, a.olabel, float(a.weight) * 2.0,
                              a.nextstate))
    with open(f"{d}/G2.fst", "wb") as f:
        write_fst(f, g2)
    with TableWriter("matrix", f"ark:{d}/test_feats.ark") as w:
        for u in sorted(sf):
            w.write(u, sf[u])
    with TableWriter("matrix", f"ark:{d}/ll.ark") as w, \
            TableWriter("matrix", f"ark:{d}/ll24.ark") as w24:
        for u in sorted(sf):
            ll = np.asarray(sys_.am.log_likes_batch(sf[u]), np.float32)
            w.write(u, ll)
            w24.write(u, ll[:24])
    with TableWriter(AmDiagGmm, f"ark:{d}/gmms.ark") as w:
        w.write("spk", sys_.am)
    with open(f"{d}/utt2spk", "w") as f:
        f.writelines(f"{u} spk\n" for u in sorted(sf))
    words = {v: k for k, v in lang.words.items()}
    return dict(d=d, am=sys_.am, test_txt=test_txt, words=words)


@pytest.fixture
def jax_scores(env, monkeypatch):
    """The port's GMM scoring handed the JAX package's loglikes."""
    from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
    jam = env["am"]

    def scores(self, feats):
        return torch.from_numpy(np.asarray(jam.log_likes_batch(
            feats.cpu().numpy()))).to(feats.device)
    monkeypatch.setattr(AmDiagGmm, "log_likes_device", scores)


def same(tmp_path, *names):
    for n in names:
        a = (tmp_path / f"torch.{n}").read_bytes()
        assert a == (tmp_path / f"jax.{n}").read_bytes(), n
        assert len(a) > 0, n


CASES = {
    "gmm-decode-simple": (
        ["--acoustic-scale=0.1", "{d}/final.mdl", "{d}/HCLG.fst",
         "ark:{d}/test_feats.ark", "ark,t:{o}.words", "ark,t:{o}.ali",
         "ark:{o}.lat"], ("words", "ali", "lat")),
    "gmm-latgen-simple": (
        ["--acoustic-scale=0.1", "--prune-interval=0", "{d}/final.mdl",
         "{d}/HCLG.fst", "ark:{d}/test_feats.ark", "ark:{o}.lat",
         "ark,t:{o}.words", "ark,t:{o}.ali"], ("lat", "words", "ali")),
    "gmm-decode-biglm-faster": (
        ["--acoustic-scale=0.1", "--beam=16", "{d}/final.mdl",
         "{d}/HCLG.fst", "{d}/G.fst", "{d}/G2.fst",
         "ark:{d}/test_feats.ark", "ark,t:{o}.words", "ark,t:{o}.ali"],
        ("words", "ali")),
    "gmm-latgen-biglm-faster": (
        ["--acoustic-scale=0.1", "--beam=16", "--prune-interval=0",
         "{d}/final.mdl", "{d}/HCLG.fst", "{d}/G.fst", "{d}/G2.fst",
         "ark:{d}/test_feats.ark", "ark:{o}.lat", "ark,t:{o}.words"],
        ("lat", "words")),
    "gmm-latgen-map": (
        ["--acoustic-scale=0.1", "--beam=16", "--prune-interval=0",
         "--utt2spk=ark,t:{d}/utt2spk", "{d}/final.mdl", "ark:{d}/gmms.ark",
         "{d}/HCLG.fst", "ark:{d}/test_feats.ark", "ark:{o}.lat",
         "ark,t:{o}.words"], ("lat", "words")),
    "latgen-incremental-mapped": (
        ["--acoustic-scale=0.1", "--beam=1e4", "--lattice-beam=1e4",
         "--determinize-period=7", "{d}/final.mdl", "{d}/HCLG.fst",
         "ark:{d}/ll24.ark", "ark:{o}.lat", "ark,t:{o}.words"],
        ("lat", "words")),
    # the reference test's beams: the words
    "latgen-incremental-mapped ": (
        ["--acoustic-scale=0.1", "--beam=16", "--determinize-period=25",
         "{d}/final.mdl", "{d}/HCLG.fst", "ark:{d}/ll.ark", "ark:{o}.lat",
         "ark,t:{o}.words"], ("words",)),
}


@pytest.mark.parametrize("tool", sorted(CASES))
def test_tool_bytes_equal_jax(env, jax_scores, tmp_path, tool):
    args, outs = CASES[tool]
    for side in ("jax", "torch"):
        run(side, tool.strip(), *[a.format(d=env["d"], o=tmp_path / side)
                                  for a in args])
    same(tmp_path, *outs)
    got = dict(SequentialTableReader("int-vector",
                                     f"ark:{tmp_path}/torch.words"))
    assert len(got) == len(env["test_txt"])


def test_same_lm_twice_equals_the_plain_decode(env, jax_scores, tmp_path):
    """gmm-decode-biglm-faster with old G = new G writes the words of
    JAX's gmm-decode-faster over the same HCLG (the port has no
    gmm-decode-faster), and gmm-latgen-biglm-faster the lattices of the
    port's gmm-latgen-faster, byte for byte."""
    d = env["d"]
    run("torch", "gmm-decode-biglm-faster", "--acoustic-scale=0.1",
        "--beam=16", d / "final.mdl", d / "HCLG.fst", d / "G.fst",
        d / "G.fst", f"ark:{d}/test_feats.ark", f"ark,t:{tmp_path}/torch.w")
    run("jax", "gmm-decode-faster", "--acoustic-scale=0.1", "--beam=16",
        d / "final.mdl", d / "HCLG.fst", f"ark:{d}/test_feats.ark",
        f"ark,t:{tmp_path}/jax.w")
    same(tmp_path, "w")
    run("torch", "gmm-latgen-biglm-faster", "--acoustic-scale=0.1",
        "--beam=16", d / "final.mdl", d / "HCLG.fst", d / "G.fst",
        d / "G.fst", f"ark:{d}/test_feats.ark", f"ark:{tmp_path}/torch.l")
    run("torch", "gmm-latgen-faster", "--acoustic-scale=0.1", "--beam=16",
        d / "final.mdl", d / "HCLG.fst", f"ark:{d}/test_feats.ark",
        f"ark:{tmp_path}/plain.l")
    assert (tmp_path / "torch.l").read_bytes() == \
        (tmp_path / "plain.l").read_bytes()


@pytest.mark.parametrize("tool", ["gmm-decode-simple",
                                  "gmm-latgen-biglm-faster",
                                  "gmm-latgen-map"])
def test_own_scoring_decodes_the_transcripts(env, tmp_path, tool):
    args, _ = CASES[tool]
    run("torch", tool, *[a.format(d=env["d"], o=tmp_path / "t")
                         for a in args])
    got = dict(SequentialTableReader("int-vector",
                                     f"ark:{tmp_path}/t.words"))
    for u, ref in env["test_txt"].items():
        assert [env["words"][w] for w in got[u]] == list(ref), u
