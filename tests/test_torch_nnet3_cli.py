"""The port's nnet3-compute and nnet3-compute-batch
(kaldi_tpu_torch/cli/nnet3_tools.py) against the JAX package's tools, in
process on the CPU: on the reference golden model and on a small TDNN-F
exported as .raw and as .mdl, the output arks equal within 1e-5 absolute
(float32, other summation orders).  The port has no host fallback: a
component without a device mapping ends the tool with an error, and
--use-device=false asks for the host evaluator.  And the table layer
(util/table.py, util/kaldi_io.py) against kaldi_tpu/util/table.py:
rspecifier and wspecifier parsing, archives and scripts each package
reads from the other, pipes."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.util import table as JT
from kaldi_tpu_torch.cli import TOOLS, get_tool
from kaldi_tpu_torch.nnet3 import mdl_io as PM
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.util import table as PT
from test_torch_nnet3_mdl_io import (COMPONENTS, TDNNF, make,
                                     seeded_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "ref_golden")
TOL = 1e-5


def read_ark(path):
    return dict(PT.SequentialTableReader("matrix", f"ark:{path}"))


def run_both(tool, args, tmp_path, opts=(), port_opts=("--use-gpu=no",)):
    """The tool of each package on the same arguments and options (the
    port's own options added); -> (port ark, JAX ark) as dicts."""
    out = {}
    for who, get, opts in (("port", get_tool, [*port_opts, *opts]),
                           ("jax", jax_tool, list(opts))):
        path = str(tmp_path / f"{who}.ark")
        rc = get(tool)([tool, *opts, *args, f"ark:{path}"])
        assert rc == 0, who
        out[who] = read_ark(path)
    return out["port"], out["jax"]


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """A 5-layer TDNN-F of the port, exported as .raw and, with a
    transition model, as .mdl; 3 utterances of 40-60 frames."""
    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
    d = tmp_path_factory.mktemp("model")
    cfg = ChainTdnnfConfig(**TDNNF)
    model = chain_tdnnf_from_flax(cfg, seeded_variables(cfg, seed=2),
                                  device="cpu")
    graph = PM.chain_tdnnf_to_nnet3(model)
    PM.write_raw_nnet3(graph, str(d / "final.raw"))
    topo = HmmTopology.chain_topology([1, 2, 3])
    tm = TransitionModel(topo, monophone_context_dependency(
        [1, 2, 3], {p: topo.num_pdf_classes(p) for p in (1, 2, 3)}))
    PM.write_nnet3_am(str(d / "final.mdl"), tm, graph)
    rng = np.random.default_rng(0)
    with PT.TableWriter("matrix", f"ark:{d / 'feats.ark'}") as w:
        for i, T in enumerate((40, 53, 60)):
            w.write(f"utt{i}", rng.normal(size=(T, cfg.feat_dim))
                    .astype(np.float32))
    return d


@pytest.mark.parametrize("tool", ["nnet3-compute", "nnet3-compute-batch"])
@pytest.mark.parametrize("model", ["golden", "final.raw", "final.mdl"])
def test_tool_matches_jax(tool, model, small_model, tmp_path):
    if model == "golden":
        mdl, feats = os.path.join(GOLDEN, "tdnn.raw"), \
            os.path.join(GOLDEN, "feats.ark")
    else:
        mdl, feats = str(small_model / model), str(small_model / "feats.ark")
    got, want = run_both(tool, [mdl, f"ark:{feats}"], tmp_path)
    assert sorted(got) == sorted(want) == sorted(read_ark(feats))
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=TOL)


def test_xent_head_batch_size_and_host_evaluator(small_model, tmp_path):
    args = [str(small_model / "final.mdl"),
            f"ark:{small_model / 'feats.ark'}"]
    for tool, opts, port_opts in (
            ("nnet3-compute-batch", ("--batch-size=2",
                                     "--use-xent-output=true"),
             ("--use-gpu=no",)),
            ("nnet3-compute", ("--use-xent-output=true",),
             ("--use-gpu=no",)),
            ("nnet3-compute", (), ("--use-device=false",))):
        got, want = run_both(tool, args, tmp_path, opts, port_opts)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL)


def test_ivectors_option(tmp_path):
    """--ivectors: one i-vector an utterance into an i-vector model; the
    tool's output equals the compiled module's on the same batch."""
    import torch
    from kaldi_tpu_torch.cli.nnet3_tools import pad_batch
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    cfg = ChainTdnnfConfig(**dict(TDNNF, ivector_dim=5))
    model = chain_tdnnf_from_flax(cfg, seeded_variables(cfg), device="cpu")
    graph = PM.chain_tdnnf_to_nnet3(model)
    PM.write_raw_nnet3(graph, str(tmp_path / "iv.raw"))
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(T, 8)).astype(np.float32) for T in (30, 41)]
    ivs = rng.normal(size=(2, 5)).astype(np.float32)
    with PT.TableWriter("matrix", f"ark:{tmp_path / 'f.ark'}") as w:
        for i, f in enumerate(feats):
            w.write(f"u{i}", f)
    with PT.TableWriter("vector", f"ark,t:{tmp_path / 'iv.ark'}") as w:
        for i, v in enumerate(ivs):
            w.write(f"u{i}", v)
    out = str(tmp_path / "o.ark")
    assert get_tool("nnet3-compute-batch")(
        ["nnet3-compute-batch", "--use-gpu=no",
         f"--ivectors=ark:{tmp_path / 'iv.ark'}", str(tmp_path / "iv.raw"),
         f"ark:{tmp_path / 'f.ark'}", f"ark:{out}"]) == 0
    want = compile_graph(graph, device="cpu")(
        torch.from_numpy(pad_batch(feats)), torch.from_numpy(ivs)).numpy()
    for i, (k, m) in enumerate(sorted(read_ark(out).items())):
        np.testing.assert_array_equal(m, want[i, :feats[i].shape[0]])
    # without --ivectors the model's ivector input is missing: an error
    assert subprocess.run(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", "nnet3-compute",
         "--use-gpu=no", str(tmp_path / "iv.raw"),
         f"ark:{tmp_path / 'f.ark'}", f"ark:{out}"], cwd=REPO,
        capture_output=True, timeout=120).returncode != 0


def test_no_host_fallback_and_refused_branches(tmp_path, monkeypatch,
                                               capsys):
    """A component without a device mapping ends the tool nonzero (the
    JAX tool would evaluate on the host); --use-device=false runs it on
    the host; a directory that is not an xconfig checkpoint is refused
    (tests/test_torch_cli_latgen.py runs one that is); the card is the
    default."""
    comp = make(PM, "DropoutMaskComponent", dict(COMPONENTS)[
        "DropoutMaskComponent"])
    nodes = [PM.Node("input", "input", dim=4),
             PM.Node("component", "m", component="m",
                     desc=PM.parse_descriptor("input")),
             PM.Node("output", "output", desc=PM.parse_descriptor("m"))]
    PM.write_raw_nnet3(PM.Nnet3Graph(nodes, {"m": comp}),
                       str(tmp_path / "m.raw"))
    with PT.TableWriter("matrix", f"ark:{tmp_path / 'f.ark'}") as w:
        w.write("u", np.ones((5, 4), np.float32))

    from kaldi_tpu_torch.cli.__main__ import main

    def cli(*args):
        """The dispatcher of `python -m kaldi_tpu_torch.cli`, in process:
        -> (exit status, stderr)."""
        monkeypatch.setattr(sys, "argv", ["kaldi_tpu_torch.cli", *args])
        capsys.readouterr()
        rc = main()
        return rc, capsys.readouterr().err
    io_args = [f"ark:{tmp_path / 'f.ark'}", f"ark:{tmp_path / 'o.ark'}"]
    for tool in ("nnet3-compute", "nnet3-compute-batch"):
        rc, err = cli(tool, "--use-gpu=no", str(tmp_path / "m.raw"),
                      *io_args)
        assert rc != 0 and "no torch mapping" in err
    rc, _err = cli("nnet3-compute", "--use-device=false",
                   str(tmp_path / "m.raw"), *io_args)
    assert rc == 0
    assert read_ark(str(tmp_path / "o.ark"))["u"].shape == (5, 3)
    rc, err = cli("nnet3-compute", "--use-gpu=no", str(tmp_path), *io_args)
    assert rc != 0 and "not an xconfig checkpoint directory" in err
    if not __import__("torch").cuda.is_available():
        rc, err = cli("nnet3-compute", os.path.join(GOLDEN, "tdnn.raw"),
                      *io_args)
        assert rc != 0 and "CUDA" in err
    assert sorted(TOOLS) == ["acc-lda", "acc-tree-stats", "add-deltas",
                             "add-self-loops", "agglomerative-cluster",
                             "ali-to-pdf", "ali-to-phones", "ali-to-post",
                             "align-equal-compiled", "apply-cmvn",
                             "apply-cmvn-sliding", "arpa-to-const-arpa",
                             "arpa2fst", "build-tree", "chain-est-phone-lm",
                             "chain-get-supervision", "chain-make-den-fst",
                             "cluster-phones", "compile-train-graphs",
                             "compose-transforms", "compute-cmvn-stats",
                             "compute-eer", "compute-mfcc-feats",
                             "compute-vad", "compute-vad-from-frame-likes",
                             "compute-wer", "convert-ali", "copy-feats",
                             "copy-gselect", "copy-int-vector",
                             "decode-faster-mapped", "est-lda", "est-mllt",
                             "extract-segments", "feat-to-dim", "feat-to-len",
                             "fgmm-global-acc-stats",
                             "fgmm-global-acc-stats-post", "fgmm-global-copy",
                             "fgmm-global-est", "fgmm-global-get-frame-likes",
                             "fgmm-global-gselect-to-post", "fgmm-global-info",
                             "fgmm-global-init-from-accs", "fgmm-global-merge",
                             "fgmm-global-sum-accs", "fgmm-global-to-gmm",
                             "fgmm-gselect", "fstaddselfloops",
                             "fstcomposecontext", "fstcopy",
                             "fstdeterminizestar", "fstisstochastic",
                             "fstminimizeencoded", "fstpushspecial",
                             "fstrmepslocal", "fstrmsymbols",
                             "fsttablecompose", "gmm-acc-mllt",
                             "gmm-acc-stats-ali", "gmm-acc-stats-twofeats",
                             "gmm-acc-stats2", "gmm-align-compiled", "gmm-est",
                             "gmm-est-fmllr", "gmm-est-gaussians-ebw",
                             "gmm-est-lvtln-trans", "gmm-est-weights-ebw",
                             "gmm-global-acc-stats",
                             "gmm-global-acc-stats-twofeats",
                             "gmm-global-copy", "gmm-global-est",
                             "gmm-global-est-fmllr",
                             "gmm-global-est-lvtln-trans",
                             "gmm-global-get-frame-likes",
                             "gmm-global-get-post",
                             "gmm-global-gselect-to-post", "gmm-global-info",
                             "gmm-global-init-from-feats",
                             "gmm-global-sum-accs", "gmm-global-to-fgmm",
                             "gmm-gselect", "gmm-info", "gmm-init-lvtln",
                             "gmm-init-mono", "gmm-ismooth-stats",
                             "gmm-latgen-faster", "gmm-rescore-lattice",
                             "gmm-sum-accs", "gmm-train-lvtln-special",
                             "gmm-transform-means", "ivector-adapt-plda",
                             "ivector-compute-dot-products",
                             "ivector-compute-lda", "ivector-compute-plda",
                             "ivector-copy-plda", "ivector-extract",
                             "ivector-extract-online",
                             "ivector-extract-online2",
                             "ivector-extractor-acc-stats",
                             "ivector-extractor-copy", "ivector-extractor-est",
                             "ivector-extractor-init",
                             "ivector-extractor-sum-accs", "ivector-mean",
                             "ivector-normalize-length",
                             "ivector-plda-scoring",
                             "ivector-plda-scoring-dense", "ivector-randomize",
                             "ivector-subtract-global-mean",
                             "ivector-transform", "latgen-faster-mapped",
                             "lattice-1best", "lattice-add-penalty",
                             "lattice-align-words",
                             "lattice-align-words-lexicon",
                             "lattice-best-path", "lattice-boost-ali",
                             "lattice-compose", "lattice-copy",
                             "lattice-determinize",
                             "lattice-determinize-phone-pruned",
                             "lattice-determinize-pruned", "lattice-lmrescore",
                             "lattice-lmrescore-const-arpa",
                             "lattice-lmrescore-pruned", "lattice-mbr-decode",
                             "lattice-prune", "lattice-scale",
                             "lattice-to-ctm-conf", "lattice-to-nbest",
                             "lattice-to-post", "logistic-regression-copy",
                             "logistic-regression-eval",
                             "logistic-regression-train", "make-h-transducer",
                             "merge-vads", "nbest-to-ctm", "nbest-to-linear",
                             "nnet3-align-compiled", "nnet3-average",
                             "nnet3-chain-combine", "nnet3-chain-combine2",
                             "nnet3-chain-compute-prob",
                             "nnet3-chain-copy-egs", "nnet3-chain-e2e-get-egs",
                             "nnet3-chain-get-egs", "nnet3-chain-merge-egs",
                             "nnet3-chain-normalize-egs",
                             "nnet3-chain-shuffle-egs",
                             "nnet3-chain-subset-egs", "nnet3-chain-train",
                             "nnet3-chain-train2", "nnet3-combine",
                             "nnet3-compute", "nnet3-compute-batch",
                             "nnet3-compute-from-egs", "nnet3-compute-prob",
                             "nnet3-copy", "nnet3-copy-egs",
                             "nnet3-discriminative-compute-from-egs",
                             "nnet3-discriminative-compute-objf",
                             "nnet3-discriminative-copy-egs",
                             "nnet3-discriminative-get-egs",
                             "nnet3-discriminative-merge-egs",
                             "nnet3-discriminative-shuffle-egs",
                             "nnet3-discriminative-subset-egs",
                             "nnet3-discriminative-train", "nnet3-get-egs",
                             "nnet3-latgen-faster",
                             "nnet3-latgen-faster-batch",
                             "nnet3-latgen-faster-looped", "nnet3-merge-egs",
                             "nnet3-shuffle-egs", "nnet3-subset-egs",
                             "nnet3-train", "online2-tcp-nnet3-decode-faster",
                             "online2-wav-dump-features",
                             "online2-wav-nnet3-latgen-faster",
                             "post-to-pdf-post", "prepare-lang",
                             "select-voiced-frames", "splice-feats",
                             "sum-tree-stats", "transform-feats",
                             "transform-vec", "validate-data-dir",
                             "validate-lang", "wav-to-duration"]


RSPECIFIERS = ["ark:foo.ark", "scp:foo.scp", "ark,s,cs:-", "ark,o,p:x.ark",
               "scp,bg,ns:a b.scp", "ark,t:gunzip -c f.gz|", "ark,b,ncs:f",
               "ark,np,no:f"]
WSPECIFIERS = ["ark:foo.ark", "ark,t:-", "ark,scp:f.ark,f.scp",
               "scp:f.scp", "ark,t,f,p:|gzip -c > x.gz", "ark,b,nf:o"]
BAD = ["foo.ark", "ark,x:f", "o:f"]


@pytest.mark.parametrize("spec", RSPECIFIERS + BAD)
def test_rspecifier_parsing_matches_jax(spec):
    try:
        want = JT.parse_rspecifier(spec)
    except Exception as e:              # noqa: BLE001
        with pytest.raises(Exception) as got:
            PT.parse_rspecifier(spec)
        assert type(got.value).__name__ == type(e).__name__
        return
    got = PT.parse_rspecifier(spec)
    assert got[:2] == want[:2]
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


@pytest.mark.parametrize("spec", WSPECIFIERS + BAD + ["ark,scp:f.ark"])
def test_wspecifier_parsing_matches_jax(spec):
    try:
        want = JT.parse_wspecifier(spec)
    except Exception as e:              # noqa: BLE001
        with pytest.raises(Exception) as got:
            PT.parse_wspecifier(spec)
        assert type(got.value).__name__ == type(e).__name__
        return
    got = PT.parse_wspecifier(spec)
    assert got[:3] == want[:3]
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])


@pytest.mark.parametrize("holder,values", [
    ("matrix", [np.arange(6, dtype=np.float32).reshape(2, 3),
                np.eye(2, dtype=np.float32)]),
    ("vector", [np.arange(3, dtype=np.float32), np.ones(1, np.float32)]),
    ("int-vector", [[1, 2, 3], []]),
    ("int", [7, -1]),
    ("token-vector", [["a", "b"], ["c"]]),
])
@pytest.mark.parametrize("mode", ["ark", "ark,t"])
def test_tables_cross_read(holder, values, mode, tmp_path):
    """Archives and scripts written by each package, read by the other;
    the same bytes; a pipe and a byte offset."""
    names = {}
    for who, T in (("port", PT), ("jax", JT)):
        ark, scp = tmp_path / f"{who}.ark", tmp_path / f"{who}.scp"
        with T.TableWriter(holder, f"{mode},scp:{ark},{scp}") as w:
            for i, v in enumerate(values):
                w.write(f"k{i}", v)
        names[who] = (ark, scp)
    assert names["port"][0].read_bytes() == names["jax"][0].read_bytes()
    for who, T in (("port", JT), ("jax", PT)):    # each reads the other
        ark, scp = names[who]
        for spec in (f"ark:{ark}", f"scp:{scp}", f"ark:cat {ark} |"):
            got = dict(T.SequentialTableReader(holder, spec))
            assert sorted(got) == [f"k{i}" for i in range(len(values))]
            for i, v in enumerate(values):
                np.testing.assert_array_equal(np.asarray(got[f"k{i}"]),
                                              np.asarray(v))
        ra = PT.RandomAccessTableReader(holder, f"scp:{scp}")
        assert "k1" in ra and "k9" not in ra
        np.testing.assert_array_equal(np.asarray(ra["k1"]),
                                      np.asarray(values[1]))


def test_kaldi_io_filenames_match_jax():
    from kaldi_tpu.util import kaldi_io as JK
    from kaldi_tpu_torch.util import kaldi_io as PK
    for name in ("", "-", "a.ark", "a.ark:12", "gunzip -c a|", "|gzip > a",
                 "a|b", "x:y"):
        assert PK.classify_rxfilename(name) == JK.classify_rxfilename(name)
        assert PK.classify_wxfilename(name) == JK.classify_wxfilename(name)
    buf = io.BytesIO(b"\x00B<Nnet3> ")
    from kaldi_tpu_torch.base import io_funcs
    r = io_funcs.PeekableReader(buf)
    assert io_funcs.init_input_stream(r) and \
        io_funcs.peek_token(r, True) == "<Nnet3>"
