"""Port parity: the chainbin tool chain of kaldi_tpu_torch against the JAX
package's, on the CPU, on the tiny mono-trained corpus of
tests/test_cli_chain.py: the phone LM, den.fst, normalization.fst and the
supervision archive byte for byte; every egs tool's archive byte for
byte; nnet3-chain-compute-prob's objective on one raw nnet within 1e-4
(host evaluator, --use-gpu=no); a raw nnet trained by either package read
by the other to the same forward; nnet3-chain-combine byte for byte; and
the whole chain through the port's get_tool as tests/test_cli_chain.py
runs it through the JAX package's."""

import os
import re
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.nnet3 import mdl_io as jmdl
from kaldi_tpu_torch.cli import get_tool as port_tool
from kaldi_tpu_torch.nnet3 import mdl_io as pmdl

sys.path.insert(0, os.path.dirname(__file__))
from test_cli_chain import chainsys  # noqa: E402,F401  (the fixture)

# the fixture's Lang: phone 2 is SIL (N, SIL, Y)
SIL = 2
TINY = ["--hidden-dim=32", "--bottleneck-dim=16", "--num-layers=2",
        "--frame-subsampling-factor=3"]


def run(get_tool, tool, *args):
    rc = get_tool(tool)([tool] + [str(a) for a in args])
    assert rc == 0, f"{tool} failed with {rc}"


def both(tool, d, *args):
    """The tool of each package, {out} in the arguments -> d/jax/..., and
    d/port/...; returns the two output directories."""
    outs = []
    for name, get_tool in (("jax", jax_tool), ("port", port_tool)):
        out = d / name
        out.mkdir(exist_ok=True)
        extra = ["--use-gpu=no"] if (get_tool is port_tool and tool in (
            "nnet3-chain-train", "nnet3-chain-compute-prob")) else []
        run(get_tool, tool, *extra,
            *[str(a).format(out=out, d=d) for a in args])
        outs.append(out)
    return outs


def same_bytes(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def made(chainsys):
    """den.fst, normalization.fst, supervision and the egs of each
    package, from the same tree, model, features and alignments."""
    d = chainsys[0]
    both("chain-est-phone-lm", d, f"ark:{d}/phones.ark",
         "{out}/phone_lm.fst")
    both("chain-make-den-fst", d, f"{d}/tree", f"{d}/0.trans_mdl",
         "{out}/phone_lm.fst", "{out}/den.fst", "{out}/normalization.fst")
    both("chain-get-supervision", d, "--frame-subsampling-factor=3",
         f"{d}/tree", f"{d}/0.trans_mdl", f"ark:{d}/ali.ark",
         "ark:{out}/sup.ark")
    both("nnet3-chain-get-egs", d, "--chunk-width=30",
         "--frame-subsampling-factor=3", "--left-context=6",
         "--right-context=6", f"{d}/0.trans_mdl", f"ark:{d}/feats.ark",
         f"ark:{d}/ali.ark", "ark:{out}/egs.ark")
    return d


@pytest.mark.parametrize("name", ["phone_lm.fst", "den.fst",
                                  "normalization.fst", "sup.ark", "egs.ark"])
def test_den_supervision_and_egs_bytes_equal_jax(made, name):
    assert same_bytes(made / "jax" / name, made / "port" / name)


def test_den_graph_from_fst_equals_jax(made):
    from kaldi_tpu.chain.graphs import den_graph_from_fst_file as jden
    from kaldi_tpu_torch.chain.graphs import den_graph_from_fst_file as pden
    j = jden(str(made / "jax" / "den.fst")).graph
    p = pden(str(made / "jax" / "den.fst")).graph
    for f in ("src", "dst", "pdf", "log_prob", "initial", "final"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), f)


@pytest.mark.parametrize("tool,args,outs", [
    ("nnet3-chain-copy-egs", [], ["egs.1.ark", "egs.2.ark"]),
    ("nnet3-chain-shuffle-egs", ["--srand=1"], ["egs_shuf.ark"]),
    ("nnet3-chain-shuffle-egs", ["--srand=3", "--buffer-size=5"],
     ["egs_shuf5.ark"]),
    ("nnet3-chain-subset-egs", ["--n=4", "--srand=2"], ["egs_sub.ark"]),
    ("nnet3-chain-merge-egs", ["--minibatch-size=4"], ["egs_mb.ark"]),
])
def test_egs_tools_bytes_equal_jax(made, tool, args, outs):
    d = made
    both(tool, d, *args, f"ark:{d}/jax/egs.ark",
         *[f"ark:{{out}}/{o}" for o in outs])
    for o in outs:
        assert os.path.getsize(d / "jax" / o) > 0
        assert same_bytes(d / "jax" / o, d / "port" / o), o


def test_normalize_egs_bytes_equal_jax(made):
    d = made
    both("nnet3-chain-normalize-egs", d, f"{d}/jax/normalization.fst",
         f"ark:{d}/jax/egs.ark", "ark:{out}/egs_norm.ark")
    assert same_bytes(d / "jax" / "egs_norm.ark", d / "port" / "egs_norm.ark")


@pytest.fixture(scope="module")
def e2e(made):
    """Each package's flat-start egs, silence optional at boundaries."""
    d = made
    both("nnet3-chain-e2e-get-egs", d, f"--optional-silence-phone={SIL}",
         f"{d}/0.trans_mdl", f"ark:{d}/feats.ark", f"ark:{d}/phones.ark",
         "ark:{out}/egs_e2e.ark")
    return d


def test_e2e_egs_bytes_equal_jax(e2e):
    assert os.path.getsize(e2e / "jax" / "egs_e2e.ark") > 0
    assert same_bytes(e2e / "jax" / "egs_e2e.ark",
                      e2e / "port" / "egs_e2e.ark")


@pytest.fixture(scope="module")
def trained(made):
    """A tiny raw nnet trained by each package's nnet3-chain-train."""
    d = made
    both("nnet3-chain-train", d, "--num-epochs=1", "--minibatch-size=4",
         *TINY, f"{d}/jax/den.fst", f"ark:{d}/jax/egs.ark",
         "{out}/final.raw")
    return d


def _prob(get_tool, capfd, *args) -> float:
    capfd.readouterr()
    run(get_tool, "nnet3-chain-compute-prob", *args)
    err = capfd.readouterr().err
    return float(re.findall(r"is (\S+) per frame", err)[-1])


@pytest.mark.parametrize("raw_of", ["jax", "port"])
def test_compute_prob_equals_jax(trained, capfd, raw_of):
    d = trained
    args = [f"{d}/{raw_of}/final.raw", f"{d}/jax/den.fst",
            f"ark:{d}/jax/egs.ark"]
    want = _prob(jax_tool, capfd, *args)
    got = _prob(port_tool, capfd, "--use-gpu=no", *args)
    assert np.isfinite(got)
    # each printed to 4 decimals
    assert abs(got - want) <= 1e-4 + 1e-4 * abs(want), (got, want)


def test_compute_prob_e2e_equals_jax(trained, e2e, capfd):
    d = trained
    args = [f"{d}/jax/final.raw", f"{d}/jax/den.fst",
            f"ark:{d}/jax/egs_e2e.ark"]
    want = _prob(jax_tool, capfd, *args)
    got = _prob(port_tool, capfd, "--use-gpu=no", *args)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4 + 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_raw_read_by_the_other_package(trained, writer):
    """A raw trained by one package: both read it to the same bytes and
    the same forward on an eg's features."""
    from kaldi_tpu.nnet3.egs import ChainExampleHolder
    from kaldi_tpu.util.table import SequentialTableReader
    path = str(trained / writer / "final.raw")
    jg, pg = jmdl.read_raw_nnet3(path), pmdl.read_raw_nnet3(path)
    for name, read in (("j", jg), ("p", pg)):
        out = trained / f"{writer}_{name}.raw"
        (jmdl if name == "j" else pmdl).write_raw_nnet3(read, str(out))
        assert same_bytes(out, path)
    _k, eg = next(iter(SequentialTableReader(
        ChainExampleHolder(), f"ark:{trained}/jax/egs.ark")))
    np.testing.assert_allclose(pg.forward(eg.feats), jg.forward(eg.feats),
                               rtol=1e-5, atol=1e-5)


def test_chain_combine_bytes_equal_jax(trained):
    d = trained
    both("nnet3-chain-combine", d, f"{d}/jax/final.raw",
         f"{d}/port/final.raw", "{out}/avg.raw")
    assert same_bytes(d / "jax" / "avg.raw", d / "port" / "avg.raw")
    both("nnet3-chain-combine2", d, f"{d}/jax/final.raw",
         f"{d}/jax/final.raw", "{out}/avg2.raw")
    assert same_bytes(d / "jax" / "avg2.raw", d / "port" / "avg2.raw")


def test_tool_chain_through_port(chainsys, tmp_path):
    """tests/test_cli_chain.py's whole chain through the port's tools."""
    from kaldi_tpu_torch.chain.graphs import den_graph_from_fst_file
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder, \
        SupervisionHolder
    from kaldi_tpu_torch.util.table import SequentialTableReader
    d, chain_tm, _tree, _tf = chainsys
    o = tmp_path

    def port(tool, *args):
        run(port_tool, tool, *args)

    def count(path, holder=ChainExampleHolder):
        return sum(1 for _ in SequentialTableReader(holder(), f"ark:{path}"))

    port("chain-est-phone-lm", f"ark:{d}/phones.ark", f"{o}/phone_lm.fst")
    port("chain-make-den-fst", f"{d}/tree", f"{d}/0.trans_mdl",
         f"{o}/phone_lm.fst", f"{o}/den.fst", f"{o}/normalization.fst")
    den = den_graph_from_fst_file(f"{o}/den.fst")
    assert int(den.graph.pdf.max()) < chain_tm.num_pdfs
    init = np.exp(np.asarray(den.graph.initial, np.float64))
    assert abs(init.sum() - 1.0) < 1e-3
    port("chain-get-supervision", f"{d}/tree", f"{d}/0.trans_mdl",
         f"ark:{d}/ali.ark", f"ark:{o}/sup.ark")
    assert count(f"{o}/sup.ark", SupervisionHolder) == 8
    port("nnet3-chain-get-egs", "--chunk-width=30", "--left-context=6",
         "--right-context=6", f"{d}/0.trans_mdl", f"ark:{d}/feats.ark",
         f"ark:{d}/ali.ark", f"ark:{o}/egs.ark")
    n0 = count(f"{o}/egs.ark")
    assert n0 >= 8
    port("nnet3-chain-shuffle-egs", "--srand=1", f"ark:{o}/egs.ark",
         f"ark:{o}/egs_shuf.ark")
    port("nnet3-chain-subset-egs", "--n=4", f"ark:{o}/egs.ark",
         f"ark:{o}/egs_sub.ark")
    assert count(f"{o}/egs_shuf.ark") == n0 and \
        count(f"{o}/egs_sub.ark") == 4
    port("nnet3-chain-train", "--use-gpu=no", "--num-epochs=2",
         "--minibatch-size=4", *TINY, f"{o}/den.fst",
         f"ark:{o}/egs_shuf.ark", f"{o}/final.raw")
    port("nnet3-chain-compute-prob", "--use-gpu=no", f"{o}/final.raw",
         f"{o}/den.fst", f"ark:{o}/egs_sub.ark")
    port("nnet3-chain-combine", f"{o}/final.raw", f"{o}/final.raw",
         f"{o}/avg.raw")
    a, b = (pmdl.read_raw_nnet3(f"{o}/{n}.raw") for n in ("final", "avg"))
    for name, comp in a.components.items():
        for key, val in comp.fields.items():
            arr = np.asarray(val)
            if arr.dtype.kind == "f" and arr.ndim >= 1:
                np.testing.assert_allclose(
                    np.asarray(b.components[name].fields[key]), arr,
                    rtol=0, atol=1e-6)


def test_compute_prob_refuses_a_missing_card(trained):
    """--use-gpu=yes (the default) raises where CUDA is not available,
    and names the CPU option; no tool falls back to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = trained
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_tool("nnet3-chain-compute-prob")([
            "nnet3-chain-compute-prob", f"{d}/jax/final.raw",
            f"{d}/jax/den.fst", f"ark:{d}/jax/egs.ark"])
