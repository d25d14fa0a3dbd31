"""Port parity: the plain nnet3 training tools of kaldi_tpu_torch
(cli/nnet3_tools2.py, cli/nnet3_tail2_tools.py) against the JAX
package's, on the CPU: the nnet3-train and nnet3-combine case of
tests/test_cli_nnet3_tail2.py through the port's tools; nnet3-copy,
nnet3-average, nnet3-combine byte for byte; nnet3-compute-prob's line
and nnet3-compute-from-egs's outputs on one raw nnet (host evaluator,
--use-gpu=no) against the JAX tools'; ali-to-pdf on a chain transition
model alone."""

import os
import re
import sys

import numpy as np
import pytest

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu_torch.cli import get_tool as port_tool
from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3

sys.path.insert(0, os.path.dirname(__file__))
from test_cli_nnet3_tail2 import _toy_feats_and_posts  # noqa: E402

TINY = ["--hidden-dim=32", "--bottleneck-dim=16", "--num-layers=2"]


def port(tool, *args):
    assert port_tool(tool)([tool] + [str(a) for a in args]) == 0, tool


def jax(tool, *args):
    assert jax_tool(tool)([tool] + [str(a) for a in args]) == 0, tool


def test_nnet3_train_and_combine(tmp_path):
    """tests/test_cli_nnet3_tail2.py's case through the port's tools."""
    from kaldi_tpu_torch.nnet3.egs import ExampleHolder
    from kaldi_tpu_torch.util.table import SequentialTableReader
    _toy_feats_and_posts(tmp_path)
    port("nnet3-get-egs", "--num-frames=12", f"ark:{tmp_path}/feats.ark",
         f"ark:{tmp_path}/post.ark", f"ark:{tmp_path}/egs.ark")
    port("nnet3-train", "--use-gpu=no", "--num-epochs=30",
         "--minibatch-size=8", *TINY, f"ark:{tmp_path}/egs.ark",
         f"{tmp_path}/final.raw")
    graph = read_raw_nnet3(f"{tmp_path}/final.raw")
    egs = [eg for _k, eg in SequentialTableReader(
        ExampleHolder(), f"ark:{tmp_path}/egs.ark")]
    correct = total = 0
    for eg in egs[:4]:
        out = graph.forward(eg.feats)
        for t, frame in enumerate(eg.targets):
            correct += int(np.argmax(out[eg.left_context + t])
                           == frame[0][0])
            total += 1
    assert correct / total > 0.8, (correct, total)
    port("nnet3-combine", f"{tmp_path}/final.raw", f"{tmp_path}/final.raw",
         f"{tmp_path}/avg.raw")
    g2 = read_raw_nnet3(f"{tmp_path}/avg.raw")
    for name, comp in graph.components.items():
        for key, val in comp.fields.items():
            arr = np.asarray(val)
            if arr.dtype.kind == "f" and arr.ndim >= 1:
                np.testing.assert_allclose(
                    np.asarray(g2.components[name].fields[key]), arr,
                    atol=1e-6)


@pytest.fixture(scope="module")
def raws(tmp_path_factory):
    """Egs of the toy corpus and two raw nnets trained on them by the JAX
    tool (different epochs)."""
    d = tmp_path_factory.mktemp("nnet3_train")
    _toy_feats_and_posts(d)
    jax("nnet3-get-egs", "--num-frames=12", "--left-context=2",
        "--right-context=2", f"ark:{d}/feats.ark", f"ark:{d}/post.ark",
        f"ark:{d}/egs.ark")
    for n in (1, 3):
        jax("nnet3-train", f"--num-epochs={n}", "--minibatch-size=8", *TINY,
            f"ark:{d}/egs.ark", f"{d}/{n}.raw")
    return d


@pytest.mark.parametrize("tool,args", [
    ("nnet3-copy", ["{d}/1.raw", "{o}/copy.raw"]),
    ("nnet3-copy", ["--binary=false", "{d}/1.raw", "{o}/copy.txt"]),
    ("nnet3-average", ["{d}/1.raw", "{d}/3.raw", "{o}/avg.raw"]),
    ("nnet3-average", ["--weights=1:3", "{d}/1.raw", "{d}/3.raw",
                       "{o}/avg13.raw"]),
    ("nnet3-combine", ["{d}/1.raw", "{d}/3.raw", "{o}/comb.raw"]),
])
def test_raw_model_tools_bytes_equal_jax(raws, tool, args):
    d = raws
    outs = {}
    for name, run in (("jax", jax), ("port", port)):
        o = d / name
        o.mkdir(exist_ok=True)
        run(tool, *[a.format(d=d, o=o) for a in args])
        outs[name] = (o / os.path.basename(args[-1])).read_bytes()
    assert outs["jax"] == outs["port"]


def test_compute_prob_line_equals_jax(raws, capsys):
    d = raws
    jax("nnet3-compute-prob", f"{d}/3.raw", f"ark:{d}/egs.ark")
    want = capsys.readouterr().out
    port("nnet3-compute-prob", "--use-gpu=no", f"{d}/3.raw",
         f"ark:{d}/egs.ark")
    got = capsys.readouterr().out
    assert re.search(r"log-prob per frame: -?\d", got)
    assert got == want


def test_compute_from_egs_equals_jax(raws):
    from kaldi_tpu_torch.util.table import SequentialTableReader
    d = raws
    jax("nnet3-compute-from-egs", f"{d}/3.raw", f"ark:{d}/egs.ark",
        f"ark:{d}/j_out.ark")
    port("nnet3-compute-from-egs", "--use-gpu=no", f"{d}/3.raw",
         f"ark:{d}/egs.ark", f"ark:{d}/p_out.ark")
    j = dict(SequentialTableReader("matrix", f"ark:{d}/j_out.ark"))
    p = dict(SequentialTableReader("matrix", f"ark:{d}/p_out.ark"))
    assert j.keys() == p.keys() and len(p) > 0
    for k in j:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-5)


def test_chain_train2_is_chain_train(raws):
    """nnet3-chain-train2 and -combine2 are nnet3-chain-train and
    -combine under their other names: the usage each prints names it."""
    for tool in ("nnet3-chain-train2", "nnet3-chain-combine2"):
        assert port_tool(tool)([tool]) == 1


def test_ali_to_pdf_reads_a_transition_model_alone(tmp_path):
    """ali-to-pdf on a chain 0.trans_mdl (a TransitionModel and nothing
    after it) gives what it gives on a model with a GMM behind the same
    transition model."""
    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
    from kaldi_tpu_torch.util import kaldi_io
    from kaldi_tpu_torch.util.table import TableWriter
    phones = [1, 2, 3]
    tm = TransitionModel(HmmTopology.chain_topology(phones),
                         monophone_context_dependency(
                             phones, {p: 2 for p in phones}))
    kaldi_io.write_kaldi_object(tm.write, f"{tmp_path}/0.trans_mdl")
    with open(f"{tmp_path}/0.trans_mdl", "rb") as f:
        head = f.read()
    with open(f"{tmp_path}/with_tail.mdl", "wb") as f:
        f.write(head + b"<DIMENSION> 5 <NUMPDFS> 0 ")
    rng = np.random.default_rng(0)
    with TableWriter("int-vector", f"ark:{tmp_path}/ali.ark") as w:
        for i in range(3):
            w.write(f"u{i}", rng.integers(1, tm.num_transition_ids + 1,
                                          size=17).astype(np.int32))
    for m in ("0.trans_mdl", "with_tail.mdl"):
        port("ali-to-pdf", f"{tmp_path}/{m}", f"ark:{tmp_path}/ali.ark",
             f"ark,t:{tmp_path}/{m}.pdf")
    a, b = ((tmp_path / f"{m}.pdf").read_text()
            for m in ("0.trans_mdl", "with_tail.mdl"))
    assert a == b and len(a.splitlines()) == 3
