"""Port parity, end to end on the CPU (--use-gpu=no): the port's
nnet3-latgen-faster, -batch and -looped, nnet3-compute over an xconfig
checkpoint directory, the lattice tools and compute-wer, against the JAX
package's tools on the same monophone fixture (test_torch_lattice_decoder
.py) and the same model (its JAX checkpoint, and the port's converted by
tools/jax_checkpoint_to_torch.py).

Tolerances: words equal; lattices equal in structure with weights within
1e-4 relative (the loglikes differ in float32 rounding); nnet3-compute's
matrices within 1e-5 * max(1, max |JAX|); the lattice tools, fed the same
archive, write the same bytes, and compute-wer prints the same lines.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_lattice_decoder import (assert_lattices_close,
                                        build_mono_fixture)

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.util.table import SequentialTableReader as JReader
from kaldi_tpu_torch.cli import get_tool as port_tool
from kaldi_tpu_torch.util.table import SequentialTableReader


def run(get, tool, *args):
    rc = get(tool)([tool] + [str(a) for a in args])
    assert rc == 0, f"{tool} failed with {rc}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return build_mono_fixture(str(tmp_path_factory.mktemp("cli_latgen")))


def words(path):
    return {k: list(v) for k, v in
            SequentialTableReader("int-vector", f"ark:{path}")}


def lattices(path):
    return dict(SequentialTableReader("lattice", f"ark:{path}"))


VARIANTS = {
    "nnet3-latgen-faster": [],
    "nnet3-latgen-faster-batch": ["--minibatch-size=2"],
    "nnet3-latgen-faster-looped": ["--frames-per-chunk=17",
                                   "--extra-left-context=10",
                                   "--extra-right-context=10"],
}


@pytest.mark.parametrize("tool", sorted(VARIANTS))
def test_latgen_tools_equal_jax(env, tmp_path, tool, capfd):
    d = env["d"]
    common = ["--acoustic-scale=1.0", "--beam=16", "--lattice-beam=8",
              *VARIANTS[tool], f"{d}/trans.mdl"]
    tail = [f"{d}/HCLG.fst", f"ark:{d}/feats.ark"]
    run(jax_tool, tool, *common, f"{d}/nnet", *tail, f"ark:{tmp_path}/j.lat",
        f"ark:{tmp_path}/j.w")
    run(port_tool, tool, "--use-gpu=no", *common, f"{d}/nnet_port", *tail,
        f"ark:{tmp_path}/p.lat", f"ark:{tmp_path}/p.w")
    got, want = words(f"{tmp_path}/p.w"), words(f"{tmp_path}/j.w")
    assert len(got) == len(env["utts"]) and got == want
    got_l, want_l = lattices(f"{tmp_path}/p.lat"), lattices(
        f"{tmp_path}/j.lat")
    assert sorted(got_l) == sorted(want_l)
    for k in got_l:
        assert_lattices_close(got_l[k], want_l[k])
    # the stats line
    err = capfd.readouterr().err
    line = [ln for ln in err.splitlines() if f"{tool} stats " in ln]
    assert len(line) == 1
    stats = json.loads(line[0].split(f"{tool} stats ", 1)[1])
    assert stats["utterances"] == len(env["utts"])
    assert stats["det_fallbacks"] == 0 and stats["failed"] == 0
    assert stats["input_frames"] == sum(f.shape[0]
                                        for f in env["feats"].values())
    assert stats["frames"] == stats["input_frames"]
    assert stats["forward_span_ms"] is None
    assert stats["search_s"] > 0 and stats["rtf"] > 0
    assert not any(stats["kernel_launches"].values())


def test_batch_tool_interior_loglikes(env):
    """-batch pads each minibatch to its longest utterance; output frames
    are round(T * T_out / T_max), here all of them (no subsampling)."""
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import (_Forward,
                                                        batch_loglikes)
    from kaldi_tpu_torch.parallel.checkpoint import load_xconfig_checkpoint
    net, _, _ = load_xconfig_checkpoint(f"{env['d']}/nnet_port",
                                        device="cpu")
    fwd = _Forward(net)
    pend = [(u, env["feats"][u]) for u in env["utts"]]
    for key, ll, n_in in batch_loglikes(fwd, pend):
        one = fwd(env["feats"][key][None])[0].numpy()
        assert ll.shape == one.shape and n_in == len(env["feats"][key])
        # the last 2 frames read the padding (Append(-1, 0, 1) twice)
        np.testing.assert_allclose(ll[:-2], one[:-2], rtol=0, atol=1e-5)
    assert fwd.calls == 1 + len(pend)


def test_subsampled_batch_output_frames():
    """round(T * T_out / T_max) with a model that subsamples by 3, T not
    a multiple of 3: ceil(T / 3) frames for the longest, round for the
    rest (the reference's rule)."""
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import batch_loglikes

    def fwd(batch):
        return torch.zeros(batch.shape[0], -(-batch.shape[1] // 3), 4)
    pend = [("a", np.zeros((31, 2), np.float32)),
            ("b", np.zeros((20, 2), np.float32)),
            ("c", np.zeros((2, 2), np.float32))]
    got = {k: ll.shape[0] for k, ll, _ in batch_loglikes(fwd, pend)}
    assert got == {"a": 11, "b": int(round(20 * 11 / 31)), "c": 1}


def test_nnet3_compute_checkpoint_directory(env, tmp_path):
    d = env["d"]
    run(jax_tool, "nnet3-compute", f"{d}/nnet", f"ark:{d}/feats.ark",
        f"ark:{tmp_path}/j.ark")
    run(port_tool, "nnet3-compute", "--use-gpu=no", f"{d}/nnet_port",
        f"ark:{d}/feats.ark", f"ark:{tmp_path}/p.ark")
    got = dict(SequentialTableReader("matrix", f"ark:{tmp_path}/p.ark"))
    want = dict(JReader("matrix", f"ark:{tmp_path}/j.ark"))
    assert sorted(got) == sorted(want) == env["utts"]
    for k in got:
        w = np.asarray(want[k])
        assert np.abs(got[k] - w).max() <= 1e-5 * max(1, np.abs(w).max())
    with pytest.raises(Exception, match="no output 'output-xent'"):
        port_tool("nnet3-compute")(["nnet3-compute", "--use-gpu=no",
                                    "--use-xent-output=true",
                                    f"{d}/nnet_port", f"ark:{d}/feats.ark",
                                    f"ark:{tmp_path}/x.ark"])
    # a JAX directory: the converter is named
    with pytest.raises(Exception, match="jax_checkpoint_to_torch"):
        port_tool("nnet3-compute")(["nnet3-compute", "--use-gpu=no",
                                    f"{d}/nnet", f"ark:{d}/feats.ark",
                                    f"ark:{tmp_path}/x.ark"])
    with pytest.raises(Exception, match="nnet3-compute reads xconfig"):
        port_tool("nnet3-compute-batch")(
            ["nnet3-compute-batch", "--use-gpu=no", f"{d}/nnet_port",
             f"ark:{d}/feats.ark", f"ark:{tmp_path}/x.ark"])


PIPELINE = [
    ("lattice-copy", []),
    ("lattice-scale", ["--acoustic-scale=0.5", "--lm-scale=2"]),
    ("lattice-scale", ["--inv-acoustic-scale=4"]),
    ("lattice-add-penalty", ["--word-ins-penalty=0.5"]),
    ("lattice-prune", ["--beam=3", "--acoustic-scale=0.5"]),
    ("lattice-determinize", []),
    ("lattice-determinize-pruned", ["--beam=4"]),
    ("lattice-1best", ["--acoustic-scale=0.5"]),
]


@pytest.fixture(scope="module")
def lat_ark(env, tmp_path_factory):
    """The JAX tool's lattice archive (raw, undeterminized) of the
    fixture: the input of each lattice tool below."""
    t = tmp_path_factory.mktemp("lat_in")
    d = env["d"]
    run(jax_tool, "nnet3-latgen-faster", "--determinize-lattice=false",
        "--beam=16", "--lattice-beam=8", f"{d}/trans.mdl", f"{d}/nnet",
        f"{d}/HCLG.fst", f"ark:{d}/feats.ark", f"ark:{t}/lat.ark")
    return f"{t}/lat.ark"


@pytest.mark.parametrize("step", range(len(PIPELINE)))
def test_lattice_tools_write_jax_bytes(lat_ark, tmp_path, step):
    tool, opts = PIPELINE[step]
    for text in (False, True):
        mode = "ark,t" if text else "ark"
        run(jax_tool, tool, *opts, f"ark:{lat_ark}",
            f"{mode}:{tmp_path}/j.ark")
        run(port_tool, tool, *opts, f"ark:{lat_ark}",
            f"{mode}:{tmp_path}/p.ark")
        assert (tmp_path / "p.ark").read_bytes() == \
            (tmp_path / "j.ark").read_bytes()


def test_scoring_pipeline_and_compute_wer(env, lat_ark, tmp_path, capsys):
    """lattice-scale | lattice-add-penalty | lattice-best-path, then
    compute-wer against the transcripts: the same words and the same
    printed lines in both packages."""
    for get, p in ((jax_tool, "j"), (port_tool, "p")):
        run(get, "lattice-scale", "--inv-acoustic-scale=10",
            f"ark:{lat_ark}", f"ark:{tmp_path}/{p}1.ark")
        run(get, "lattice-add-penalty", "--word-ins-penalty=0.0",
            f"ark:{tmp_path}/{p}1.ark", f"ark:{tmp_path}/{p}2.ark")
        run(get, "lattice-best-path", f"ark:{tmp_path}/{p}2.ark",
            f"ark,t:{tmp_path}/{p}.w", f"ark:{tmp_path}/{p}.ali")
    assert (tmp_path / "p.w").read_bytes() == (tmp_path / "j.w").read_bytes()
    assert (tmp_path / "p.ali").read_bytes() == \
        (tmp_path / "j.ali").read_bytes()
    names = env["words"]
    with open(tmp_path / "hyp.txt", "w") as f:
        for k, v in words(f"{tmp_path}/p.w").items():
            f.write(" ".join([k] + [names[w] for w in v]) + "\n")
    capsys.readouterr()
    outs = []
    for get in (jax_tool, port_tool):
        for mode in ("strict", "present", "all"):
            run(get, "compute-wer", f"--mode={mode}",
                f"ark:{env['d']}/text.ark", f"ark:{tmp_path}/hyp.txt")
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("%WER ")
    assert len(lattices(f"{tmp_path}/p2.ark")) == len(env["utts"])


def test_use_gpu_yes_without_cuda_raises(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    d = env["d"]
    for tool in sorted(VARIANTS):
        with pytest.raises(RuntimeError, match="CUDA"):
            port_tool(tool)([tool, "--use-gpu=yes", f"{d}/trans.mdl",
                             f"{d}/nnet_port", f"{d}/HCLG.fst",
                             f"ark:{d}/feats.ark", f"ark:{tmp_path}/l.ark"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tool("nnet3-compute")(["nnet3-compute", f"{d}/nnet_port",
                                    f"ark:{d}/feats.ark",
                                    f"ark:{tmp_path}/o.ark"])
