"""A graph built by the port's tools (tools/mkgraph_steps.py: the small
width-1 chain system of chain_lattices.py) decoded on the card against
the CPU: nnet3-latgen-faster --use-gpu=yes and --use-gpu=no over a
seeded xconfig TDNN and seeded features, the same words and each
lattice's best path within 1e-4 relative, then lattice-mbr-decode and
nbest-to-ctm over both archives.  These tests need an NVIDIA GPU, so
they skip elsewhere; on a machine with a card run them with `python -m
pytest tests/test_torch_cuda_mkgraph.py -m cuda -q --noconftest`.  They
import no jax."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.nnet3.xconfig import build_xconfig_model, xconfig_to_flax
from kaldi_tpu_torch.parallel.checkpoint import save_checkpoint
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter

sys.path.insert(0, os.path.dirname(__file__))
import chain_lattices as C  # noqa: E402

pytestmark = pytest.mark.cuda

XCONFIG = """input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=64 input=Append(-1,0,1)
relu-batchnorm-layer name=tdnn2 dim=64 input=Append(-1,0,1)
output-layer name=output dim={pdfs} include-log-softmax=true
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def run(tool, *args):
    with contextlib.redirect_stderr(io.StringIO()):
        assert get_tool(tool)([tool, *[str(a) for a in args]]) == 0


def _system(d: str):
    system = C.build_chain_system(d)
    text = XCONFIG.format(pdfs=system["tm_obj"].num_pdfs)
    model = build_xconfig_model(text, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    save_checkpoint(os.path.join(d, "nnet"), xconfig_to_flax(model), 0,
                    extra={"xconfig": text})
    rng = np.random.default_rng(1)
    with TableWriter("matrix", f"ark:{d}/feats.ark") as w:
        for u in range(4):
            w.write(f"utt{u}", rng.standard_normal(
                (int(rng.integers(30, 60)), 13)).astype(np.float32))
    return system


def test_tool_graph_decodes_on_the_card_as_on_the_cpu(cuda, tmp_path):
    d = str(tmp_path)
    system = _system(d)
    for gpu in ("yes", "no"):
        run("nnet3-latgen-faster", f"--use-gpu={gpu}", "--beam=15",
            "--lattice-beam=8", "--acoustic-scale=1.0", system["tm"],
            f"{d}/nnet", system["hclg"], f"ark:{d}/feats.ark",
            f"ark:{d}/lat.{gpu}", f"ark,t:{d}/words.{gpu}")
        run("lattice-mbr-decode", f"ark:{d}/lat.{gpu}",
            f"ark,t:{d}/mbr.{gpu}")
        run("lattice-1best", f"ark:{d}/lat.{gpu}", f"ark:{d}/1best.{gpu}")
        run("nbest-to-ctm", f"ark:{d}/1best.{gpu}", f"{d}/ctm.{gpu}")
    words = [dict(SequentialTableReader("int-vector", f"ark:{d}/words.{g}"))
             for g in ("yes", "no")]
    assert len(words[0]) == 4 and words[0] == words[1]
    lats = [dict(SequentialTableReader("lattice", f"ark:{d}/lat.{g}"))
            for g in ("yes", "no")]
    for k, lat in lats[1].items():
        a, b = lattice_best_path(lats[0][k]), lattice_best_path(lat)
        assert a[:2] == b[:2]
        assert abs(a[2] - b[2]) <= 1e-4 * abs(b[2])
    assert open(f"{d}/mbr.yes").read() == open(f"{d}/mbr.no").read()
    assert open(f"{d}/ctm.yes").read() == open(f"{d}/ctm.no").read()
