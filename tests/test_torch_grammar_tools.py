"""Port parity, on the CPU (--use-gpu=no): make-grammar-fst,
nnet3-latgen-grammar, online2-wav-nnet3-latgen-grammar,
online2-wav-nnet3-latgen-incremental (`kaldi_tpu_torch/cli/
tail15_tools.py`) and nnet3-latgen-faster-lookahead (`cli/
nnet3_latgen_tools.py`) against the JAX package's tools, run as
tests/test_cli_tail15.py and tests/test_cli_nnet3_latgen_variants.py run
them, on the JAX package's monophone YES/NO system.

Tolerances: make-grammar-fst's files (the prepared FST, the grammar
container, the static expansion) equal byte for byte, and each package
reads the other's container.  The network tools compute their loglikes
in their own float32 (the port's compiled module against JAX's), so
their words are equal and their lattices equal in structure with
weights within 1e-4 relative (tests/test_torch_lattice_decoder.py's
rule); the grammar and lookahead decodes are also held to the port's
own plain decode of the same graph, byte for byte.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_lattice_decoder import (LATGEN_XCONFIG,  # noqa: E402
                                        assert_lattices_close)

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.util.table import SequentialTableReader

NNET_TOOLS = ("nnet3-latgen-grammar", "nnet3-latgen-faster",
              "nnet3-latgen-faster-lookahead",
              "online2-wav-nnet3-latgen-grammar",
              "online2-wav-nnet3-latgen-faster",
              "online2-wav-nnet3-latgen-incremental")


def run(side, tool, *args):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and tool in NNET_TOOLS \
        else []
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exited {rc}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import importlib.util

    import jax
    import jax.numpy as jnp

    from test_mono_e2e import FS, make_corpus, unigram_g

    from kaldi_tpu.decoder.graph import Lang
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.wave import WaveData
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.fstext.fst import Arc, TropicalWeight, VectorFst
    from kaldi_tpu.fstext.openfst_io import write_fst
    from kaldi_tpu.nnet3.mdl_io import read_raw_nnet3, write_nnet3_am
    from kaldi_tpu.nnet3.xconfig import build_xconfig_model
    from kaldi_tpu.parallel.checkpoint import save_checkpoint
    from kaldi_tpu.recipes.mono import (TrainMonoOptions, make_hclg,
                                        train_mono)
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.table import TableWriter
    d = tmp_path_factory.mktemp("grammar_tools")
    train_txt, train_wav, test_txt, test_wav = make_corpus(
        num_train=8, num_test=2)
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
    kaldi_io.write_kaldi_object(sys_.tm.write, f"{d}/trans.mdl")
    g_real = unigram_g(lang)
    with open(f"{d}/HCLG.fst", "wb") as f:
        write_fst(f, make_hclg(sys_, g_real))
    # HCL := HCLG over a flat G (zero weights, same words); HCL o G on
    # demand decodes as HCLG
    g_flat = VectorFst(TropicalWeight)
    s = g_flat.add_state()
    g_flat.set_start(s)
    g_flat.set_final(s)
    for w in ("YES", "NO"):
        g_flat.add_arc(s, Arc(lang.words[w], lang.words[w], 0.0, s))
    with open(f"{d}/HCL.fst", "wb") as f:
        write_fst(f, make_hclg(sys_, g_flat))
    with open(f"{d}/G.fst", "wb") as f:
        write_fst(f, g_real)
    with TableWriter("matrix", f"ark:{d}/feats.ark") as w:
        for u in sorted(sf):
            w.write(u, sf[u])
    scp = []
    for utt, wav in sorted(test_wav.items()):
        with open(d / f"{utt}.wav", "wb") as f:
            WaveData(FS, wav[None, :]).write(f)
        scp.append(f"{utt} {d / f'{utt}.wav'}")
    (d / "wav.scp").write_text("\n".join(scp) + "\n")
    # an xconfig checkpoint of random weights (JAX's, and the port's
    # converted by tools/jax_checkpoint_to_torch.py)
    text = LATGEN_XCONFIG.replace("$num_targets", str(sys_.tm.num_pdfs))
    model = build_xconfig_model(text, train=False)
    variables = model.init(jax.random.PRNGKey(7),
                           {"input": jnp.zeros((1, 21, 13))})
    os.makedirs(f"{d}/nnet", exist_ok=True)
    save_checkpoint(f"{d}/nnet", variables, 0, extra={"xconfig": text})
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "jax_checkpoint_to_torch.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    conv.convert(f"{d}/nnet", f"{d}/nnet_port")
    # a one-affine nnet3 .mdl over the transition model (the reference
    # test's construction)
    rng = np.random.default_rng(0)
    D, P = 13, sys_.tm.num_pdfs
    rows = "\n".join(" ".join(f"{v:.5f}" for v in r) + " "
                     for r in rng.normal(scale=0.1, size=(P, D)))
    raw = (f"<Nnet3>\ninput-node name=input dim={D}\n"
           "component-node name=aff component=aff input=input\n"
           "output-node name=output input=aff objective=linear\n\n"
           "<NumComponents> 1\n"
           "<ComponentName> aff <NaturalGradientAffineComponent> "
           "<LearningRate> 0.001 <LinearParams>  [\n" + rows + "]\n"
           "<BiasParams>  [ " + " ".join("0" for _ in range(P)) +
           " ]\n<RankIn> 20 <RankOut> 80 <UpdatePeriod> 4 "
           "<NumSamplesHistory> 2000 <Alpha> 4 "
           "</NaturalGradientAffineComponent>\n</Nnet3>\n")
    (d / "a.raw").write_text(raw)
    write_nnet3_am(f"{d}/am.mdl", sys_.tm, read_raw_nnet3(str(d / "a.raw")))
    return dict(d=d, fs=FS, utts=sorted(test_wav),
                offset=max(lang.phones.values()) + 1)


def words(path):
    return {k: list(v) for k, v in
            SequentialTableReader("int-vector", f"ark:{path}")}


def lattices(path):
    return dict(SequentialTableReader("lattice", f"ark:{path}"))


def same_lattices(a, b):
    la, lb = lattices(a), lattices(b)
    assert sorted(la) == sorted(lb) and la
    for k in la:
        assert_lattices_close(la[k], lb[k])


# -- make-grammar-fst --------------------------------------------------------


def _sub_fsts(d):
    """The reference grammar test's top-level graph and sub-graph, as
    FST files (tests/test_torch_grammar_fst.py)."""
    from test_torch_grammar_fst import NT_X, OFFSET, PORT, SUB, TOP, fst

    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    for name, arcs, finals in (("top", TOP, {5: 0.0}), ("sub", SUB, {})):
        f = fst(PORT, 1 + max(max(a[0], a[4]) for a in arcs), arcs, finals)
        with open(d / f"{name}.fst", "wb") as out:
            write_fst(out, f)
    return OFFSET, NT_X


def test_make_grammar_fst_bytes_equal_jax(tmp_path):
    off, nt = _sub_fsts(tmp_path)
    for side in ("jax", "torch"):
        o = tmp_path / side
        run(side, "make-grammar-fst", f"--nonterm-phones-offset={off}",
            tmp_path / "top.fst", f"{o}.prep.fst")
        run(side, "make-grammar-fst", f"--nonterm-phones-offset={off}",
            tmp_path / "top.fst", nt, tmp_path / "sub.fst", f"{o}.grammar")
        run(side, "make-grammar-fst", f"--nonterm-phones-offset={off}",
            "--write-as-grammar=false", tmp_path / "top.fst", nt,
            tmp_path / "sub.fst", f"{o}.expanded.fst")
    for name in ("prep.fst", "grammar", "expanded.fst"):
        assert (tmp_path / f"torch.{name}").read_bytes() == \
            (tmp_path / f"jax.{name}").read_bytes(), name
    # each package reads the other's container
    from kaldi_tpu.cli.tail15_tools import read_grammar_any as jread
    from kaldi_tpu_torch.cli.tail15_tools import (expand_grammar,
                                                  read_grammar_any)
    from kaldi_tpu_torch.fstext.grammar_fst import GrammarFst
    g = read_grammar_any(str(tmp_path / "jax.grammar"))
    assert isinstance(g, GrammarFst) and len(g.ifsts) == 1
    assert type(jread(str(tmp_path / "torch.grammar"))).__name__ == \
        "GrammarFst"
    plain = read_grammar_any(str(tmp_path / "torch.expanded.fst"))
    assert expand_grammar(plain) is plain
    e = expand_grammar(g)
    assert (e.num_states, e.num_arcs()) == (plain.num_states,
                                            plain.num_arcs())


# -- the decoders ------------------------------------------------------------


@pytest.fixture(scope="module")
def prepared(env, tmp_path_factory):
    """HCLG.fst prepared as a grammar of one FST (make-grammar-fst usage
    2), and as a grammar container with no sub-FSTs."""
    t = tmp_path_factory.mktemp("prepared")
    d, off = env["d"], env["offset"]
    run("torch", "make-grammar-fst", f"--nonterm-phones-offset={off}",
        d / "HCLG.fst", t / "HCLG_prep.fst")
    return t


def test_nnet3_latgen_grammar(env, prepared, tmp_path):
    d = env["d"]
    opts = ["--acoustic-scale=1.0", "--beam=16", "--lattice-beam=8",
            d / "trans.mdl"]
    tail = [prepared / "HCLG_prep.fst", f"ark:{d}/feats.ark"]
    run("jax", "nnet3-latgen-grammar", *opts, d / "nnet", *tail,
        f"ark:{tmp_path}/j.lat", f"ark:{tmp_path}/j.w")
    run("torch", "nnet3-latgen-grammar", *opts, d / "nnet_port", *tail,
        f"ark:{tmp_path}/t.lat", f"ark:{tmp_path}/t.w")
    assert words(tmp_path / "t.w") == words(tmp_path / "j.w")
    same_lattices(tmp_path / "t.lat", tmp_path / "j.lat")
    # the port's plain decode of the HCLG writes the same bytes
    run("torch", "nnet3-latgen-faster", *opts, d / "nnet_port",
        d / "HCLG.fst", f"ark:{d}/feats.ark", f"ark:{tmp_path}/p.lat",
        f"ark:{tmp_path}/p.w")
    for ext in ("lat", "w"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"p.{ext}").read_bytes()


def test_nnet3_latgen_faster_lookahead(env, tmp_path, capfd):
    d = env["d"]
    opts = ["--acoustic-scale=1.0", "--beam=16", "--lattice-beam=8",
            "--prune-interval=0", d / "trans.mdl"]
    tail = [d / "HCL.fst", d / "G.fst", f"ark:{d}/feats.ark"]
    run("jax", "nnet3-latgen-faster-lookahead", *opts, d / "nnet", *tail,
        f"ark:{tmp_path}/j.lat", f"ark:{tmp_path}/j.w")
    run("torch", "nnet3-latgen-faster-lookahead", *opts, d / "nnet_port",
        *tail, f"ark:{tmp_path}/t.lat", f"ark:{tmp_path}/t.w")
    assert words(tmp_path / "t.w") == words(tmp_path / "j.w")
    same_lattices(tmp_path / "t.lat", tmp_path / "j.lat")
    err = capfd.readouterr().err
    assert "nnet3-latgen-faster-lookahead stats " in err
    assert "product states interned" in err
    # the words of the prebuilt HCLG's decode
    run("torch", "nnet3-latgen-faster", *opts, d / "nnet_port",
        d / "HCLG.fst", f"ark:{d}/feats.ark", f"ark:{tmp_path}/p.lat",
        f"ark:{tmp_path}/p.w")
    assert words(tmp_path / "t.w") == words(tmp_path / "p.w")


def test_online2_wav_nnet3_latgen_grammar(env, prepared, tmp_path):
    d = env["d"]
    common = [f"--sample-frequency={env['fs']}", "--dither=0.0",
              "--frame-subsampling-factor=1", d / "am.mdl"]
    for side in ("jax", "torch"):
        run(side, "online2-wav-nnet3-latgen-grammar", *common,
            prepared / "HCLG_prep.fst", f"scp:{d}/wav.scp",
            f"ark,t:{tmp_path}/{side}.g")
    run("torch", "online2-wav-nnet3-latgen-faster", *common,
        d / "HCLG.fst", f"scp:{d}/wav.scp", f"ark,t:{tmp_path}/torch.f")
    g = (tmp_path / "torch.g").read_text()
    assert g == (tmp_path / "jax.g").read_text()
    assert g == (tmp_path / "torch.f").read_text()
    assert len(words(tmp_path / "torch.g")) == len(env["utts"])


def test_online2_wav_nnet3_latgen_incremental(env, tmp_path):
    d = env["d"]
    for side in ("jax", "torch"):
        run(side, "online2-wav-nnet3-latgen-incremental",
            f"--sample-frequency={env['fs']}", "--dither=0.0",
            "--frame-subsampling-factor=1", "--determinize-period=10",
            d / "am.mdl", d / "HCLG.fst", f"scp:{d}/wav.scp",
            f"ark:{tmp_path}/{side}.lat")
    from kaldi_tpu_torch.decoder.incremental import _LABEL_BASE
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    got, want = lattices(tmp_path / "torch.lat"), lattices(
        tmp_path / "jax.lat")
    assert sorted(got) == sorted(want) == env["utts"]
    for k in got:
        assert lattice_best_path(got[k])[:2] == \
            lattice_best_path(want[k])[:2]
        assert all(a.olabel < _LABEL_BASE for r in got[k].arcs for a in r)
