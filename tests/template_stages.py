"""The generic recipe's stages 0-2 run by the JAX package's tools on a
small fabricated corpus, as common input of the port's parity tests of
the recipe's tools and modules (tests/test_torch_*.py)."""

from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.decoder.lang_dir import read_symbol_table
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.util.table import TableWriter

GPU_TOOLS = ("gmm-align-compiled", "gmm-latgen-faster", "compute-mfcc-feats")


def run(side, tool, *args):
    """Run `tool` of the JAX package (side "jax") or of the port on the
    CPU (side "torch"); -> its status."""
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and tool in GPU_TOOLS \
        else []
    return fn([tool, *extra, *[str(a) for a in args]])


def jax_stage2(root, n_train: int = 8, n_test: int = 2):
    """Under root (a pathlib.Path): the corpus, lang, train feats.ark
    and text.int, then the mono system through the JAX tools: 0.mdl,
    tree, graphs.ark, the equal alignment ali0.ark, 0.acc, 1.mdl, one
    realignment ali1.ark, 1.acc and 2.mdl."""
    make_standard_corpus(str(root), n_train, n_test)
    d, lang = root / "train", root / "lang"
    assert run("jax", "prepare-lang", root / "lexicon.txt", lang) == 0
    for split in ("train", "test"):
        assert run("jax", "compute-mfcc-feats", "--sample-frequency=8000",
                   "--dither=0", f"scp:{root}/{split}/wav.scp",
                   f"ark:{root}/{split}/feats.ark") == 0
    words = read_symbol_table(str(lang / "words.txt"))
    with TableWriter("int-vector", f"ark:{root}/text.int") as w, \
            open(d / "text") as f:
        for line in f:
            utt, *toks = line.split()
            w.write(utt, [words[t] for t in toks])
    feats = f"ark:{d}/feats.ark"
    assert run("jax", "gmm-init-mono", f"--train-feats={feats}",
               lang / "topo", 13, root / "0.mdl", root / "tree") == 0
    assert run("jax", "compile-train-graphs", "--self-loop-scale=0.1",
               root / "tree", root / "0.mdl", lang / "L_disambig.fst",
               f"ark:{root}/text.int", f"ark:{root}/graphs.ark") == 0
    assert run("jax", "align-equal-compiled", f"ark:{root}/graphs.ark",
               feats, f"ark:{root}/ali0.ark") == 0
    assert run("jax", "gmm-acc-stats-ali", root / "0.mdl", feats,
               f"ark:{root}/ali0.ark", root / "0.acc") == 0
    assert run("jax", "gmm-est", "--min-gaussian-occupancy=3", "--mix-up=20",
               root / "0.mdl", root / "0.acc", root / "1.mdl") == 0
    assert run("jax", "gmm-align-compiled", "--beam=10",
               "--acoustic-scale=0.1", root / "1.mdl",
               f"ark:{root}/graphs.ark", feats, f"ark:{root}/ali1.ark") == 0
    assert run("jax", "gmm-acc-stats-ali", root / "1.mdl", feats,
               f"ark:{root}/ali1.ark", root / "1.acc") == 0
    assert run("jax", "gmm-est", "--min-gaussian-occupancy=3", "--mix-up=40",
               root / "1.mdl", root / "1.acc", root / "2.mdl") == 0
    return root
