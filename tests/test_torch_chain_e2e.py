"""Port parity: the flat-start e2e chain training of kaldi_tpu_torch
(`recipes/chain.py` `train_chain_e2e`, `e2e_chain_egs`, `nnet_log_likes`)
against the JAX package's on the CPU, over the reference test's
fabricated corpus (14 train utterances, MFCC by the port's tool; a few
cut shorter so that two length buckets form and one utterance is too
short for its transcript): the denominator and the numerators equal;
from JAX's initial variables, every step's objective over 2 epochs
within 1e-5 relative and the final parameters (and BatchNorm
statistics) within 1e-4 of their largest magnitude; the scores of
`nnet_log_likes` within 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_tpu.chain import supervision as jsup
from kaldi_tpu.decoder.graph import Lang as JLang
from kaldi_tpu.hmm.topology import HmmTopology as JTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.nnet3.models import ChainTdnnf as JModel
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.recipes import chain as jchain
from kaldi_tpu.tree import monophone_context_dependency as jmono
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.decoder.graph import Lang
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.recipes.template_corpus import make_standard_corpus
from kaldi_tpu_torch.recipes.template_run import read_lexicon, read_texts
from kaldi_tpu_torch.util.table import SequentialTableReader

# train_chain_e2e's default network (every phone 2 pdfs: 5 phones)
CFG = dict(feat_dim=13, num_pdfs=10, hidden_dim=128, bottleneck_dim=32,
           prefinal_dim=64, num_layers=5, subsample_layer=3,
           frame_subsampling_factor=3)
# egs/template/run.py stage 8's options
OPTS = dict(num_epochs=2, learning_rate=2e-3, minibatch_size=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(lexicon, train feats, train texts, test feats): 10 train
    utterances whole (228 frames), 3 cut to 152 frames (a bucket of 150
    input frames) and one to 9 (3 outputs, too short for its 4 words)."""
    root = str(tmp_path_factory.mktemp("e2e"))
    make_standard_corpus(root)
    for split in ("train", "test"):
        assert get_tool("compute-mfcc-feats")([
            "compute-mfcc-feats", "--use-gpu=no", "--sample-frequency=8000",
            "--dither=0", f"scp:{root}/{split}/wav.scp",
            f"ark:{root}/{split}/feats.ark"]) == 0
    feats = dict(SequentialTableReader("matrix",
                                       f"ark:{root}/train/feats.ark"))
    utts = sorted(feats)
    for u in utts[10:13]:
        feats[u] = feats[u][:152]
    feats[utts[13]] = feats[utts[13]][:9]
    test = dict(SequentialTableReader("matrix", f"ark:{root}/test/feats.ark"))
    test["te03"] = test["te03"][:200]
    return (read_lexicon(os.path.join(root, "lexicon.txt")), feats,
            read_texts(os.path.join(root, "train")), test)


def jax_e2e_system(jlang):
    phones = sorted(jlang.phones.values())
    tree = jmono(phones, {p: 2 for p in phones})
    return JTm(JTopo.chain_topology(phones), tree), tree


def to_np(v):
    return jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                     "batch_stats": dict(v["batch_stats"])})


def jax_init(T):
    """The initial variables that the JAX package's train_chain_e2e draws
    (chain.py:688-690: PRNGKey(seed), a (2, longest bucket, dim) input)."""
    v = JModel(JCfg(**CFG), train=True).init(
        jax.random.PRNGKey(0), jnp.zeros((2, T, CFG["feat_dim"])))
    return to_np(v)


def leaves(a, b, path=""):
    if hasattr(a, "keys"):
        assert set(a) == set(b), path
        for k in sorted(a):
            yield from leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def test_e2e_egs_match_jax(corpus):
    lexicon, feats, texts, _ = corpus
    lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    jlang = JLang(lexicon, sil_phone="SIL", sil_prob=0.5)
    ctm, ctree = tchain.e2e_chain_system(lang)
    jtm, jtree = jax_e2e_system(jlang)
    assert ctm.num_pdfs == jtm.num_pdfs == 10
    den, buckets = tchain.e2e_chain_egs(lang, feats, texts, ctm, ctree, 3)
    assert {T: len(v) for T, v in buckets.items()} == {228: 10, 150: 3}
    sil = jlang.phones["SIL"]
    seqs = {u: [jlang.phones[p] for w in texts[u]
                for p in jlang.lexicon[w][0]] for u in sorted(feats)}
    jden = jsup.make_denominator_graph(
        [[sil] + s + [sil] for s in seqs.values()], jtm, jtree)
    fields = ("src", "dst", "pdf", "log_prob", "initial", "final")
    for name in fields:
        np.testing.assert_array_equal(getattr(den.graph, name),
                                      np.asarray(getattr(jden.graph, name)),
                                      err_msg=name)
    utts = [u for u in sorted(feats) if feats[u].shape[0] >= 150]
    got = [g for items in buckets.values() for _, g in items]
    assert len(got) == len(utts)
    for u, g in zip(utts, got):
        jg = jsup.transcript_to_e2e_numerator(seqs[u], jtm, optional_sil=sil)
        for name in fields:
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(jg, name)))


class _NumpySpy:
    """numpy, whose `mean` keeps each list it averages: the JAX package's
    train_chain_e2e averages each epoch's step objectives (chain.py:751)."""

    def __init__(self):
        self.lists = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, a, *args, **kw):
        self.lists.append([float(x) for x in a])
        return np.mean(a, *args, **kw)


def test_two_epochs_match_jax(corpus, monkeypatch):
    lexicon, feats, texts, test = corpus
    spy = _NumpySpy()
    monkeypatch.setattr(jchain, "np", spy)
    jlang = JLang(lexicon, sil_phone="SIL", sil_prob=0.5)
    jmodel, j_vars, _, j_tm, _ = jchain.train_chain_e2e(
        jlang, feats, texts, opts=jchain.ChainTrainOptions(**OPTS))
    monkeypatch.undo()
    j_steps = [x for epoch in spy.lists for x in epoch]
    init = jax_init(228)
    stats = {}
    lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    model, t_vars, _, t_tm, _ = tchain.train_chain_e2e(
        lang, feats, texts, opts=tchain.ChainTrainOptions(**OPTS),
        variables=init, device="cpu", stats=stats)
    # 3 steps an epoch: 2 of 4 of the 228-frame bucket, 1 of 3 of the 150
    assert len(stats["step_objf"]) == len(j_steps) == 6
    assert stats["utterances"] == 13 and stats["buckets"] == 2
    for a, b in zip(stats["step_objf"], j_steps):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    assert stats["epoch_objf"] == pytest.approx(
        [np.mean(stats["step_objf"][:3]), np.mean(stats["step_objf"][3:])])
    j_vars = to_np(j_vars)
    # each group against its largest magnitude: a bias that feeds a
    # BatchNorm gets a gradient at rounding noise, which Adam scales up to
    # steps of the learning rate, and a mean after a normalisation sits
    # at 1e-9, so neither holds to a bar of its own
    for group in ("params", "batch_stats"):
        pairs = list(leaves(t_vars[group], j_vars[group]))
        largest = max(np.abs(b).max() for _, _, b in pairs)
        for path, a, b in pairs:
            assert a.shape == b.shape, path
            assert np.abs(a - b).max() <= 1e-4 * largest, path
    moved = 0.0
    for path, a, b in leaves(t_vars["params"], init["params"]):
        moved = max(moved, float(np.abs(a - b).max()))
    assert moved > 1e-3
    assert t_tm.num_pdfs == j_tm.num_pdfs
    # the trained model's scores of the test set
    t_ll = tchain.nnet_log_likes(model, t_vars, test)
    j_ll = jchain.nnet_log_likes(jmodel, j_vars, test)
    assert list(t_ll) == list(j_ll)
    for u in j_ll:
        assert t_ll[u].shape == j_ll[u].shape == (-(-test[u].shape[0] // 3),
                                                  10)
        assert np.abs(t_ll[u] - j_ll[u]).max() <= \
            1e-4 * np.abs(j_ll[u]).max()


def test_nnet_log_likes_matches_jax(corpus):
    *_, test = corpus
    variables = jax_init(228)
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**CFG), variables,
                                  device="cpu")
    t_ll = tchain.nnet_log_likes(model, variables, test)
    j_ll = jchain.nnet_log_likes(JModel(JCfg(**CFG)), variables, test)
    for u in j_ll:
        assert np.abs(t_ll[u] - j_ll[u]).max() <= \
            1e-4 * np.abs(j_ll[u]).max()
    # on the model's device by default, or where asked
    again = tchain.nnet_log_likes(model, variables, test, device="cpu")
    for u in t_ll:
        np.testing.assert_array_equal(again[u], t_ll[u])


def test_no_usable_utterance_raises(corpus):
    lexicon, feats, texts, _ = corpus
    lang = Lang(lexicon, sil_phone="SIL", sil_prob=0.5)
    short = {u: f[:9] for u, f in feats.items()}
    with pytest.raises(ValueError, match="no usable utterances"):
        tchain.train_chain_e2e(lang, short, texts, device="cpu")
