"""Port parity: the context-dependent (triphone) chain system of
kaldi_tpu_torch against the JAX package's, on the CPU.

  - estimate_window_lm: the same acceptor arc for arc (labels, weights
    within 1e-12 relative, destinations, finals) and the same window
    tokens;
  - segment_alignment_words: the same segments, and the same errors;
  - `train_system(ctx=True, ivector_dim=8)` on the tiny bench corpus,
    with the window-LM denominator and with the token bigram: it trains
    and decodes end to end (and `train_scale.train_and_decode` writes
    the files `main_scale` writes), and from the port's own features,
    alignments and i-vectors the JAX package's `train_chain_ctx` builds
    the same transition model and tree (equal bytes), the same
    denominator graph (arrays equal, weights within 1e-6 relative) and
    the same chunks and numerators.
"""

import io
import json

import numpy as np
import pytest

from kaldi_tpu.base import io_funcs as jiof
from kaldi_tpu.chain import supervision as jsup
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as JCfg
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.recipes import chain as jchain
from kaldi_tpu_torch.base import io_funcs as tiof
from kaldi_tpu_torch.chain import supervision as tsup
from kaldi_tpu_torch.chain.objective import ChainTrainingOptions
from kaldi_tpu_torch.nnet3.models import ChainTdnnfConfig
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.recipes import chain as tchain
from kaldi_tpu_torch.recipes import train_scale

TINY = dict(vocab=30, num_phone_groups=5, phones_per_group=2,
            words_per_utt=8, num_train=24, num_test=6, num_lm_sents=200,
            noise=850.0, f2_gap=120.0, seed=11)
NET = dict(feat_dim=40, ivector_dim=8, hidden_dim=32, bottleneck_dim=8,
           prefinal_dim=16, num_layers=3, subsample_layer=2,
           frame_subsampling_factor=3)
OPTS = dict(num_epochs=1, learning_rate=1e-3, final_learning_rate=1e-4,
            minibatch_size=16, chunk_width=150, left_tolerance=5,
            right_tolerance=5)


def fst_arcs(fst):
    return [[(a.ilabel, a.olabel, float(a.weight), a.nextstate)
             for a in fst.arcs[s]] for s in range(fst.num_states)]


def window_seqs(seed, n=40, phones=tuple(range(1, 8))):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        seq = []
        for _ in range(int(rng.integers(1, 6))):
            pron = [int(p) for p in rng.choice(phones,
                                               int(rng.integers(1, 4)))]
            pad = [0] + pron + [0]
            seq += [tuple(pad[i:i + 3]) for i in range(len(pron))]
        seqs.append(seq)
    return seqs


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_window_lm_matches(seed):
    seqs = window_seqs(seed)
    seqs.append([])
    (jfst, jinfo), (tfst, tinfo) = (m.estimate_window_lm(seqs, interp=0.2)
                                    for m in (jsup, tsup))
    assert tinfo == jinfo
    assert tfst.start == jfst.start
    want, got = fst_arcs(jfst), fst_arcs(tfst)
    assert [[a[:2] + a[3:] for a in s] for s in got] == \
        [[a[:2] + a[3:] for a in s] for s in want]
    np.testing.assert_allclose([a[2] for s in got for a in s],
                               [a[2] for s in want for a in s], rtol=1e-12)
    np.testing.assert_allclose(
        [float(w) for w in tfst.finals], [float(w) for w in jfst.finals],
        rtol=1e-12)


@pytest.fixture(scope="module", params=[True, False],
                ids=["window_den", "token_bigram"])
def trained(request):
    """The port's train_scale path on the tiny corpus (one epoch of a
    3-layer, width-32 TDNN-F with 8-dim i-vectors), with what its chain
    trainer was given, and the JAX package's train_chain_ctx on the
    port's features, alignments and i-vectors with its trainer stubbed
    out."""
    window_den = request.param
    got = {}
    orig = tchain._fit_chain

    def t_fit(cfg, den, chunks, nums, *a, **kw):
        got.update(den=den, chunks=chunks, nums=nums)
        return orig(cfg, den, chunks, nums, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tchain, "_fit_chain", t_fit)
    stats = {}
    spec = tbc.BenchCorpusSpec(**TINY)
    opts = tchain.ChainTrainOptions(
        chain=ChainTrainingOptions(l2_regularize=5e-5,
                                   leaky_hmm_coefficient=0.1,
                                   xent_regularize=0.1), **OPTS)
    try:
        sysd = tbc.train_system(
            spec, cfg=lambda n: ChainTdnnfConfig(num_pdfs=n, **NET),
            chain_opts=opts, ctx=True, max_leaves=40, min_gain=5.0,
            ivector_dim=8, window_den=window_den, device="cpu",
            stats=stats)
        dec = train_scale.decode_test(
            sysd, ChainTdnnfConfig(num_pdfs=sysd["chain_tm"].num_pdfs,
                                   **NET), device="cpu")
        want = {}

        def j_fit(cfg, den, chunks, nums, *a, **kw):
            want.update(den=den, chunks=chunks, nums=nums)
            return None, {}
        mp.setattr(jchain, "_fit_chain", j_fit)
        lang, lexicon = sysd["lang"], sysd["lexicon"]
        word_prons = {u: [[lang.phones[p] for p in lexicon[w][0]]
                          for w in sysd["train_txt"][u]]
                      for u in sysd["feats"]}
        _, _, jden, jtm, jtree = jchain.train_chain_ctx(
            sysd["gmm"], sysd["feats"], sysd["alignments"], word_prons,
            lambda n: JCfg(num_pdfs=n, **NET), jchain.ChainTrainOptions(
                chain=jchain.ChainTrainingOptions(
                    l2_regularize=5e-5, leaky_hmm_coefficient=0.1,
                    xent_regularize=0.1), **OPTS),
            max_leaves=40, min_gain=5.0, ivectors=sysd["ivectors"],
            window_den=window_den)
    finally:
        mp.undo()
    return {"sysd": sysd, "stats": stats, "decode": dec, "got": got,
            "want": want, "jden": jden, "jtm": jtm, "jtree": jtree,
            "window_den": window_den}


def _bytes(obj, init):
    f = io.BytesIO()
    init(f, True)
    obj.write(f, True)
    return f.getvalue()


def test_train_system_ctx_trains_and_decodes(trained):
    stats, sysd, dec = trained["stats"], trained["sysd"], trained["decode"]
    assert stats["window_den"] is trained["window_den"]
    assert stats["leaves"] == sysd["chain_tm"].num_pdfs == 40
    assert len(stats["step_objf"]) == stats["chunks"] // 16 >= 1
    assert np.isfinite(stats["step_objf"]).all()
    for k in ("ivector_s", "tree_s", "den_s", "egs_s", "chain_s"):
        assert stats[k] >= 0
    assert stats["den"]["states"] == sysd["den"].num_states
    assert set(sysd["ivectors"]) == set(sysd["feats"])
    assert all(v.shape == (8,) for v in sysd["ivectors"].values())
    assert dec["lanes_decoded"] == TINY["num_test"]
    assert np.isfinite(dec["wer"])


def test_ctx_tree_and_transition_model_match(trained):
    sysd = trained["sysd"]
    assert _bytes(sysd["chain_tree"], tiof.init_output_stream) == \
        _bytes(trained["jtree"], jiof.init_output_stream)
    assert _bytes(sysd["chain_tm"], tiof.init_output_stream) == \
        _bytes(trained["jtm"], jiof.init_output_stream)


def test_ctx_den_graph_matches(trained):
    got, want = trained["sysd"]["den"].graph, trained["jden"].graph
    for k in ("src", "dst", "pdf"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("log_prob", "initial", "final"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, atol=1e-6)


def test_ctx_chunks_and_numerators_match(trained):
    got, want = trained["got"], trained["want"]
    assert len(got["chunks"]) == len(want["chunks"]) > 0
    for (gf, ga, gi), (wf, wa, wi) in zip(got["chunks"], want["chunks"]):
        np.testing.assert_array_equal(gf, wf)
        assert ga is None and wa is None
        np.testing.assert_array_equal(gi, wi)
    for g, w in zip(got["nums"], want["nums"]):
        for k in ("src", "dst", "pdf", "log_prob", "initial", "final"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))


def test_segment_alignment_words_matches(trained):
    sysd = trained["sysd"]
    gmm, lang, lexicon = sysd["gmm"], sysd["lang"], sysd["lexicon"]
    sil = lang.phones["SIL"]
    for u in list(sysd["alignments"])[:6]:
        prons = [[lang.phones[p] for p in lexicon[w][0]]
                 for w in sysd["train_txt"][u]]
        ali = sysd["alignments"][u]
        assert tchain.segment_alignment_words(ali, gmm.tm, prons, sil) == \
            jchain.segment_alignment_words(ali, gmm.tm, prons, sil)
        for bad in (prons[:-1], prons + [prons[0]]):
            with pytest.raises(ValueError) as je:
                jchain.segment_alignment_words(ali, gmm.tm, bad, sil)
            with pytest.raises(ValueError) as te:
                tchain.segment_alignment_words(ali, gmm.tm, bad, sil)
            assert str(te.value) == str(je.value)


def test_train_scale_writes_what_main_scale_writes(tmp_path):
    """train_scale.train_and_decode on the tiny corpus: params.npz,
    ivec.npz, chain.tm, chain.tree and meta.json with main_scale's keys;
    the tm and tree read back give the trained system's bytes, the
    extractor reads back through both packages' loaders."""
    stats = {}
    meta = train_scale.train_and_decode(
        str(tmp_path), epochs=1, device="cpu",
        spec=tbc.BenchCorpusSpec(**TINY),
        config=lambda n: ChainTdnnfConfig(num_pdfs=n, **NET),
        max_leaves=40, min_gain=5.0, ivector_dim=8, stats=stats)
    sysd = stats.pop("system")
    assert set(meta) == {"wer", "num_pdfs", "config", "epochs", "vocab",
                         "noise", "f2_gap", "states", "corpus_hash"}
    assert meta["num_pdfs"] == sysd["chain_tm"].num_pdfs == 40
    assert meta["states"] == stats["decode"]["states"]
    with open(tmp_path / "meta.json") as f:
        assert json.load(f) == meta
    for name, obj in (("chain.tm", sysd["chain_tm"]),
                      ("chain.tree", sysd["chain_tree"])):
        with open(tmp_path / name, "rb") as f:
            assert f.read() == _bytes(obj, tiof.init_output_stream)
    ex = tbc.load_ivector_extractor(str(tmp_path / "ivec.npz"))
    assert ex["M"].shape == (64, 40, 8)
    assert jbc.load_ivector_extractor(str(tmp_path / "ivec.npz")).R == 8
    assert set(tbc.load_params(str(tmp_path / "params.npz"))["params"]) \
        == set(sysd["variables"]["params"])
    for k in ("graph_s", "decode_s", "train_s"):
        assert stats[k] >= 0
