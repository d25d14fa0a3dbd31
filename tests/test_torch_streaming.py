"""Port parity of streaming acoustic scoring: kaldi_tpu_torch/nnet3/
streaming.py OnlineNnetScorer against kaldi_tpu/nnet3/streaming.py, on
the CPU, over one small TDNN-F .mdl written by the JAX package's
exporter (both packages read the same bytes).

- The port's scorer (the compiled module on a device-resident window)
  against the JAX package's scorer (its host evaluator on a numpy
  window), same chunks, contexts and subsampling: each call emits the
  same frames, within 1e-5.
- The port's streamed output equals its own offline forward of the whole
  utterance, for any chunking, also where the input length is not a
  multiple of the subsampling factor and where the left context is not.
- The reference faults this repairs, shown on the JAX package: the
  online2 tools' chunk-alone scoring differs from the offline forward
  at chunk edges and restarts the subsampling phase at every chunk; its
  scorer's window starts off the subsampling grid when the left context
  is not a multiple of the factor; and it drops the last output frame
  when the input length is not a multiple.
- The compiled module called from 4 threads at once gives the sequential
  outputs; the scorer's device defaults to CUDA.
"""

import os
import threading

import numpy as np
import pytest
import torch

from kaldi_tpu.nnet3 import mdl_io as JM
from kaldi_tpu.nnet3.models import ChainTdnnf as FlaxTdnnf
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as FlaxConfig
from kaldi_tpu.nnet3.streaming import OnlineNnetScorer as JaxScorer
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu_torch.nnet3 import mdl_io as PM
from kaldi_tpu_torch.nnet3.models import ChainTdnnfConfig
from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from test_torch_nnet3_mdl_io import seeded_variables

TOL = 1e-5
SUB = 3
QUICK = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
             words_per_utt=5, num_train=2, num_test=4, num_lm_sents=80)
SMALL = dict(feat_dim=13, hidden_dim=16, bottleneck_dim=4, prefinal_dim=8,
             num_layers=5, subsample_layer=3, frame_subsampling_factor=SUB)


def tdnnf_context(cfg) -> int:
    """Input frames of context each side of the exported TDNN-F."""
    return sum(s * (cfg.frame_subsampling_factor
                    if i > cfg.subsample_layer else 1)
               for i, s in enumerate(cfg.time_strides(), start=1))


def small_system(d, seed=1):
    """The quick legacy corpus's chain transition model and decoding
    graph (HCLG.fst, words.txt, a wav archive of its test utterances),
    and a small TDNN-F .mdl with that model's pdfs and its context,
    written by the JAX package into directory d."""
    from kaldi_tpu_torch.feat.wave import WaveData
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    from kaldi_tpu_torch.recipes import bench_corpus as tbc
    from kaldi_tpu_torch.util.table import TableWriter
    spec = tbc.BenchCorpusSpec(**QUICK)
    lexicon, _, _, test_txt, test_wav, lm_text = tbc.make_corpus(
        spec, train_audio=False)
    lang, tm, tree = tbc.chain_tm_tree_for(lexicon)
    flat = tbc.build_decode_graph(lexicon, lm_text, tm, tree,
                                  lang=lang).to_flat_graph()
    fst = flat.to_vector_fst()
    with open(os.path.join(d, "HCLG.fst"), "wb") as f:
        write_fst(f, fst)
    with open(os.path.join(d, "words.txt"), "w") as f:
        f.writelines(f"{w} {i}\n" for i, w in enumerate(flat.words))
    kw = dict(SMALL, num_pdfs=tm.num_pdfs)
    variables = seeded_variables(ChainTdnnfConfig(**kw), seed=seed)
    jgraph = JM.chain_tdnnf_to_nnet3(FlaxTdnnf(FlaxConfig(**kw), train=False),
                                     variables)
    jlexicon = jbc.make_corpus(jbc.BenchCorpusSpec(**QUICK),
                               train_audio=False)[0]
    jtm = jbc.chain_tm_tree_for(jlexicon)[1]
    ctx = tdnnf_context(ChainTdnnfConfig(**kw))
    mdl = os.path.join(d, "final.mdl")
    JM.write_nnet3_am(mdl, jtm, jgraph, left_context=ctx, right_context=ctx)
    waves = {u: np.clip(np.round(test_wav[u]), -32768, 32767)
             for u in sorted(test_wav)}
    with TableWriter("wave", f"ark:{os.path.join(d, 'wav.ark')}") as w:
        for u, x in waves.items():
            w.write(u, WaveData(spec.fs, x))
    return dict(spec=spec, tm=tm, fst=fst, words=flat.words, mdl=mdl,
                ctx=ctx, waves=waves, sil=lang.phones[lang.sil_phone],
                num_pdfs=tm.num_pdfs)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    return small_system(str(tmp_path_factory.mktemp("stream")))


@pytest.fixture(scope="module")
def models(system):
    _ptm, pgraph, pinfo = PM.read_nnet3_am(system["mdl"])
    _jtm, jgraph, jinfo = JM.read_nnet3_am(system["mdl"])
    assert pinfo["left_context"] == jinfo["left_context"] == system["ctx"]
    return compile_graph(pgraph, device="cpu"), jgraph


def feats(seed, T, D=13):
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


def port_scorer(net, left, right, sub=SUB):
    return OnlineNnetScorer(lambda w: net(w)[:, ::sub], left, right, sub,
                            device="cpu")


def jax_scorer(jgraph, left, right, sub=SUB):
    return JaxScorer(lambda w: jgraph.forward(np.asarray(w[0]))[None, ::sub],
                     left_context=left, right_context=right, subsample=sub)


def split(T, rng, lo=1, hi=25):
    bounds, pos = [], 0
    while pos < T:
        n = int(rng.integers(lo, hi))
        bounds.append((pos, min(T, pos + n)))
        pos += n
    return bounds


def stream(scorer, x, bounds, as_numpy):
    outs = [as_numpy(scorer.accept_features(x[a:b])) for a, b in bounds]
    outs.append(as_numpy(scorer.finish()))
    return outs


def to_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("seed", range(3))
def test_scorer_matches_jax(models, system, seed):
    net, jgraph = models
    left = -(-system["ctx"] // SUB) * SUB
    T = 3 * int(np.random.default_rng(seed).integers(20, 45))
    x = feats(seed, T)
    bounds = split(T, np.random.default_rng(seed + 9))
    got = stream(port_scorer(net, left, system["ctx"]), x, bounds, to_np)
    want = stream(jax_scorer(jgraph, left, system["ctx"]), x, bounds, to_np)
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
    got = np.concatenate([g for g in got if g.shape[0]])
    want = np.concatenate([w for w in want if w.shape[0]])
    assert got.shape == (T // SUB, system["num_pdfs"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,left,seed", [(91, None, 0), (92, None, 1),
                                         (90, 13, 2), (40, None, 3),
                                         (7, None, 4)])
def test_streamed_equals_offline_forward(models, system, T, left, seed):
    """Any chunking, T % 3 in {0, 1, 2}, a left context off the grid,
    an utterance shorter than the context."""
    net, _ = models
    ctx = system["ctx"]
    x = feats(seed, T)
    offline = net(torch.from_numpy(x)[None])[0, ::SUB].numpy()
    for bounds in (split(T, np.random.default_rng(seed)), [(0, T)],
                   [(t, t + 1) for t in range(T)]):
        sc = port_scorer(net, ctx if left is None else left, ctx)
        out = [o for o in stream(sc, x, bounds, to_np) if o.shape[0]]
        got = np.concatenate(out)
        assert got.shape == offline.shape == (-(-T // SUB),
                                              system["num_pdfs"])
        np.testing.assert_allclose(got, offline, atol=TOL, rtol=TOL)
        # the window keeps no more than the frames a later window reads
        assert sc._buf.shape[0] <= T - sc._base
        assert sc._base >= max(0, sc._emitted * SUB - sc.left - SUB)


def test_reference_faults_on_jax(models, system):
    """What the port repairs, shown on the JAX package itself."""
    _net, jgraph = models
    ctx, T = system["ctx"], 96
    x = feats(7, T)
    offline = jgraph.forward(x)[::SUB]
    # online2-tcp-nnet3-decode-faster: each 16-frame chunk scored alone,
    # out[::s] (online_tools2.py:69-71)
    alone = np.concatenate([jgraph.forward(x[a:a + 16])[::SUB]
                            for a in range(0, T, 16)])
    assert alone.shape[0] == 6 * (T // 16) != offline.shape[0]
    # online2-wav-nnet3-latgen-faster: chunks of a multiple of 3 frames,
    # still scored alone (online_tools.py:110-112): edges differ
    alone18 = np.concatenate([jgraph.forward(x[a:a + 18])[::SUB]
                              for a in range(0, T, 18)])
    assert alone18.shape == offline.shape
    err = np.abs(alone18 - offline).max(axis=1)
    assert err[6] > 1e-2 and err[1:5].max() > 1e-2     # chunk edges
    # its scorer: a left context off the grid puts outputs on other frames
    off = np.concatenate([o for o in stream(
        jax_scorer(jgraph, ctx + 1, ctx), x, split(T, np.random.
                                                   default_rng(1)), to_np)
        if o.shape[0]])
    inner = slice(ctx // SUB + 2, T // SUB - ctx // SUB - 2)
    assert np.abs(off[inner] - offline[inner]).max() > 1e-2
    # and at the end it emits floor(T / 3) frames
    short = np.concatenate([o for o in stream(
        jax_scorer(jgraph, 3 * ctx, ctx), x[:T - 1], [(0, T - 1)], to_np)
        if o.shape[0]])
    assert short.shape[0] == (T - 1) // SUB < -(-(T - 1) // SUB)


def test_concurrent_calls_equal_sequential(models):
    """The TCP server's threads share one compiled module: its values and
    consumer counts live in each call."""
    net, _ = models
    xs = [torch.from_numpy(feats(20 + i, 30 + 7 * i))[None] for i in range(4)]
    want = [net(x) for x in xs]
    got = [None] * 4

    def run(i):
        for _ in range(5):
            got[i] = net(xs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scorer_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineNnetScorer(lambda w: w)
    sc = OnlineNnetScorer(lambda w: w, 0, 0, device="cpu")
    assert sc.accept_features(np.ones((2, 3), np.float32)).shape == (2, 3)
    assert sc.finish().shape[0] == 0
