"""Port parity, end to end: the JAX BatchedOfflinePipeline2 (MFCC ->
i-vectors -> ChainTdnnf -> BlockChainDecoder with Pallas kernel a in
interpret mode) against the kaldi_tpu_torch pipeline on the CPU, with a
small random-init model (float32 params; both pipelines round the model
input to bf16), the committed i-vector extractor, a small block-chain
graph and three seeded waves.  Equal words; cost within 1e-4 relative.
Lattice mode (Pallas kernel b in interpret mode on the JAX side): equal
words, cost within 1e-4 relative, lattices with equal states and arc
labels; arc weights within 2e-3 absolute, since the two acoustic models
differ by about 1e-4 a frame and a word arc sums several frames.

The main path's search, the n-gram decoder, runs through both pipelines
with the same search_kwargs (a pruned pool), and in lattice mode: equal
words, cost within 1e-4 relative; its lattices equal the JAX decoder's
on the port's own loglikes.

The legacy path (bench.py --legacy): the quick legacy corpus's chain
system and LexChain graph, a small random model without i-vectors, the
corpus's own test utterances, exact search: equal words, cost within
1e-4 relative, and the JAX decoder on the port's loglikes gives the
port's words and costs.

Two wires: int16 waves of three lengths (zero padding), and mu-law waves
of one length whose frame count fills its bucket exactly, so that no
frame holds only the mu-law pad byte (whose cepstra are rounding noise,
see test_torch_frontend.py)."""

import os

import numpy as np
import pytest

from kaldi_tpu.decoder.batched_pipeline2 import \
    BatchedOfflinePipeline2 as JaxPipeline
from kaldi_tpu.decoder.block_chain import BlockChainDecoder as JaxDecoder
from kaldi_tpu.decoder.lexchain import LexChainDecoder as JaxLexDecoder
from kaldi_tpu.decoder.lexchain_ng import NgramLexDecoder as JaxNgDecoder
from kaldi_tpu.feat.frontend import OfflineFeature as JaxFeature
from kaldi_tpu.feat.frontend import mulaw_encode as jax_mulaw_encode
from kaldi_tpu.ivector.batched import BatchedIvectorExtractor as JaxIvec
from kaldi_tpu.nnet3.models import ChainTdnnf as FlaxTdnnf
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as FlaxConfig
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.recipes.bench_corpus import BenchCorpusSpec, mfcc_options
from kaldi_tpu.recipes.bench_corpus import \
    load_ivector_extractor as jax_load_ivec
from kaldi_tpu_torch.decoder.batched_pipeline2 import (
    BatchedOfflinePipeline2, PipelineStats)
from kaldi_tpu_torch.decoder.block_chain import BlockChainDecoder
from kaldi_tpu_torch.decoder.lexchain import LexChainDecoder
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexDecoder
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor
from kaldi_tpu_torch.lat.functions import lattice_best_path
from test_torch_block_chain import graphs
from test_torch_block_chain_lattice import assert_lattices_match
from test_torch_frontend import bench_options, waves
from test_torch_lexchain_ng import graphs as ng_graphs
from test_torch_tdnnf import SMALL, random_variables

IVEC = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus",
                    "flagship_ng_ivec.npz")


def pipelines(seed=0):
    jg, tg = graphs(seed, V=9, num_pdfs=SMALL["num_pdfs"])
    fcfg = FlaxConfig(**SMALL)
    variables = random_variables(fcfg, seed=seed)
    ref = JaxPipeline(FlaxTdnnf(fcfg, train=False), variables["params"],
                      variables["batch_stats"],
                      JaxDecoder(jg, interpret=True),
                      JaxFeature(mfcc_options(BenchCorpusSpec())),
                      ivector_extractor=JaxIvec(jax_load_ivec(IVEC)))
    dev = "cpu"
    port = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(ChainTdnnfConfig(**SMALL), variables,
                              device=dev),
        BlockChainDecoder(tg, device=dev),
        OfflineFeature(bench_options(), device=dev),
        ivector_extractor=BatchedIvectorExtractor(
            load_ivector_extractor(IVEC), device=dev),
        device=dev)
    return ref, port


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
def test_pipeline_matches_jax(wire):
    ref, port = pipelines()
    if wire == "int16":
        ws = [w.astype(np.int16) for w in waves(11, [8000, 6500, 4900])]
    else:
        n = 63 * 160 + 400                 # 64 frames: the bucket, exactly
        ws = [jax_mulaw_encode(w) for w in waves(12, [n, n, n])]
    want = ref.decode_batch(ws)
    stats = PipelineStats()
    got = port.decode_batch(ws, stats=stats)
    assert stats.total_audio_s == pytest.approx(
        sum(len(w) for w in ws) / 16000.0)
    assert stats.wall_s >= stats.search_s > 0
    for b, (r, o) in enumerate(zip(want, got)):
        assert r is not None and o is not None
        assert o[0] == r[0], f"lane {b} words"
        assert len(o[0]) > 0
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"


def test_lattice_mode_matches_jax():
    ref, port = pipelines()
    ws = [w.astype(np.int16) for w in waves(11, [8000, 6500, 4900])]
    want = ref.decode_batch(ws, generate_lattices=True, lattice_beam=10.0)
    lat_stats = {}
    stats = PipelineStats()
    got = port.decode_batch(ws, stats=stats, generate_lattices=True,
                            lattice_beam=10.0, lat_stats=lat_stats)
    assert lat_stats["n_survivors"] > 0 and lat_stats["fwd_s"] > 0
    assert stats.search_s >= lat_stats["fwd_s"]
    best = port.decode_batch(ws)
    for b, (r, o) in enumerate(zip(want, got)):
        assert r is not None and o is not None
        assert o[0] == r[0] == best[b][0], f"lane {b} words"
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"
        assert abs(o[1] - best[b][1]) <= 1e-3
        assert_lattices_match(o[2], r[2], atol=2e-3)
        assert lattice_best_path(o[2])[1] == o[0]
    # alternatives exist in some lane
    assert any(o[2].num_arcs() > len(lattice_best_path(o[2])[0])
               for o in got)


def test_num_waves_not_ported():
    _, port = pipelines()
    with pytest.raises(NotImplementedError, match="num_waves"):
        port.decode_batch([np.zeros(4000, np.int16)], num_waves=2)


def ng_pipelines(search_kwargs=None, stats=None, acoustic_scale=1.0):
    """Both pipelines with an NgramLexDecoder over the same small graph
    (V=8, silence, triphone-hashed tables), the small random model and the
    committed i-vector extractor; the search_kwargs forwarded to both
    (the port's also with `stats`) -> (JAX graph, JAX pipeline, port)."""
    jg, tg, _ = ng_graphs(2, V=8, use_sil=True, ctx=3)
    fcfg = FlaxConfig(**SMALL)
    variables = random_variables(fcfg, seed=0)
    kw = search_kwargs or {}
    ref = JaxPipeline(FlaxTdnnf(fcfg, train=False), variables["params"],
                      variables["batch_stats"], JaxNgDecoder(jg),
                      JaxFeature(mfcc_options(BenchCorpusSpec())),
                      acoustic_scale=acoustic_scale, search_kwargs=kw,
                      ivector_extractor=JaxIvec(jax_load_ivec(IVEC)))
    port = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(ChainTdnnfConfig(**SMALL), variables,
                              device="cpu"),
        NgramLexDecoder(tg, device="cpu"),
        OfflineFeature(bench_options(), device="cpu"),
        acoustic_scale=acoustic_scale,
        search_kwargs=dict(kw, stats=stats) if stats is not None else kw,
        ivector_extractor=BatchedIvectorExtractor(
            load_ivector_extractor(IVEC), device="cpu"),
        device="cpu")
    return jg, ref, port


def test_ngram_search_with_search_kwargs_matches_jax():
    """Both pipelines with an NgramLexDecoder and the same search_kwargs
    (a pool of 4 rows within a beam of 8, forwarded to decode_batch), on
    the waves of test_pipeline_matches_jax.  Both round the model input
    to bf16, so where a feature or i-vector element sits at a bf16
    rounding boundary the two AMs part by about 1e-3 a frame on a whole
    lane (other seeds show it); the decoders themselves must agree on the
    same loglikes: the JAX decoder on the port pipeline's loglikes gives
    the port's words and costs."""
    kw = dict(prune_k=4, prune_beam=8.0, exact_topk=False)
    stats = {}
    jg, ref, port = ng_pipelines(kw, stats)
    ws = [w.astype(np.int16) for w in waves(11, [8000, 6500, 4900])]
    want = ref.decode_batch(ws)
    got = port.decode_batch(ws)
    assert set(stats) == {"fwd_s", "fol_s", "traceback_s"}
    feats, nframes = port.feats.compute_batch_device(ws)
    loglikes, out_lens = port.loglikes(feats, nframes)
    same_ll = JaxNgDecoder(jg).decode_batch(loglikes.numpy(),
                                            lengths=out_lens, **kw)
    for b, (r, o, s) in enumerate(zip(want, got, same_ll)):
        assert r is not None and o is not None
        assert o[0] == r[0] == s[0], f"lane {b} words"
        assert len(o[0]) > 0
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"
        assert abs(o[1] - s[2]) <= 1e-4 * max(1.0, abs(s[2]))


def test_ngram_lattice_mode_matches_jax():
    """Both pipelines in lattice mode with the n-gram decoder (beam 20)
    on the same waves, at acoustic scale 0.1, where path costs rise frame
    by frame: at scale 1 this small model's costs fall, and the
    reference's survivor rule then drops the best path
    (test_torch_lexchain_ng_lattice.py).  Equal words, costs within 1e-4
    relative, and lat_stats reaches the decoder.  On the port pipeline's
    own loglikes (the bf16 seam above) the JAX decoder's lattices equal
    the port's state for state, weights within 1e-4, and each lattice's
    best path is the port's decode_batch with the same pool."""
    scale = 0.1
    jg, ref, port = ng_pipelines(acoustic_scale=scale)
    ws = [w.astype(np.int16) for w in waves(11, [8000, 6500, 4900])]
    want = ref.decode_batch(ws, generate_lattices=True, lattice_beam=20.0)
    lat_stats = {}
    stats = PipelineStats()
    got = port.decode_batch(ws, stats=stats, generate_lattices=True,
                            lattice_beam=20.0, lat_stats=lat_stats)
    assert sorted(lat_stats) == ["assemble_s", "fwd_s", "n_events",
                                 "pool_s"]
    assert stats.search_s >= lat_stats["fwd_s"] > 0
    feats, nframes = port.feats.compute_batch_device(ws)
    loglikes, out_lens = port.loglikes(feats, nframes)
    same_ll = JaxNgDecoder(jg).decode_batch_lattice(
        loglikes.numpy(), scale, lengths=out_lens, lattice_beam=20.0)
    best = port.decoder.decode_batch(loglikes, scale, lengths=out_lens,
                                     prune_k=128)
    for b, (r, o, s, h) in enumerate(zip(want, got, same_ll, best)):
        assert r is not None and o is not None and s is not None
        assert o[0] == r[0] == h[0], f"lane {b} words"
        assert len(o[0]) > 0
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"
        assert abs(o[1] - h[2]) <= 1e-4 * max(1.0, abs(h[2]))
        assert_lattices_match(o[2], s)
        assert o[2].num_arcs() > out_lens[b]


def legacy_pipelines():
    """bench.py main_legacy's pipeline at a small size on both sides: the
    quick legacy spec (V=24), chain_tm_tree_for and build_decode_graph of
    each package, a small random model without i-vectors (18 pdfs),
    LexChainDecoder (exact), the MFCC frontend with 40 cepstra; and the
    corpus's 6 test utterances as int16 waves.  -> (JAX graph, JAX
    pipeline, port pipeline, waves)."""
    quick = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
                 words_per_utt=5, num_train=2, num_test=6, num_lm_sents=80)
    built = []
    for bc in (jbc, tbc):
        spec = bc.BenchCorpusSpec(**quick)
        lexicon, _, _, test_txt, test_wav, lm_text = bc.make_corpus(
            spec, train_audio=False)
        lang, tm, tree = bc.chain_tm_tree_for(lexicon)
        built.append((spec, test_wav, bc.build_decode_graph(
            lexicon, lm_text, tm, tree, lang=lang)))
    (spec, test_wav, jg), (_, _, tg) = built
    kw = dict(SMALL, ivector_dim=0, num_pdfs=tg.num_pdfs)
    fcfg = FlaxConfig(**kw)
    variables = random_variables(fcfg, seed=3)
    ref = JaxPipeline(FlaxTdnnf(fcfg, train=False), variables["params"],
                      variables["batch_stats"], JaxLexDecoder(jg),
                      JaxFeature(mfcc_options(spec, num_ceps=40)),
                      sample_rate=spec.fs)
    port = BatchedOfflinePipeline2(
        chain_tdnnf_from_flax(ChainTdnnfConfig(**kw), variables,
                              device="cpu"),
        LexChainDecoder(tg, device="cpu"),
        OfflineFeature(tbc.mfcc_options(tbc.BenchCorpusSpec(**quick),
                                        num_ceps=40), device="cpu"),
        sample_rate=spec.fs, device="cpu")
    ws = [np.clip(test_wav[u], -32767, 32767).astype(np.int16)
          for u in sorted(test_wav)]
    return jg, ref, port, ws


def test_legacy_lexchain_pipeline_matches_jax():
    """The legacy pipelines (legacy_pipelines) in best-path mode."""
    jg, ref, port, ws = legacy_pipelines()
    want = ref.decode_batch(ws)
    stats = PipelineStats()
    got = port.decode_batch(ws, stats=stats)
    assert stats.search_s > 0 and stats.total_audio_s > 6.0
    feats, nframes = port.feats.compute_batch_device(ws)
    loglikes, out_lens = port.loglikes(feats, nframes)
    same_ll = JaxLexDecoder(jg).decode_batch(loglikes.numpy(),
                                             lengths=out_lens)
    for b, (r, o, s) in enumerate(zip(want, got, same_ll)):
        assert r is not None and o is not None
        assert o[0] == r[0] == s[0], f"lane {b} words"
        assert len(o[0]) > 0
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"
        assert abs(o[1] - s[2]) <= 1e-4 * max(1.0, abs(s[2]))


def test_legacy_lexchain_lattice_pipeline_matches_jax():
    """The legacy pipelines in lattice mode (bench.py --legacy
    --with-lattices, J=4) at lattice_beam 20 (at its beam of 8 this small
    random model's lattices hold the best path alone): every lane has a
    lattice whose
    best path is the JAX pipeline's (equal words, cost within 1e-4
    relative) and the port's decode_batch on the same loglikes; on those
    loglikes the JAX decoder's lattices equal the port's state for
    state, weights within 1e-4, and lat_stats reaches the decoder."""
    jg, ref, port, ws = legacy_pipelines()
    want = ref.decode_batch(ws, generate_lattices=True, lattice_beam=20.0)
    lat_stats = {}
    stats = PipelineStats()
    got = port.decode_batch(ws, stats=stats, generate_lattices=True,
                            lattice_beam=20.0, lat_stats=lat_stats)
    assert stats.search_s >= lat_stats["fwd_s"] > 0
    assert lat_stats["n_arcs"] > 0
    feats, nframes = port.feats.compute_batch_device(ws)
    loglikes, out_lens = port.loglikes(feats, nframes)
    same_ll = JaxLexDecoder(jg).decode_batch_lattice(
        loglikes.numpy(), lengths=out_lens, lattice_beam=20.0)
    best = port.decoder.decode_batch(loglikes, lengths=out_lens)
    for b, (r, o, s, h) in enumerate(zip(want, got, same_ll, best)):
        assert r is not None and o is not None and s is not None
        assert o[0] == r[0] == h[0], f"lane {b} words"
        assert len(o[0]) > 0
        assert abs(o[1] - r[1]) <= 1e-4 * max(1.0, abs(r[1])), \
            f"lane {b}: {o[1]} vs {r[1]}"
        assert abs(o[1] - h[2]) <= 1e-4 * max(1.0, abs(h[2]))
        assert_lattices_match(o[2], s)
        assert o[2].num_arcs() > out_lens[b]
