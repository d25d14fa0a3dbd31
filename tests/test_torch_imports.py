"""Import hygiene of the port: no module of kaldi_tpu_torch, and nothing
chip_smoke.py imports, pulls in jax, flax, triton or kaldi_tpu; and the
entry points raise when CUDA is asked for on a machine without it, and
run when the caller passes device="cpu"."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import kaldi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kaldi_tpu_torch.__path__,
                                               "kaldi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton",
                                    "kaldi_tpu"))
print(len(names))
print(",".join(bad))
print(",".join(n for n in names if n not in sys.modules))
"""


def test_no_jax_flax_triton_or_kaldi_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad, missing = proc.stdout.split("\n")[:3]
    assert int(n_modules) >= 25
    assert bad == "", f"forbidden modules imported: {bad}"
    assert missing == ""
    walked = set(_walked())
    for name in ("fstext.fst", "fstext.ops", "lat.kaldi_lattice",
                 "lat.functions", "ops.block_chain_lattice_step",
                 "ops.block_chain_step", "decoder.block_chain",
                 "ops.viterbi_relax", "decoder.batched_viterbi",
                 "decoder.viterbi", "decoder.graph_direct",
                 "decoder.lexchain_ng", "decoder.lexchain",
                 "decoder.chain_blocks", "lm.trigram", "lm.bigram",
                 "base.io_funcs",
                 "util.kaldi_io", "util.edit_distance", "hmm.topology",
                 "hmm.transition_model", "tree.event_map",
                 "tree.context_dep", "recipes.bench_corpus",
                 "online.decoding", "online.features",
                 "online.batched_device_pipeline", "decoder.graph",
                 "decoder.native_viterbi", "hmm.hmm_utils", "gmm.diag_gmm",
                 "gmm.am_diag_gmm", "gmm.mle", "chain.graphs",
                 "chain.supervision", "chain.objective", "recipes.mono",
                 "recipes.chain", "recipes.train_bench", "base.logging",
                 "util.table", "util.parse_options", "nnet3.mdl_io",
                 "nnet3.torch_bridge", "cli", "cli.nnet3_tools",
                 "feat.wave", "feat.functions", "fstext.openfst_io",
                 "nnet3.streaming", "online.server", "util.profile",
                 "cli.online_tools", "cli.online_tools2", "nnet3.xconfig",
                 "nnet3.components", "parallel.checkpoint",
                 "decoder.lattice_decoder", "cli.nnet3_latgen_tools",
                 "cli.lat_tools", "cli.ali_tools", "hmm.posterior",
                 "nnet3.egs", "parallel.optim", "parallel.recovery",
                 "parallel.trainer", "cli.chain_tools", "cli.nnet3_tools2",
                 "cli.nnet3_tail2_tools", "cli.tail4_tools",
                 "decoder.lang_dir", "util.validation", "cli.misc_tools",
                 "cli.feat_tools", "cli.gmm_tools", "cli.tree_tools",
                 "fstext.context", "recipes.deltas", "lm.arpa",
                 "recipes.template_run", "recipes.template_corpus",
                 "transform", "transform.lda", "transform.mllt",
                 "transform.fmllr", "transform.gauss_rows",
                 "recipes.lda_mllt", "cli.transform_tools",
                 "nnet3.discriminative", "nnet3.discriminative_train",
                 "nnet3.natural_gradient", "cli.tail3_tools",
                 "cli.tail9_tools", "ivector.logistic_regression",
                 "ivector.cluster", "transform.lvtln", "gmm.ebw",
                 "recipes.mmi", "recipes.synthetic_run", "cli.vtln_tools",
                 "cli.fst_tools", "cli.graph_tools", "cli.lat_tools2",
                 "lm.const_arpa", "lm.rescore", "lat.compose_pruned",
                 "lat.sausages", "lat.word_align", "fstext.grammar_fst",
                 "decoder.biglm", "decoder.incremental",
                 "decoder.dense_relax", "decoder.beam_sparse",
                 "cli.decoders2_tools", "cli.tail15_tools"):
        assert f"kaldi_tpu_torch.{name}" in walked, name


def _walked():
    import pkgutil

    import kaldi_tpu_torch
    return [m.name for m in pkgutil.walk_packages(kaldi_tpu_torch.__path__,
                                                  "kaldi_tpu_torch.")]


def _makers(device):
    """Constructors of the port's entry points on `device`."""
    from kaldi_tpu_torch.decoder.batched_pipeline2 import \
        BatchedOfflinePipeline2
    from kaldi_tpu_torch.decoder.batched_viterbi import BatchedViterbi
    from kaldi_tpu_torch.decoder.block_chain import (BlockChainDecoder,
                                                     BlockChainGraph)
    from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                      synth_bigram,
                                                      synth_lexicon)
    from kaldi_tpu_torch.decoder.lexchain_ng import (NgramLexDecoder,
                                                     NgramLexGraph)
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
    from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                              chain_tdnnf_from_flax)
    from kaldi_tpu_torch.lm.trigram import TrigramBackoffLm
    from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor
    spec = DirectGraphSpec(vocab=5, num_phones=4, min_pron=1, max_pron=3,
                           num_pdfs=16)
    g = BlockChainGraph.build(synth_lexicon(spec), synth_bigram(spec),
                              num_pdfs=16)
    ivec = load_ivector_extractor(os.path.join(
        REPO, "egs", "bench_corpus", "flagship_ng_ivec.npz"))
    cfg = ChainTdnnfConfig(feat_dim=4, num_pdfs=16, hidden_dim=8,
                           bottleneck_dim=4, prefinal_dim=4, num_layers=0)
    params = {"input_affine": {"kernel": np.zeros((4, 8)),
                               "bias": np.zeros(8)},
              "output_affine": {"kernel": np.zeros((4, 16)),
                                "bias": np.zeros(16)},
              "output_xent_affine": {"kernel": np.zeros((4, 16)),
                                     "bias": np.zeros(16)}}
    stats = {"input_bn": {"bn": {"mean": np.zeros(8), "var": np.ones(8)}}}
    for head in ("prefinal_chain", "prefinal_xent"):
        params[head] = {"affine": {"kernel": np.zeros((8, 8)),
                                   "bias": np.zeros(8)},
                        "linear": {"kernel": np.zeros((8, 4))}}
        stats[head] = {n: {"bn": {"mean": np.zeros(d), "var": np.ones(d)}}
                       for n, d in (("bn1", 8), ("bn2", 4))}
    opts = MfccOptions()
    opts.frame_opts.dither = 0.0
    lm = TrigramBackoffLm.from_counts([["a", "b", "a"], ["b"]], prune_tri=1)
    ng = NgramLexGraph.build([np.array([1, 2]), np.array([3])], lm,
                             num_pdfs=16)
    return [
        lambda: OfflineFeature(opts, device=device),
        lambda: BatchedIvectorExtractor(ivec, device=device),
        lambda: chain_tdnnf_from_flax(
            cfg, {"params": params, "batch_stats": stats}, device=device),
        lambda: BlockChainDecoder(g, device=device),
        lambda: BatchedViterbi(g.to_flat_graph().to_vector_fst(), g.tid2pdf,
                               device=device),
        lambda: NgramLexDecoder(ng, device=device),
    ], BatchedOfflinePipeline2


def test_entry_points_raise_without_cuda_and_run_on_cpu():
    from kaldi_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    makers, pipeline = _makers(None)
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    makers, pipeline = _makers("cpu")
    fe, iv, model, dec, dense, ngram = [make() for make in makers]
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline(model, dec, fe)
    pipeline(model, dec, fe, ivector_extractor=iv, device="cpu")
    feats, n = fe.compute_batch_device([np.zeros(4000, np.int16)])
    assert feats.device.type == "cpu" and int(n[0]) == 23
    out = dec.decode_batch(np.zeros((1, 6, 16), np.float32))
    assert out[0] is not None
    lats = dec.decode_batch_lattice(np.zeros((1, 6, 16), np.float32))
    assert lats[0] is not None and lats[0].num_states > 0
    hyps = dense.run(np.zeros((2, 6, 16), np.float32), [6, 4])
    assert [len(h[0]) for h in hyps] == [6, 4]
    hyps = ngram.decode_batch(np.zeros((2, 6, 16), np.float32),
                              lengths=[6, 4])
    assert [len(h[1]) for h in hyps] == [6, 4]


def test_lexchain_entry_points_raise_without_cuda_and_run_on_cpu():
    """The legacy path's decoder (best path and lattice mode) and online
    pipeline: CUDA by default (raising without it), the CPU when asked."""
    from kaldi_tpu_torch.decoder.lexchain import (LexChainDecoder,
                                                  LexChainGraph)
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
    from kaldi_tpu_torch.online.batched_device_pipeline import \
        BatchedDeviceOnlinePipelineLex
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    lm = BigramBackoffLm.from_counts([["a", "b", "a"], ["b"]])
    g = LexChainGraph.build([np.array([1, 2]), np.array([3])], lm,
                            num_pdfs=16, use_sil=True, sil_phone=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        LexChainDecoder(g)
    dec = LexChainDecoder(g, device="cpu")
    assert dec.device.type == "cpu"
    hyps = dec.decode_batch(np.zeros((2, 6, 16), np.float32),
                            lengths=[6, 4])
    assert [len(h[1]) for h in hyps] == [6, 4]
    lats = dec.decode_batch_lattice(np.zeros((2, 6, 16), np.float32),
                                    lengths=[6, 4])
    assert [lattice_best_path(lat)[1] for lat in lats] == \
        [h[0] for h in hyps]
    pipe = BatchedDeviceOnlinePipelineLex(dec, lambda f: f, feat_dim=16,
                                          num_lanes=2, chunk_frames=4)
    assert pipe._cost.device.type == "cpu"
    pipe.init_channel(0, "u")
    pipe.accept_features(0, np.zeros((6, 16), np.float32))
    while pipe.compute():
        pass
    assert pipe.finalize(0) == hyps[0]


def test_training_entry_points_raise_without_cuda(tmp_path):
    """The training side: train_bench (its main and train_and_decode),
    the GMM scorer and the chain trainer default to CUDA and raise
    without it."""
    from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
    from kaldi_tpu_torch.recipes import bench_corpus as tbc
    from kaldi_tpu_torch.recipes import chain as tchain
    from kaldi_tpu_torch.recipes import train_bench
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        AmDiagGmm()
    assert AmDiagGmm(device="cpu").device.type == "cpu"
    spec = tbc.BenchCorpusSpec(vocab=12, num_phone_groups=2,
                               phones_per_group=2, words_per_utt=3,
                               num_train=2, num_test=1, num_lm_sents=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.train_and_decode(str(tmp_path), epochs=1, spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tchain._fit_chain(train_bench.flagship_config(spec), None, [], [],
                          tchain.ChainTrainOptions(), 150, 40)
    with pytest.raises(SystemExit):
        train_bench.main([])                 # --out is required
    assert not os.listdir(tmp_path)



def test_online2_entry_points_raise_without_cuda_and_run_on_cpu(tmp_path):
    """The online2 serving path: the streaming scorer, the streaming
    features and the online2 tools default to CUDA and raise without it;
    the CPU when asked."""
    from kaldi_tpu_torch.cli import get_tool
    from kaldi_tpu_torch.feat.frontend import MfccOptions
    from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
    from kaldi_tpu_torch.online.features import OnlineFeature
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    opts = MfccOptions()
    opts.frame_opts.dither = 0.0
    for make in (lambda d: OnlineNnetScorer(lambda w: w, device=d),
                 lambda d: OnlineFeature(opts, device=d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
        make("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_tool("online2-wav-dump-features")(
            ["online2-wav-dump-features", "--dither=0",
             f"ark:{tmp_path / 'w.ark'}", f"ark:{tmp_path / 'f.ark'}"])


def test_slice19_entry_points_raise_without_cuda_and_run_on_cpu():
    """The logistic regression's training, the LVTLN Gram matrices and
    the warped frontend: CUDA by default (raising without it), the CPU
    when asked."""
    from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu_torch.ivector.logistic_regression import \
        train_logistic_regression
    from kaldi_tpu_torch.transform.lvtln import LvtlnGram
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    x = np.random.default_rng(0).normal(size=(6, 3))
    y = np.array([0, 1, 0, 1, 0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_logistic_regression(x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        LvtlnGram(3)
    assert train_logistic_regression(x, y, device="cpu").weights.shape == \
        (2, 4)
    gram = LvtlnGram(3, device="cpu")
    gram.add(x[:, :3], 2 * x[:, :3])
    np.testing.assert_allclose(gram.solve()[0], 2 * np.eye(3), atol=1e-5)
    opts = MfccOptions()
    opts.frame_opts.dither = 0.0
    feats, n = OfflineFeature(opts, device="cpu").compute_batch_device(
        [np.zeros(4000, np.int16)] * 2, vtln_warp=[0.9, 1.1])
    assert feats.device.type == "cpu" and list(n) == [23, 23]
