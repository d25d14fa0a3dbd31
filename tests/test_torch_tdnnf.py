"""Port parity: ChainTdnnf of kaldi_tpu_torch, loaded through
chain_tdnnf_from_flax, against the flax reference in float32.

(i) a small random-init config with i-vectors: both heads within 1e-4
    of max|ref|;
(ii) the committed full-width flagship_ng_params.npz (17 x 1536) on a
    ~1 s utterance: within 1e-3 of max|ref| (17 layers of float32
    matmuls summed in another order); the same for the legacy model,
    flagship_params.npz (17 x 1536, 50 pdfs, no i-vectors);
(iii) bf16, loosely: the port in bf16 against the flax model with bf16
    params (rounding happens at different places, see components.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kaldi_tpu.nnet3.models import ChainTdnnf as FlaxTdnnf
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as FlaxConfig
from kaldi_tpu.recipes.bench_corpus import load_params as jax_load_params
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)
from kaldi_tpu_torch.recipes.bench_corpus import load_params

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")
SMALL = dict(feat_dim=40, ivector_dim=32, num_pdfs=48, hidden_dim=64,
             bottleneck_dim=16, prefinal_dim=24, num_layers=6,
             subsample_layer=3, frame_subsampling_factor=3)
FLAGSHIP = dict(feat_dim=40, ivector_dim=32, num_pdfs=2000, hidden_dim=1536,
                bottleneck_dim=160, prefinal_dim=256, num_layers=17,
                subsample_layer=8, frame_subsampling_factor=3)
# the legacy model (bench.py main_legacy): no i-vectors, 50 pdfs
LEGACY = dict(FLAGSHIP, ivector_dim=0, num_pdfs=50)


def random_variables(cfg, seed=0):
    """flax init, with batch statistics made non-trivial."""
    model = FlaxTdnnf(cfg, train=False)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, 20, cfg.feat_dim)),
                   jnp.zeros((1, cfg.ivector_dim)))
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        return {k: (perturb(a) if isinstance(a, dict) else
                    (rng.normal(size=a.shape) * 0.3).astype(np.float32)
                    if k == "mean" else
                    rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
                    if k == "var" else a)
                for k, a in tree.items()}
    return {"params": v["params"], "batch_stats": perturb(v["batch_stats"])}


def inputs(seed, B, T, cfg):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, cfg.feat_dim)).astype(np.float32) * 3,
            rng.normal(size=(B, cfg.ivector_dim)).astype(np.float32))


def run_both(kw, variables, feats, ivecs):
    fcfg = FlaxConfig(**kw)
    ref = FlaxTdnnf(fcfg, train=False).apply(variables, feats, ivecs)
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**kw), variables,
                                  device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(feats), torch.from_numpy(ivecs))
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def assert_close_of_max(got, want, frac):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


def test_config_time_strides_match():
    for kw in (SMALL, FLAGSHIP):
        assert list(ChainTdnnfConfig(**kw).time_strides()) == \
            list(FlaxConfig(**kw).time_strides())


def test_small_random_f32():
    cfg = FlaxConfig(**SMALL)
    variables = random_variables(cfg)
    feats, ivecs = inputs(1, 3, 37, cfg)
    ref, out = run_both(SMALL, variables, feats, ivecs)
    for r, o in zip(ref, out):
        assert o.shape == r.shape == (3, 13, 48)
        assert_close_of_max(o, r, 1e-4)


def test_chain_head_alone_matches_forward():
    cfg = ChainTdnnfConfig(**SMALL)
    variables = random_variables(FlaxConfig(**SMALL), seed=2)
    model = chain_tdnnf_from_flax(cfg, variables, device="cpu")
    feats, ivecs = inputs(3, 2, 20, cfg)
    f, i = torch.from_numpy(feats), torch.from_numpy(ivecs)
    with torch.inference_mode():
        assert torch.equal(model.chain(f, i), model(f, i)[0])


def test_flagship_weights_f32():
    variables = load_params(os.path.join(ART, "flagship_ng_params.npz"))
    ref_vars = jax_load_params(os.path.join(ART, "flagship_ng_params.npz"))
    cfg = FlaxConfig(**FLAGSHIP)
    feats, ivecs = inputs(4, 1, 100, cfg)           # ~1 s of frames
    fcfg = FlaxConfig(**FLAGSHIP)
    ref = FlaxTdnnf(fcfg, train=False).apply(ref_vars, feats, ivecs)
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**FLAGSHIP), variables,
                                  device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(feats), torch.from_numpy(ivecs))
    assert out[0].shape == (1, 34, 2000)
    for r, o in zip(ref, out):
        assert_close_of_max(o.numpy(), np.asarray(r), 1e-3)


def test_legacy_flagship_weights_f32():
    """flagship_params.npz through load_params and chain_tdnnf_from_flax,
    against flax on ~1 s of frames, both heads, without i-vectors."""
    path = os.path.join(ART, "flagship_params.npz")
    variables = load_params(path)
    cfg = FlaxConfig(**LEGACY)
    assert cfg.ivector_dim == 0
    feats = inputs(7, 1, 100, cfg)[0]               # ~1 s of frames
    ref = FlaxTdnnf(cfg, train=False).apply(jax_load_params(path), feats)
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**LEGACY), variables,
                                  device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(feats), None)
    assert out[0].shape == (1, 34, 50)
    for r, o in zip(ref, out):
        assert_close_of_max(o.numpy(), np.asarray(r), 1e-3)


def test_small_bf16_loose():
    cfg = FlaxConfig(**SMALL)
    variables = random_variables(cfg, seed=5)
    feats, ivecs = inputs(6, 2, 31, cfg)
    params16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                            variables["params"])
    ref, _ = FlaxTdnnf(cfg, train=False).apply(
        {"params": params16, "batch_stats": variables["batch_stats"]},
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(ivecs, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    model = chain_tdnnf_from_flax(ChainTdnnfConfig(**SMALL), variables,
                                  dtype=torch.bfloat16, device="cpu")
    with torch.inference_mode():
        out = model.chain(torch.from_numpy(feats).to(torch.bfloat16),
                          torch.from_numpy(ivecs).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    # bf16 keeps ~3 significant digits; 6 layers compound the rounding
    assert_close_of_max(out.float().numpy(), ref, 3e-2)
