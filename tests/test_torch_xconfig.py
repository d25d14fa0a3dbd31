"""Port parity: nnet3/xconfig.py and the layer zoo of nnet3/components.py
against the JAX package's, on the same numpy inputs and carried weights,
in float32 on the CPU (no TF32 there).

Tolerance: max |port - JAX| <= 1e-5 * max(1, max |JAX|) for every layer
and model below (products summed in another order; the recurrent layers
split each frame's gate product into an input half computed for all
frames at once and a recurrent half, which moves the sums again).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet3 import components as jc
from kaldi_tpu.nnet3 import xconfig as jx
from kaldi_tpu.nnet3.models import ChainTdnnf as FlaxTdnnf
from kaldi_tpu.nnet3.models import ChainTdnnfConfig as FlaxConfig
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.nnet3 import components as tc
from kaldi_tpu_torch.nnet3 import xconfig as tx
from kaldi_tpu_torch.nnet3.models import (ChainTdnnfConfig,
                                          chain_tdnnf_from_flax)

REL = 1e-5


def close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def perturb_stats(variables, seed):
    """Batch statistics made non-trivial (flax inits them to 0 and 1)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: (walk(a) if isinstance(a, dict) else
                    (rng.normal(size=a.shape) * 0.3).astype(np.float32)
                    if k == "mean" else
                    rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32))
                for k, a in tree.items()}
    out = dict(np_tree(variables))
    if "batch_stats" in out:
        out["batch_stats"] = walk(out["batch_stats"])
    return out


def jax_init(module, *args, seed=0):
    return module.init(jax.random.PRNGKey(seed), *args)


def feats(seed, B, T, D, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, T, D))
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# parsing and descriptors

TEXT = """
# a comment line
input dim=13 name=input   # trailing comment
input dim=$ivdim name=ivector
relu-batchnorm-layer name=tdnn1 dim=32 input=Append(-1, 0, 1, ReplaceIndex(ivector, t, 0))
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=8 time-stride=1
output-layer name=output dim=$num_targets include-log-softmax=false
"""


def test_parse_xconfig_matches_jax():
    subs = {"ivdim": 7, "num_targets": 11}
    got = tx.parse_xconfig(TEXT, subs)
    want = jx.parse_xconfig(TEXT, subs)
    assert [(l.layer_type, l.name, l.opts) for l in got] == \
        [(l.layer_type, l.name, l.opts) for l in want]
    assert got[2].get("input") == "Append(-1, 0, 1, ReplaceIndex(ivector, t, 0))"
    assert got[3].get_int("time-stride") == 1
    assert got[3].get_float("bypass-scale", 0.66) == 0.66
    for bad in ("relu-batchnorm-layer dim=3", "input name=a stray"):
        with pytest.raises(KaldiTpuError):
            tx.parse_xconfig(bad)
        with pytest.raises(Exception):
            jx.parse_xconfig(bad)


DESCRIPTORS = ["a", "a@-2", "b@3", "Append(-1, 0, 1)", "Append(-2,0,2)",
               "Append(a, b)", "Append(Offset(a, -1), b@2, 0)",
               "Offset(a, 3)", "Offset(b, -4)", "ReplaceIndex(iv, t, 0)",
               "Sum(a, b)", "Sum(a, b@1, Offset(a, -1))", "Scale(0.5, a)",
               "Sum(Scale(-2, a), b)", "IfDefined(missing)",
               "IfDefined(a@-1)", "Append(IfDefined(missing), a)"]


@pytest.mark.parametrize("desc", DESCRIPTORS)
def test_descriptor_matches_jax(desc):
    """Every descriptor form over the same tensors: edge replication at
    both ends, __prev__ for bare integers, zeros for IfDefined of a
    missing input."""
    a, b, prev = feats(1, 2, 9, 5), feats(2, 2, 9, 5), feats(3, 2, 9, 5)
    iv = np.repeat(feats(4, 2, 1, 5), 9, axis=1)
    tj = {"a": jnp.asarray(a), "b": jnp.asarray(b), "iv": jnp.asarray(iv),
          "__prev__": jnp.asarray(prev)}
    tt = {k: torch.from_numpy(np.array(v)) for k, v in tj.items()}
    close(tx._eval_descriptor(desc, tt, "a"),
          jx._eval_descriptor(desc, tj, "a"), rel=0)
    dims = {k: tx._Dim(v.shape[-1]) for k, v in tt.items()}
    assert int(tx._eval_descriptor(desc, dims, "a")) == \
        jx._eval_descriptor(desc, tj, "a").shape[-1]


def test_descriptor_errors():
    t = {"a": torch.zeros(1, 3, 2), "__prev__": torch.zeros(1, 3, 2)}
    with pytest.raises(KaldiTpuError, match="unknown descriptor"):
        tx._eval_expr("nope", t)
    with pytest.raises(KaldiTpuError, match="unsupported descriptor"):
        tx._eval_expr("Round(a, 2)", t)
    assert tx._eval_descriptor("", t, "a") is t["a"]


# ---------------------------------------------------------------------------
# the layer zoo


def test_lstmp_layer_and_carries():
    B, T, D, cd, rd, nd = 3, 23, 12, 16, 6, 5
    x = feats(5, B, T, D)
    m = jc.LstmpLayer(cell_dim=cd, recurrent_dim=rd, nonrecurrent_dim=nd)
    v = np_tree(jax_init(m, jnp.asarray(x)))
    p = v["params"]
    p["b_ifco"] = np.random.default_rng(6).normal(
        size=p["b_ifco"].shape).astype(np.float32)
    t = tc.LstmpLayer(D, cd, rd, nd)
    with torch.no_grad():
        for n, prm in t.named_parameters():
            prm.copy_(torch.from_numpy(p[n]))
    ys, (c, r) = m.apply({"params": p}, jnp.asarray(x))
    ys_t, (c_t, r_t) = t(torch.from_numpy(x))
    close(ys_t, ys)
    close(c_t, c)
    close(r_t, r)
    # carried state: the second half from the first half's carries
    y1, st = m.apply({"params": p}, jnp.asarray(x[:, :11]))
    y2, _ = m.apply({"params": p}, jnp.asarray(x[:, 11:]), init_state=st)
    st_t = t(torch.from_numpy(x[:, :11]))[1]
    y2_t, _ = t(torch.from_numpy(x[:, 11:]), init_state=st_t)
    close(y2_t, y2)
    close(torch.cat([t(torch.from_numpy(x[:, :11]))[0], y2_t], 1), ys)


def test_gru_layer_and_carries():
    B, T, D, cd, pd = 2, 19, 10, 14, 6
    x = feats(7, B, T, D)
    m = jc.GruLayer(cell_dim=cd, projection_dim=pd)
    p = np_tree(jax_init(m, jnp.asarray(x)))["params"]
    rng = np.random.default_rng(8)
    for n in ("b_zr", "b_h"):
        p[n] = rng.normal(size=p[n].shape).astype(np.float32)
    t = tc.GruLayer(D, cd, pd)
    with torch.no_grad():
        for n, prm in t.named_parameters():
            prm.copy_(torch.from_numpy(p[n]))
    ys, h = m.apply({"params": p}, jnp.asarray(x))
    ys_t, h_t = t(torch.from_numpy(x))
    close(ys_t, ys)
    close(h_t, h)
    h0 = rng.normal(size=(B, cd)).astype(np.float32)
    ys, h = m.apply({"params": p}, jnp.asarray(x), init_state=jnp.asarray(h0))
    ys_t, h_t = t(torch.from_numpy(x), init_state=torch.from_numpy(h0))
    close(ys_t, ys)
    close(h_t, h)


def test_statistics_pooling_plain_and_masked():
    x = feats(9, 3, 17, 8, scale=2.0)
    x[2] = 0.5                                   # zero variance: the floor
    mask = np.ones((3, 17), bool)
    mask[0, 12:] = False
    mask[1, :3] = False
    m = jc.StatisticsPooling()
    t = tc.StatisticsPooling()
    close(t(torch.from_numpy(x)), m.apply({}, jnp.asarray(x)))
    close(t(torch.from_numpy(x), torch.from_numpy(mask)),
          m.apply({}, jnp.asarray(x), jnp.asarray(mask)))


@pytest.mark.parametrize("stride", [1, 2])
def test_restricted_attention(stride):
    B, T, D = 2, 13, 12
    x = feats(10, B, T, D)
    kw = dict(num_heads=3, key_dim=5, value_dim=4, num_left_inputs=4,
              num_right_inputs=2, time_stride=stride)
    m = jc.RestrictedAttention(**kw)
    p = np_tree(jax_init(m, jnp.asarray(x)))["params"]
    rng = np.random.default_rng(11)
    for n in ("query", "key", "value"):
        p[n]["bias"] = rng.normal(size=p[n]["bias"].shape).astype(np.float32)
    t = tc.RestrictedAttention(D, **kw)
    with torch.no_grad():
        for n in ("query", "key", "value"):
            getattr(t, n).weight.copy_(torch.from_numpy(p[n]["kernel"]).T)
            getattr(t, n).bias.copy_(torch.from_numpy(p[n]["bias"]))
    close(t(torch.from_numpy(x)), m.apply({"params": p}, jnp.asarray(x)))


def test_pnorm_scale_offset_sum_block():
    x = feats(12, 2, 7, 12, scale=3.0)
    for od, p in ((4, 2.0), (3, 1.5), (6, 3.0)):
        close(tc.Pnorm(od, p)(torch.from_numpy(x)),
              jc.Pnorm(output_dim=od, p=p).apply({}, jnp.asarray(x)))
    with pytest.raises(ValueError):
        tc.Pnorm(5)(torch.from_numpy(x))
    rng = np.random.default_rng(13)
    sc = {"scale": rng.normal(size=12).astype(np.float32),
          "offset": rng.normal(size=12).astype(np.float32)}
    t = tc.ScaleAndOffset(12)
    with torch.no_grad():
        t.scale.copy_(torch.from_numpy(sc["scale"]))
        t.offset.copy_(torch.from_numpy(sc["offset"]))
    close(t(torch.from_numpy(x)),
          jc.ScaleAndOffset(dim=12).apply({"params": sc}, jnp.asarray(x)))
    for od, s in ((4, 1.0), (6, 0.5)):
        close(tc.SumBlock(od, s)(torch.from_numpy(x)),
              jc.SumBlock(output_dim=od, scale=s).apply({}, jnp.asarray(x)))
    with pytest.raises(ValueError):
        tc.SumBlock(5)(torch.from_numpy(x))


# ---------------------------------------------------------------------------
# xconfig models: every layer type, JAX's XconfigModel against the port's


MODELS = {
    "relu_bn_affine_linear": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=24 input=Append(-2,-1,0,1,2)
relu-batchnorm-dropout-layer name=tdnn2 dim=20 input=Append(-1,0,1)
relu-renorm-layer name=tdnn3 dim=18
fixed-affine-layer name=lda dim=16
affine-layer name=aff
linear-component name=lin dim=12
batchnorm-component name=bn1
no-op-component name=nop input=Sum(lin, Scale(0.5, bn1@-1))
output-layer name=output dim=9
""",
    "tdnnf_prefinal_two_heads": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=32
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=8 time-stride=1
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=32 bottleneck-dim=8 time-stride=1 subsample=3
tdnnf-layer name=tdnnf5 dim=32 bottleneck-dim=8 time-stride=3 bypass-scale=0.75
prefinal-layer name=prefinal-chain input=tdnnf5 big-dim=32 small-dim=16
output-layer name=output dim=11 include-log-softmax=false
prefinal-layer name=prefinal-xent input=tdnnf5 big-dim=32 small-dim=16
output-layer name=output-xent dim=11
""",
    "ivector_replace_index": """
input dim=13 name=input
input dim=6 name=ivector
relu-batchnorm-layer name=tdnn1 dim=20 input=Append(-1,0,1,ReplaceIndex(ivector,t,0))
relu-batchnorm-layer name=tdnn2 dim=20 input=Append(tdnn1@-2, tdnn1, IfDefined(nothere))
output-layer name=output dim=7
""",
    "lstmp": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=24 input=Append(-1,0,1)
lstmp-layer name=lstm1 cell-dim=20 recurrent-projection-dim=6 non-recurrent-projection-dim=5
fast-lstmp-layer name=lstm2 cell-dim=16 recurrent-projection-dim=4
fast-lstm-layer name=lstm3 cell-dim=12
lstm-layer name=lstm4 cell-dim=8 recurrent-projection-dim=3 input=Append(lstm3@-1, lstm3)
output-layer name=output dim=9
""",
    "gru": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=24
gru-layer name=gru1 cell-dim=20 recurrent-projection-dim=7
gru-layer name=gru2 cell-dim=16
output-layer name=output dim=9
""",
    "attention": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=24
attention-relu-renorm-layer name=att1 num-heads=3 key-dim=5 value-dim=4 num-left-inputs=5 num-right-inputs=2
attention-layer name=att2 num-heads=2 key-dim=4 value-dim=6 num-left-inputs=2 num-right-inputs=3 time-stride=2
output-layer name=output dim=9
""",
    "cnn_even_kernel_stride2": """
input dim=40 name=input
conv-relu-batchnorm-layer name=cnn1 height-in=40 num-filters-out=6 time-kernel=3 height-kernel=3
cnn-layer name=cnn2 height-in=40 num-filters-out=4 time-kernel=4 height-kernel=2 height-subsample-out=2
conv-relu-batchnorm-layer name=cnn3 height-in=20 num-filters-out=3 time-kernel=2 height-kernel=3 height-subsample-out=2
output-layer name=output dim=9
""",
    "xvector_stats": """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=16 input=Append(-2,-1,0,1,2)
relu-batchnorm-layer name=tdnn2 dim=16 input=Append(-2,0,2)
relu-batchnorm-layer name=tdnn3 dim=24
stats-layer name=stats
relu-batchnorm-layer name=tdnn4 dim=12
output-layer name=output dim=5
""",
}


def _jax_model(text, B, T, seed):
    layers = jx.parse_xconfig(text)
    model = jx.XconfigModel(tuple(layers), train=False)
    dims = {l.name: l.get_int("dim") for l in layers
            if l.layer_type == "input"}
    ins = {n: (feats(seed + i, B, T, d) if n == "input"
               else feats(seed + i, B, 1, d)[:, 0])
           for i, (n, d) in enumerate(dims.items())}
    v = perturb_stats(jax_init(
        model, {n: jnp.asarray(a) for n, a in ins.items()}, seed=seed), seed)
    rng = np.random.default_rng(seed)

    def bias(tree):
        return {k: (bias(a) if isinstance(a, dict) else
                    rng.normal(size=a.shape).astype(np.float32) * 0.3
                    if k in ("bias", "b_ifco", "b_zr", "b_h") else a)
                for k, a in tree.items()}
    v["params"] = bias(v["params"])
    return model, v, ins


@pytest.mark.parametrize("name", sorted(MODELS))
def test_xconfig_model_matches_jax(name):
    text = MODELS[name]
    T = 31 if "cnn" not in name else 20        # 31: not a multiple of 3
    model, v, ins = _jax_model(text, 2, T, seed=20)
    want = model.apply(v, {n: jnp.asarray(a) for n, a in ins.items()})
    port = tx.xconfig_from_flax(text, v, device="cpu")
    got = port({n: torch.from_numpy(a) for n, a in ins.items()})
    assert sorted(got) == sorted(want)
    for head in want:
        close(got[head], want[head])
    # the weights go back into flax's tree unchanged
    back = tx.xconfig_to_flax(port)
    flat = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, a in flat:
        np.testing.assert_array_equal(flat_back[path], a)


def test_xconfig_float64_and_build_defaults():
    text = MODELS["tdnnf_prefinal_two_heads"]
    model, v, ins = _jax_model(text, 1, 25, seed=30)
    f32 = tx.xconfig_from_flax(text, v, device="cpu")
    f64 = tx.xconfig_from_flax(text, v, device="cpu", dtype=torch.float64)
    assert f64.dtype == torch.float64 and f64.mods["tdnn1_bn"].mean.dtype \
        == torch.float64
    x = torch.from_numpy(ins["input"])
    close(f32({"input": x})["output"], f64({"input": x})["output"], rel=1e-5)
    zero = tx.build_xconfig_model(text, device="cpu")
    assert not zero.training
    assert float(zero({"input": x})["output"].abs().max()) == 0.0
    assert tx.xconfig_to_flax(zero)["batch_stats"]["tdnn1_bn"]["bn"]["var"] \
        .tolist() == [1.0] * 32


def test_unknown_layer_type_raises_at_build():
    text = "input dim=4 name=input\nfancy-layer name=f1 dim=3\n"
    with pytest.raises(KaldiTpuError, match="fancy-layer"):
        tx.build_xconfig_model(text, device="cpu")
    with pytest.raises(KaldiTpuError, match="has no dim"):
        tx.build_xconfig_model("input name=input\n", device="cpu")
    m = tx.XconfigModel(tx.parse_xconfig(
        "input name=input\noutput-layer name=output dim=2\n"),
        input_dims={"input": 3})
    assert m.mods["output_affine"].weight.shape == (2, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present")
        tx.build_xconfig_model(text.splitlines()[0])


# ---------------------------------------------------------------------------
# the legacy chain TDNN-F as an xconfig model

SMALL = dict(feat_dim=13, num_pdfs=11, hidden_dim=32, bottleneck_dim=8,
             prefinal_dim=16, num_layers=9, subsample_layer=5,
             frame_subsampling_factor=3)


@pytest.mark.parametrize("ivector_dim", [0, 6])
def test_chain_tdnnf_xconfig_equals_chain_tdnnf(ivector_dim):
    """chain_tdnnf_xconfig + chain_tdnnf_variables_to_xconfig compute
    ChainTdnnf's function: in JAX (its XconfigModel on the port's text)
    and in the port (the xconfig module against chain_tdnnf_from_flax)."""
    cfg_j = FlaxConfig(ivector_dim=ivector_dim, **SMALL)
    cfg_t = ChainTdnnfConfig(ivector_dim=ivector_dim, **SMALL)
    x = feats(40, 2, 32, SMALL["feat_dim"], scale=2.0)
    iv = feats(41, 2, 1, max(ivector_dim, 1))[:, 0, :ivector_dim]
    native = FlaxTdnnf(cfg_j, train=False)
    v = perturb_stats(native.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                  jnp.asarray(iv)), 3)
    chain, xent = native.apply(v, jnp.asarray(x), jnp.asarray(iv))
    text = tx.chain_tdnnf_xconfig(cfg_t)
    xv = tx.chain_tdnnf_variables_to_xconfig(v)
    ins = {"input": x} if not ivector_dim else {"input": x, "ivector": iv}
    jmodel = jx.XconfigModel(tuple(jx.parse_xconfig(text)), train=False)
    out = jmodel.apply(xv, {k: jnp.asarray(a) for k, a in ins.items()})
    close(out["output"], chain)
    close(out["output-xent"], xent)
    port = tx.xconfig_from_flax(text, xv, device="cpu")
    got = port({k: torch.from_numpy(a) for k, a in ins.items()})
    ref = chain_tdnnf_from_flax(cfg_t, v, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(iv) if ivector_dim else None)
    assert got["output"].shape == (2, 11, 11)
    close(got["output"], ref[0].numpy())
    close(got["output-xent"], ref[1].numpy())
    close(got["output"], chain)
    layers = tx.parse_xconfig(text)
    assert [l.get_int("time-stride") for l in layers
            if l.layer_type == "tdnnf-layer"] == list(cfg_t.time_strides())
    assert [l.name for l in layers if l.get("subsample")] == ["tdnnf5"]
