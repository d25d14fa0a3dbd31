"""Port parity: parallel/checkpoint.py (the .npz checkpoint layout, the
latest-step rule, ObjectiveInfo) and tools/jax_checkpoint_to_torch.py,
which turns a JAX package orbax checkpoint directory into the port's.

Tolerance: the converted model's outputs within 1e-5 * max(1, max |JAX|)
of the JAX model's on the same features (float32 on the CPU); the
arrays themselves are carried bit for bit.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet3.xconfig import build_xconfig_model as jax_build
from kaldi_tpu.parallel import checkpoint as jck
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.parallel import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XCONFIG = """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=24 input=Append(-2,-1,0,1,2)
tdnnf-layer name=tdnnf2 dim=24 bottleneck-dim=6 time-stride=1
lstmp-layer name=lstm1 cell-dim=16 recurrent-projection-dim=4
output-layer name=output dim=7 include-log-softmax=false
output-layer name=output-xent input=tdnnf2 dim=7
"""


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(REPO, "tools", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"a_affine": {"kernel": rng.normal(size=(3, 4)),
                                    "bias": rng.normal(size=4)
                                    .astype(np.float32)},
                       "tdnnf3": {"linear": np.arange(6, dtype=np.int32)}},
            "batch_stats": {"a_bn": {"bn": {"mean": np.zeros(4, np.float32),
                                            "var": np.ones(4)}}}}


def _equal_trees(a, b):
    fa, fb = tck.flatten_tree(a), tck.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k])


def test_round_trip_and_latest_step(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (0, 3, 12):
        tck.save_checkpoint(d, _tree(step), step,
                            extra={"xconfig": "x", "step": step}
                            if step != 3 else None)
    assert tck.checkpoint_steps(d) == [0, 3, 12]
    state, extra, step = tck.restore_checkpoint(d)
    assert step == 12 and extra == {"xconfig": "x", "step": 12}
    _equal_trees(state, _tree(12))
    state, extra, step = tck.restore_checkpoint(d, step=3)
    assert step == 3 and extra is None
    _equal_trees(state, _tree(3))
    # torch tensors are written as arrays; no pickle in the archive
    t = {"params": {"w": torch.arange(4.0)}}
    tck.save_checkpoint(d, t, 20)
    with np.load(os.path.join(d, "step_20", "variables.npz"),
                 allow_pickle=False) as z:
        assert z.files == ["params/w"]
    state, _, _ = tck.restore_checkpoint(d, template=t)
    np.testing.assert_array_equal(state["params"]["w"], np.arange(4.0))
    with pytest.raises(KaldiTpuError, match="differ from the template"):
        tck.restore_checkpoint(d, template=_tree(0))
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "ckpt"), step=7)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tck.restore_checkpoint(str(tmp_path / "empty"))
    with pytest.raises(KaldiTpuError, match="'/'"):
        tck.flatten_tree({"a/b": np.zeros(1)})


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """An xconfig checkpoint directory as the JAX package writes it:
    orbax steps 0 and 2, step_0.meta.json with the xconfig text."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    model = jax_build(XCONFIG, train=False)
    v0 = model.init(jax.random.PRNGKey(0), {"input": jnp.zeros((1, 21, 13))})
    v2 = model.init(jax.random.PRNGKey(2), {"input": jnp.zeros((1, 21, 13))})
    rng = np.random.default_rng(5)
    v2 = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, v2)
    jck.save_checkpoint(d, v0, 0, extra={"xconfig": XCONFIG})
    jck.save_checkpoint(d, v2, 2, extra={"egs_position": 17})
    return d, model, v0, v2


def test_jax_directory_names_the_converter(jax_dir):
    d = jax_dir[0]
    with pytest.raises(KaldiTpuError, match="jax_checkpoint_to_torch.py"):
        tck.restore_checkpoint(d)
    with pytest.raises(KaldiTpuError, match="jax_checkpoint_to_torch.py"):
        tck.load_xconfig_checkpoint(d, device="cpu")


@pytest.mark.parametrize("step", [None, 0])
def test_converter_gives_the_same_model(jax_dir, tmp_path, step):
    d, model, v0, v2 = jax_dir
    out = str(tmp_path / "port")
    rc = _converter().main([d, out] + ([] if step is None
                                          else [f"--step={step}"]))
    assert rc == 0
    want_step, want_v = (2, v2) if step is None else (0, v0)
    state, extra, got_step = tck.restore_checkpoint(out)
    assert got_step == want_step
    _equal_trees(state, jax.tree.map(np.asarray, dict(want_v)))
    with open(os.path.join(out, "step_0.meta.json")) as f:
        assert json.load(f)["xconfig"] == XCONFIG
    net, text, got_step = tck.load_xconfig_checkpoint(out, device="cpu")
    assert text == XCONFIG and got_step == want_step
    x = np.random.default_rng(9).normal(size=(2, 29, 13)).astype(np.float32)
    want = model.apply(want_v, {"input": jnp.asarray(x)})
    got = net({"input": torch.from_numpy(x)})
    for head in ("output", "output-xent"):
        w = np.asarray(want[head])
        err = float(np.abs(got[head].numpy() - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (head, err)


def test_objective_info_matches_jax():
    got, want = tck.ObjectiveInfo("output", 3), jck.ObjectiveInfo("output", 3)
    rng = np.random.default_rng(1)
    for _ in range(7):
        objf, frames = float(rng.normal()), float(rng.integers(10, 90))
        got.update(objf, frames)
        want.update(objf, frames)
        assert (got.phase_objf, got.phase_frames, got.minibatches) == \
            (want.phase_objf, want.phase_frames, want.minibatches)
    assert got.print_total() == want.print_total()
