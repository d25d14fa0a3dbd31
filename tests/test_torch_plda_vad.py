"""Port parity: VAD (`ivector/vad.py`), PLDA (`ivector/plda.py`) and the
speaker back end's tools (VAD, LDA, PLDA, scoring, EER, sliding CMN)
against the JAX package's, on the CPU, over seeded i-vectors and
features.  The host numpy of the reference is copied, so decisions,
files and scores are equal; the LDA statistics accumulate on the device
path and the LDA matrix is within 1e-9 of its largest element."""

import contextlib
import io

import numpy as np
import pytest

from ivector_fixtures import rel_err, speaker_of, synth_feats, write_set
from kaldi_tpu.cli import get_tool as jtool
from kaldi_tpu.ivector.plda import train_plda as jtrain
from kaldi_tpu.ivector.vad import VadEnergyOptions as JVadOpts
from kaldi_tpu.ivector.vad import compute_vad_energy as jvad
from kaldi_tpu.util.table import TableWriter
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.ivector.plda import Plda, train_plda
from kaldi_tpu_torch.ivector.vad import VadEnergyOptions, compute_vad_energy


def run(side, tool, *args) -> str:
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and \
        tool == "ivector-compute-lda" else []
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    out.flush()
    assert rc == 0, f"{side} {tool} exited {rc}"
    return buf.getvalue().decode()


def _classes(seed=0, n_spk=6, per=5, dim=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(n_spk, dim))
    return {f"s{i}": [centers[i] + rng.normal(scale=0.7, size=dim)
                      for _ in range(per)] for i in range(n_spk)}


def _bytes(obj) -> bytes:
    buf = io.BytesIO()
    obj.write(buf, True)
    return buf.getvalue()


@pytest.mark.parametrize("ctx,scale", [(0, 0.5), (3, 0.5), (2, 0.0)])
def test_vad_exact(ctx, scale):
    f = synth_feats(3, 6, seed=7)
    for x in f.values():
        kw = dict(vad_frames_context=ctx, vad_energy_mean_scale=scale)
        np.testing.assert_array_equal(
            compute_vad_energy(VadEnergyOptions(**kw), x),
            jvad(JVadOpts(**kw), x))


def test_plda_train_score_adapt_io():
    cls = _classes()
    jp, tp = jtrain(cls), train_plda(cls)
    assert _bytes(tp) == _bytes(jp)
    assert _bytes(Plda.read(io.BytesIO(_bytes(jp)), True)) == _bytes(jp)
    v = _classes(1)["s0"]
    for n in (1, 3):
        for simple in (False, True):
            a = tp.transform_ivector(v[0], n, simple)
            np.testing.assert_array_equal(
                a, jp.transform_ivector(v[0], n, simple))
    ta, tb = tp.transform_ivector(v[0], 3), tp.transform_ivector(v[1])
    assert tp.log_likelihood_ratio(ta, 3, tb) == \
        jp.log_likelihood_ratio(ta, 3, tb)
    adapt = np.stack(sum(_classes(2, dim=8).values(), []))
    assert _bytes(tp.adapt(adapt, 0.6, 0.3)) == _bytes(jp.adapt(adapt, 0.6,
                                                                0.3))


@pytest.fixture(scope="module")
def sid(tmp_path_factory):
    """Feature and i-vector archives of 4 speakers, their spk2utt,
    utt2spk and trials files."""
    root = tmp_path_factory.mktemp("sid")
    feats = synth_feats(16, 6, seed=8)
    write_set(root / "d", feats)
    rng = np.random.default_rng(9)
    centers = rng.normal(scale=2.0, size=(4, 8))
    ivs = {u: centers[int(u[1:]) % 4] + rng.normal(scale=0.8, size=8)
           for u in sorted(feats)}
    with TableWriter("vector", f"ark:{root}/ivec.ark") as w:
        for u in sorted(ivs):
            w.write(u, ivs[u])
    with TableWriter("vector", f"ark:{root}/likes0.ark") as w0, \
            TableWriter("vector", f"ark:{root}/likes1.ark") as w1:
        for u in sorted(feats):
            w0.write(u, rng.normal(size=feats[u].shape[0]))
            w1.write(u, rng.normal(size=feats[u].shape[0]))
    (root / "trials").write_text("".join(
        f"spk{s} {u}\n" for s in range(4) for u in sorted(ivs)))
    (root / "labels").write_text("".join(
        f"{s} {'target' if s == speaker_of(u) else 'nontarget'}\n"
        for s in [f"spk{i}" for i in range(4)] for u in sorted(ivs)))
    # the JAX back end's files the later steps read
    j = root / "jax"
    j.mkdir()
    run("jax", "compute-vad", "--vad-energy-mean-scale=0.4",
        f"ark:{root}/d/feats.ark", f"ark:{j}/vad.ark")
    run("jax", "ivector-mean", f"ark:{root}/d/spk2utt", f"ark:{root}/ivec.ark",
        f"ark:{j}/spk.ark", f"ark:{j}/num_utts.ark")
    run("jax", "ivector-normalize-length", f"ark:{root}/ivec.ark",
        f"ark:{j}/norm.ark")
    run("jax", "ivector-normalize-length", f"ark:{j}/spk.ark",
        f"ark:{j}/spk_norm.ark")
    run("jax", "ivector-compute-plda", f"ark:{root}/d/spk2utt",
        f"ark:{j}/norm.ark", j / "plda")
    (root / "mean.vec").write_text(" [ 0.5 -1 0 0 2 0 0 1 ]\n")
    (root / "lda.mat").write_text(
        " [\n" + "\n".join(" ".join(str(v) for v in row) for row in
                           rng.normal(size=(3, 9))) + " ]\n")
    return {"root": root, "j": j}


CASES = {
    "compute-vad": ["--vad-energy-threshold=4", "--vad-frames-context=2",
                    "ark:{root}/d/feats.ark", "ark:{out}"],
    "select-voiced-frames": ["ark:{root}/d/feats.ark", "ark:{j}/vad.ark",
                             "ark:{out}"],
    "merge-vads": ["--map=or", "ark:{j}/vad.ark", "ark:{j}/vad.ark",
                   "ark:{out}"],
    "compute-vad-from-frame-likes": ["--priors=0.3,0.7",
                                     "ark:{root}/likes0.ark",
                                     "ark:{root}/likes1.ark", "ark:{out}"],
    "apply-cmvn-sliding": ["--cmn-window=40", "--min-window=10",
                           "ark:{root}/d/feats.ark", "ark:{out}"],
    "apply-cmvn-sliding-center": ["--cmn-window=30", "--center=true",
                                  "--normalize-variance=true",
                                  "ark:{root}/d/feats.ark", "ark:{out}"],
    "ivector-mean": ["ark:{root}/d/spk2utt", "ark:{root}/ivec.ark",
                     "ark:{out}", "ark:{out}.n"],
    "ivector-transform": ["{root}/lda.mat", "ark:{root}/ivec.ark",
                          "ark:{out}"],
    "transform-vec": ["{root}/lda.mat", "ark:{root}/ivec.ark", "ark:{out}"],
    "ivector-subtract-global-mean": ["ark:{root}/ivec.ark", "ark:{out}"],
    "ivector-subtract-global-mean-file": ["{root}/mean.vec",
                                          "ark:{root}/ivec.ark", "ark:{out}"],
    "ivector-normalize-length": ["--scaleup=false", "ark:{root}/ivec.ark",
                                 "ark:{out}"],
    "ivector-compute-plda": ["ark:{root}/d/spk2utt", "ark:{j}/norm.ark",
                             "{out}"],
    "ivector-plda-scoring": ["--num-utts=ark:{j}/num_utts.ark", "{j}/plda",
                             "ark:{j}/spk_norm.ark", "ark:{j}/norm.ark",
                             "{root}/trials", "{out}"],
    "ivector-plda-scoring-dense": ["{j}/plda", "ark:{root}/d/spk2utt",
                                   "ark:{j}/norm.ark", "ark:{out}"],
    "ivector-adapt-plda": ["--within-covar-scale=0.5", "{j}/plda",
                           "ark:{root}/ivec.ark", "{out}"],
    "ivector-copy-plda": ["--smoothing=0.1", "{j}/plda", "{out}"],
    "ivector-compute-dot-products": ["{root}/trials", "ark:{j}/spk.ark",
                                     "ark:{root}/ivec.ark", "{out}"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_backend_tools_equal(sid, tmp_path, name):
    tool = name.replace("-file", "").replace("-center", "")
    outs = []
    for side in ("jax", "torch"):
        out = tmp_path / side
        run(side, tool, *[str(a).format(root=sid["root"], j=sid["j"],
                                        out=out) for a in CASES[name]])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_ivector_compute_lda(sid, tmp_path):
    mats = []
    for side in ("jax", "torch"):
        out = tmp_path / side
        run(side, "ivector-compute-lda", "--dim=3",
            f"ark:{sid['root']}/ivec.ark", f"ark:{sid['root']}/d/utt2spk",
            out)
        mats.append(_matrix(out))
    assert mats[0].shape == mats[1].shape == (3, 9)
    assert rel_err(mats[1], mats[0]) < 1e-9


def _matrix(path):
    from kaldi_tpu_torch.base import io_funcs as iof
    from kaldi_tpu_torch.util import kaldi_io
    return kaldi_io.read_kaldi_object(iof.read_matrix, str(path))


@pytest.mark.parametrize("labels", ["labels", "reversed"])
def test_compute_eer_exact(sid, tmp_path, labels):
    """compute-eer over the dot-product scores of the trials: the same
    line on both sides."""
    scores = tmp_path / "scores"
    run("torch", "ivector-compute-dot-products", sid["root"] / "trials",
        f"ark:{sid['j']}/spk.ark", f"ark:{sid['root']}/ivec.ark", scores)
    lab = (sid["root"] / "labels").read_text().splitlines()
    sc = [line.split()[2] for line in scores.read_text().splitlines()]
    if labels == "reversed":
        sc = [str(-float(s)) for s in sc]
    f = tmp_path / "eer_in"
    f.write_text("".join(f"{s} {lb.split()[1]}\n" for s, lb in zip(sc, lab)))
    assert run("torch", "compute-eer", f) == run("jax", "compute-eer", f)
