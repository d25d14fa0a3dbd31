"""Port parity: extended Baum-Welch (`gmm/ebw.py`), lattice MMI training
(`recipes/mmi.py`), the tools of steps/train_mmi.sh (gmm-rescore-lattice,
lattice-boost-ali, lattice-to-post, gmm-acc-stats2, gmm-ismooth-stats,
gmm-est-gaussians-ebw, gmm-est-weights-ebw), the decoders of
log-likelihood matrices (latgen-faster-mapped, decode-faster-mapped)
and the two VTLN tools that need an acoustic model
(gmm-acc-stats-twofeats, gmm-est-lvtln-trans) against the JAX package's,
on the CPU, over the JAX package's monophone system on the synthetic
YES/NO corpus (tests/test_mono_e2e.py, 10 training utterances).

The EBW updates are the reference's host float64 code (within 1e-12);
each tool's archive is compared byte for byte from the same input file,
the float64 statistics within 1e-9 of their largest element where the
posteriors are the same numbers.  Where the tools compute float32 GMM
log-likelihoods themselves, the tolerance follows from their rounding
(TERM_RTOL below).  The MMI loop's objectives are held within 2e-3 of
JAX's; its boosting is Kaldi's (phone
errors lowered in cost), so the JAX loop runs with its boost replaced by
the same, and the reference's own, opposite boost is shown separately."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kaldi_tpu.cli import get_tool as jtool  # noqa: E402
from kaldi_tpu.gmm import ebw as jebw  # noqa: E402
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JGmm  # noqa: E402
from kaldi_tpu.gmm.mle import AccumDiagGmm as JAcc  # noqa: E402
from kaldi_tpu_torch.cli import get_tool as ttool  # noqa: E402
from kaldi_tpu_torch.cli.vtln_tools import DEVICE_TOOLS  # noqa: E402
from kaldi_tpu_torch.gmm import ebw as tebw  # noqa: E402
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm  # noqa: E402
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm, AccumDiagGmm  # noqa: E402
from kaldi_tpu_torch.util import kaldi_io  # noqa: E402
from kaldi_tpu_torch.util.table import (SequentialTableReader,  # noqa: E402
                                        TableWriter)

GPU_TOOLS = DEVICE_TOOLS + ("gmm-rescore-lattice",)
# A frame's float32 GMM log-likelihood sums terms of up to ~5e4 on this
# corpus (raw MFCC, c0 near 90, inverse variances up to ~80) that cancel
# to ~-30: float32 products in another order (torch's against XLA's, or
# numpy's one frame against numpy's batch) round apart by several ulps
# of those terms.  A log-likelihood is held within 1e-5 of the largest
# sum of its terms' magnitudes.
TERM_RTOL = 1e-5


def run(side, tool, *args):
    fn = (jtool if side == "jax" else ttool)(tool)
    extra = ["--use-gpu=no"] if side == "torch" and tool in GPU_TOOLS \
        else []
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = fn([tool, *extra, *[str(a) for a in args]])
    assert rc == 0, f"{side} {tool} exited {rc}"


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def same_bytes(d, name):
    return (d / f"torch.{name}").read_bytes() == (d / f"jax.{name}").read_bytes()


# -- EBW units (tests/test_ebw_mmi.py's cases, both packages) -------------


def _gmm_pair(w, mu, var):
    pair = []
    for cls in (JGmm, DiagGmm):
        g = cls(len(w), len(mu[0]))
        g.set_from_means_and_vars(np.asarray(w, np.float64),
                                  np.asarray(mu, np.float64),
                                  np.asarray(var, np.float64))
        pair.append(g)
    return pair


def _acc_pair(data, post):
    out = []
    for cls in (JAcc, AccumDiagGmm):
        acc = cls(post.shape[1], data.shape[1])
        acc.accumulate(data, post)
        out.append(acc)
    return out


@pytest.mark.parametrize("case", ["toward_num", "adversarial_den"])
def test_ebw_gaussian_update_matches_jax(case):
    rng = np.random.default_rng(0 if case == "toward_num" else 1)
    jg, tg = _gmm_pair([0.4, 0.6], [[0.0, 0.0], [1.0, -1.0]],
                       [[1.0, 1.0], [0.5, 2.0]])
    if case == "toward_num":
        num = _acc_pair(rng.normal(1.0, size=(200, 2)), rng.random((200, 2)))
        den = _acc_pair(rng.normal(-1.0, size=(100, 2)), rng.random((100, 2)))
        opts = (jebw.EbwOptions(), tebw.EbwOptions())
    else:
        num = _acc_pair(rng.normal(scale=0.1, size=(50, 2)),
                        np.ones((50, 2)))
        den = _acc_pair(rng.normal(scale=3.0, size=(50, 2)),
                        np.ones((50, 2)))
        opts = (jebw.EbwOptions(E=0.5), tebw.EbwOptions(E=0.5))
    want = jebw.update_ebw_diag_gmm(num[0], den[0], jg, opts[0])
    got = tebw.update_ebw_diag_gmm(num[1], den[1], tg, opts[1])
    assert np.allclose(got, want, rtol=1e-12, atol=0)
    assert rel(tg.get_means(), jg.get_means()) < 1e-12
    assert rel(tg.get_vars(), jg.get_vars()) < 1e-12
    assert np.all(tg.get_vars() > 0)


@pytest.mark.parametrize("iters", [1, 3])
def test_ebw_weight_update_matches_jax(iters):
    jg, tg = _gmm_pair([0.5, 0.3, 0.2], [[-1.0], [1.0], [2.0]],
                       [[1.0], [1.0], [1.0]])
    accs = []
    for cls in (JAcc, AccumDiagGmm):
        num, den = cls(3, 1), cls(3, 1)
        num.occupancy = np.array([80.0, 20.0, 5.0])
        den.occupancy = np.array([30.0, 30.0, 2.0])
        accs.append((num, den))
    want = jebw.update_ebw_weights_diag_gmm(*accs[0], jg, iters)
    got = tebw.update_ebw_weights_diag_gmm(*accs[1], tg, iters)
    assert got == pytest.approx(want, rel=1e-12)
    assert np.allclose(tg.weights, jg.weights, rtol=1e-12, atol=0)
    assert tg.weights.sum() == pytest.approx(1.0)


def test_ismooth_matches_jax():
    pair = []
    for cls in (JAcc, AccumDiagGmm):
        src, dst = cls(2, 2), cls(2, 2)
        src.occupancy = np.array([10.0, 0.0])
        src.mean_accs = np.array([[20.0, 30.0], [1.0, 1.0]])
        src.var_accs = np.array([[50.0, 100.0], [1.0, 1.0]])
        dst.occupancy = np.array([1.0, 2.0])
        (jebw if cls is JAcc else tebw).ismooth_stats_diag_gmm(src, 5.0, dst)
        pair.append(dst)
    for name in ("occupancy", "mean_accs", "var_accs"):
        assert np.array_equal(getattr(pair[1], name), getattr(pair[0], name))
    assert pair[1].mean_accs[0, 0] == pytest.approx(10.0)


# -- the monophone system and its files ------------------------------------


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """JAX's monophone system (train_mono as tests/test_ebw_mmi.py trains
    it) and its files: final.mdl, HCLG.fst (unigram G), feats.ark,
    ali.ark (its Viterbi alignments), post.ark (their posteriors),
    den.lat (JAX's gmm-latgen-faster lattices of the train set)."""
    from test_mono_e2e import FS, make_corpus, unigram_g

    from kaldi_tpu.cli.gmm_tools import write_am_gmm
    from kaldi_tpu.decoder.graph import Lang, TrainingGraphCompiler
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.fstext.openfst_io import write_fst
    from kaldi_tpu.recipes.mono import (TrainMonoOptions, _align_all,
                                        make_hclg, train_mono)
    from kaldi_tpu.util import kaldi_io as jio
    d = tmp_path_factory.mktemp("mmi")
    train_txt, train_wav, _, _ = make_corpus(num_train=10, num_test=3)
    comp = OfflineFeature(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=FS, dither=0.0)))
    tf = dict(zip(train_wav, comp.compute_batch(list(train_wav.values()))))
    lang = Lang({"YES": [["Y"]], "NO": [["N"]]}, sil_phone="SIL",
                sil_prob=0.5)
    lang.make_topology()
    sys_ = train_mono(lang, tf, train_txt,
                      TrainMonoOptions(num_iters=6, totgauss=30,
                                       realign_iters=(1, 2, 3, 4, 5)))
    write_am_gmm(str(d / "final.mdl"), sys_.tm, sys_.am)
    jio.write_kaldi_object(sys_.tree.write, str(d / "tree"))
    with open(d / "HCLG.fst", "wb") as f:
        write_fst(f, make_hclg(sys_, unigram_g(lang)))
    compiler = TrainingGraphCompiler(sys_.tm, sys_.tree, sys_.lang)
    graphs = {u: compiler.compile(train_txt[u]) for u in tf}
    ali = _align_all(sys_, graphs, tf, 10.0, 0.1, 1.0)
    assert len(ali) == 10
    with TableWriter("matrix", f"ark:{d}/feats.ark") as w, \
            TableWriter("matrix", f"ark:{d}/feats2.ark") as w2, \
            TableWriter("int-vector", f"ark:{d}/ali.ark") as wa:
        for u in sorted(tf):
            w.write(u, tf[u])
            w2.write(u, (0.5 * tf[u] + 1.0).astype(np.float32))
            wa.write(u, ali[u])
    run("jax", "ali-to-post", f"ark:{d}/ali.ark", f"ark:{d}/post.ark")
    run("jax", "gmm-latgen-faster", "--acoustic-scale=0.1", "--beam=16",
        "--lattice-beam=10", d / "final.mdl", d / "HCLG.fst",
        f"ark:{d}/feats.ark", f"ark:{d}/den.lat")
    return dict(d=d, sys=sys_, lang=lang, feats=tf, texts=train_txt,
                g=unigram_g(lang))


def term_scale(am, x):
    """(T, num_pdfs): for each frame and pdf, the largest over the pdf's
    Gaussians of |gconst| + |x| . |mu/var| + 0.5 x^2 . 1/var."""
    x = np.asarray(x, np.float64)
    out = np.zeros((x.shape[0], am.num_pdfs))
    for p in range(am.num_pdfs):
        g = am.get_pdf(p)
        out[:, p] = (np.abs(g.gconsts)[None]
                     + np.abs(x) @ np.abs(g.means_invvars.T.astype(
                         np.float64))
                     + 0.5 * (x * x) @ g.inv_vars.T.astype(np.float64)
                     ).max(axis=1)
    return out


def test_rescore_boost_and_posteriors_match_jax(mono):
    d = mono["d"]
    for side in ("jax", "torch"):
        run(side, "gmm-rescore-lattice", d / "final.mdl", f"ark:{d}/den.lat",
            f"ark:{d}/feats.ark", f"ark:{d}/{side}.rescored")
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    got, want = (dict(SequentialTableReader(LatticeHolder(),
                                            f"ark:{d}/{s}.rescored"))
                 for s in ("torch", "jax"))
    assert list(got) == list(want) and len(got) == 10
    from kaldi_tpu.lat.functions import lattice_state_times
    tm = mono["sys"].tm
    for k in want:
        a, b = got[k], want[k]
        scale = term_scale(mono["sys"].am, mono["feats"][k])
        times = lattice_state_times(b)
        assert a.num_states == b.num_states
        for s in range(b.num_states):
            for x, y in zip(a.arcs[s], b.arcs[s]):
                assert (x.ilabel, x.olabel, x.nextstate) == \
                    (y.ilabel, y.olabel, y.nextstate)
                assert x.weight[0] == y.weight[0]
                bound = 0.0 if y.ilabel == 0 else TERM_RTOL * scale[
                    times[s], tm.transition_id_to_pdf(y.ilabel)]
                assert abs(x.weight[1] - y.weight[1]) <= bound
    # from one input archive the boost and the posteriors are the same
    for side in ("jax", "torch"):
        run(side, "lattice-boost-ali", "--b=0.1", d / "final.mdl",
            f"ark:{d}/jax.rescored", f"ark:{d}/ali.ark",
            f"ark:{d}/{side}.boosted")
        run(side, "lattice-to-post", "--acoustic-scale=0.1",
            f"ark:{d}/{side}.boosted", f"ark:{d}/{side}.post")
    assert same_bytes(d, "boosted") and same_bytes(d, "post")


@pytest.fixture(scope="module")
def mmi_stats(mono):
    """Signed posteriors (numerator +, denominator -) as train_mmi.sh's
    sum-post gives them, and both tools' gmm-acc-stats2 files."""
    d = mono["d"]
    run("jax", "lattice-to-post", "--acoustic-scale=0.1",
        f"ark:{d}/den.lat", f"ark:{d}/den.post")
    num = dict(SequentialTableReader("posterior", f"ark:{d}/post.ark"))
    den = dict(SequentialTableReader("posterior", f"ark:{d}/den.post"))
    with TableWriter("posterior", f"ark:{d}/signed.post") as w:
        for u in sorted(num):
            w.write(u, [list(n) + [(t, -p) for t, p in dn]
                        for n, dn in zip(num[u], den[u])])
    for side in ("jax", "torch"):
        run(side, "gmm-acc-stats2", d / "final.mdl", f"ark:{d}/feats.ark",
            f"ark:{d}/signed.post", d / f"{side}.num", d / f"{side}.den")
    return d


def _accs(path) -> AccumAmDiagGmm:
    return kaldi_io.read_kaldi_object(AccumAmDiagGmm.read, str(path))


@pytest.mark.parametrize("which", ["num", "den"])
def test_acc_stats2_matches_jax(mmi_stats, which):
    got, want = _accs(mmi_stats / f"torch.{which}"), \
        _accs(mmi_stats / f"jax.{which}")
    assert np.array_equal(got.transition_accs, want.transition_accs)
    for a, b in zip(got.accs, want.accs):
        for name in ("occupancy", "mean_accs", "var_accs"):
            assert rel(getattr(a, name), getattr(b, name)) < 1e-9
    assert sum(a.occupancy.sum() for a in got.accs) > 0


def test_ebw_tools_write_jax_bytes(mmi_stats):
    d = mmi_stats
    for side in ("jax", "torch"):
        run(side, "gmm-ismooth-stats", "--tau=100", d / "jax.num",
            d / "jax.num", d / f"{side}.snum")
        run(side, "gmm-est-gaussians-ebw", "--E=2", d / "final.mdl",
            d / "jax.snum", d / "jax.den", d / f"{side}.g.mdl")
        run(side, "gmm-est-weights-ebw", d / "jax.g.mdl", d / "jax.num",
            d / "jax.den", d / f"{side}.w.mdl")
    assert same_bytes(d, "snum")
    assert same_bytes(d, "g.mdl")
    assert same_bytes(d, "w.mdl")
    assert d.joinpath("jax.g.mdl").read_bytes() != \
        d.joinpath("final.mdl").read_bytes()


@pytest.fixture(scope="module")
def loglikes(mono):
    d = mono["d"]
    with TableWriter("matrix", f"ark:{d}/loglikes.ark") as w:
        for u in sorted(mono["feats"]):
            w.write(u, np.asarray(mono["sys"].am.log_likes_batch(
                mono["feats"][u]), np.float32))
    return d


def test_latgen_faster_mapped_matches_jax(loglikes, capsys):
    d = loglikes
    for side in ("jax", "torch"):
        run(side, "latgen-faster-mapped", "--acoustic-scale=0.1",
            "--beam=16", "--lattice-beam=6", d / "final.mdl", d / "HCLG.fst",
            f"ark:{d}/loglikes.ark", f"ark:{d}/{side}.mlat",
            f"ark,t:{d}/{side}.mwords", f"ark,t:{d}/{side}.mali")
    assert same_bytes(d, "mlat") and same_bytes(d, "mwords") and \
        same_bytes(d, "mali")
    assert "latgen-faster-mapped stats" in capsys.readouterr().err


def test_decode_faster_mapped_matches_jax(loglikes):
    d = loglikes
    for side in ("jax", "torch"):
        run(side, "decode-faster-mapped", "--acoustic-scale=0.1",
            d / "final.mdl", d / "HCLG.fst", f"ark:{d}/loglikes.ark",
            f"ark,t:{d}/{side}.dwords", f"ark:{d}/{side}.dali")
    assert same_bytes(d, "dwords") and same_bytes(d, "dali")
    assert (d / "torch.dwords").read_text().count("\n") == 10


def test_acc_stats_twofeats_matches_jax(mono):
    """The reference scores one frame at a time, the port a pdf's frames
    at once: numpy's float32 products round the log-likelihoods apart
    (TERM_RTOL; up to 4e-3 here), which moves a frame's Gaussian
    posteriors by up to 5e-3, so the float64 statistics agree within
    1e-2 of their largest element; the transition counts are equal."""
    d = mono["d"]
    for side in ("jax", "torch"):
        run(side, "gmm-acc-stats-twofeats", d / "final.mdl",
            f"ark:{d}/feats.ark", f"ark:{d}/feats2.ark",
            f"ark:{d}/post.ark", d / f"{side}.tf")
    got, want = _accs(d / "torch.tf"), _accs(d / "jax.tf")
    assert np.array_equal(got.transition_accs, want.transition_accs)
    for a, b in zip(got.accs, want.accs):
        for name in ("occupancy", "mean_accs", "var_accs"):
            assert rel(getattr(a, name), getattr(b, name)) < 1e-2


def test_est_lvtln_trans_matches_jax(mono, tmp_path):
    d = mono["d"]
    run("jax", "gmm-init-lvtln", "--dim=13", "--num-classes=5",
        "--default-class=2", tmp_path / "init")
    run("jax", "gmm-train-lvtln-special", 0, tmp_path / "init",
        tmp_path / "lv", f"ark:{d}/feats.ark", f"ark:{d}/feats2.ark")
    (tmp_path / "spk2utt").write_text(
        "a " + " ".join(sorted(mono["feats"])[:5]) + "\nb "
        + " ".join(sorted(mono["feats"])[5:]) + "\n")
    for side in ("jax", "torch"):
        run(side, "gmm-est-lvtln-trans", f"--spk2utt=ark:{tmp_path}/spk2utt",
            d / "final.mdl", tmp_path / "lv", f"ark:{d}/feats2.ark",
            f"ark:{d}/ali.ark", f"ark:{tmp_path}/{side}.trans",
            f"ark,t:{tmp_path}/{side}.warp")
    assert (tmp_path / "torch.warp").read_text() == \
        (tmp_path / "jax.warp").read_text()
    got, want = (dict(SequentialTableReader("matrix",
                                            f"ark:{tmp_path}/{s}.trans"))
                 for s in ("torch", "jax"))
    assert list(got) == ["a", "b"]
    for k in want:
        assert rel(got[k], want[k]) < 1e-9


# -- the MMI loop ------------------------------------------------------------


def _port_system(mono):
    """The JAX system's files read by the port, on the CPU."""
    from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm
    from kaldi_tpu_torch.decoder.graph import Lang
    from kaldi_tpu_torch.recipes.mono import MonoSystem
    from kaldi_tpu_torch.recipes.synthetic_run import unigram_g
    from kaldi_tpu_torch.tree.context_dep import ContextDependency
    d = mono["d"]
    tm, am = read_am_gmm(str(d / "final.mdl"), device="cpu")
    tree = kaldi_io.read_kaldi_object(ContextDependency.read, str(d / "tree"))
    lang = Lang({"YES": [["Y"]], "NO": [["N"]]}, sil_phone="SIL",
                sil_prob=0.5)
    lang.topo = tm.topo
    return MonoSystem(lang, tree, tm, am), unigram_g(lang)


def _jax_system(mono):
    from kaldi_tpu.cli.gmm_tools import read_am_gmm
    from kaldi_tpu.recipes.mono import MonoSystem
    tm, am = read_am_gmm(str(mono["d"] / "final.mdl"))
    return MonoSystem(mono["lang"], mono["sys"].tree, tm, am)


def _repaired_jax_boost(lat, alignment, tm, boost):
    """Kaldi's boost (lattice-boost-ali) on a JAX lattice, in place."""
    from kaldi_tpu.lat.functions import lattice_state_times
    times = lattice_state_times(lat)
    ref = [tm.transition_id_to_phone(t) for t in alignment]
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            if a.ilabel != 0 and times[s] < len(ref):
                err = float(tm.transition_id_to_phone(a.ilabel) != ref[times[s]])
                a.weight = (a.weight[0] - boost * err, a.weight[1])


@pytest.mark.parametrize("boost", [0.0, 0.1])
def test_train_mmi_matches_jax(mono, monkeypatch, boost):
    """3 iterations of (b)MMI: each objective within 2e-3 of JAX's and
    not falling, the means within 1e-2 of their largest element of JAX's
    (the log-likelihoods round apart, TERM_RTOL, the lattice posteriors
    move, and each EBW update, num - den + D, amplifies it), and the
    training set still decoding at 0% WER (tests/test_ebw_mmi.py's
    bar)."""
    import kaldi_tpu.recipes.mmi as jmmi
    from kaldi_tpu_torch.recipes.mmi import TrainMmiOptions, train_mmi
    from kaldi_tpu_torch.recipes.mono import decode, make_hclg
    from kaldi_tpu_torch.util.edit_distance import WerStats
    monkeypatch.setattr(jmmi, "_boost_lattice", _repaired_jax_boost)
    jsys = _jax_system(mono)
    want = jmmi.train_mmi(jsys, mono["feats"], mono["texts"], mono["g"],
                          jmmi.TrainMmiOptions(num_iters=3, boost=boost))
    tsys, g = _port_system(mono)
    timing = {}
    got = train_mmi(tsys, mono["feats"], mono["texts"], g,
                    TrainMmiOptions(num_iters=3, boost=boost), timing=timing)
    assert np.allclose(got, want, atol=2e-3, rtol=0), (got, want)
    assert got[-1] >= got[0] - 1e-3
    assert set(timing) == {"align_s", "score_s", "lattice_s", "update_s"}
    assert rel(np.concatenate([tsys.am.get_pdf(p).get_means()
                               for p in range(tsys.am.num_pdfs)]),
               np.concatenate([jsys.am.get_pdf(p).get_means()
                               for p in range(jsys.am.num_pdfs)])) < 1e-2
    hyps = decode(tsys, make_hclg(tsys, g), mono["feats"])
    stats = WerStats()
    for utt, ref in mono["texts"].items():
        stats.add(ref, hyps[utt])
    assert stats.wer == 0.0, stats.report()


def test_reference_boost_has_the_opposite_sign(mono):
    """The reference fault kept out of the port (ROADMAP.md §3): the JAX
    package's `_boost_lattice` lowers the graph cost of the arcs whose
    pdf MATCHES the numerator alignment, where boosted MMI (Kaldi's
    lattice-boost-ali, Povey et al. 2008) lowers the cost of the arcs in
    error.  The port's `_boost_lattice` is lattice-boost-ali's."""
    from kaldi_tpu.lat.kaldi_lattice import LatticeHolder as JHolder
    from kaldi_tpu.recipes.mmi import _boost_lattice
    from kaldi_tpu.util.table import SequentialTableReader as JSR
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    from kaldi_tpu_torch.recipes.mmi import _boost_lattice as port_boost
    d = mono["d"]
    tm = mono["sys"].tm
    key, lat = next(iter(JSR(JHolder(), f"ark:{d}/den.lat")))
    # boost against another utterance's alignment, so that arcs are in
    # error (this system's lattices hold the reference's phones only)
    alis = dict(JSR("int-vector", f"ark:{d}/ali.ark"))
    other = next(k for k in sorted(alis) if k != key and
                 len(alis[k]) >= len(alis[key]))
    ali = list(alis[other])
    before = [[a.weight[0] for a in lat.arcs[s]]
              for s in range(lat.num_states)]
    _boost_lattice(lat, ali, tm, 0.1)
    tlat = dict(SequentialTableReader(LatticeHolder(),
                                      f"ark:{d}/den.lat"))[key]
    from kaldi_tpu_torch.cli.gmm_tools import _read_tm
    port = port_boost(tlat, ali, _read_tm(str(d / "final.mdl")), 0.1)
    from kaldi_tpu.lat.functions import lattice_state_times
    times = lattice_state_times(lat)
    ref = [tm.transition_id_to_phone(t) for t in ali]
    lowered_right = lowered_wrong = port_wrong = 0
    for s in range(lat.num_states):
        for i, a in enumerate(lat.arcs[s]):
            if a.ilabel == 0 or times[s] >= len(ref):
                continue
            right = tm.transition_id_to_phone(a.ilabel) == ref[times[s]]
            delta = before[s][i] - a.weight[0]
            port_delta = before[s][i] - port.arcs[s][i].weight[0]
            lowered_right += right and delta > 0
            lowered_wrong += (not right) and delta > 0
            port_wrong += (not right) and port_delta > 0
            assert port_delta == pytest.approx(0.0 if right else 0.1)
    assert lowered_right > 0 and lowered_wrong == 0 and port_wrong > 0


@pytest.mark.parametrize("max_silence", [None, 1.0])
def test_reference_boost_ali_counts_matching_silence_as_error(
        mono, max_silence):
    """The reference fault repaired in the port (ROADMAP.md §3): the JAX
    package's lattice-boost-ali gives every arc on a --silence-phones
    phone an error of 1, also where it matches the alignment.  Kaldi's
    LatticeBoost gives an arc 0 where its phone is the alignment's, else
    --max-silence (0 by default) on a silence phone and 1 on any other;
    the port does that.  Without --silence-phones the two tools write the
    same bytes (test_rescore_boost_and_posteriors_match_jax)."""
    from kaldi_tpu.lat.functions import lattice_state_times
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    d = mono["d"]
    tm = mono["sys"].tm
    sil = mono["lang"].phones["SIL"]
    # each alignment shifted by 7 frames, so that arcs of both kinds are
    # in error (this system's lattices hold the reference's phones only)
    alis = {k: np.roll(np.asarray(v), 7) for k, v in
            SequentialTableReader("int-vector", f"ark:{d}/ali.ark")}
    with TableWriter("int-vector", f"ark:{d}/shifted.ali") as w:
        for k in sorted(alis):
            w.write(k, alis[k])
    opts = ["--b=0.1", f"--silence-phones={sil}"]
    port_opts = opts + ([] if max_silence is None
                        else [f"--max-silence={max_silence}"])
    run("jax", "lattice-boost-ali", *opts, d / "final.mdl",
        f"ark:{d}/den.lat", f"ark:{d}/shifted.ali", f"ark:{d}/jax.silboost")
    run("torch", "lattice-boost-ali", *port_opts, d / "final.mdl",
        f"ark:{d}/den.lat", f"ark:{d}/shifted.ali",
        f"ark:{d}/torch.silboost")
    lats, jax, port = (dict(SequentialTableReader(LatticeHolder(),
                                                  f"ark:{d}/{name}"))
                       for name in ("den.lat", "jax.silboost",
                                    "torch.silboost"))
    sil_error = max_silence or 0.0
    count = dict(sil_right=0, sil_wrong=0, wrong=0, jax_sil_right=0)
    for key, lat in lats.items():
        ref = [tm.transition_id_to_phone(t) for t in alis[key]]
        times = lattice_state_times(lat)
        for s in range(lat.num_states):
            for i, a in enumerate(lat.arcs[s]):
                if a.ilabel == 0:
                    continue
                phone = tm.transition_id_to_phone(a.ilabel)
                right = phone == ref[times[s]]
                kind = ("sil_" if phone == sil else "") + \
                    ("right" if right else "wrong")
                err = 0.0 if right else (sil_error if phone == sil else 1.0)
                port_delta = a.weight[0] - port[key].arcs[s][i].weight[0]
                jax_delta = a.weight[0] - jax[key].arcs[s][i].weight[0]
                assert port_delta == pytest.approx(0.1 * err, abs=1e-6)
                count[kind] = count.get(kind, 0) + 1
                count["jax_sil_right"] += kind == "sil_right" and \
                    jax_delta == pytest.approx(0.1, abs=1e-6)
    # matching silence arcs: the reference boosts every one of them
    assert min(count["sil_right"], count["sil_wrong"], count["wrong"]) > 0
    assert count["jax_sil_right"] == count["sil_right"]
