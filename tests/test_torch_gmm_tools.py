"""Port parity: the GMM tools (`cli/gmm_tools.py`), the alignment tools
added with them (`cli/ali_tools.py`) and the GMM I/O, merging and
posterior accumulation (`gmm/`), against the JAX package's, on the CPU.
Each port tool reads the files the JAX tools wrote at the same step of
the generic recipe's stage 2 (8 training utterances of its fabricated
corpus): models, trees, graphs, alignments and statistics come out byte
for byte where the reference's writer is deterministic; one gmm-est
within 1e-4 relative; gmm-align-compiled's alignments equal, or, where a
Viterbi tie flips, of the same cost within 1e-4 relative."""

import numpy as np
import pytest

from kaldi_tpu.cli.gmm_tools import read_am_gmm as jread
from kaldi_tpu.gmm import AccumAmDiagGmm as JAcc
from kaldi_tpu.gmm import DiagGmm as JGmm
from kaldi_tpu.util import kaldi_io as jio
from kaldi_tpu_torch.cli import get_tool as ttool
from kaldi_tpu_torch.cli.gmm_tools import read_am_gmm as tread
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm as TGmm
from kaldi_tpu_torch.gmm.mle import AccumAmDiagGmm as TAcc
from kaldi_tpu_torch.util import kaldi_io as tio
from kaldi_tpu_torch.util.table import SequentialTableReader
from template_stages import jax_stage2, run

@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    return jax_stage2(tmp_path_factory.mktemp("gmm"))


def _both(stage2, tmp_path, tool, args, out_name):
    """Run `tool` on both sides with `{out}` in args -> (jax, torch)
    output bytes."""
    outs = []
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}_{out_name}"
        a = [str(x).format(root=stage2, out=out) for x in args]
        assert run(side, tool, *a) == 0
        outs.append(out.read_bytes())
    return outs


STEPS = {
    "gmm-init-mono": (["--train-feats=ark:{root}/train/feats.ark",
                       "{root}/lang/topo", 13, "{out}", "{out}.tree"],
                      "0.mdl"),
    "gmm-init-mono-perturb": (["--train-feats=ark:{root}/train/feats.ark",
                               "--perturb-factor=0.1", "{root}/lang/topo",
                               13, "{out}", "{out}.tree"], "0p.mdl"),
    "compile-train-graphs": (["--self-loop-scale=0.1", "{root}/tree",
                              "{root}/0.mdl", "{root}/lang/L_disambig.fst",
                              "ark:{root}/text.int", "ark:{out}"],
                             "graphs.ark"),
    "align-equal-compiled": (["ark:{root}/graphs.ark",
                              "ark:{root}/train/feats.ark", "ark:{out}"],
                             "ali0.ark"),
    "gmm-acc-stats-ali": (["{root}/1.mdl", "ark:{root}/train/feats.ark",
                           "ark:{root}/ali1.ark", "{out}"], "1.acc"),
    "gmm-sum-accs": (["{out}", "{root}/1.acc", "{root}/1.acc"], "sum.acc"),
    "ali-to-phones": (["{root}/1.mdl", "ark:{root}/ali1.ark", "ark,t:{out}"],
                      "phones.txt"),
    "ali-to-phones-lengths": (["--write-lengths=true", "{root}/1.mdl",
                               "ark:{root}/ali1.ark", "ark,t:{out}"],
                              "lengths.txt"),
    "ali-to-phones-per-frame": (["--per-frame=true", "{root}/1.mdl",
                                 "ark:{root}/ali1.ark", "ark:{out}"],
                                "frames.ark"),
    "copy-int-vector": (["ark:{root}/ali1.ark", "ark,t:{out}"], "ali.txt"),
}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_tool_output_bytes(stage2, tmp_path, step):
    args, name = STEPS[step]
    tool = step.split("-perturb")[0].split("-lengths")[0].split(
        "-per-frame")[0]
    j, t = _both(stage2, tmp_path, tool, args, name)
    assert t == j and len(t) > 0
    if tool == "gmm-init-mono":
        assert (tmp_path / f"torch_{name}.tree").read_bytes() == \
            (tmp_path / f"jax_{name}.tree").read_bytes()


@pytest.mark.parametrize("mix_up", [0, 20, 60])
def test_gmm_est_within_1e4(stage2, tmp_path, mix_up):
    for side in ("jax", "torch"):
        assert run(side, "gmm-est", "--min-gaussian-occupancy=3",
                   f"--mix-up={mix_up}", stage2 / "1.mdl", stage2 / "1.acc",
                   tmp_path / f"{side}.mdl") == 0
    jtm, jam = jread(str(tmp_path / "jax.mdl"))
    ttm, tam = tread(str(tmp_path / "torch.mdl"), device="cpu")
    assert tam.num_pdfs == jam.num_pdfs and tam.num_gauss() == jam.num_gauss()
    for g, h in zip(tam.densities, jam.densities):
        for name in ("weights", "means_invvars", "inv_vars", "gconsts"):
            a, b = getattr(g, name), getattr(h, name)
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(ttm.log_probs, jtm.log_probs, rtol=1e-4)


def test_gmm_est_update_flags(stage2, tmp_path):
    outs = []
    for side in ("jax", "torch"):
        assert run(side, "gmm-est", "--update-flags=mvw", stage2 / "1.mdl",
                   stage2 / "1.acc", tmp_path / f"{side}.mdl") == 0
        outs.append((tmp_path / f"{side}.mdl").read_bytes())
    assert outs[0] == outs[1]
    for bad in ("--power=0.5", "--update-flags=mv"):
        with pytest.raises(NotImplementedError):
            ttool("gmm-est")(["gmm-est", bad, str(stage2 / "1.mdl"),
                              str(stage2 / "1.acc"), str(tmp_path / "x")])


def _ali(path):
    return {k: list(v) for k, v in
            SequentialTableReader("int-vector", f"ark:{path}")}


@pytest.mark.parametrize("mdl", ["1.mdl", "2.mdl"])
def test_gmm_align_compiled_matches(stage2, tmp_path, mdl):
    for side in ("jax", "torch"):
        assert run(side, "gmm-align-compiled", "--beam=10",
                   "--acoustic-scale=0.1", stage2 / mdl,
                   f"ark:{stage2}/graphs.ark", f"ark:{stage2}/train/feats.ark",
                   f"ark:{tmp_path}/{side}.ark") == 0
    a, b = _ali(tmp_path / "torch.ark"), _ali(tmp_path / "jax.ark")
    assert sorted(a) == sorted(b) and len(a) == 8
    from kaldi_tpu.decoder import viterbi as jvit
    from kaldi_tpu.fstext.fst import VectorFst as JFst
    from kaldi_tpu.util.table import RandomAccessTableReader as JReader
    from kaldi_tpu_torch.decoder import viterbi as tvit
    from kaldi_tpu_torch.fstext.fst import VectorFst as TFst
    from kaldi_tpu_torch.util.table import RandomAccessTableReader
    ttm, tam = tread(str(stage2 / mdl), device="cpu")
    jtm, jam = jread(str(stage2 / mdl))
    tg = RandomAccessTableReader(TFst, f"ark:{stage2}/graphs.ark")
    jg = JReader(JFst, f"ark:{stage2}/graphs.ark")
    feats = dict(SequentialTableReader("matrix", f"ark:{stage2}/train/feats.ark"))
    for k in b:
        if a[k] == b[k]:
            continue
        # a flipped Viterbi tie: the port's best path under its loglikes
        # costs what the JAX package's costs under its own
        ct = tvit.FasterDecoder(tg[k], tvit.FasterDecoderOptions(
            beam=10.0)).decode(tam.log_likes_batch(feats[k]),
                               ttm.id2pdf_id, 0.1)[2]
        cj = jvit.FasterDecoder(jg[k], jvit.FasterDecoderOptions(
            beam=10.0)).decode(np.asarray(jam.log_likes_batch(feats[k])),
                               jtm.id2pdf_id, 0.1)[2]
        assert abs(ct - cj) <= 1e-4 * abs(cj), k


def test_gmm_info_prints_the_same(stage2, capsys):
    for side in ("jax", "torch"):
        assert run(side, "gmm-info", stage2 / "2.mdl") == 0
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and "number of gaussians" in out[-1]


def test_am_gmm_read_write_round_trip(stage2, tmp_path):
    from kaldi_tpu_torch.cli.gmm_tools import write_am_gmm
    tm, am = tread(str(stage2 / "2.mdl"), device="cpu")
    for binary in (True, False):
        p = tmp_path / f"m{int(binary)}.mdl"
        write_am_gmm(str(p), tm, am, binary=binary)
        tm2, am2 = tread(str(p), device="cpu")
        jtm2, jam2 = jread(str(p))
        assert am2.num_gauss() == am.num_gauss() == jam2.num_gauss()
        for g, h in zip(am2.densities, am.densities):
            np.testing.assert_allclose(g.means_invvars, h.means_invvars,
                                       rtol=1e-6)
    write_am_gmm(str(tmp_path / "again.mdl"), tm, am)
    assert (tmp_path / "again.mdl").read_bytes() == \
        (stage2 / "2.mdl").read_bytes()


def test_accs_read_write_and_add(stage2, tmp_path):
    ta = tio.read_kaldi_object(TAcc.read, str(stage2 / "1.acc"))
    ja = jio.read_kaldi_object(JAcc.read, str(stage2 / "1.acc"))
    ta.add(tio.read_kaldi_object(TAcc.read, str(stage2 / "1.acc")))
    ja.add(jio.read_kaldi_object(JAcc.read, str(stage2 / "1.acc")))
    for binary in (True, False):
        tio.write_kaldi_object(ta.write, str(tmp_path / "t.acc"), binary)
        jio.write_kaldi_object(ja.write, str(tmp_path / "j.acc"), binary)
        assert (tmp_path / "t.acc").read_bytes() == \
            (tmp_path / "j.acc").read_bytes()


@pytest.mark.parametrize("target", [1, 3, 6])
def test_diag_gmm_merge(target):
    rng = np.random.default_rng(target)
    M, D = 8, 4
    w = rng.uniform(0.2, 1.0, M)
    means, var = rng.normal(size=(M, D)), rng.uniform(0.5, 2.0, (M, D))
    t, j = TGmm(M, D), JGmm(M, D)
    for g in (t, j):
        g.set_from_means_and_vars(w / w.sum(), means, var)
        g.merge(target)
    assert t.num_gauss == j.num_gauss == target
    for name in ("weights", "means_invvars", "inv_vars", "gconsts"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_accumulate_posterior_and_for_pdf(stage2):
    ttm, tam = tread(str(stage2 / "2.mdl"), device="cpu")
    jtm, jam = jread(str(stage2 / "2.mdl"))
    feats = dict(SequentialTableReader("matrix", f"ark:{stage2}/train/feats.ark"))
    ali = _ali(stage2 / "ali1.ark")
    rng = np.random.default_rng(3)
    ta = TAcc(tam, num_transition_ids=ttm.num_transition_ids)
    ja = JAcc(jam, num_transition_ids=jtm.num_transition_ids)
    for k in sorted(feats)[:3]:
        n = ttm.num_transition_ids
        post = [[(int(t), 0.7), (int(rng.integers(1, n + 1)), 0.3)]
                for t in ali[k]]
        assert ta.accumulate_posterior(tam, ttm, feats[k], post) == \
            pytest.approx(ja.accumulate_posterior(jam, jtm, feats[k], post),
                          rel=1e-9)
        f = feats[k][5].astype(np.float64)
        assert ta.accumulate_for_pdf(tam, 2, f, 0.5) == \
            pytest.approx(ja.accumulate_for_pdf(jam, 2, f, 0.5), rel=1e-9)
    for a, b in zip(ta.accs, ja.accs):
        np.testing.assert_allclose(a.mean_accs, b.mean_accs, rtol=1e-9)
        np.testing.assert_allclose(a.occupancy, b.occupancy, rtol=1e-9)
    np.testing.assert_allclose(ta.transition_accs, ja.transition_accs)


def test_shared_phones_tree_matches(stage2, tmp_path):
    (tmp_path / "sets").write_text("1 2\n3 5\n4\n")
    outs = _both(stage2, tmp_path, "gmm-init-mono",
                 ["--shared-phones=" + str(tmp_path / "sets"),
                  "{root}/lang/topo", 13, "{out}", "{out}.tree"], "s.mdl")
    assert outs[0] == outs[1]
    assert (tmp_path / "torch_s.mdl.tree").read_bytes() == \
        (tmp_path / "jax_s.mdl.tree").read_bytes()


def test_align_options_not_carried_raise(stage2, tmp_path):
    for bad in ("--careful=true", "--transition-scale=2"):
        with pytest.raises(NotImplementedError):
            ttool("gmm-align-compiled")([
                "gmm-align-compiled", "--use-gpu=no", bad,
                str(stage2 / "1.mdl"), f"ark:{stage2}/graphs.ark",
                f"ark:{stage2}/train/feats.ark", f"ark:{tmp_path}/x.ark"])
