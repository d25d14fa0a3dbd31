"""Port parity: decoder/lattice_decoder.py (LatticeFasterDecoder),
fstext/ops.py invert, lat/functions.py determinize_lattice and
lat/kaldi_lattice.py (CompactLattice, the lattice text and
compactlattice44 archives) against the JAX package's, over the HCLG of a
small monophone system (the fixture of
tests/test_cli_nnet3_latgen_variants.py: it has epsilon arcs) and
continuous random loglikes (no exact ties).

The port's periodic link pruning is upstream's, not the reference's
(test_reference_pruning_fault), so its lattices are held to JAX's
decoder without that pruning.  Tolerances: the raw lattices equal, arc
for arc and weight for weight, state numbers included, where neither
prunes; else the arcs of the paths within the lattice beam equal up to a
relabeling; determinized lattices equal in structure with weights within
1e-4 relative, best paths and words equal, costs within 1e-4 relative;
archives byte for byte.
"""

import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from kaldi_tpu.decoder import lattice_decoder as JD
from kaldi_tpu.fstext import fst as JF
from kaldi_tpu.fstext import ops as JOPS
from kaldi_tpu.fstext import openfst_io as JIO
from kaldi_tpu.lat import functions as JLF
from kaldi_tpu.lat import kaldi_lattice as JKL
from kaldi_tpu.util import table as JT
from kaldi_tpu_torch.decoder import lattice_decoder as TD
from kaldi_tpu_torch.fstext import fst as TF
from kaldi_tpu_torch.fstext import ops as TOPS
from kaldi_tpu_torch.fstext import openfst_io as TIO
from kaldi_tpu_torch.lat import functions as TLF
from kaldi_tpu_torch.lat import kaldi_lattice as TKL
from kaldi_tpu_torch.util import table as TT

LATGEN_XCONFIG = """
input dim=13 name=input
relu-batchnorm-layer name=tdnn1 dim=32 input=Append(-2,-1,0,1,2)
relu-batchnorm-layer name=tdnn2 dim=32 input=Append(-1,0,1)
output-layer name=output include-log-softmax=true dim=$num_targets
"""


def build_mono_fixture(d: str) -> dict:
    """The JAX package's monophone system on its synthetic YES/NO corpus
    (tests/test_mono_e2e.py), as the nnet3-latgen tools read it:
    trans.mdl, HCLG.fst, feats.ark of the test utterances, a random
    xconfig model as a JAX checkpoint directory (nnet/) and converted to
    the port's (nnet_port/), and the test transcripts as text.ark."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    from test_mono_e2e import FS, make_corpus, unigram_g

    from kaldi_tpu.decoder.graph import Lang
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.nnet3.xconfig import build_xconfig_model
    from kaldi_tpu.parallel.checkpoint import save_checkpoint
    from kaldi_tpu.recipes.mono import (TrainMonoOptions, make_hclg,
                                        train_mono)
    from kaldi_tpu.util import kaldi_io
    train_txt, train_wav, test_txt, test_wav = make_corpus(num_train=8,
                                                           num_test=3)
    comp = OfflineFeature(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=FS, dither=0.0)))
    tf = dict(zip(train_wav, comp.compute_batch(list(train_wav.values()))))
    sf = dict(zip(test_wav, comp.compute_batch(list(test_wav.values()))))
    lang = Lang({"YES": [["Y"]], "NO": [["N"]]}, sil_phone="SIL",
                sil_prob=0.5)
    lang.make_topology()
    sys_ = train_mono(lang, tf, train_txt,
                      TrainMonoOptions(num_iters=4, totgauss=24,
                                       realign_iters=(1, 2, 3)))
    kaldi_io.write_kaldi_object(sys_.tm.write, f"{d}/trans.mdl")
    with open(f"{d}/HCLG.fst", "wb") as f:
        JIO.write_fst(f, make_hclg(sys_, unigram_g(lang)))
    with JT.TableWriter("matrix", f"ark:{d}/feats.ark") as w:
        for u in sorted(sf):
            w.write(u, sf[u])
    words = {v: k for k, v in lang.words.items()}
    with JT.TableWriter("token-vector", f"ark,t:{d}/text.ark") as w:
        for u in sorted(test_txt):
            w.write(u, list(test_txt[u]))
    with open(f"{d}/words.txt", "w") as f:
        f.writelines(f"{words[i]} {i}\n" for i in sorted(words))
    text = LATGEN_XCONFIG.replace("$num_targets", str(sys_.tm.num_pdfs))
    model = build_xconfig_model(text, train=False)
    variables = model.init(jax.random.PRNGKey(7),
                           {"input": jnp.zeros((1, 21, 13))})
    os.makedirs(f"{d}/nnet", exist_ok=True)
    save_checkpoint(f"{d}/nnet", variables, 0, extra={"xconfig": text})
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "jax_checkpoint_to_torch.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    conv.convert(f"{d}/nnet", f"{d}/nnet_port")
    return dict(d=d, tm=sys_.tm, num_pdfs=sys_.tm.num_pdfs,
                utts=sorted(sf), feats=sf, test_txt=test_txt, words=words)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    return build_mono_fixture(str(tmp_path_factory.mktemp("latgen")))


def canon(lat):
    return (lat.start,
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for arcs in lat.arcs], list(lat.finals))


def near(a, b, rel=1e-4):
    return abs(a - b) <= rel * max(1.0, abs(a), abs(b))


def assert_lattices_close(got, want, rel=1e-4):
    """Equal structure, weights within `rel` relative."""
    assert got.start == want.start and got.num_states == want.num_states
    for ga, wa in zip(got.arcs, want.arcs):
        assert [(a.ilabel, a.olabel, a.nextstate) for a in ga] == \
            [(a.ilabel, a.olabel, a.nextstate) for a in wa]
        for x, y in zip(ga, wa):
            assert near(x.weight[0], y.weight[0], rel) and \
                near(x.weight[1], y.weight[1], rel)
    for x, y in zip(got.finals, want.finals):
        assert (x == TF.LatticeWeight.zero) == (y == JF.LatticeWeight.zero)
        if x != TF.LatticeWeight.zero:
            assert near(x[0], y[0], rel) and near(x[1], y[1], rel)


def random_loglikes(seed, T, P):
    return (np.random.default_rng(seed).normal(size=(T, P)) * 2.0
            ).astype(np.float32)


OPTS = {"default": {},
        "narrow": dict(beam=8.0, lattice_beam=4.0),
        "max_active": dict(max_active=12, min_active=4),
        "prune_often": dict(prune_interval=4, lattice_beam=6.0),
        "no_prune": dict(prune_interval=0)}


def relabeled(lat):
    """The lattice with its states renumbered in a canonical order (from
    the start, breadth first, each state's arcs in (ilabel, olabel,
    weight) order): equal for two lattices that differ by a relabeling."""
    order, queue, out = {lat.start: 0}, [lat.start], []
    while queue:
        s = queue.pop(0)
        arcs = sorted(lat.arcs[s], key=lambda a: (a.ilabel, a.olabel,
                                                  a.weight))
        for a in arcs:
            if a.nextstate not in order:
                order[a.nextstate] = len(order)
                queue.append(a.nextstate)
        out.append([(a.ilabel, a.olabel, a.weight, order[a.nextstate])
                    for a in arcs])
    finals = {order[s]: w for s, w in enumerate(lat.finals)
              if s in order and w != TF.LatticeWeight.zero}
    return out, finals


@pytest.mark.parametrize("opts", sorted(OPTS))
@pytest.mark.parametrize("seed", range(3))
def test_raw_lattice_equals_jax(mono, opts, seed):
    """The port's raw lattice against JAX's decoder without its periodic
    link pruning (prune_interval=0, where the reference's pruning fault,
    test_reference_pruning_fault, cannot bite): the same lattice, state
    numbers included, when the port does not prune either; when it does,
    the same arcs on the paths within lattice_beam of the best (each
    lattice_prune'd), up to a relabeling.  The best path is the host
    FasterDecoder's at the same beams."""
    from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                                 FasterDecoderOptions)
    jf = JIO.read_fst_file(f"{mono['d']}/HCLG.fst")
    tf = TIO.read_fst_file(f"{mono['d']}/HCLG.fst")
    assert any(a.ilabel == 0 for arcs in tf.arcs for a in arcs)
    scale = 0.5 if seed == 2 else 1.0
    ll = random_loglikes(seed, 26 + 3 * seed, mono["num_pdfs"])
    tid2pdf = np.asarray(mono["tm"].id2pdf_id)
    kw = OPTS[opts]
    td = TD.LatticeFasterDecoder(tf, TD.LatticeFasterDecoderOptions(**kw))
    want = JD.LatticeFasterDecoder(jf, JD.LatticeFasterDecoderOptions(
        **dict(kw, prune_interval=0))).decode(ll, tid2pdf, scale)
    got = td.decode(ll, tid2pdf, scale)
    assert want is not None and got is not None
    if kw.get("prune_interval", 25) == 0:
        assert canon(got) == canon(want)
    else:
        assert td.stats["max_live_links"] > 0
    lb = td.opts.lattice_beam
    assert relabeled(TLF.lattice_prune(got, lb)) == \
        relabeled(JLF.lattice_prune(want, lb))
    fd = FasterDecoder(tf, FasterDecoderOptions(
        beam=td.opts.beam, max_active=td.opts.max_active)).decode(
            ll, tid2pdf, scale)
    ali, words, cost = TLF.lattice_best_path(got)
    assert (ali, words) == (fd[0], fd[1]) and near(cost, fd[2])
    # the determinized lattice, its best path and cost
    dw, dg = JLF.determinize_lattice(want), TLF.determinize_lattice(got)
    assert dg is not got
    for g, w in ((got, want), (dg, dw)):
        ali_g, words_g, cost_g = TLF.lattice_best_path(g)
        ali_w, words_w, cost_w = JLF.lattice_best_path(w)
        assert (ali_g, words_g) == (ali_w, words_w)
        assert near(cost_g, cost_w)
    if kw.get("prune_interval", 25) == 0:
        assert_lattices_close(dg, dw)


def _two_branches(mod):
    """Two words from the start, each a self-loop of its own transition
    id (1 -> pdf 0, 2 -> pdf 1), both final."""
    f = mod.VectorFst()
    f.add_states(3)
    f.start = 0
    for w in (1, 2):
        f.add_arc(0, mod.Arc(w, w, 0.0, w))
        f.add_arc(w, mod.Arc(w, 0, 0.0, w))
        f.finals[w] = 0.0
    return f


def test_reference_pruning_fault():
    """The reference's periodic pruning measures every link against the
    frontier's best token.  Word 2's branch trails by 12.5 at frame 25
    (inside the beam of 16, beyond the lattice beam of 10), so its links
    go; it wins from frame 30 on, and JAX's lattice then starts at frame
    25 with no word.  The port measures a link against its own frontier
    token: the whole 60 frames, word 2, the host FasterDecoder's path."""
    from kaldi_tpu_torch.decoder.viterbi import FasterDecoder
    ll = np.zeros((60, 2), np.float32)
    ll[:30, 1] = -0.5
    ll[30:, 0] = -1.0
    tid2pdf = np.array([0, 0, 1])
    jax_lat = JD.LatticeFasterDecoder(_two_branches(JF)).decode(ll, tid2pdf)
    ali, words, cost = JLF.lattice_best_path(jax_lat)
    assert (len(ali), words, cost) == (35, [], 2.5)
    no_prune = JD.LatticeFasterDecoder(_two_branches(JF),
                                       JD.LatticeFasterDecoderOptions(
                                           prune_interval=0))
    port = TD.LatticeFasterDecoder(_two_branches(TF)).decode(ll, tid2pdf)
    fd = FasterDecoder(_two_branches(TF)).decode(ll, tid2pdf)
    assert TLF.lattice_best_path(port) == (fd[0], [2], 15.0)
    assert len(fd[0]) == 60
    assert relabeled(TLF.lattice_prune(port, 10.0)) == relabeled(
        JLF.lattice_prune(no_prune.decode(ll, tid2pdf), 10.0))


def test_real_model_loglikes_equal_jax(mono):
    """The fixture's utterances through its model, at the tools' default
    beams: the arcs within the lattice beam of JAX's decoder without its
    periodic pruning, up to a relabeling, and the same best path."""
    import torch

    from kaldi_tpu_torch.parallel.checkpoint import load_xconfig_checkpoint
    net, _, _ = load_xconfig_checkpoint(f"{mono['d']}/nnet_port",
                                        device="cpu")
    jd = JD.LatticeFasterDecoder(JIO.read_fst_file(f"{mono['d']}/HCLG.fst"),
                                 JD.LatticeFasterDecoderOptions(
                                     prune_interval=0))
    td = TD.LatticeFasterDecoder(TIO.read_fst_file(f"{mono['d']}/HCLG.fst"))
    lb = td.opts.lattice_beam
    for u in mono["utts"]:
        with torch.no_grad():
            x = torch.from_numpy(mono["feats"][u][None].copy())
            ll = net({"input": x})["output"][0].numpy()
        want = jd.decode(ll, mono["tm"].id2pdf_id, 1.0)
        got = td.decode(ll, mono["tm"].id2pdf_id, 1.0)
        assert relabeled(TLF.lattice_prune(got, lb)) == \
            relabeled(JLF.lattice_prune(want, lb))
        assert TLF.lattice_best_path(got)[:2] == \
            JLF.lattice_best_path(want)[:2]


def test_no_tokens_and_no_final(mono):
    tf = TIO.read_fst_file(f"{mono['d']}/HCLG.fst")
    ll = np.full((5, mono["num_pdfs"]), -np.inf, np.float32)
    assert TD.LatticeFasterDecoder(tf).decode(ll, mono["tm"].id2pdf_id) \
        is None
    # a graph without finals: every last-frame token counts as final
    nf = TIO.read_fst_file(f"{mono['d']}/HCLG.fst")
    jf = JIO.read_fst_file(f"{mono['d']}/HCLG.fst")
    nf.finals = [TF.TropicalWeight.zero] * nf.num_states
    jf.finals = [JF.TropicalWeight.zero] * jf.num_states
    ll = random_loglikes(5, 9, mono["num_pdfs"])
    got = TD.LatticeFasterDecoder(nf).decode(ll, mono["tm"].id2pdf_id)
    want = JD.LatticeFasterDecoder(jf).decode(ll, mono["tm"].id2pdf_id)
    assert canon(got) == canon(want)


def _random_fst(mod, seed):
    rng = np.random.default_rng(seed)
    f = mod.VectorFst(mod.LatticeWeight)
    f.add_states(6)
    f.start = 0
    for s in range(5):
        for _ in range(3):
            f.add_arc(s, mod.Arc(int(rng.integers(0, 9)),
                                 int(rng.integers(0, 4)),
                                 (float(np.float32(rng.normal())),
                                  float(np.float32(rng.normal()))),
                                 int(rng.integers(s + 1, 6))))
    f.finals[5] = (0.25, 0.5)
    return f


def test_invert_matches_jax():
    got = TOPS.invert(_random_fst(TF, 3))
    want = JOPS.invert(_random_fst(JF, 3))
    assert canon(got) == canon(want)
    assert canon(TOPS.invert(got)) == canon(_random_fst(TF, 3))


def test_determinize_lattice_falls_back_like_jax(capfd):
    """A word-less run of 5,001 transition ids blows up determinize_star's
    output strings: both packages warn and return the raw lattice."""
    def chain(mod):
        lat = mod.VectorFst(mod.LatticeWeight)
        lat.add_states(5003)
        lat.start = 0
        for s in range(5001):
            lat.add_arc(s, mod.Arc(1 + s % 7, 0, (0.0, 0.5), s + 1))
        lat.add_arc(5001, mod.Arc(3, 2, (1.0, 0.5), 5002))
        lat.finals[5002] = (0.0, 0.0)
        return lat
    got_in, want_in = chain(TF), chain(JF)
    got, want = TLF.determinize_lattice(got_in), JLF.determinize_lattice(want_in)
    assert got is got_in and want is want_in
    assert "fell back to raw lattice" in capfd.readouterr().err
    # a small one determinizes in both
    small = _random_fst(TF, 4)
    det = TLF.determinize_lattice(small)
    assert det is not small
    assert canon(det) == canon(JLF.determinize_lattice(_random_fst(JF, 4)))


@pytest.mark.parametrize("holder", ["lattice", "compact-lattice"])
@pytest.mark.parametrize("text", [False, True])
def test_archives_equal_jax_bytes(mono, tmp_path, holder, text):
    """The same lattices written by each package's holder give the same
    bytes (binary compactlattice44, or text), and each package reads the
    other's archive back to the same lattice."""
    ll = random_loglikes(9, 25, mono["num_pdfs"])
    jlat = JD.LatticeFasterDecoder(
        JIO.read_fst_file(f"{mono['d']}/HCLG.fst"),
        JD.LatticeFasterDecoderOptions(prune_interval=0)).decode(
            ll, mono["tm"].id2pdf_id)
    tlat = TD.LatticeFasterDecoder(
        TIO.read_fst_file(f"{mono['d']}/HCLG.fst"),
        TD.LatticeFasterDecoderOptions(prune_interval=0)).decode(
            ll, mono["tm"].id2pdf_id)
    assert canon(tlat) == canon(jlat)
    lats = {"raw": (tlat, jlat),
            "det": (TLF.determinize_lattice(tlat),
                    JLF.determinize_lattice(jlat))}
    jh = (JKL.LatticeHolder() if holder == "lattice"
          else JKL.CompactLatticeHolder())
    th = TT._make_holder(holder)
    mode = "ark,t" if text else "ark"
    pa, ja = tmp_path / "port.ark", tmp_path / "jax.ark"
    with TT.TableWriter(th, f"{mode}:{pa}") as w:
        for k, (t, _) in lats.items():
            w.write(k, t)
    with JT.TableWriter(jh, f"{mode}:{ja}") as w:
        for k, (_, j) in lats.items():
            w.write(k, j)
    assert pa.read_bytes() == ja.read_bytes()
    back_t = dict(TT.SequentialTableReader(holder, f"ark:{ja}"))
    back_j = dict(JT.SequentialTableReader(jh, f"ark:{pa}"))
    for k in lats:
        assert canon(back_t[k]) == canon(back_j[k])
    if holder == "lattice" and text:
        for k, (t, _) in lats.items():
            assert canon(back_t[k]) == canon(t)


def test_compact_lattice_round_trip():
    lat = _random_fst(TF, 6)
    clat = TKL.lattice_to_compact(lat)
    jclat = JKL.lattice_to_compact(_random_fst(JF, 6))
    assert canon(clat) == canon(jclat)
    assert canon(TKL.compact_to_lattice(clat)) == \
        canon(JKL.compact_to_lattice(jclat))
    W = TKL.CompactLatticeWeight
    a, b = ((1.0, 2.0), (3, 4)), ((0.5, 2.5), (3,))
    assert W.plus(a, b) == JKL.CompactLatticeWeight.plus(a, b) == b
    assert W.times(a, b) == ((1.5, 4.5), (3, 4, 3))
    assert W.divide(W.times(b, a), b) == ((1.0, 2.0), (3, 4))
    assert W.plus(W.zero, a) == a and W.times(W.zero, a) == W.zero
    for binary in (True, False):
        buf = io.BytesIO()
        TKL.write_compact_lattice(buf, binary, clat)
        jbuf = io.BytesIO()
        JKL.write_compact_lattice(jbuf, binary, jclat)
        assert buf.getvalue() == jbuf.getvalue()
        buf.seek(0)
        back = TKL.read_compact_lattice(buf, binary)
        assert [[(a.ilabel, a.nextstate, a.weight[1]) for a in arcs]
                for arcs in back.arcs] == \
            [[(a.ilabel, a.nextstate, a.weight[1]) for a in arcs]
             for arcs in clat.arcs]
