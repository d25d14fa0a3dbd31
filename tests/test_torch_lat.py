"""Port parity of the host FST and lattice pieces: the port's own copies
of VectorFst (with its text form), connect, lattice_best_path,
lattice_prune, lattice_state_times and lattice_nbest against the JAX
package's, on hand-built lattices and on seeded random acyclic ones.
Exact: the same Python arithmetic runs on both sides."""

import pytest

from kaldi_tpu.fstext import fst as jfst
from kaldi_tpu.fstext.ops import connect as jax_connect
import numpy as np

from kaldi_tpu.lat import functions as jlat
from kaldi_tpu.lat.functions import lattice_best_path as jax_best_path
from kaldi_tpu_torch.fstext import fst as tfst
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.lat import functions as tlat
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice

# (states, start, arcs (src, ilabel, olabel, (graph, acoustic), dst),
#  finals {state: weight})
LATTICES = {
    "linear": (3, 0, [(0, 5, 1, (0.5, 1.0), 1), (1, 6, 0, (0.0, 2.0), 2)],
               {2: (0.25, 0.0)}),
    # two word alternatives, a dead end (3) and an unreachable state (4)
    "diamond": (6, 0, [(0, 1, 7, (1.0, 2.0), 1), (0, 2, 8, (0.5, 2.0), 2),
                       (1, 3, 0, (0.0, 0.5), 5), (2, 4, 0, (0.0, 1.5), 5),
                       (0, 9, 9, (0.1, 0.1), 3), (4, 9, 9, (0.0, 0.0), 5)],
                {5: (1.5, 0.0)}),
    # equal totals: the first path found stays (strict improvement only)
    "tie": (4, 0, [(0, 1, 1, (1.0, 1.0), 1), (0, 2, 2, (0.5, 1.5), 2),
                   (1, 3, 0, (0.0, 0.0), 3), (2, 4, 0, (0.0, 0.0), 3)],
            {3: (0.0, 0.0)}),
    # start is not state 0, two finals, epsilon input labels
    "finals": (4, 2, [(2, 0, 4, (0.0, 3.0), 0), (2, 11, 5, (2.0, 0.0), 1),
                      (0, 12, 0, (0.0, 0.25), 3)],
               {1: (0.5, 0.0), 3: (0.0, 0.0)}),
    "no_final": (2, 0, [(0, 1, 1, (1.0, 1.0), 1)], {}),
}


def build(mod, name, spec=None):
    """LATTICES[name], or the spec given, in module mod's VectorFst."""
    n, start, arcs, finals = spec or LATTICES[name]
    lat = mod.VectorFst(mod.LatticeWeight)
    lat.add_states(n)
    lat.set_start(start)
    for s, il, ol, w, d in arcs:
        lat.add_arc(s, mod.Arc(il, ol, w, d))
    for s, w in finals.items():
        lat.set_final(s, w)
    return lat


def same(got, want):
    assert (got.num_states, got.start, got.num_arcs()) == \
        (want.num_states, want.start, want.num_arcs())
    assert got.finals == want.finals
    assert [[tuple(a) for a in arcs] for arcs in got.arcs] == \
        [[tuple(a) for a in arcs] for arcs in want.arcs]


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_connect_and_best_path_match(name):
    got, want = build(tfst, name), build(jfst, name)
    assert lattice_best_path(got) == jax_best_path(want)
    same(connect(got), jax_connect(want))
    if name != "no_final":
        assert got.num_states > 0
        assert lattice_best_path(got) == jax_best_path(want)


@pytest.mark.parametrize("name", ["diamond", "finals"])
def test_text_form_matches_and_round_trips(name):
    got, want = build(tfst, name), build(jfst, name)
    assert got.to_text() == want.to_text()
    back = Lattice.from_text(got.to_text(), tfst.LatticeWeight)
    assert back.to_text() == got.to_text()
    assert lattice_best_path(back) == lattice_best_path(got)
    copy = got.copy()
    copy.arcs[got.start][0].ilabel += 1
    assert copy.to_text() != got.to_text()


def test_semirings_match():
    assert (tfst.EPS, tfst.INF) == (jfst.EPS, jfst.INF)
    pairs = [((1.0, 2.0), (2.5, 0.5)), ((1.0, 2.0), (0.5, 2.5)),
             ((1.0, 2.0), tfst.LatticeWeight.zero)]
    for a, b in pairs:
        for op in ("plus", "times"):
            assert getattr(tfst.LatticeWeight, op)(a, b) == \
                getattr(jfst.LatticeWeight, op)(a, b)
        assert tfst.LatticeWeight.approx_equal(a, b) == \
            jfst.LatticeWeight.approx_equal(a, b)
    for a, b in [(1.0, 2.0), (3.0, 3.0), (1.0, tfst.INF)]:
        for op in ("plus", "times", "approx_equal"):
            assert getattr(tfst.TropicalWeight, op)(a, b) == \
                getattr(jfst.TropicalWeight, op)(a, b)
    t = tfst.VectorFst()
    assert t.semiring is tfst.TropicalWeight and t.start == -1


def random_dag(seed, n=40, density=0.12):
    """A seeded acyclic lattice as LATTICES holds them: arcs go to higher
    states only (one to the next state always), epsilon inputs and
    outputs among them, two to four finals, state 0 the start."""
    rng = np.random.default_rng(seed)
    arcs = []
    for s in range(n - 1):
        dsts = [d for d in range(s + 2, n) if rng.random() < density]
        for d in [s + 1] + dsts:
            arcs.append((s, int(rng.integers(0, 9)),
                         int(rng.integers(0, 5)),
                         (round(float(rng.uniform(0, 3)), 3),
                          round(float(rng.normal(1.0, 2.0)), 3)), d))
    finals = {int(s): (round(float(rng.uniform(0, 1)), 3), 0.0)
              for s in rng.choice(np.arange(n // 2, n),
                                  int(rng.integers(2, 5)), replace=False)}
    return n, 0, arcs, finals


@pytest.mark.parametrize("seed", range(4))
def test_prune_times_and_nbest_match(seed):
    got, want = (build(m, None, random_dag(seed)) for m in (tfst, jfst))
    assert tlat.lattice_state_times(got) == jlat.lattice_state_times(want)
    assert tlat._topsort(got) == jlat._topsort(want)
    assert tlat._forward_backward_costs(got) == \
        jlat._forward_backward_costs(want)
    for n in (1, 5, 40):
        paths = tlat.lattice_nbest(got, n)
        assert paths == jlat.lattice_nbest(want, n)
        assert len(paths) == n
        assert [p[2] for p in paths] == sorted(p[2] for p in paths)
    for beam in (0.5, 3.0, 1e9):
        pruned = tlat.lattice_prune(got, beam)
        same(pruned, jlat.lattice_prune(want, beam))
        assert lattice_best_path(pruned)[2] == \
            pytest.approx(lattice_best_path(got)[2])
    assert tlat.lattice_prune(got, 0.5).num_arcs() < \
        tlat.lattice_prune(got, 1e9).num_arcs()


@pytest.mark.parametrize("name", ["diamond", "finals", "tie"])
def test_prune_and_nbest_on_hand_built(name):
    got, want = build(tfst, name), build(jfst, name)
    for beam in (0.0, 1.0, 10.0):
        same(tlat.lattice_prune(got, beam), jlat.lattice_prune(want, beam))
    assert tlat.lattice_nbest(got, 3) == jlat.lattice_nbest(want, 3)
    assert tlat.lattice_state_times(got) == jlat.lattice_state_times(want)


def test_cycles_are_refused():
    lat = build(tfst, "linear")
    lat.add_arc(2, tfst.Arc(1, 0, (0.0, 0.0), 0))
    with pytest.raises(ValueError, match="cycles"):
        tlat.lattice_nbest(lat, 2)


# ---- the lattice functions that consume lattices: on the lattices of the
# JAX package's LexChain and n-gram decoders, converted to each package's
# VectorFst ----------------------------------------------------------------
DECODER_LATS = ("lex0", "lex1", "ng0", "ng1")


def convert(lat, mod):
    """A lattice in module mod's VectorFst: the same states, start, arcs
    (in order) and finals."""
    out = mod.VectorFst(mod.LatticeWeight)
    out.add_states(lat.num_states)
    out.set_start(lat.start)
    for s, arcs in enumerate(lat.arcs):
        for a in arcs:
            out.add_arc(s, mod.Arc(a.ilabel, a.olabel, tuple(a.weight),
                                   a.nextstate))
        out.finals[s] = lat.finals[s]
    return out


@pytest.fixture(scope="module")
def decoder_lattices():
    """Two lanes' lattices of the JAX LexChain decoder and two of its
    n-gram decoder (beam 10, small graphs of the port's parity tests)."""
    from kaldi_tpu.decoder.lexchain import LexChainDecoder as JaxLex
    from kaldi_tpu.decoder.lexchain_ng import NgramLexDecoder as JaxNg
    from test_torch_lexchain import graphs as lex_graphs
    from test_torch_lexchain_ng import graphs as ng_graphs
    jg, _, rng = lex_graphs(1, use_sil=True, sil_phone=5, sil_prob=0.4,
                            extra_variants=2)
    ll = rng.normal(size=(2, 10, jg.num_pdfs)).astype(np.float32)
    lats = JaxLex(jg).decode_batch_lattice(ll, lattice_beam=10.0)
    jg, _, rng = ng_graphs(2, V=6, use_sil=True, ctx=3, extra_variants=1)
    ll = rng.normal(size=(2, 10, jg.num_pdfs)).astype(np.float32)
    lats += JaxNg(jg).decode_batch_lattice(ll, lattice_beam=10.0)
    assert all(lat is not None and lat.num_arcs() > 30 for lat in lats)
    return dict(zip(DECODER_LATS, lats))


def pair(decoder_lattices, name):
    """(port lattice, JAX lattice) of decoder_lattices[name]."""
    want = decoder_lattices[name]
    return convert(want, tfst), convert(want, jfst)


@pytest.mark.parametrize("name", DECODER_LATS)
def test_best_path_lattice_matches(decoder_lattices, name):
    got, want = pair(decoder_lattices, name)
    one = tlat.lattice_best_path_lattice(got)
    same(one, jlat.lattice_best_path_lattice(want))
    assert one.num_arcs() == one.num_states - 1
    assert lattice_best_path(one) == lattice_best_path(got)


@pytest.mark.parametrize("name", DECODER_LATS)
def test_scale_and_penalty_match(decoder_lattices, name):
    got, want = pair(decoder_lattices, name)
    for lm, ac in ((1.0, 1.0), (0.5, 0.08), (2.0, 0.0)):
        same(tlat.lattice_scale(got, lm, ac), jlat.lattice_scale(want, lm,
                                                                 ac))
    same(tlat.lattice_scale(got, 1.0, 1.0), got)
    assert lattice_best_path(tlat.lattice_scale(got)) == \
        lattice_best_path(got)
    for penalty in (1.5, -0.5):
        pen = tlat.add_word_ins_penalty(got, penalty)
        same(pen, jlat.add_word_ins_penalty(want, penalty))
        if penalty < 0:        # a bonus: the best path keeps its words
            assert len(lattice_best_path(pen)[1]) >= \
                len(lattice_best_path(got)[1])
    assert got.to_text() == want.to_text()          # inputs untouched


@pytest.mark.parametrize("name", DECODER_LATS)
def test_forward_backward_post_matches(decoder_lattices, name):
    got, want = pair(decoder_lattices, name)
    for scale in (1.0, 0.1):
        post = tlat.lattice_forward_backward_post(got, scale)
        assert post == jlat.lattice_forward_backward_post(want, scale)
        assert len(post) == len(lattice_best_path(got)[0])
        for frame in post:
            assert abs(sum(p for _, p in frame) - 1.0) <= 1e-6


@pytest.mark.parametrize("name", DECODER_LATS)
@pytest.mark.parametrize("beam", [3.0, 10.0])
def test_determinize_pruned_matches(decoder_lattices, name, beam):
    """Equal output lattices; every word sequence of the output once,
    the best path's words and cost kept."""
    got, want = pair(decoder_lattices, name)
    det = tlat.determinize_lattice_pruned(got, beam=beam)
    same(det, jlat.determinize_lattice_pruned(want, beam=beam))
    _, words, cost = lattice_best_path(det)
    _, words0, cost0 = lattice_best_path(got)
    assert words == words0 and cost == pytest.approx(cost0, abs=1e-9)
    seqs = [tuple(p[1]) for p in tlat.lattice_nbest(det, 50)]
    assert len(seqs) == len(set(seqs))


@pytest.mark.parametrize("name", ["lex0", "ng1"])
def test_determinize_overflow_backs_off(decoder_lattices, name, caplog):
    """max_states too small: each attempt overflows, the beam shrinks and
    the input is pruned again, as in the reference, down to the tight
    pruned lattice; with a few more states a retry succeeds."""
    got, want = pair(decoder_lattices, name)
    with caplog.at_level("WARNING", logger="kaldi_tpu_torch.lat.functions"):
        out = tlat.determinize_lattice_pruned(got, beam=10.0, max_states=2)
    same(out, jlat.determinize_lattice_pruned(want, beam=10.0,
                                              max_states=2))
    assert sum("overflow" in r.message for r in caplog.records) == 4
    assert "giving up" in caplog.records[-1].message
    assert lattice_best_path(out)[1] == lattice_best_path(got)[1]
    full = tlat.determinize_lattice_pruned(got, beam=10.0)
    n = full.num_states
    caplog.clear()
    with caplog.at_level("WARNING", logger="kaldi_tpu_torch.lat.functions"):
        retried = tlat.determinize_lattice_pruned(got, beam=10.0,
                                                  max_states=n // 3)
    same(retried, jlat.determinize_lattice_pruned(want, beam=10.0,
                                                  max_states=n // 3))
    assert lattice_best_path(retried)[1] == lattice_best_path(got)[1]


def test_best_path_lattice_without_a_final_is_none():
    got, want = build(tfst, "no_final"), build(jfst, "no_final")
    assert tlat.lattice_best_path_lattice(got) is None
    assert jlat.lattice_best_path_lattice(want) is None
    one = tlat.lattice_best_path_lattice(build(tfst, "diamond"))
    same(one, jlat.lattice_best_path_lattice(build(jfst, "diamond")))
