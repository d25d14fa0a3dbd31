"""Port parity: on-the-fly LM composition (`kaldi_tpu_torch/decoder/
biglm.py`: BackoffWordFst, LazyBiglmFst, LazyComposeFst) against the JAX
package's, and the port's host decoders reading a lazy FST on demand
(`decoder/lattice_decoder.py` GraphRows, `decoder/viterbi.py`).

On random graphs and backoff LMs made from a seed: the lazy arcs and
finals equal JAX's state for state (exact: the same float64 sums); the
port's decoders over the lazy FST give JAX's decoders' results (raw
lattices equal arc for arc with the periodic link pruning off, where the
port's pruning is upstream's) and the results of the same decoder over
the statically expanded product (best path equal, cost within 1e-9);
and the decoder asks the lazy FST only for the states its search
reaches: the states whose arcs were made are exactly the ones whose rows
it read, fewer than the product holds.
"""

import numpy as np
import pytest

from kaldi_tpu.decoder import biglm as JB
from kaldi_tpu.decoder.lattice_decoder import LatticeFasterDecoder as JLat
from kaldi_tpu.decoder.viterbi import FasterDecoder as JFaster
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu_torch.decoder import biglm as TB
from kaldi_tpu_torch.decoder.lattice_decoder import (
    LatticeFasterDecoder, LatticeFasterDecoderOptions)
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.lat.functions import lattice_best_path

NW = 6          # words 1..NW


def make(Fst, A, S, arcs, finals, start=0):
    f = Fst(TropicalWeight)
    f.add_states(S)
    f.set_start(start)
    for s, il, ol, w, d in arcs:
        f.add_arc(s, A(il, ol, w, d))
    for s, w in finals.items():
        f.finals[s] = w
    return f


def both(S, arcs, finals):
    return make(VectorFst, Arc, S, arcs, finals), \
        make(JFst, JArc, S, arcs, finals)


def random_hcl(rng, S=80, P=8, eps_frac=0.15):
    """An HCL-like graph: transition-id ilabels, sparse word olabels."""
    arcs = []
    for s in range(S):
        for _ in range(int(rng.integers(1, 5))):
            ol = int(rng.integers(1, NW + 1)) if rng.uniform() < 0.3 else 0
            if rng.uniform() < eps_frac and s < S - 1:
                arcs.append((s, EPS, ol, float(rng.uniform(0, 1)),
                             int(rng.integers(s + 1, S))))
            else:
                arcs.append((s, int(rng.integers(1, 2 * P + 1)), ol,
                             float(rng.uniform(0, 2)),
                             int(rng.integers(0, S))))
    finals = {int(s): float(rng.uniform(0, 1))
              for s in rng.choice(S, 6, replace=False)}
    tid2pdf = np.concatenate([[0], (np.arange(2 * P)) % P])
    return S, arcs, finals, tid2pdf


def random_g(rng, missing=()):
    """A bigram backoff acceptor over words 1..NW: state 0 the unigram
    (final), state w the history w with a few explicit words and a
    backoff arc to 0; words in `missing` absent from the unigram."""
    arcs, finals = [], {0: float(rng.uniform(0.5, 2))}
    for w in range(1, NW + 1):
        if w not in missing:
            arcs.append((0, w, w, float(rng.uniform(1, 3)), w))
        for v in rng.choice(np.arange(1, NW + 1), 2, replace=False):
            arcs.append((w, int(v), int(v), float(rng.uniform(0, 2)),
                         int(v)))
        arcs.append((w, EPS, EPS, float(rng.uniform(0, 1)), 0))
        if rng.uniform() < 0.5:
            finals[w] = float(rng.uniform(0, 1))
    return NW + 1, arcs, finals


def walk(lazy, limit=100000):
    """BFS over a duck-typed FST: [(state, final, arcs)] in visit order."""
    out, seen, queue = [], {lazy.start}, [lazy.start]
    while queue and len(out) < limit:
        s = queue.pop(0)
        arcs = [(a.ilabel, a.olabel, float(a.weight), a.nextstate)
                for a in lazy.arcs[s]]
        out.append((s, float(lazy.finals[s]), arcs))
        for a in arcs:
            if a[3] not in seen:
                seen.add(a[3])
                queue.append(a[3])
    return out


def expand(lazy):
    """The whole lazy product as a port VectorFst (same state ids)."""
    rows = walk(lazy)
    n = 1 + max(max([s for s, _, _ in rows]),
                max((a[3] for _, _, arcs in rows for a in arcs),
                    default=0))
    f = VectorFst(TropicalWeight)
    f.add_states(n)
    f.set_start(lazy.start)
    for s, fw, arcs in rows:
        f.finals[s] = fw
        for a in arcs:
            f.add_arc(s, Arc(*a))
    return f


def systems(seed):
    rng = np.random.default_rng(seed)
    S, arcs, finals, tid2pdf = random_hcl(rng)
    hcl_t, hcl_j = both(S, arcs, finals)
    g_old = random_g(rng)
    g_new = random_g(rng, missing=(NW,))
    return rng, tid2pdf, (hcl_t, hcl_j), both(*g_old), both(*g_new)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lazy_arcs_and_finals_equal_jax(seed):
    _, _, (ht, hj), (ot, oj), (nt, nj) = systems(seed)
    bt = TB.LazyBiglmFst(ht, TB.BackoffWordFst(ot), TB.BackoffWordFst(nt))
    bj = JB.LazyBiglmFst(hj, JB.BackoffWordFst(oj), JB.BackoffWordFst(nj))
    assert walk(bt) == walk(bj)
    assert bt.num_interned == len(bj._keys)
    ct = TB.LazyComposeFst(ht, TB.BackoffWordFst(nt))
    cj = JB.LazyComposeFst(hj, JB.BackoffWordFst(nj))
    assert walk(ct) == walk(cj)
    # a word missing from the new LM's unigram kills the paths through
    # it from the unigram state
    gt = TB.BackoffWordFst(nt)
    assert gt.get_arc(0, NW) is None
    assert gt.get_arc(1, 1) == JB.BackoffWordFst(nj).get_arc(1, 1)


def loglikes(rng, T=14, P=8):
    return rng.normal(scale=2.0, size=(T, P)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["biglm", "compose"])
def test_lattice_decoder_on_demand_equals_jax_and_static(seed, kind):
    rng, tid2pdf, (ht, hj), (ot, oj), (nt, nj) = systems(seed)
    lt, lj, fresh = lazy_pair(kind, ht, hj, ot, oj, nt, nj)
    ll = loglikes(rng)
    opts = LatticeFasterDecoderOptions(beam=6.0, lattice_beam=4.0,
                                       prune_interval=0)
    dec = LatticeFasterDecoder(lt, opts)
    lat = dec.decode(ll, tid2pdf, 1.0)
    jlat = JLat(lj, opts).decode(ll, tid2pdf, 1.0)
    assert (lat is None) == (jlat is None)
    if lat is None:
        return
    assert [[tuple(a) for a in r] for r in lat.arcs] == \
        [[tuple(a) for a in r] for r in jlat.arcs]
    assert list(lat.finals) == list(jlat.finals)
    # the decoder read the rows of exactly the states whose arcs the lazy
    # FST made, and those are fewer than the product's
    rows = dec.rows
    read = {rows.external(i) for i in range(len(rows._ext))
            if rows._done[i]}
    assert read == set(lt._arc_cache)
    assert dec.stats["states_expanded"] == len(read)
    static = expand(fresh())
    assert len(read) < static.num_states
    slat = LatticeFasterDecoder(static, opts).decode(ll, tid2pdf, 1.0)
    a1, w1, c1 = lattice_best_path(lat)
    a2, w2, c2 = lattice_best_path(slat)
    assert (a1, w1) == (a2, w2) and c1 == pytest.approx(c2, abs=1e-9)


def lazy_pair(kind, ht, hj, ot, oj, nt, nj):
    """(port's, JAX's) lazy FST of `kind`, and a maker of the port's."""
    def port():
        if kind == "biglm":
            return TB.LazyBiglmFst(ht, TB.BackoffWordFst(ot),
                                   TB.BackoffWordFst(nt))
        return TB.LazyComposeFst(ht, TB.BackoffWordFst(nt))
    lj = (JB.LazyBiglmFst(hj, JB.BackoffWordFst(oj), JB.BackoffWordFst(nj))
          if kind == "biglm" else
          JB.LazyComposeFst(hj, JB.BackoffWordFst(nj)))
    return port(), lj, port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["biglm", "compose"])
def test_faster_decoder_on_demand_equals_jax_and_static(seed, kind):
    rng, tid2pdf, (ht, hj), (ot, oj), (nt, nj) = systems(seed)
    lt, lj, fresh = lazy_pair(kind, ht, hj, ot, oj, nt, nj)
    ll = loglikes(rng)
    o = FasterDecoderOptions(beam=8.0)
    got = FasterDecoder(lt, o).decode(ll, tid2pdf, 1.0)
    want = JFaster(lj, o).decode(ll, tid2pdf, 1.0)
    assert got == want
    n_made = len(lt._arc_cache)
    static = expand(fresh())
    assert n_made < static.num_states
    s = FasterDecoder(static, o).decode(ll, tid2pdf, 1.0)
    assert (got is None) == (s is None)
    if got is not None:
        assert got[:2] == s[:2] and got[2] == pytest.approx(s[2], abs=1e-9)


def test_same_lm_twice_is_the_plain_decode():
    """old G == new G: the biglm product adds 0 to every word arc, so
    the decode is the plain graph's, lattice for lattice."""
    rng, tid2pdf, (ht, _), (ot, _), _ = systems(3)
    ll = loglikes(rng)
    opts = LatticeFasterDecoderOptions(beam=7.0, lattice_beam=5.0)
    lazy = TB.LazyBiglmFst(ht, TB.BackoffWordFst(ot), TB.BackoffWordFst(ot))
    a = LatticeFasterDecoder(lazy, opts).decode(ll, tid2pdf, 1.0)
    b = LatticeFasterDecoder(ht, opts).decode(ll, tid2pdf, 1.0)
    assert (a is None) == (b is None)
    if a is not None:
        assert lattice_best_path(a)[:2] == lattice_best_path(b)[:2]
