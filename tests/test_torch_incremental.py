"""Port parity: the incremental-determinization decoder
(`kaldi_tpu_torch/decoder/incremental.py`) against the JAX package's,
on the JAX package's monophone YES/NO system (tests/test_mono_e2e.py)
and on a constructed graph.

The port repairs a reference fault (ROADMAP §3): the reference restarts
every frontier token at cost 0 in each chunk, so its beam forgets the
tokens' history.  Shown here on the JAX
package: its best path differs from its own LatticeFasterDecoder's at
the same beams, by a cost gap the test states; the port's equals the
port's LatticeFasterDecoder's.  Where no token or link is pruned the
port's lattices are JAX's, arc for arc (exact weights); with pruning,
the best path equals the port's LatticeFasterDecoder's (words and
alignment; cost within 1e-6).
"""

import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from kaldi_tpu.decoder.incremental import \
    LatticeIncrementalDecoder as JInc
from kaldi_tpu.decoder.lattice_decoder import LatticeFasterDecoder as JLat
from kaldi_tpu.fstext.fst import Arc as JArc
from kaldi_tpu.fstext.fst import VectorFst as JFst
from kaldi_tpu.lat.functions import lattice_best_path as j_best_path
from kaldi_tpu_torch.decoder import LatticeIncrementalDecoder
from kaldi_tpu_torch.decoder.incremental import _LABEL_BASE
from kaldi_tpu_torch.decoder.lattice_decoder import (
    LatticeFasterDecoder, LatticeFasterDecoderOptions)
from kaldi_tpu_torch.fstext.fst import Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.lat.functions import lattice_best_path


def through_bytes(jfst):
    """A JAX package VectorFst as both packages read its OpenFst bytes
    (float32 weights, as the tools read HCLG.fst)."""
    from kaldi_tpu.fstext.openfst_io import read_fst as jread
    from kaldi_tpu.fstext.openfst_io import write_fst as jwrite
    from kaldi_tpu_torch.fstext.openfst_io import read_fst
    buf = io.BytesIO()
    jwrite(buf, jfst)
    data = buf.getvalue()
    return read_fst(io.BytesIO(data)), jread(io.BytesIO(data))


@pytest.fixture(scope="module")
def system():
    from test_mono_e2e import FS, make_corpus, unigram_g

    from kaldi_tpu.decoder.graph import Lang
    from kaldi_tpu.feat.frontend import MfccOptions, OfflineFeature
    from kaldi_tpu.feat.window import FrameExtractionOptions
    from kaldi_tpu.recipes.mono import (TrainMonoOptions, make_hclg,
                                        train_mono)
    train_txt, train_wav, test_txt, test_wav = make_corpus(
        num_train=8, num_test=3)
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
    hclg, jhclg = through_bytes(make_hclg(sys_, unigram_g(lang)))
    lls = {u: np.asarray(sys_.am.log_likes_batch(sf[u]), np.float32)
           for u in sorted(sf)}
    return dict(jhclg=jhclg, hclg=hclg,
                tid2pdf=np.asarray(sys_.tm.id2pdf_id), lls=lls)


def arcs_of(lat):
    return [[tuple(a) for a in r] for r in lat.arcs], list(lat.finals)


@pytest.mark.parametrize("chunk", [7, 12])
def test_equals_jax_where_nothing_is_pruned(system, chunk):
    opts = LatticeFasterDecoderOptions(beam=1e4, lattice_beam=1e4,
                                       max_active=10 ** 6)
    tid = system["tid2pdf"]
    for utt, ll in system["lls"].items():
        ll = ll[:24]
        got = LatticeIncrementalDecoder(system["hclg"], opts, chunk)
        want = JInc(system["jhclg"], opts, chunk)
        a = got.decode(ll, tid, 0.1)
        b = want.decode(ll, tid, 0.1)
        assert arcs_of(a) == arcs_of(b), utt
        assert got.stats == want.stats


@pytest.mark.parametrize("chunk", [20, 30])
def test_best_path_equals_lattice_faster_decoder(system, chunk):
    """The reference test's beams: the port's incremental best path is
    its LatticeFasterDecoder's, and the transcript's."""
    opts = LatticeFasterDecoderOptions(beam=16.0, lattice_beam=7.0,
                                       determinize_lattice=False)
    tid = system["tid2pdf"]
    inc = LatticeIncrementalDecoder(system["hclg"], opts, chunk)
    ref = LatticeFasterDecoder(system["hclg"], opts)
    for utt, ll in system["lls"].items():
        a, w, c = lattice_best_path(inc.decode(ll, tid, 0.1))
        ra, rw, rc = lattice_best_path(ref.decode(ll, tid, 0.1))
        assert (a, w) == (ra, rw), utt
        assert c == pytest.approx(rc, abs=1e-6)
        assert len(a) == ll.shape[0] and inc.stats["chunks"] >= 3
        jw = j_best_path(JInc(system["jhclg"], opts, chunk).decode(
            ll, tid, 0.1))[1]
        assert jw == w, utt
        # no marker label leaks into the lattice
        lat = inc.decode(ll, tid, 0.1)
        assert all(a.olabel < _LABEL_BASE for r in lat.arcs for a in r)


def test_chunk_memory_is_bounded(system):
    opts = LatticeFasterDecoderOptions(beam=16.0, lattice_beam=7.0)
    ll = next(iter(system["lls"].values()))
    small = LatticeIncrementalDecoder(system["hclg"], opts, 20)
    small.decode(ll, system["tid2pdf"], 0.1)
    big = LatticeIncrementalDecoder(system["hclg"], opts, ll.shape[0])
    big.decode(ll, system["tid2pdf"], 0.1)
    assert small.stats["max_chunk_links"] < big.stats["max_chunk_links"]


def two_branches(Fst, A):
    """start -(word 1)-> a, -(word 2)-> b; a and b loop on their own
    pdf (0 and 1) and leave to the final state on pdf 2."""
    f = Fst(TropicalWeight)
    f.add_states(4)
    f.set_start(0)
    f.add_arc(0, A(1, 1, 0.0, 1))
    f.add_arc(0, A(2, 2, 0.0, 2))
    f.add_arc(1, A(3, 0, 0.0, 1))
    f.add_arc(2, A(4, 0, 0.0, 2))
    f.add_arc(1, A(5, 0, 0.0, 3))
    f.add_arc(2, A(6, 0, 0.0, 3))
    f.finals[3] = 0.0
    return f


def test_reference_fault_forgets_history():
    """The reference fault on the JAX package.  Chunks of 2 frames, beam 6,
    lattice beam 8.  Six frames favour branch a by 3 a frame, so b ends
    each chunk 6 behind (inside the lattice beam) and enters the next at
    cost 0 as a does; then two frames favour b by 7, so in the fourth
    chunk a trails b's chunk-local cost by more than the beam and is
    cut, though a's path is 18 - 14 = 4 cheaper in all.  The reference's
    best path is b's; its LatticeFasterDecoder's, and the port's
    incremental decoder's, are a's."""
    tid2pdf = np.array([0, 0, 1, 0, 1, 2, 2])
    ll = np.zeros((9, 3), np.float32)
    ll[:6, 1] = -3.0            # a cheaper by 3 a frame
    ll[6:8, 0] = -7.0           # b cheaper by 7 a frame
    ll[:8, 2] = -50.0           # only the last frame leaves to the
    ll[8, :2] = -50.0           # final state
    opts = LatticeFasterDecoderOptions(beam=6.0, lattice_beam=8.0,
                                       determinize_lattice=False)
    jf = two_branches(JFst, JArc)
    j_inc = j_best_path(JInc(jf, opts, 2).decode(ll, tid2pdf, 1.0))
    j_ref = j_best_path(JLat(jf, opts).decode(ll, tid2pdf, 1.0))
    assert j_ref[1] == [1] and j_inc[1] == [2]
    assert j_inc[2] - j_ref[2] == pytest.approx(4.0, abs=1e-6)
    tf = two_branches(VectorFst, Arc)
    t_inc = lattice_best_path(LatticeIncrementalDecoder(
        tf, opts, 2).decode(ll, tid2pdf, 1.0))
    assert t_inc[1] == [1] and t_inc[0] == j_ref[0]
    assert t_inc[2] == pytest.approx(j_ref[2], abs=1e-6)
