"""Port parity of the OpenFst binary I/O: kaldi_tpu_torch/fstext/
openfst_io.py against kaldi_tpu/fstext/openfst_io.py, on the same seeded
FSTs (tropical and lattice weights, non-final and final states, epsilon
arcs, a decoding graph's flat form).  The bytes each writes are equal;
each package reads the other's files with every arc and weight equal;
compactlattice44 files of the JAX package read into the same expanded
lattices; archives round trip through FstHolder both ways; files in
OpenFst text form read alike; what the port refuses raises."""

import io
import struct

import numpy as np
import pytest

from kaldi_tpu.fstext import fst as JF
from kaldi_tpu.fstext import openfst_io as JO
from kaldi_tpu.util import table as JT
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.fstext import fst as PF
from kaldi_tpu_torch.fstext import openfst_io as PO
from kaldi_tpu_torch.util import table as PT


def random_fst(mod, seed, lattice=False, n=9, arcs=30):
    """The same random FST in either package's VectorFst."""
    rng = np.random.default_rng(seed)
    sr = mod.LatticeWeight if lattice else mod.TropicalWeight
    f = mod.VectorFst(sr)
    f.add_states(n)
    f.start = int(rng.integers(0, n))

    def weight():
        a = float(np.float32(rng.normal() * 3))
        return (a, float(np.float32(rng.normal()))) if lattice else a

    for _ in range(arcs):
        s, d = (int(x) for x in rng.integers(0, n, 2))
        il, ol = (int(x) for x in rng.integers(0, 6, 2))
        f.add_arc(s, mod.Arc(il, ol, weight(), d))
    for s in range(n):
        if rng.random() < 0.4:
            f.finals[s] = weight()
    return f


def fst_bytes(mod, f):
    buf = io.BytesIO()
    mod.write_fst(buf, f)
    return buf.getvalue()


def assert_same_fst(a, b):
    assert (a.start, a.num_states) == (b.start, b.num_states)
    assert list(a.finals) == list(b.finals)
    for s in range(a.num_states):
        assert [tuple(x) for x in a.arcs[s]] == [tuple(x) for x in b.arcs[s]]


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_bytes_equal_and_cross_read(seed, lattice):
    pf, jf = random_fst(PF, seed, lattice), random_fst(JF, seed, lattice)
    got, want = fst_bytes(PO, pf), fst_bytes(JO, jf)
    assert got == want
    back = PO.read_fst(io.BytesIO(want))
    assert back.semiring is (PF.LatticeWeight if lattice
                             else PF.TropicalWeight)
    assert_same_fst(back, jf)
    assert_same_fst(JO.read_fst(io.BytesIO(got)), pf)
    assert_same_fst(PO.read_fst(io.BytesIO(got)), pf)


def test_decoding_graph_round_trip(tmp_path):
    """A LexChainGraph's flat form, as the online2 tools read HCLG.fst."""
    from kaldi_tpu_torch.decoder.lexchain import LexChainGraph
    from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
    lm = BigramBackoffLm.from_counts([["a", "b", "a"], ["b", "c"], ["c"]])
    g = LexChainGraph.build([np.array([1, 2]), np.array([3]),
                             np.array([2, 3, 1])], lm, num_pdfs=16,
                            use_sil=True, sil_phone=4)
    f = g.to_flat_graph().to_vector_fst()
    path = tmp_path / "HCLG.fst"
    with open(path, "wb") as out:
        PO.write_fst(out, f)
    assert_same_fst(PO.read_fst_file(str(path)), f)
    assert_same_fst(JO.read_fst_file(str(path)), f)
    assert path.read_bytes() == fst_bytes(JO, JO.read_fst_file(str(path)))


@pytest.mark.parametrize("seed", range(2))
def test_compact_lattice_files_read_like_jax(seed):
    """compactlattice44 (the JAX package writes a Lattice so) reads into
    the same expanded lattice in both packages."""
    rng = np.random.default_rng(seed)
    lat = JF.VectorFst(JF.LatticeWeight)
    lat.add_states(5)
    lat.start = 0
    for s in range(4):
        for _ in range(2):
            lat.add_arc(s, JF.Arc(int(rng.integers(1, 9)),
                                  int(rng.integers(0, 3)),
                                  (float(np.float32(rng.normal())),
                                   float(np.float32(rng.normal()))), s + 1))
    lat.finals[4] = (0.5, 0.25)
    buf = io.BytesIO()
    JO.write_fst(buf, lat, as_compact_lattice=True)
    raw = buf.getvalue()
    assert b"compactlattice44" in raw
    assert_same_fst(PO.read_fst(io.BytesIO(raw)),
                    JO.read_fst(io.BytesIO(raw)))
    # the CompactLattice readers and writers: the same bytes as JAX's
    got, want = io.BytesIO(), io.BytesIO()
    PO.write_fst(got, PO.read_fst(io.BytesIO(raw)), as_compact_lattice=True)
    JO.write_fst(want, JO.read_fst(io.BytesIO(raw)), as_compact_lattice=True)
    assert got.getvalue() == want.getvalue()
    clat = PO.read_compact_fst(io.BytesIO(raw))
    jclat = JO.read_compact_fst(io.BytesIO(raw))
    assert clat.start == jclat.start and clat.finals == jclat.finals
    assert [[tuple(a) for a in arcs] for arcs in clat.arcs] == \
        [[tuple(a) for a in arcs] for arcs in jclat.arcs]
    back = io.BytesIO()
    PO.write_compact_fst(back, clat)
    assert back.getvalue() == raw


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fst_holder_archives(writer, tmp_path):
    fsts = {f"k{i}": i for i in range(3)}
    ark, scp = tmp_path / "f.ark", tmp_path / "f.scp"
    if writer == "port":
        with PT.TableWriter("fst", f"ark,scp:{ark},{scp}") as w:
            for k, i in fsts.items():
                w.write(k, random_fst(PF, i))
    else:
        with JT.TableWriter(JO.FstHolder(), f"ark,scp:{ark},{scp}") as w:
            for k, i in fsts.items():
                w.write(k, random_fst(JF, i))
    for spec in (f"ark:{ark}", f"scp:{scp}"):
        got = dict(PT.SequentialTableReader(PO.FstHolder(), spec))
        want = dict(JT.SequentialTableReader(JO.FstHolder(), spec))
        assert sorted(got) == sorted(want) == sorted(fsts)
        for k, i in fsts.items():
            assert_same_fst(got[k], want[k])
            assert_same_fst(got[k], random_fst(PF, i))
    by_name = dict(PT.SequentialTableReader("fst", f"ark:{ark}"))
    assert_same_fst(by_name["k2"], random_fst(PF, 2))
    with PT.TableWriter("fst", f"ark,t:{tmp_path / 't.ark'}") as w:
        with pytest.raises(KaldiTpuError, match="binary"):
            w.write("a", random_fst(PF, 0))


def test_text_form_and_refusals(tmp_path):
    f = random_fst(PF, 5)
    text = tmp_path / "g.txt"
    text.write_text(f.to_text())
    got, want = PO.read_fst_file(str(text)), JO.read_fst_file(str(text))
    assert_same_fst(got, want)
    raw = bytearray(fst_bytes(PO, f))
    assert PO.peek_is_openfst(io.BufferedReader(io.BytesIO(bytes(raw))))
    assert not PO.peek_is_openfst(io.BytesIO(bytes(raw)))   # no peek
    # symbol-table flag, const FSTs, other arc types, a bad magic
    flags_at = 4 + 4 + len("vector") + 4 + len("standard") + 4
    with_syms = raw[:flags_at] + struct.pack("<i", 1) + raw[flags_at + 4:]
    with pytest.raises(KaldiTpuError, match="symbol tables"):
        PO.read_fst(io.BytesIO(bytes(with_syms)))
    const = bytes(raw).replace(b"\x06\0\0\0vector", b"\x05\0\0\0const", 1)
    with pytest.raises(KaldiTpuError, match="const"):
        PO.read_fst(io.BytesIO(const))
    log_arcs = bytes(raw).replace(b"\x08\0\0\0standard",
                                  b"\x03\0\0\0log", 1)
    with pytest.raises(KaldiTpuError, match="arc type"):
        PO.read_fst(io.BytesIO(log_arcs))
    with pytest.raises(KaldiTpuError, match="magic"):
        PO.read_fst(io.BytesIO(b"\0" * 64))
    # the JAX package's own container is not ported
    kt = tmp_path / "g.kt"
    with open(kt, "wb") as out:
        out.write(b"\0B")
        random_fst(JF, 5).write(out, True)
    with pytest.raises(KaldiTpuError, match="KtFst"):
        PO.read_fst_file(str(kt))
