"""OpenFst binary VectorFst read and write (port of
`kaldi_tpu/fstext/openfst_io.py`; the reference's fstext/kaldi-fst-io.h).

Byte-level interop with Kaldi's graph files (HCLG.fst, L.fst, G.fst)
and FST archives.  Arc types: "standard" (tropical) and "lattice4"
(Kaldi LatticeWeight) are read and written; "compactlattice44" is read
into Lattice form (each arc's transition-id string expanded into a
chain of arcs) by `read_fst`, and into a CompactLattice, arc grouping
kept, by `read_compact_fst`; `write_fst(..., as_compact_lattice=True)`
writes a Lattice as compactlattice44 and `write_compact_fst` a
CompactLattice.  FSTs with attached symbol tables are refused, as the
reference refuses them (its decoding graphs never attach them).

Layout (OpenFst FstHeader + VectorFst version 2 body, little-endian):
  int32 magic=2125659606; string fsttype; string arctype;
  int32 version; int32 flags; uint64 properties;
  int64 start; int64 numstates; int64 numarcs;
  then a state at a time: final weight, int64 narcs, and its arcs,
  {int32 ilabel, int32 olabel, weight, int32 nextstate}.
Strings are an int32 length and the bytes; weights are 1 float
(standard), 2 floats (lattice4), or 2 floats + int32 n + n int32
(compactlattice44).

Not carried over yet: the JAX package's own `<KtFst>` container, which
`read_fst_file` refuses.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.fstext.fst import (EPS, Arc, LatticeWeight,
                                        TropicalWeight, VectorFst)
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.table import Holder

FST_MAGIC = 2125659606
_HAS_ISYMBOLS = 0x1
_HAS_OSYMBOLS = 0x2


def _read_string(f: BinaryIO) -> str:
    n = struct.unpack("<i", f.read(4))[0]
    return f.read(n).decode("utf-8")


def _write_string(f: BinaryIO, s: str) -> None:
    f.write(struct.pack("<i", len(s)))
    f.write(s.encode("utf-8"))


def read_fst_file(rxfilename: str) -> VectorFst:
    """An FST file in OpenFst binary format (the reference's .fst files)
    or in OpenFst text format."""
    with kaldi_io.input_stream(rxfilename) as f:
        if not hasattr(f, "peek"):
            f = io.BufferedReader(f)  # type: ignore[arg-type]
        if peek_is_openfst(f):
            return read_fst(f)
        binary = iof.init_input_stream(f)
        if binary or iof.peek_token(f, binary) == "<KtFst>":
            raise KaldiTpuError(
                f"{rxfilename}: the <KtFst> container of "
                "kaldi_tpu/fstext/fst.py is not ported; write the graph in "
                "OpenFst binary form")
        return VectorFst.from_text(f.read().decode("utf-8"))


def peek_is_openfst(stream: BinaryIO) -> bool:
    if not hasattr(stream, "peek"):
        return False
    head = iof.peek_bytes(stream, 4)
    return len(head) == 4 and struct.unpack("<i", head)[0] == FST_MAGIC


def read_fst(stream: BinaryIO) -> VectorFst:
    magic = struct.unpack("<i", stream.read(4))[0]
    if magic != FST_MAGIC:
        raise KaldiTpuError(f"bad OpenFst magic {magic}")
    fsttype = _read_string(stream)
    arctype = _read_string(stream)
    _version, flags = struct.unpack("<ii", stream.read(8))
    _props = struct.unpack("<Q", stream.read(8))[0]
    start, numstates, _numarcs = struct.unpack("<qqq", stream.read(24))
    if fsttype == "const":
        raise KaldiTpuError("const FSTs not yet supported; use fstconvert")
    if fsttype != "vector":
        raise KaldiTpuError(f"unsupported FST type {fsttype!r}")
    if flags & (_HAS_ISYMBOLS | _HAS_OSYMBOLS):
        raise KaldiTpuError("FSTs with attached symbol tables unsupported")
    if arctype == "standard":
        sr, wsize, compact = TropicalWeight, 1, False
    elif arctype in ("lattice4", "compactlattice44"):
        sr, wsize, compact = LatticeWeight, 2, arctype != "lattice4"
    else:
        raise KaldiTpuError(f"unsupported arc type {arctype!r}")
    wfmt = f"<{wsize}f"

    def read_weight():
        vals = struct.unpack(wfmt, stream.read(4 * wsize))
        w = float(vals[0]) if wsize == 1 else (float(vals[0]),
                                               float(vals[1]))
        string = []
        if compact:
            n = struct.unpack("<i", stream.read(4))[0]
            if n:
                string = list(struct.unpack(f"<{n}i", stream.read(4 * n)))
        return w, string

    fst = VectorFst(sr)
    fst.add_states(max(numstates, 0))
    fst.start = int(start)
    for s in range(numstates):
        w, fstring = read_weight()
        # OpenFst writes Zero() (+inf) for a state that is not final
        is_zero = (w if wsize == 1 else w[0]) == float("inf")
        fst.finals[s] = sr.zero if is_zero else w
        if compact and fstring:
            # the final string becomes a chain of epsilon-output arcs to a
            # fresh final state
            cur, lw = s, fst.finals[s]
            fst.finals[s] = LatticeWeight.zero
            for i, tid in enumerate(fstring):
                ns = fst.add_state()
                fst.add_arc(cur, Arc(tid, EPS, lw if i == 0
                                     else LatticeWeight.one, ns))
                cur = ns
            fst.finals[cur] = LatticeWeight.one
        narcs = struct.unpack("<q", stream.read(8))[0]
        for _ in range(narcs):
            il, ol = struct.unpack("<ii", stream.read(8))
            w, string = read_weight()
            (ns,) = struct.unpack("<i", stream.read(4))
            if not compact:
                fst.add_arc(s, Arc(il, ol, w, ns))
            elif not string:
                fst.add_arc(s, Arc(EPS, il, w, ns))
            else:
                # ilabel == olabel == the word; the tid string expands
                cur = s
                for i, tid in enumerate(string):
                    nxt = ns if i == len(string) - 1 else fst.add_state()
                    fst.add_arc(cur, Arc(tid, il if i == 0 else EPS,
                                         w if i == 0 else LatticeWeight.one,
                                         nxt))
                    cur = nxt
    return fst


def write_fst(stream: BinaryIO, fst: VectorFst,
              as_compact_lattice: bool = False) -> None:
    """An FST in OpenFst binary form; a Lattice as compactlattice44 when
    `as_compact_lattice` (converted by lattice_to_compact first)."""
    if as_compact_lattice:
        if fst.semiring is not LatticeWeight:
            raise KaldiTpuError("unsupported semiring for OpenFst write")
        from kaldi_tpu_torch.lat.kaldi_lattice import lattice_to_compact
        write_compact_fst(stream, lattice_to_compact(fst))
        return
    if fst.semiring is TropicalWeight:
        arctype, wsize = "standard", 1
    elif fst.semiring is LatticeWeight:
        arctype, wsize = "lattice4", 2
    else:
        raise KaldiTpuError("unsupported semiring for OpenFst write")
    _write_header(stream, arctype, fst)
    zero = struct.pack(f"<{wsize}f", *([float("inf")] * wsize))

    def weight(w) -> bytes:
        if w == fst.semiring.zero:
            return zero
        return struct.pack("<f", w) if wsize == 1 else struct.pack("<2f", *w)

    for s in range(fst.num_states):
        stream.write(weight(fst.finals[s]))
        stream.write(struct.pack("<q", len(fst.arcs[s])))
        for a in fst.arcs[s]:
            stream.write(struct.pack("<ii", a.ilabel, a.olabel)
                         + weight(a.weight)
                         + struct.pack("<i", a.nextstate))


def _write_header(stream: BinaryIO, arctype: str, fst: VectorFst) -> None:
    stream.write(struct.pack("<i", FST_MAGIC))
    _write_string(stream, "vector")
    _write_string(stream, arctype)
    stream.write(struct.pack("<ii", 2, 0))          # version, flags
    stream.write(struct.pack("<Q", 0))              # properties
    stream.write(struct.pack("<qqq", fst.start, fst.num_states,
                             fst.num_arcs()))


def write_compact_fst(stream: BinaryIO, clat) -> None:
    """A CompactLattice as OpenFst compactlattice44, its arc grouping
    kept (one arc's string stays one arc)."""
    _write_header(stream, "compactlattice44", clat)

    def weight(w) -> bytes:
        lw, string = w
        if string is None:
            return struct.pack("<2fi", float("inf"), float("inf"), 0)
        return (struct.pack("<2fi", lw[0], lw[1], len(string))
                + struct.pack(f"<{len(string)}i", *string))

    for s in range(clat.num_states):
        stream.write(weight(clat.finals[s]))
        stream.write(struct.pack("<q", len(clat.arcs[s])))
        for a in clat.arcs[s]:
            stream.write(struct.pack("<ii", a.ilabel, a.olabel)
                         + weight(a.weight)
                         + struct.pack("<i", a.nextstate))


def read_compact_fst(stream: BinaryIO):
    """OpenFst compactlattice44 into a CompactLattice, each arc's
    transition-id string kept on it (read_fst expands them instead)."""
    from kaldi_tpu_torch.lat.kaldi_lattice import (CompactLattice,
                                                   CompactLatticeWeight)
    magic = struct.unpack("<i", stream.read(4))[0]
    if magic != FST_MAGIC:
        raise KaldiTpuError(f"bad OpenFst magic {magic}")
    fsttype = _read_string(stream)
    arctype = _read_string(stream)
    _version, flags = struct.unpack("<ii", stream.read(8))
    _props = struct.unpack("<Q", stream.read(8))[0]
    start, numstates, _numarcs = struct.unpack("<qqq", stream.read(24))
    if fsttype != "vector" or arctype != "compactlattice44":
        raise KaldiTpuError(f"read_compact_fst: got {fsttype}/{arctype}")
    if flags & (_HAS_ISYMBOLS | _HAS_OSYMBOLS):
        raise KaldiTpuError("FSTs with attached symbol tables unsupported")
    clat = CompactLattice()
    clat.add_states(max(numstates, 0))
    clat.start = int(start)

    def read_weight():
        g, a, n = struct.unpack("<2fi", stream.read(12))
        tids = tuple(struct.unpack(f"<{n}i", stream.read(4 * n))) \
            if n else ()
        if g == float("inf"):
            return CompactLatticeWeight.zero
        return ((float(g), float(a)), tids)

    for s in range(numstates):
        clat.finals[s] = read_weight()
        narcs = struct.unpack("<q", stream.read(8))[0]
        for _ in range(narcs):
            il, ol = struct.unpack("<ii", stream.read(8))
            w = read_weight()
            (ns,) = struct.unpack("<i", stream.read(4))
            clat.add_arc(s, Arc(il, ol, w, ns))
    return clat


class FstHolder(Holder):
    """Table holder for archives of OpenFst-binary FSTs (the reference's
    VectorFstHolder, fstext/kaldi-fst-io.h): an entry is raw OpenFst
    binary after the \\0B marker."""

    binary_container = True

    def read(self, stream):
        iof.init_input_stream(stream)
        return read_fst(stream)

    def write(self, stream, binary, value):
        if not binary:
            raise KaldiTpuError("FST tables require binary mode")
        write_fst(stream, value)
