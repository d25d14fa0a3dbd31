"""Lattice types and I/O (port of `kaldi_tpu/lat/kaldi_lattice.py`;
parity: lat/kaldi-lattice.h:44,46).

Lattice        — VectorFst over LatticeWeight (graph_cost,
                 acoustic_cost); ilabels = transition-ids, olabels =
                 words.
CompactLattice — acceptor over words whose weights carry
                 (LatticeWeight, transition-id string)
                 (fstext/lattice-weight.h:424).

Text archives are the reference's (`ark,t:` lattices interoperate);
binary entries are OpenFst compactlattice44, as the reference writes
them.  The JAX package's own `<KtFst>` binary container is not carried
over: a binary entry that is not OpenFst raises, naming it.
"""

from __future__ import annotations

from typing import BinaryIO, Optional

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        VectorFst)
from kaldi_tpu_torch.util.table import Holder

Lattice = VectorFst  # semiring=LatticeWeight, ilabel=tid, olabel=word

_KTFST = ("the <KtFst> container of kaldi_tpu/fstext/fst.py is not ported; "
          "binary lattices are OpenFst compactlattice44")


class CompactLatticeWeight:
    """(LatticeWeight, int-string) semiring (lattice-weight.h:424)."""
    zero = ((INF, INF), None)       # a None string marks zero
    one = ((0.0, 0.0), ())

    @staticmethod
    def plus(a, b):
        if a[1] is None:
            return b
        if b[1] is None:
            return a
        wa = LatticeWeight.plus(a[0], b[0])
        if wa == a[0] and (wa != b[0] or len(a[1]) <= len(b[1])):
            return a
        return b

    @staticmethod
    def times(a, b):
        if a[1] is None or b[1] is None:
            return CompactLatticeWeight.zero
        return (LatticeWeight.times(a[0], b[0]), a[1] + b[1])

    @staticmethod
    def divide(a, b):
        if a[1] is None or b[1] is None:
            raise KaldiTpuError("divide by zero CompactLatticeWeight")
        n = len(b[1])
        if a[1][:n] != b[1]:
            raise KaldiTpuError("string division mismatch")
        return (LatticeWeight.divide(a[0], b[0]), a[1][n:])

    @staticmethod
    def approx_equal(a, b, delta=1e-3):
        if (a[1] is None) != (b[1] is None):
            return False
        return a[1] == b[1] and LatticeWeight.approx_equal(a[0], b[0], delta)


class CompactLattice(VectorFst):
    def __init__(self):
        super().__init__(CompactLatticeWeight)


def lattice_to_compact(lat: Lattice) -> CompactLattice:
    """ConvertLattice: each arc becomes a word arc whose weight carries
    its transition id (if any) as a one-element string.  Correct for any
    acyclic lattice; compact only where the lattice already is."""
    out = CompactLattice()
    out.add_states(lat.num_states)
    out.start = lat.start
    for s in range(lat.num_states):
        if lat.finals[s] != LatticeWeight.zero:
            out.finals[s] = (lat.finals[s], ())
        for a in lat.arcs[s]:
            tids = () if a.ilabel == EPS else (a.ilabel,)
            out.add_arc(s, Arc(a.olabel, a.olabel, (a.weight, tids),
                               a.nextstate))
    return out


def compact_to_lattice(clat: CompactLattice) -> Lattice:
    """ConvertLattice the other way: weight strings expand into chains
    of transition-id arcs (the word on the first)."""
    out = VectorFst(LatticeWeight)
    out.add_states(clat.num_states)
    out.start = clat.start
    for s in range(clat.num_states):
        w = clat.finals[s]
        if w != CompactLatticeWeight.zero and w[1] is not None:
            lw, tids = w
            if tids:
                cur = s
                for i, t in enumerate(tids):
                    ns = out.add_state()
                    out.add_arc(cur, Arc(t, EPS, lw if i == 0
                                         else LatticeWeight.one, ns))
                    cur = ns
                out.finals[cur] = LatticeWeight.one
            else:
                out.finals[s] = lw
        for a in clat.arcs[s]:
            lw, tids = a.weight
            if tids is None:
                continue
            word = a.ilabel
            if not tids:
                out.add_arc(s, Arc(EPS, word, lw, a.nextstate))
                continue
            cur = s
            for i, t in enumerate(tids):
                ns = a.nextstate if i == len(tids) - 1 else out.add_state()
                out.add_arc(cur, Arc(t, word if i == 0 else EPS,
                                     lw if i == 0 else LatticeWeight.one, ns))
                cur = ns
    return out


# ---------------------------------------------------------------------------
# text I/O (the reference's lattice archive text format)


def write_lattice_text(stream: BinaryIO, lat: Lattice) -> None:
    stream.write(b"\n")  # the key line's end, as the reference writes it

    def fmt_w(w):
        return f"{w[0]},{w[1]}"

    order = [lat.start] + [s for s in range(lat.num_states)
                           if s != lat.start]
    for s in order:
        if s < 0:
            continue
        for a in lat.arcs[s]:
            stream.write(f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}\t"
                         f"{fmt_w(a.weight)}\n".encode())
        if lat.finals[s] != LatticeWeight.zero:
            stream.write(f"{s}\t{fmt_w(lat.finals[s])}\n".encode())
    stream.write(b"\n")


def read_lattice_text(stream: BinaryIO) -> Optional[Lattice]:
    lat = VectorFst(LatticeWeight)

    def ensure(n):
        while lat.num_states <= n:
            lat.add_state()

    started = saw_any = False
    while True:
        line = stream.readline()
        if not line:
            break
        line = line.decode("utf-8").strip()
        if not line:
            if saw_any:
                break
            continue
        saw_any = True
        parts = line.split()
        s = int(parts[0])
        ensure(s)
        if not started:
            lat.set_start(s)
            started = True
        if len(parts) >= 4:
            d, il, ol = int(parts[1]), int(parts[2]), int(parts[3])
            ensure(d)
            w = (0.0, 0.0)
            if len(parts) >= 5:
                g, a = parts[4].split(",")[:2]
                w = (float(g), float(a))
            lat.add_arc(s, Arc(il, ol, w, d))
        elif len(parts) == 2:
            g, a = parts[1].split(",")[:2]
            lat.finals[s] = (float(g), float(a))
        else:
            lat.finals[s] = (0.0, 0.0)
    return lat if saw_any else None


class LatticeHolder(Holder):
    """Table holder for Lattice entries: binary entries are written as
    OpenFst compactlattice44 and read back expanded (openfst_io.read_fst);
    text entries are the reference's lattice text."""
    binary_container = True

    def read(self, stream):
        from kaldi_tpu_torch.fstext.openfst_io import (peek_is_openfst,
                                                       read_fst)
        if iof.init_input_stream(stream):
            if peek_is_openfst(stream):
                return read_fst(stream)
            raise KaldiTpuError(_KTFST)
        return read_lattice_text(stream)

    def write(self, stream, binary, value):
        if binary:
            from kaldi_tpu_torch.fstext.openfst_io import write_fst
            write_fst(stream, value, as_compact_lattice=True)
        else:
            write_lattice_text(stream, value)


def write_compact_lattice(stream: BinaryIO, binary: bool,
                          clat: CompactLattice) -> None:
    """A CompactLattice with its arc grouping kept (one aligned arc, one
    word): binary is OpenFst compactlattice44; text is the reference's
    compact text, `s1 s2 word g,a,t1_t2_t3`."""
    if binary:
        from kaldi_tpu_torch.fstext.openfst_io import write_compact_fst
        write_compact_fst(stream, clat)
        return
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            tids = "_".join(str(t) for t in (a.weight[1] or ()))
            stream.write(
                f"{s} {a.nextstate} {a.ilabel} "
                f"{a.weight[0][0]:.7g},{a.weight[0][1]:.7g},{tids}\n"
                .encode())
        w = clat.finals[s]
        if w != CompactLatticeWeight.zero and w[1] is not None:
            tids = "_".join(str(t) for t in w[1])
            stream.write(
                f"{s} {w[0][0]:.7g},{w[0][1]:.7g},{tids}\n".encode())
    stream.write(b"\n")


def _parse_compact_weight(tok: str):
    bits = tok.split(",")
    g = float(bits[0]) if bits and bits[0] else 0.0
    a = float(bits[1]) if len(bits) > 1 and bits[1] else 0.0
    tids = (tuple(int(x) for x in bits[2].split("_"))
            if len(bits) > 2 and bits[2] else ())
    return ((g, a), tids)


def read_compact_lattice(stream: BinaryIO,
                         binary: bool) -> Optional[CompactLattice]:
    if binary:
        from kaldi_tpu_torch.fstext.openfst_io import read_compact_fst
        return read_compact_fst(stream)
    # text: lines up to a blank one; `s1 s2 word g,a,tids` / `s g,a,tids`
    clat = CompactLattice()

    def ensure(k):
        while clat.num_states <= k:
            clat.add_state()

    any_line = False
    while True:
        raw = stream.readline()
        if not raw:
            break
        line = raw.decode().strip()
        if not line:
            if any_line:
                break
            continue
        any_line = True
        parts = line.split()
        if len(parts) >= 4:
            s1, s2, word = int(parts[0]), int(parts[1]), int(parts[2])
            ensure(max(s1, s2))
            clat.add_arc(s1, Arc(word, word, _parse_compact_weight(parts[3]),
                                 s2))
        elif len(parts) == 2:
            ensure(int(parts[0]))
            clat.finals[int(parts[0])] = _parse_compact_weight(parts[1])
        elif len(parts) == 1:
            ensure(int(parts[0]))
            clat.finals[int(parts[0])] = ((0.0, 0.0), ())
    if clat.num_states == 0:
        return None
    clat.set_start(0)
    return clat


class CompactLatticeHolder(LatticeHolder):
    """Table holder for CompactLattice entries, arc grouping kept (the
    reference's compactlattice44); a Lattice given to write is converted
    first."""

    def read(self, stream):
        from kaldi_tpu_torch.fstext.openfst_io import peek_is_openfst
        if iof.init_input_stream(stream):
            if peek_is_openfst(stream):
                return read_compact_lattice(stream, True)
            raise KaldiTpuError(_KTFST)
        return read_compact_lattice(stream, False)

    def write(self, stream, binary, value):
        if not isinstance(value, CompactLattice) and \
                value.semiring is LatticeWeight:
            value = lattice_to_compact(value)
        write_compact_lattice(stream, binary, value)
