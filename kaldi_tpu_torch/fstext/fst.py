"""WFST core: semirings and a mutable vector FST (the part of
`kaldi_tpu/fstext/fst.py` that lattice assembly and the lattice best
path need).

Host-side symbolic graph surgery stays on the CPU.  Weights are plain
floats (tropical) or tuples (lattice: (graph_cost, acoustic_cost));
each semiring class provides plus/times/zero/one as static methods so
algorithms are generic without per-arc object overhead.

`VectorFst.write` / `read` are the reference's own binary container
(`<KtFst>`, the holder of compiled training graphs in an archive), byte
for byte.  Not carried over yet: the log semiring and `to_csr`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

EPS = 0  # epsilon label
INF = float("inf")
KDELTA = 1.0 / 1024.0  # default comparison delta (OpenFst kDelta)


class TropicalWeight:
    """min-plus semiring over floats."""
    zero = INF
    one = 0.0

    @staticmethod
    def plus(a: float, b: float) -> float:
        return a if a <= b else b

    @staticmethod
    def times(a: float, b: float) -> float:
        return a + b

    @staticmethod
    def divide(a: float, b: float) -> float:
        return a - b

    @staticmethod
    def approx_equal(a: float, b: float, delta: float = KDELTA) -> bool:
        if a == b:
            return True
        if math.isinf(a) or math.isinf(b):
            return False
        return abs(a - b) <= delta

    @staticmethod
    def is_member(a: float) -> bool:
        return not math.isnan(a)


class LogWeight:
    """log semiring: plus = -log(e^-a + e^-b), times = +."""
    zero = INF
    one = 0.0

    @staticmethod
    def plus(a: float, b: float) -> float:
        if a == INF:
            return b
        if b == INF:
            return a
        if a > b:
            a, b = b, a
        return a - math.log1p(math.exp(a - b))

    @staticmethod
    def times(a: float, b: float) -> float:
        return a + b

    @staticmethod
    def divide(a: float, b: float) -> float:
        return a - b

    @staticmethod
    def approx_equal(a, b, delta: float = KDELTA) -> bool:
        return TropicalWeight.approx_equal(a, b, delta)


class LatticeWeight:
    """Lattice semiring: pairs (graph_cost, acoustic_cost); plus = min by
    total cost (tie-break on graph cost), times = componentwise +."""
    zero = (INF, INF)
    one = (0.0, 0.0)

    @staticmethod
    def plus(a: Tuple[float, float], b: Tuple[float, float]):
        ta, tb = a[0] + a[1], b[0] + b[1]
        if ta != tb:
            return a if ta < tb else b
        return a if a[0] <= b[0] else b

    @staticmethod
    def times(a, b):
        return (a[0] + b[0], a[1] + b[1])

    @staticmethod
    def divide(a, b):
        return (a[0] - b[0], a[1] - b[1])

    @staticmethod
    def approx_equal(a, b, delta: float = KDELTA) -> bool:
        return (TropicalWeight.approx_equal(a[0], b[0], delta)
                and TropicalWeight.approx_equal(a[1], b[1], delta))


@dataclass
class Arc:
    __slots__ = ("ilabel", "olabel", "weight", "nextstate")
    ilabel: int
    olabel: int
    weight: object
    nextstate: int

    def __iter__(self):
        return iter((self.ilabel, self.olabel, self.weight, self.nextstate))


class VectorFst:
    """Mutable FST. `weights` semiring defaults to tropical."""

    def __init__(self, semiring=TropicalWeight):
        self.semiring = semiring
        self.arcs: List[List[Arc]] = []
        self.finals: List[object] = []  # final weight per state (zero = non-final)
        self.start: int = -1

    # -- construction -------------------------------------------------------

    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append(self.semiring.zero)
        return len(self.arcs) - 1

    def add_states(self, n: int) -> None:
        for _ in range(n):
            self.add_state()

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight=None) -> None:
        self.finals[s] = self.semiring.one if weight is None else weight

    def is_final(self, s: int) -> bool:
        return self.finals[s] != self.semiring.zero

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def copy(self) -> "VectorFst":
        out = VectorFst(self.semiring)
        out.start = self.start
        out.finals = list(self.finals)
        out.arcs = [[Arc(a.ilabel, a.olabel, a.weight, a.nextstate)
                     for a in arcs] for arcs in self.arcs]
        return out

    def __repr__(self):
        return (f"<VectorFst states={self.num_states} arcs={self.num_arcs()} "
                f"start={self.start}>")

    # -- text I/O (OpenFst AT&T format) -------------------------------------

    def to_text(self, acceptor: bool = False) -> str:
        lines = []

        def fmt_w(w):
            if self.semiring is LatticeWeight:
                return f"{w[0]},{w[1]}"
            return f"{w}"

        def emit_state(s):
            for a in self.arcs[s]:
                base = f"{s}\t{a.nextstate}\t{a.ilabel}"
                if not acceptor:
                    base += f"\t{a.olabel}"
                w = fmt_w(a.weight)
                if a.weight != self.semiring.one:
                    base += f"\t{w}"
                lines.append(base)
            if self.is_final(s):
                if self.finals[s] != self.semiring.one:
                    lines.append(f"{s}\t{fmt_w(self.finals[s])}")
                else:
                    lines.append(f"{s}")

        if self.start >= 0:
            emit_state(self.start)
            for s in range(self.num_states):
                if s != self.start:
                    emit_state(s)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str, semiring=TropicalWeight,
                  acceptor: bool = False) -> "VectorFst":
        fst = cls(semiring)

        def parse_w(tok):
            if semiring is LatticeWeight:
                a, b = tok.split(",")
                return (float(a), float(b))
            return float(tok)

        def ensure(s):
            while fst.num_states <= s:
                fst.add_state()

        first = True
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            s = int(parts[0])
            ensure(s)
            if first:
                fst.set_start(s)
                first = False
            n_arc_fields = 3 if acceptor else 4
            if len(parts) >= n_arc_fields:
                ns = int(parts[1])
                ensure(ns)
                il = int(parts[2])
                ol = il if acceptor else int(parts[3])
                w = (parse_w(parts[n_arc_fields])
                     if len(parts) > n_arc_fields else semiring.one)
                fst.add_arc(s, Arc(il, ol, w, ns))
            else:
                w = parse_w(parts[1]) if len(parts) > 1 else semiring.one
                fst.finals[s] = w
        return fst

    # -- the binary container of the reference (<KtFst>) ------------------

    def write(self, stream, binary: bool = True) -> None:
        from kaldi_tpu_torch.base import io_funcs as iof
        sr_name = {TropicalWeight: "standard", LogWeight: "log",
                   LatticeWeight: "lattice"}[self.semiring]
        iof.write_token(stream, binary, "<KtFst>")
        iof.write_token(stream, binary, sr_name)
        iof.write_int32(stream, binary, self.num_states)
        iof.write_int32(stream, binary, self.start)
        nfloats = 2 if self.semiring is LatticeWeight else 1
        fin = np.array([list(w) if nfloats == 2 else [w]
                        for w in self.finals], np.float32).reshape(
                            -1, nfloats) \
            if self.num_states else np.zeros((0, nfloats), np.float32)
        stream.write(fin.astype("<f4").tobytes())
        counts = np.array([len(a) for a in self.arcs], "<i4")
        stream.write(counts.tobytes())
        rows = []
        for arcs in self.arcs:
            for a in arcs:
                w = list(a.weight) if nfloats == 2 else [a.weight]
                rows.append([a.ilabel, a.olabel, a.nextstate] + w)
        if rows:
            arr = np.array(rows, np.float64)
            stream.write(arr[:, :3].astype("<i4").tobytes())
            stream.write(arr[:, 3:].astype("<f4").tobytes())
        iof.write_token(stream, binary, "</KtFst>")

    @classmethod
    def read(cls, stream, binary: bool = True) -> "VectorFst":
        from kaldi_tpu_torch.base import io_funcs as iof
        iof.expect_token(stream, binary, "<KtFst>")
        sr_name = iof.read_token(stream, binary)
        semiring = {"standard": TropicalWeight, "log": LogWeight,
                    "lattice": LatticeWeight}[sr_name]
        fst = cls(semiring)
        n = iof.read_int32(stream, binary)
        start = iof.read_int32(stream, binary)
        nfloats = 2 if semiring is LatticeWeight else 1
        fin = np.frombuffer(stream.read(4 * nfloats * n),
                            "<f4").reshape(n, nfloats)
        counts = np.frombuffer(stream.read(4 * n), "<i4")
        total = int(counts.sum())
        ints = np.frombuffer(stream.read(12 * total),
                             "<i4").reshape(total, 3)
        ws = np.frombuffer(stream.read(4 * nfloats * total),
                           "<f4").reshape(total, nfloats)
        fst.add_states(n)
        fst.start = start
        for s in range(n):
            fst.finals[s] = (tuple(map(float, fin[s])) if nfloats == 2
                             else float(fin[s, 0]))
        pos = 0
        for s in range(n):
            for _ in range(counts[s]):
                il, ol, ns = map(int, ints[pos])
                w = (tuple(map(float, ws[pos])) if nfloats == 2
                     else float(ws[pos, 0]))
                fst.add_arc(s, Arc(il, ol, w, ns))
                pos += 1
        iof.expect_token(stream, binary, "</KtFst>")
        return fst
