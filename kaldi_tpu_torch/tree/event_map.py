"""Decision-tree event maps (port of `EventMap.read`, `write`,
`write_nullable`, `map` and `multi_map` of
`kaldi_tpu/tree/event_map.py`; parity: tree/event-map.h:86).

An event maps keys to values: keys 0..N-1 are context positions (value
= phone), key -1 (kPdfClass) the pdf-class.  A map answers an event
with a pdf-id, or None.  The three kinds are read from and written to
"CE", "TE" and "SE" records as the reference writes them.
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Optional, Sequence

from kaldi_tpu_torch.base import io_funcs as iof

PDF_CLASS_KEY = -1


class EventMap:
    def map(self, event: Dict[int, int]) -> Optional[int]:
        raise NotImplementedError

    def multi_map(self, event: Dict[int, Optional[List[int]]]) -> set:
        """All answers reachable when some keys range over lists (None
        or an absent key: any value)."""
        raise NotImplementedError

    def max_answer(self) -> int:
        raise NotImplementedError

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        raise NotImplementedError

    @staticmethod
    def write_nullable(stream: BinaryIO, binary: bool,
                       em: Optional["EventMap"]) -> None:
        if em is None:
            iof.write_token(stream, binary, "NULL")
        else:
            em.write(stream, binary)

    @staticmethod
    def read(stream: BinaryIO, binary: bool = True
             ) -> Optional["EventMap"]:
        tok = iof.peek_token(stream, binary)
        if tok == "NULL":
            iof.read_token(stream, binary)
            return None
        if tok == "CE":
            iof.read_token(stream, binary)
            return ConstantEventMap(iof.read_int32(stream, binary))
        if tok == "TE":
            iof.read_token(stream, binary)
            key = iof.read_int32(stream, binary)
            size = iof.read_uint32(stream, binary)
            iof.expect_token(stream, binary, "(")
            table = [EventMap.read(stream, binary) for _ in range(size)]
            iof.expect_token(stream, binary, ")")
            return TableEventMap(key, table)
        if tok == "SE":
            iof.read_token(stream, binary)
            key = iof.read_int32(stream, binary)
            yes_set = iof.read_int_vector(stream, binary)
            iof.expect_token(stream, binary, "{")
            yes = EventMap.read(stream, binary)
            no = EventMap.read(stream, binary)
            iof.expect_token(stream, binary, "}")
            return SplitEventMap(key, yes_set, yes, no)
        raise ValueError(f"EventMap.read: unexpected token {tok!r}")


class ConstantEventMap(EventMap):
    def __init__(self, answer: int):
        self.answer = answer

    def map(self, event):
        return self.answer

    def multi_map(self, event):
        return {self.answer}

    def max_answer(self):
        return self.answer

    def write(self, stream, binary=True):
        iof.write_token(stream, binary, "CE")
        iof.write_int32(stream, binary, self.answer)


class TableEventMap(EventMap):
    def __init__(self, key: int, table: List[Optional[EventMap]]):
        self.key = key
        self.table = table

    def map(self, event):
        v = event.get(self.key)
        if v is None or v < 0 or v >= len(self.table) or \
                self.table[v] is None:
            return None
        return self.table[v].map(event)

    def multi_map(self, event):
        vals = event.get(self.key)
        if vals is None:                  # key unconstrained: all branches
            idxs = range(len(self.table))
        else:
            idxs = vals if isinstance(vals, (list, set, tuple)) else [vals]
        out = set()
        for v in idxs:
            if 0 <= v < len(self.table) and self.table[v] is not None:
                out |= self.table[v].multi_map(event)
        return out

    def max_answer(self):
        return max((t.max_answer() for t in self.table if t is not None),
                   default=-1)

    def write(self, stream, binary=True):
        iof.write_token(stream, binary, "TE")
        iof.write_int32(stream, binary, self.key)
        # the size is unsigned in the reference (event-map.cc:125)
        iof.write_uint32(stream, binary, len(self.table))
        iof.write_token(stream, binary, "(")
        for t in self.table:
            EventMap.write_nullable(stream, binary, t)
        iof.write_token(stream, binary, ")")
        if not binary:
            stream.write(b"\n")


class SplitEventMap(EventMap):
    def __init__(self, key: int, yes_set: Sequence[int],
                 yes: Optional[EventMap], no: Optional[EventMap]):
        self.key = key
        self.yes_set = frozenset(yes_set)
        self.yes = yes
        self.no = no

    def map(self, event):
        v = event.get(self.key)
        if v is None:
            return None
        branch = self.yes if v in self.yes_set else self.no
        return branch.map(event) if branch is not None else None

    def multi_map(self, event):
        vals = event.get(self.key)
        if vals is None:
            branches = [self.yes, self.no]
        else:
            vv = vals if isinstance(vals, (list, set, tuple)) else [vals]
            branches = []
            if any(v in self.yes_set for v in vv):
                branches.append(self.yes)
            if any(v not in self.yes_set for v in vv):
                branches.append(self.no)
        out = set()
        for b in branches:
            if b is not None:
                out |= b.multi_map(event)
        return out

    def max_answer(self):
        return max(self.yes.max_answer() if self.yes else -1,
                   self.no.max_answer() if self.no else -1)

    def write(self, stream, binary=True):
        iof.write_token(stream, binary, "SE")
        iof.write_int32(stream, binary, self.key)
        iof.write_int_vector(stream, binary, sorted(self.yes_set))
        iof.write_token(stream, binary, "{")
        EventMap.write_nullable(stream, binary, self.yes)
        EventMap.write_nullable(stream, binary, self.no)
        iof.write_token(stream, binary, "}")
