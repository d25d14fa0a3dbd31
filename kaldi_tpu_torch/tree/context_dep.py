"""Context dependency: (phone window, pdf-class) -> pdf-id (port of
`ContextDependency` (with its reader and writer),
`monophone_context_dependency` and `monophone_context_dependency_shared`
of
`kaldi_tpu/tree/context_dep.py`; parity: tree/context-dep.h:59,
MonophoneContextDependency of context-dep.cc)."""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Optional, Sequence

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.tree.event_map import (PDF_CLASS_KEY, ConstantEventMap,
                                            EventMap, TableEventMap)


class ContextDependency:
    def __init__(self, N: int = 1, P: int = 0,
                 to_pdf: Optional[EventMap] = None):
        self.N = N  # context width
        self.P = P  # central position
        self.to_pdf = to_pdf

    def context_width(self) -> int:
        return self.N

    def central_position(self) -> int:
        return self.P

    @property
    def num_pdfs(self) -> int:
        return self.to_pdf.max_answer() + 1

    def compute(self, phone_window: Sequence[int], pdf_class: int
                ) -> Optional[int]:
        """phone_window: N phones (0 = out-of-window filler)."""
        if len(phone_window) != self.N:
            raise ValueError(f"window of {len(phone_window)} phones, "
                             f"the tree's width is {self.N}")
        event = {PDF_CLASS_KEY: pdf_class}
        for i, p in enumerate(phone_window):
            event[i] = p
        return self.to_pdf.map(event)

    def pdfs_for(self, phone: int, pdf_class: int) -> List[int]:
        """Every pdf-id that (phone at the central position, pdf_class)
        can map to over any context (GetPdfInfo, context-dep.cc)."""
        event = {PDF_CLASS_KEY: [pdf_class], self.P: [phone]}
        return sorted(self.to_pdf.multi_map(event))

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "ContextDependency")
        iof.write_int32(stream, binary, self.N)
        iof.write_int32(stream, binary, self.P)
        iof.write_token(stream, binary, "ToPdf")
        self.to_pdf.write(stream, binary)
        iof.write_token(stream, binary, "EndContextDependency")
        if not binary:
            stream.write(b"\n")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "ContextDependency":
        iof.expect_token(stream, binary, "ContextDependency")
        N = iof.read_int32(stream, binary)
        P = iof.read_int32(stream, binary)
        tok = iof.read_token(stream, binary)
        if tok == "ToLength":               # old files, as the reference
            EventMap.read(stream, binary)
            tok = iof.read_token(stream, binary)
        if tok != "ToPdf":
            raise ValueError(f"expected ToPdf, got {tok}")
        to_pdf = EventMap.read(stream, binary)
        iof.expect_token(stream, binary, "EndContextDependency")
        return cls(N, P, to_pdf)


def monophone_context_dependency(phones: Sequence[int],
                                 phone2num_pdf_classes: Dict[int, int]
                                 ) -> ContextDependency:
    """The trivial tree: each (phone, pdf_class) its own pdf, numbered in
    phone order."""
    table: List[Optional[EventMap]] = [None] * (max(phones) + 1)
    pdf = 0
    for phone in sorted(phones):
        sub: List[Optional[EventMap]] = []
        for _ in range(phone2num_pdf_classes[phone]):
            sub.append(ConstantEventMap(pdf))
            pdf += 1
        table[phone] = TableEventMap(PDF_CLASS_KEY, sub)
    return ContextDependency(1, 0, TableEventMap(0, table))


def monophone_context_dependency_shared(
        phone_sets: Sequence[Sequence[int]],
        phone2num_pdf_classes: Dict[int, int]) -> ContextDependency:
    """Monophone tree with tied phone sets (--shared-phones)."""
    table: List[Optional[EventMap]] = [None] * (
        max(p for s in phone_sets for p in s) + 1)
    pdf = 0
    for phone_set in phone_sets:
        npc_set = {phone2num_pdf_classes[p] for p in phone_set}
        if len(npc_set) != 1:
            raise ValueError("shared phones must have same #pdf-classes")
        npc = npc_set.pop()
        shared = TableEventMap(PDF_CLASS_KEY, [ConstantEventMap(pdf + i)
                                               for i in range(npc)])
        pdf += npc
        for p in phone_set:
            table[p] = shared
    return ContextDependency(1, 0, TableEventMap(0, table))
