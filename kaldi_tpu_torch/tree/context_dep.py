"""Context dependency: (phone window, pdf-class) -> pdf-id (port of
`ContextDependency` of `kaldi_tpu/tree/context_dep.py`; parity:
tree/context-dep.h:59)."""

from __future__ import annotations

from typing import BinaryIO, Optional, Sequence

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.tree.event_map import PDF_CLASS_KEY, EventMap


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
