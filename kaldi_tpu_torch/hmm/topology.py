"""HMM topology (port of the reader and writer, `three_state`,
`chain_topology`, `is_hmm` and `num_pdf_classes` of
`kaldi_tpu/hmm/topology.py`; parity: hmm/hmm-topology.h:93).

Per-phone HMM prototypes: each entry is a list of states, each state
has a pdf-class (or none for the final non-emitting state) and a list
of (next-state, probability) transitions.  Text and binary `topo`
formats are read and written as the reference writes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

from kaldi_tpu_torch.base import io_funcs as iof

NO_PDF = -1


@dataclass
class HmmState:
    forward_pdf_class: int = NO_PDF
    self_loop_pdf_class: int = NO_PDF
    transitions: List[Tuple[int, float]] = field(default_factory=list)

    def __post_init__(self):
        if self.self_loop_pdf_class == NO_PDF and \
                self.forward_pdf_class != NO_PDF:
            self.self_loop_pdf_class = self.forward_pdf_class


class HmmTopology:
    def __init__(self):
        self.phones: List[int] = []          # sorted phone ids
        self.phone2idx: Dict[int, int] = {}  # phone -> entry index
        self.entries: List[List[HmmState]] = []

    @classmethod
    def three_state(cls, phones: List[int],
                    nonsil_phones: Optional[List[int]] = None,
                    sil_phones: Optional[List[int]] = None,
                    num_sil_states: int = 5,
                    num_nonsil_states: int = 3) -> "HmmTopology":
        """Standard Bakis topology (the gen_topo.pl default: 3 emitting
        states for regular phones, 5 for silence)."""
        topo = cls()
        if sil_phones is None:
            sil_phones = []
        if nonsil_phones is None:
            nonsil_phones = [p for p in phones if p not in set(sil_phones)]

        def bakis(n: int) -> List[HmmState]:
            states = []
            for i in range(n):
                states.append(HmmState(i, i, [(i, 0.5), (i + 1, 0.5)]))
            states.append(HmmState())  # final non-emitting
            return states

        def sil_entry(n: int) -> List[HmmState]:
            # gen_topo.pl silence: state 0 can jump to 1..n-2; middle states
            # fully connected among {1..n-1}; last emitting -> final
            if n < 3:
                return bakis(n)
            states = []
            mid = list(range(1, n - 1))
            first_next = [0] + mid
            p = 1.0 / len(first_next)
            states.append(HmmState(0, 0, [(s, p) for s in first_next]))
            for i in range(1, n - 1):
                nexts = mid + [n - 1]
                p = 1.0 / len(nexts)
                states.append(HmmState(i, i, [(s, p) for s in nexts]))
            states.append(HmmState(n - 1, n - 1, [(n - 1, 0.75), (n, 0.25)]))
            states.append(HmmState())
            return states

        if nonsil_phones:
            topo.entries.append(bakis(num_nonsil_states))
            for p in nonsil_phones:
                topo.phone2idx[p] = len(topo.entries) - 1
        if sil_phones:
            topo.entries.append(sil_entry(num_sil_states))
            for p in sil_phones:
                topo.phone2idx[p] = len(topo.entries) - 1
        topo.phones = sorted(topo.phone2idx)
        return topo

    @classmethod
    def chain_topology(cls, phones: List[int]) -> "HmmTopology":
        """The 'chain' topology (steps/nnet3/chain/gen_topo.py): one
        emitting state whose first frame uses pdf-class 0 and whose
        self-loop uses pdf-class 1, so a phone can be traversed in a
        single frame at the subsampled rate."""
        topo = cls()
        topo.entries.append([HmmState(0, 1, [(0, 0.5), (1, 0.5)]),
                             HmmState()])
        for p in phones:
            topo.phone2idx[p] = 0
        topo.phones = sorted(topo.phone2idx)
        return topo

    def num_pdf_classes(self, phone: int) -> int:
        entry = self.topology_for_phone(phone)
        return 1 + max(max(s.forward_pdf_class for s in entry
                           if s.forward_pdf_class != NO_PDF),
                       max(s.self_loop_pdf_class for s in entry
                           if s.self_loop_pdf_class != NO_PDF))

    def is_hmm(self) -> bool:
        """True when no state has distinct forward and self-loop
        pdf-classes (the reference's plain, non-extended format)."""
        return all(s.forward_pdf_class == s.self_loop_pdf_class
                   for e in self.entries for s in e)

    def topology_for_phone(self, phone: int) -> List[HmmState]:
        if phone not in self.phone2idx:
            raise ValueError(f"no topology entry for phone {phone}")
        return self.entries[self.phone2idx[phone]]

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<Topology>")
        is_hmm = self.is_hmm()
        if not binary:
            stream.write(b"\n")
            for i, entry in enumerate(self.entries):
                stream.write(b"<TopologyEntry>\n<ForPhones>\n")
                stream.write(" ".join(str(p) for p in sorted(self.phone2idx)
                                      if self.phone2idx[p] == i).encode())
                stream.write(b" \n</ForPhones>\n")
                for j, st in enumerate(entry):
                    stream.write(f"<State> {j} ".encode())
                    if st.forward_pdf_class != NO_PDF:
                        if is_hmm:
                            stream.write(
                                f"<PdfClass> {st.forward_pdf_class} "
                                .encode())
                        else:
                            stream.write(
                                f"<ForwardPdfClass> {st.forward_pdf_class} "
                                f"<SelfLoopPdfClass> "
                                f"{st.self_loop_pdf_class} ".encode())
                    for ns, p in st.transitions:
                        stream.write(f"<Transition> {ns} {p} ".encode())
                    stream.write(b"</State>\n")
                stream.write(b"</TopologyEntry>\n")
            stream.write(b"</Topology>\n")
            return
        # hmm-topology.cc:208-227: phones, phone2idx, [-1 marker of the
        # extended format], entries
        iof.write_int_vector(stream, binary, self.phones)
        phone2idx_vec = [-1] * (max(self.phone2idx, default=-1) + 1)
        for p, i in self.phone2idx.items():
            phone2idx_vec[p] = i
        iof.write_int_vector(stream, binary, phone2idx_vec)
        if not is_hmm:
            iof.write_int32(stream, binary, -1)
        iof.write_int32(stream, binary, len(self.entries))
        for entry in self.entries:
            iof.write_int32(stream, binary, len(entry))
            for st in entry:
                iof.write_int32(stream, binary, st.forward_pdf_class)
                if not is_hmm:
                    iof.write_int32(stream, binary, st.self_loop_pdf_class)
                iof.write_int32(stream, binary, len(st.transitions))
                for ns, p in st.transitions:
                    iof.write_int32(stream, binary, ns)
                    iof.write_float(stream, binary, p)
        iof.write_token(stream, binary, "</Topology>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True) -> "HmmTopology":
        topo = cls()
        iof.expect_token(stream, binary, "<Topology>")
        if binary:
            topo._read_binary(stream)
        else:
            topo._read_text(stream)
        topo.phones = sorted(topo.phone2idx)
        return topo

    def _read_binary(self, stream: BinaryIO) -> None:
        # hmm-topology.cc:208-227: phones, phone2idx, [-1 marker of the
        # extended format], entries
        iof.read_int_vector(stream, True)
        phone2idx_vec = iof.read_int_vector(stream, True)
        self.phone2idx = {p: i for p, i in enumerate(phone2idx_vec)
                          if i != -1}
        n_entries = iof.read_int32(stream, True)
        is_hmm = True
        if n_entries == -1:
            is_hmm = False
            n_entries = iof.read_int32(stream, True)
        for _ in range(n_entries):
            entry = []
            for _ in range(iof.read_int32(stream, True)):
                fwd = iof.read_int32(stream, True)
                slf = fwd if is_hmm else iof.read_int32(stream, True)
                st = HmmState(fwd, slf)
                for _ in range(iof.read_int32(stream, True)):
                    ns = iof.read_int32(stream, True)
                    st.transitions.append((ns, iof.read_float(stream, True)))
                entry.append(st)
            self.entries.append(entry)
        iof.expect_token(stream, True, "</Topology>")

    def _read_text(self, stream: BinaryIO) -> None:
        def tok():
            return iof.read_token(stream, False)

        while True:
            t = tok()
            if t == "</Topology>":
                return
            if t != "<TopologyEntry>":
                raise ValueError(f"expected <TopologyEntry>, got {t}")
            iof.expect_token(stream, False, "<ForPhones>")
            phones = []
            while (t := tok()) != "</ForPhones>":
                phones.append(int(t))
            entry: List[HmmState] = []
            t = tok()
            while t != "</TopologyEntry>":
                if t != "<State>":
                    raise ValueError(f"expected <State>, got {t}")
                if int(tok()) != len(entry):
                    raise ValueError("HMM states out of order")
                st = HmmState()
                t = tok()
                if t == "<PdfClass>":
                    st.forward_pdf_class = int(tok())
                    st.self_loop_pdf_class = st.forward_pdf_class
                    t = tok()
                elif t == "<ForwardPdfClass>":
                    st.forward_pdf_class = int(tok())
                    if tok() != "<SelfLoopPdfClass>":
                        raise ValueError("expected <SelfLoopPdfClass>")
                    st.self_loop_pdf_class = int(tok())
                    t = tok()
                while t == "<Transition>":
                    ns = int(tok())
                    st.transitions.append((ns, float(tok())))
                    t = tok()
                if t != "</State>":
                    raise ValueError(f"expected </State>, got {t}")
                entry.append(st)
                t = tok()
            self.entries.append(entry)
            for p in phones:
                self.phone2idx[p] = len(self.entries) - 1
