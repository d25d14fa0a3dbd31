"""Transition model (port of the construction from a topology and a
tree, the reader and writer, the queries and `mle_update` of
`kaldi_tpu/hmm/transition_model.py`; parity: hmm/transition-model.h:124).

Maps between transition-ids, transition-states, tuples
(phone, hmm_state, forward_pdf, self_loop_pdf) and pdf-ids, and holds
the transition log-probs: built from an HmmTopology and a tree
(`TransitionModel(topo, ctx_dep)`, the topology's probabilities), or
read from and written to a `final.mdl`-style file (<TransitionModel>
topo <Triples>/<Tuples> ... <LogProbs> ...).
"""

from __future__ import annotations

import bisect
import math
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.hmm.topology import NO_PDF, HmmTopology


class TransitionModel:
    def __init__(self, topo: Optional[HmmTopology] = None, ctx_dep=None):
        self.topo = topo
        self.tuples: List[Tuple[int, int, int, int]] = []
        self.log_probs = np.zeros(1, dtype=np.float32)  # 1-based
        if topo is not None and ctx_dep is not None:
            self._compute_tuples(ctx_dep)
            self._compute_derived()
            self._initialize_probs()

    def _compute_tuples(self, ctx_dep) -> None:
        """The (phone, hmm_state, fwd_pdf, self_pdf) tuples the tree can
        give each emitting state (transition-model.cc:27), sorted."""
        tuples = set()
        for phone in self.topo.phones:
            for j, st in enumerate(self.topo.topology_for_phone(phone)):
                if st.forward_pdf_class == NO_PDF:
                    continue
                for pdf in ctx_dep.pdfs_for(phone, st.forward_pdf_class):
                    if st.self_loop_pdf_class != st.forward_pdf_class:
                        for sp in ctx_dep.pdfs_for(phone,
                                                   st.self_loop_pdf_class):
                            tuples.add((phone, j, pdf, sp))
                    else:
                        tuples.add((phone, j, pdf, pdf))
        self.tuples = sorted(tuples)

    def _initialize_probs(self) -> None:
        """Log-probs from the topology's transition probabilities."""
        nid = self.num_transition_ids
        self.log_probs = np.zeros(nid + 1, dtype=np.float32)
        for tid in range(1, nid + 1):
            ts = self.id2state[tid]
            idx = tid - self.state2id[ts]
            phone, hmm_state, _, _ = self.tuples[ts - 1]
            prob = self.topo.topology_for_phone(
                phone)[hmm_state].transitions[idx][1]
            if prob <= 0.0:
                raise ValueError("zero transition probability in topology")
            self.log_probs[tid] = math.log(prob)

    def _compute_derived(self) -> None:
        """transition-state and transition-id tables and the pdf count
        (transition-model.cc:144)."""
        n = len(self.tuples)
        self.state2id = np.zeros(n + 2, dtype=np.int32)
        cur = 1
        self.num_pdfs = 0
        for ts in range(1, n + 2):
            self.state2id[ts] = cur
            if ts <= n:
                phone, hmm_state, fwd, slf = self.tuples[ts - 1]
                self.num_pdfs = max(self.num_pdfs, fwd + 1, slf + 1)
                entry = self.topo.topology_for_phone(phone)
                cur += len(entry[hmm_state].transitions)
        self.id2state = np.zeros(cur, dtype=np.int32)
        self.id2pdf_id = np.zeros(cur, dtype=np.int32)
        for ts in range(1, n + 1):
            for tid in range(self.state2id[ts], self.state2id[ts + 1]):
                self.id2state[tid] = ts
                self.id2pdf_id[tid] = (self.tuples[ts - 1][3]
                                       if self.is_self_loop(tid)
                                       else self.tuples[ts - 1][2])

    # -- queries ------------------------------------------------------------
    @property
    def num_transition_ids(self) -> int:
        return len(self.id2state) - 1

    @property
    def num_transition_states(self) -> int:
        return len(self.tuples)

    def transition_id_to_transition_state(self, tid: int) -> int:
        return int(self.id2state[tid])

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.id2pdf_id[tid])

    def transition_ids_to_pdfs(self, tids) -> np.ndarray:
        return self.id2pdf_id[np.asarray(tids, dtype=np.int64)]

    def transition_id_to_phone(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1][0]

    def transition_id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1][1]

    def transition_state_to_phone(self, ts: int) -> int:
        return self.tuples[ts - 1][0]

    def tuple_to_transition_state(self, phone, hmm_state, pdf,
                                  self_pdf) -> int:
        t = (phone, hmm_state, pdf, self_pdf)
        i = bisect.bisect_left(self.tuples, t)
        if i >= len(self.tuples) or self.tuples[i] != t:
            raise ValueError(f"no transition state for tuple {t}")
        return i + 1

    def pair_to_transition_id(self, trans_state: int,
                              trans_index: int) -> int:
        return int(self.state2id[trans_state]) + trans_index

    def num_transition_indices(self, trans_state: int) -> int:
        return int(self.state2id[trans_state + 1]
                   - self.state2id[trans_state])

    def is_self_loop(self, tid: int) -> bool:
        ts = self.id2state[tid]
        idx = tid - self.state2id[ts]
        phone, hmm_state, _, _ = self.tuples[ts - 1]
        trans = self.topo.topology_for_phone(phone)[hmm_state].transitions
        return idx < len(trans) and trans[idx][0] == hmm_state

    def get_transition_log_prob(self, tid: int) -> float:
        return float(self.log_probs[tid])

    def self_loop_of(self, trans_state: int) -> int:
        """Transition-id of this state's self-loop, or 0."""
        phone, hmm_state, _, _ = self.tuples[trans_state - 1]
        trans = self.topo.topology_for_phone(phone)[hmm_state].transitions
        for idx, (dest, _) in enumerate(trans):
            if dest == hmm_state:
                return self.pair_to_transition_id(trans_state, idx)
        return 0

    def get_phones(self) -> List[int]:
        return self.topo.phones

    def mle_update(self, stats: np.ndarray, floor: float = 0.01,
                   min_count: float = 5.0) -> Tuple[float, float]:
        """stats: counts indexed by transition-id (1-based array of size
        num_transition_ids+1).  Returns (objf_impr_per_frame, count)."""
        objf_impr = 0.0
        count = 0.0
        for ts in range(1, self.num_transition_states + 1):
            lo, hi = self.state2id[ts], self.state2id[ts + 1]
            counts = stats[lo:hi].astype(np.float64)
            tot = counts.sum()
            if tot < min_count:
                continue
            old_lp = self.log_probs[lo:hi].astype(np.float64)
            new_p = counts / tot
            new_p = np.maximum(new_p, floor)
            new_p /= new_p.sum()
            new_lp = np.log(new_p)
            objf_impr += float((counts * (new_lp - old_lp)).sum())
            count += tot
            self.log_probs[lo:hi] = new_lp.astype(np.float32)
        return (objf_impr / max(count, 1.0), count)

    # -- I/O ----------------------------------------------------------------
    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        is_hmm = self.topo.is_hmm()

        def newline():
            if not binary:
                stream.write(b"\n")

        iof.write_token(stream, binary, "<TransitionModel>")
        newline()
        self.topo.write(stream, binary)
        iof.write_token(stream, binary, "<Triples>" if is_hmm else "<Tuples>")
        iof.write_int32(stream, binary, len(self.tuples))
        newline()
        for phone, hmm_state, fwd, slf in self.tuples:
            iof.write_int32(stream, binary, phone)
            iof.write_int32(stream, binary, hmm_state)
            iof.write_int32(stream, binary, fwd)
            if not is_hmm:
                iof.write_int32(stream, binary, slf)
            newline()
        iof.write_token(stream, binary,
                        "</Triples>" if is_hmm else "</Tuples>")
        newline()
        iof.write_token(stream, binary, "<LogProbs>")
        newline()
        iof.write_vector(stream, binary, self.log_probs)
        iof.write_token(stream, binary, "</LogProbs>")
        newline()
        iof.write_token(stream, binary, "</TransitionModel>")
        newline()

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "TransitionModel":
        tm = cls()
        iof.expect_token(stream, binary, "<TransitionModel>")
        tm.topo = HmmTopology.read(stream, binary)
        token = iof.read_token(stream, binary)
        if token not in ("<Triples>", "<Tuples>"):
            raise ValueError(f"expected <Triples>/<Tuples>, got {token}")
        tuples = []
        for _ in range(iof.read_int32(stream, binary)):
            phone = iof.read_int32(stream, binary)
            hmm_state = iof.read_int32(stream, binary)
            fwd = iof.read_int32(stream, binary)
            slf = (iof.read_int32(stream, binary)
                   if token == "<Tuples>" else fwd)
            tuples.append((phone, hmm_state, fwd, slf))
        tm.tuples = tuples
        end = iof.read_token(stream, binary)
        if end not in ("</Triples>", "</Tuples>"):
            raise ValueError(f"expected </Triples>/</Tuples>, got {end}")
        tm._compute_derived()
        iof.expect_token(stream, binary, "<LogProbs>")
        tm.log_probs = iof.read_vector(stream, binary).astype(np.float32)
        iof.expect_token(stream, binary, "</LogProbs>")
        iof.expect_token(stream, binary, "</TransitionModel>")
        return tm
