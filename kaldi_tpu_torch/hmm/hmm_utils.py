"""H-level graph expansion (port of `expand_hmm` of
`kaldi_tpu/hmm/hmm_utils.py`; parity: hmm/hmm-utils.{h,cc}).

The reference builds an explicit H transducer (GetHTransducer), composes
Ha o CLG, determinizes, then runs AddSelfLoops (reorder=true,
hmm-utils.cc:472).  Here the composition and determinization are fused
into a direct arc expansion: every phone arc of CLG is replaced in place
by that phone's HMM without self-loops, one graph state per HMM
*transition*, so that each state has a unique incoming transition-state
class; the self-loop pass then applies the reorder=true weights:
outgoing arcs and finals of a state are scaled by the predecessor
state's non-self-loop probability and the self-loop arc is attached
(hmm-utils.cc:527-548).

`make_h_transducer` and `add_self_loops` are the by-hand mkgraph route
(`make-h-transducer`, `fsttablecompose`, ..., `add-self-loops`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.fstext.ops import connect
from kaldi_tpu_torch.hmm.topology import NO_PDF
from kaldi_tpu_torch.hmm.transition_model import TransitionModel


def _non_self_loop_log_prob(tm: TransitionModel, ts: int) -> float:
    sl = tm.self_loop_of(ts)
    if sl == 0:
        return 0.0
    p_self = math.exp(tm.get_transition_log_prob(sl))
    return math.log(max(1.0 - p_self, 1e-10))


def expand_hmm(clg: VectorFst, tm: TransitionModel, ctx_dep,
               transition_scale: float = 1.0,
               self_loop_scale: float = 0.1,
               disambig_syms: Sequence[int] = (),
               ilabel_info: Optional[List[Tuple[int, ...]]] = None
               ) -> VectorFst:
    """CLG -> HCLG with transition-ids on the input side, including
    self-loops. For monophone systems CLG ilabels are phone ids; for
    context-dependent systems pass `ilabel_info` mapping each CLG
    ilabel to its phone window (fstext/context-fst.h ilabel_info
    convention; entry 0 unused/eps).

    Returns a connected tropical FST ready for decoding/alignment."""
    disambig = set(disambig_syms)
    P = ctx_dep.central_position()
    out = VectorFst(TropicalWeight)
    out.add_states(clg.num_states)
    out.start = clg.start
    # state -> incoming transition-state class (0 = none/eps)
    state_class: Dict[int, int] = {}

    for s in range(clg.num_states):
        out.finals[s] = clg.finals[s]

    for s in range(clg.num_states):
        for arc in clg.arcs[s]:
            label = arc.ilabel
            if label == EPS or label in disambig:
                # pass through (disambig symbols are epsilon-like here)
                il = EPS if label in disambig else label
                out.add_arc(s, Arc(il, arc.olabel, arc.weight, arc.nextstate))
                continue
            window = (ilabel_info[label] if ilabel_info is not None
                      else (label,))
            phone = window[P]
            entry = tm.topo.topology_for_phone(phone)
            pdfs = [ctx_dep.compute(list(window), pc)
                    for pc in range(tm.topo.num_pdf_classes(phone))]
            # graph state per non-self-loop HMM transition (j -> k)
            trans_states: Dict[Tuple[int, int], int] = {}
            n_entry = len(entry)

            def tid_for(j: int, idx: int) -> Tuple[int, float]:
                st = entry[j]
                fwd_pdf = pdfs[st.forward_pdf_class]
                self_pdf = pdfs[st.self_loop_pdf_class]
                ts = tm.tuple_to_transition_state(phone, j, fwd_pdf, self_pdf)
                tid = tm.pair_to_transition_id(ts, idx)
                # renormalized: log p - log(1 - p_self)  (ignoring self-loops)
                lp = (tm.get_transition_log_prob(tid)
                      - _non_self_loop_log_prob(tm, ts))
                return tid, lp

            def graph_state(j: int, k: int) -> int:
                if (j, k) not in trans_states:
                    ns = out.add_state()
                    trans_states[(j, k)] = ns
                    st_j = entry[j]
                    fwd_pdf = pdfs[st_j.forward_pdf_class]
                    self_pdf = pdfs[st_j.self_loop_pdf_class]
                    state_class[ns] = tm.tuple_to_transition_state(
                        phone, j, fwd_pdf, self_pdf)
                return trans_states[(j, k)]

            # emit arcs: from src_graph_state representing "we are in hmm
            # state j" — j==0 means the CLG source state s itself
            def emit_from(j: int, src: int, first: bool):
                st = entry[j]
                for idx, (k, _prob) in enumerate(st.transitions):
                    if k == j:
                        continue  # self-loops added in second pass
                    tid, lp = tid_for(j, idx)
                    w = -transition_scale * lp
                    olabel = EPS
                    if first:
                        w = TropicalWeight.times(arc.weight, w)
                        olabel = arc.olabel
                    dest = graph_state(j, k)
                    out.add_arc(src, Arc(tid, olabel, w, dest))

            emit_from(0, s, True)
            # worklist over created (j, k) transition-states until all
            # downstream HMM transitions are expanded
            done = set()
            while True:
                pending = [key for key in trans_states if key not in done]
                if not pending:
                    break
                for (j, k) in pending:
                    done.add((j, k))
                    gs = trans_states[(j, k)]
                    if entry[k].forward_pdf_class == NO_PDF:
                        # final topo state: epsilon to the CLG destination
                        out.add_arc(gs, Arc(EPS, EPS, TropicalWeight.one,
                                            arc.nextstate))
                    else:
                        emit_from(k, gs, False)

    # --- self-loop pass (reorder=true semantics) ---------------------------
    for gs, ts in state_class.items():
        nsl = _non_self_loop_log_prob(tm, ts)
        corr = -self_loop_scale * nsl
        for a in out.arcs[gs]:
            a.weight = TropicalWeight.times(a.weight, corr)
        if out.finals[gs] != TropicalWeight.zero:
            out.finals[gs] = TropicalWeight.times(out.finals[gs], corr)
        sl = tm.self_loop_of(ts)
        if sl != 0:
            lp = tm.get_transition_log_prob(sl)
            out.add_arc(gs, Arc(sl, EPS, -self_loop_scale * lp, gs))

    return connect(out)


def make_h_transducer(ilabel_info: List[Tuple[int, ...]],
                      ctx_dep, tm: TransitionModel,
                      transition_scale: float = 1.0
                      ) -> Tuple[VectorFst, List[int]]:
    """Ha (hmm/hmm-utils.cc GetHTransducer): a one-loop-state
    transducer mapping transition-id sequences (self-loops EXCLUDED,
    probabilities renormalized by 1-p_self) to CLG ilabel-info
    indices.  Disambiguation entries (-sym,) pass through on fresh
    input ids past the transition-id range.  Returns (Ha,
    disambig_syms_left) — compose with CLG, optimize, then
    add_self_loops() for the full HCLG (mkgraph.sh's by-hand route)."""
    P = ctx_dep.central_position()
    out = VectorFst(TropicalWeight)
    loop = out.add_state()
    out.set_start(loop)
    out.set_final(loop, TropicalWeight.one)
    next_disambig = tm.num_transition_ids + 1
    disambig_out: List[int] = []
    for i, window in enumerate(ilabel_info):
        if len(window) == 0:
            continue
        if len(window) == 1 and window[0] < 0:    # disambig entry
            out.add_arc(loop, Arc(next_disambig, i, TropicalWeight.one,
                                  loop))
            disambig_out.append(next_disambig)
            next_disambig += 1
            continue
        phone = window[P]
        entry = tm.topo.topology_for_phone(phone)
        pdfs = [ctx_dep.compute(list(window), pc)
                for pc in range(tm.topo.num_pdf_classes(phone))]

        def tid_for(j: int, idx: int) -> Tuple[int, float]:
            st = entry[j]
            ts = tm.tuple_to_transition_state(
                phone, j, pdfs[st.forward_pdf_class],
                pdfs[st.self_loop_pdf_class])
            tid = tm.pair_to_transition_id(ts, idx)
            lp = (tm.get_transition_log_prob(tid)
                  - _non_self_loop_log_prob(tm, ts))
            return tid, lp

        # one fst state per HMM TRANSITION (j -> k), so every state
        # has a unique incoming transition-state class — the invariant
        # add_self_loops' reorder pass needs (the reference establishes
        # it with MakePrecedingInputSymbolsSameClass)
        trans_states: Dict[Tuple[int, int], int] = {}

        def emit_from(j: int, src: int, first: bool) -> List[Tuple]:
            created = []
            for idx, (k, _p) in enumerate(entry[j].transitions):
                if k == j:
                    continue               # self-loops come later
                tid, lp = tid_for(j, idx)
                # even the transition into the final topo state gets a
                # dedicated (j, k) state (with an eps exit to the
                # loop): the reorder self-loop of state j attaches at
                # its forward arc's DESTINATION, which must therefore
                # have a unique incoming transition-state class
                if (j, k) in trans_states:
                    dest = trans_states[(j, k)]
                else:
                    dest = out.add_state()
                    trans_states[(j, k)] = dest
                    created.append((j, k))
                out.add_arc(src, Arc(
                    tid, i if first else EPS,
                    -transition_scale * lp, dest))
            return created

        work = emit_from(0, loop, True)
        while work:
            (j, k) = work.pop()
            src = trans_states[(j, k)]
            if entry[k].forward_pdf_class == NO_PDF:
                out.add_arc(src, Arc(EPS, EPS, TropicalWeight.one,
                                     loop))
            else:
                work.extend(emit_from(k, src, False))
    return out, disambig_out


def add_self_loops(fst: VectorFst, tm: TransitionModel,
                   self_loop_scale: float = 0.1) -> VectorFst:
    """AddSelfLoops with reorder=true (hmm/hmm-utils.cc
    AddSelfLoopsReorder): each state's transition-state class is
    propagated from its incoming arcs' transition-ids; the
    renormalization 1-p_self is undone at self_loop_scale on the
    state's outgoing arcs and final weight, and the self-loop arc is
    attached AFTER the forward transition.

    A state whose incoming arcs carry more than one class (epsilon and
    disambiguation symbols are class 0, and so is the start state's
    implicit entry) is first split into one copy per class, as
    upstream's MakePrecedingInputSymbolsSameClass does: the state keeps
    its id for its least class, each other class gets a new state at
    the end with the same outgoing arcs and final weight, and the arcs
    of that class are pointed at it.  `fstminimizeencoded` merges such
    states in HCLGa.  The reference raises where two transition-states
    meet and gives every state the class of its transition-ids
    (ROADMAP.md section 3); where no state mixes classes the result is
    the reference's."""
    n_tids = tm.num_transition_ids

    def cls(label: int) -> int:
        if label == EPS or label > n_tids:
            return 0
        return tm.transition_id_to_transition_state(label)

    incoming: Dict[int, set] = {}
    if fst.start >= 0:
        incoming[fst.start] = {0}
    for s in range(fst.num_states):
        for a in fst.arcs[s]:
            incoming.setdefault(a.nextstate, set()).add(cls(a.ilabel))
    copy_of: Dict[Tuple[int, int], int] = {}
    state_class: Dict[int, int] = {}
    for s in sorted(incoming):
        classes = sorted(incoming[s])
        state_class[s] = classes[0]
        for c in classes[1:]:
            t = fst.add_state()
            fst.finals[t] = fst.finals[s]
            fst.arcs[t] = [Arc(a.ilabel, a.olabel, a.weight, a.nextstate)
                           for a in fst.arcs[s]]
            copy_of[(s, c)] = t
            state_class[t] = c
    if copy_of:
        for arcs in fst.arcs:
            for a in arcs:
                a.nextstate = copy_of.get((a.nextstate, cls(a.ilabel)),
                                          a.nextstate)
    for gs, ts in state_class.items():
        if ts == 0:
            continue
        sl = tm.self_loop_of(ts)
        if sl == 0:
            continue
        corr = -self_loop_scale * _non_self_loop_log_prob(tm, ts)
        for a in fst.arcs[gs]:
            a.weight = TropicalWeight.times(a.weight, corr)
        if fst.finals[gs] != TropicalWeight.zero:
            fst.finals[gs] = TropicalWeight.times(fst.finals[gs], corr)
        lp = tm.get_transition_log_prob(sl)
        fst.add_arc(gs, Arc(sl, EPS, -self_loop_scale * lp, gs))
    return fst
