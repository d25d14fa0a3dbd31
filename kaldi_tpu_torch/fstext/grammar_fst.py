"""GrammarFst: decode-time splicing of sub-graphs into a top-level
graph (port of `kaldi_tpu/fstext/grammar_fst.py`; parity:
decoder/grammar-fst.h:101 GrammarFstTpl and fstext/grammar-context-fst.h:69,
the nonterminal symbol encoding).

A top-level HCLG invokes sub-graphs through special ilabels that encode
(nonterminal, left-context phone) pairs; instances of the sub-FSTs are
made lazily as a decoder reaches the invocation points, so the composed
graph never exists whole.  States are 64-bit, (instance_id << 32) |
base_state, the reference's layout.  The decoder sees the duck-typed
surface of a VectorFst: `.start`, `.arcs[state]`, `.finals[state]`;
the port's host decoders (`decoder/lattice_decoder.py`,
`decoder/viterbi.py`) ask it only for the states their search reaches.

Symbol encoding (grammar-context-fst.h:85):
  label = kNontermBigNumber + nonterminal * encoding_multiple + phone
where encoding_multiple is the smallest multiple of 1000 strictly
greater than nonterm_phones_offset, and `nonterminal` is the id in
phones.txt (offset + kNontermBegin/End/Reenter/UserDefined...).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst

KALDI_GRAMMAR_FST_SPECIAL_WEIGHT = 4096.0

NONTERM_BOS = 0          # #nonterm_bos
NONTERM_BEGIN = 1        # #nonterm_begin
NONTERM_END = 2          # #nonterm_end
NONTERM_REENTER = 3      # #nonterm_reenter
NONTERM_USER_DEFINED = 4  # first user nonterminal (#nonterm:foo)
NONTERM_MEDIUM_NUMBER = 1000
NONTERM_BIG_NUMBER = 10000000


def get_encoding_multiple(nonterm_phones_offset: int) -> int:
    return NONTERM_MEDIUM_NUMBER * (
        nonterm_phones_offset // NONTERM_MEDIUM_NUMBER + 1)


def encode_symbol(nonterm_phones_offset: int, nonterminal: int,
                  phone: int) -> int:
    """ilabel for (nonterminal-id-in-phones.txt, left-context phone)."""
    mult = get_encoding_multiple(nonterm_phones_offset)
    return NONTERM_BIG_NUMBER + nonterminal * mult + phone


def decode_symbol(nonterm_phones_offset: int, label: int
                  ) -> Tuple[int, int]:
    mult = get_encoding_multiple(nonterm_phones_offset)
    rem = label - NONTERM_BIG_NUMBER
    return rem // mult, rem % mult


class _ExpandedState:
    __slots__ = ("dest_fst_instance", "arcs")

    def __init__(self, dest_fst_instance: int, arcs: List[Arc]):
        self.dest_fst_instance = dest_fst_instance
        self.arcs = arcs


class _FstInstance:
    __slots__ = ("ifst_index", "fst", "parent_instance", "parent_state",
                 "parent_reentry_arcs", "child_instances",
                 "expanded_states")

    def __init__(self, ifst_index: int, fst: VectorFst,
                 parent_instance: int, parent_state: int):
        self.ifst_index = ifst_index
        self.fst = fst
        self.parent_instance = parent_instance
        self.parent_state = parent_state
        self.parent_reentry_arcs: Dict[int, int] = {}
        self.child_instances: Dict[Tuple[int, int], int] = {}
        self.expanded_states: Dict[int, _ExpandedState] = {}


class _ArcsView:
    def __init__(self, gf: "GrammarFst"):
        self.gf = gf

    def __getitem__(self, state: int) -> List[Arc]:
        return self.gf._arcs_of(state)


class _FinalsView:
    def __init__(self, gf: "GrammarFst"):
        self.gf = gf

    def __getitem__(self, state: int):
        return self.gf._final_of(state)


class GrammarFst:
    """Lazily-spliced composite decoding graph (grammar-fst.h:101).

    top_fst: the top-level HCLG (instance 0).
    ifsts: list of (nonterminal_id, HCLG) pairs; nonterminal ids must
    be >= nonterm_phones_offset + NONTERM_USER_DEFINED.
    All FSTs must have been through `prepare_for_grammar_fst`."""

    def __init__(self, nonterm_phones_offset: int, top_fst: VectorFst,
                 ifsts: Sequence[Tuple[int, VectorFst]]):
        self.offset = nonterm_phones_offset
        self.top_fst = top_fst
        self.ifsts = list(ifsts)
        self.nonterminal_map: Dict[int, int] = {}
        for i, (nt, _f) in enumerate(self.ifsts):
            if nt in self.nonterminal_map:
                raise KaldiTpuError(f"nonterminal {nt} paired with two "
                                    "FSTs")
            if nt < self.offset + NONTERM_USER_DEFINED:
                raise KaldiTpuError(
                    f"nonterminal {nt} expected to be >= "
                    f"{self.offset + NONTERM_USER_DEFINED}")
            self.nonterminal_map[nt] = i
        self.entry_arcs: List[Dict[int, int]] = [
            {} for _ in self.ifsts]
        self.instances: List[_FstInstance] = [
            _FstInstance(-1, top_fst, -1, -1)]
        self.arcs = _ArcsView(self)
        self.finals = _FinalsView(self)

    # -- symbol helpers ----------------------------------------------
    def _phone_symbol_for(self, kind: int) -> int:
        return self.offset + kind

    # -- duck-typed FST surface --------------------------------------
    @property
    def start(self) -> int:
        return self.top_fst.start

    def _final_of(self, state: int):
        if state >> 32:
            return TropicalWeight.zero
        w = self.top_fst.finals[int(state)]
        if float(w) == KALDI_GRAMMAR_FST_SPECIAL_WEIGHT:
            return TropicalWeight.zero
        return w

    def _arcs_of(self, state: int) -> List[Arc]:
        instance_id = state >> 32
        base = state & 0xFFFFFFFF
        inst = self.instances[instance_id]
        fst = inst.fst
        if float(fst.finals[base]) != KALDI_GRAMMAR_FST_SPECIAL_WEIGHT:
            # normal state: rebase nextstates into this instance
            if instance_id == 0:
                return list(fst.arcs[base])
            hi = instance_id << 32
            return [Arc(a.ilabel, a.olabel, a.weight, hi | a.nextstate)
                    for a in fst.arcs[base]]
        es = inst.expanded_states.get(base)
        if es is None:
            es = self._expand_state(instance_id, base)
            inst.expanded_states[base] = es
        hi = es.dest_fst_instance << 32
        return [Arc(a.ilabel, a.olabel, a.weight, hi | a.nextstate)
                for a in es.arcs]

    # -- expansion ----------------------------------------------------
    def _init_entry_or_reentry_arcs(self, fst: VectorFst, entry_state: int,
                                    expected_nonterminal: int
                                    ) -> Dict[int, int]:
        phone_to_arc: Dict[int, int] = {}
        for idx, arc in enumerate(fst.arcs[entry_state]):
            if arc.ilabel <= NONTERM_BIG_NUMBER:
                raise KaldiTpuError(
                    "graph problem: expected only encoded-nonterminal "
                    "arcs here; did you run prepare_for_grammar_fst and "
                    "build the sub-graphs with #nonterm_begin/end?")
            nonterminal, phone = decode_symbol(self.offset, arc.ilabel)
            if nonterminal != expected_nonterminal:
                raise KaldiTpuError(
                    f"expected nonterminal {expected_nonterminal}, got "
                    f"{nonterminal}")
            if phone in phone_to_arc:
                raise KaldiTpuError("two arcs with the same left-context "
                                    "phone")
            phone_to_arc[phone] = idx
        return phone_to_arc

    def _init_entry_arcs(self, i: int) -> bool:
        fst = self.ifsts[i][1]
        if fst.num_states == 0:
            return False
        self.entry_arcs[i] = self._init_entry_or_reentry_arcs(
            fst, fst.start, self._phone_symbol_for(NONTERM_BEGIN))
        return True

    def _get_child_instance_id(self, instance_id: int, nonterminal: int,
                               state: int) -> int:
        key = (nonterminal, state)
        inst = self.instances[instance_id]
        child = inst.child_instances.get(key)
        if child is not None:
            return child
        child = len(self.instances)
        inst.child_instances[key] = child
        i = self.nonterminal_map.get(nonterminal)
        if i is None:
            raise KaldiTpuError(f"nonterminal {nonterminal} requested "
                                "but no FST provided for it")
        ci = _FstInstance(i, self.ifsts[i][1], instance_id, state)
        ci.parent_reentry_arcs = self._init_entry_or_reentry_arcs(
            inst.fst, state, self._phone_symbol_for(NONTERM_REENTER))
        self.instances.append(ci)
        return child

    @staticmethod
    def _combine_arcs(leaving: Arc, arriving: Arc,
                      cost_correction: float) -> Arc:
        if leaving.olabel != EPS:
            raise KaldiTpuError("leaving arc has nonzero olabel; run "
                                "prepare_for_grammar_fst")
        return Arc(EPS, arriving.olabel,
                   cost_correction + float(leaving.weight)
                   + float(arriving.weight), arriving.nextstate)

    def _expand_state(self, instance_id: int, state_id: int
                      ) -> _ExpandedState:
        fst = self.instances[instance_id].fst
        arcs0 = fst.arcs[state_id]
        if not arcs0 or arcs0[0].ilabel <= NONTERM_BIG_NUMBER:
            raise KaldiTpuError("state marked special has no encoded "
                                "arcs; did you run "
                                "prepare_for_grammar_fst?")
        nonterminal, _ = decode_symbol(self.offset, arcs0[0].ilabel)
        if nonterminal == self._phone_symbol_for(NONTERM_END):
            return self._expand_state_end(instance_id, state_id)
        if nonterminal >= self._phone_symbol_for(NONTERM_USER_DEFINED):
            return self._expand_state_user_defined(instance_id, state_id)
        raise KaldiTpuError(f"unexpected nonterminal {nonterminal} while "
                            "expanding state")

    def _expand_state_end(self, instance_id: int, state_id: int
                          ) -> _ExpandedState:
        if instance_id == 0:
            raise KaldiTpuError("#nonterm_end in FST-instance 0")
        inst = self.instances[instance_id]
        parent = self.instances[inst.parent_instance]
        parent_arcs = parent.fst.arcs[inst.parent_state]
        cost_correction = -math.log(max(len(inst.parent_reentry_arcs),
                                        1))
        arcs: List[Arc] = []
        for leaving in inst.fst.arcs[state_id]:
            nonterminal, phone = decode_symbol(self.offset,
                                               leaving.ilabel)
            if nonterminal != self._phone_symbol_for(NONTERM_END):
                raise KaldiTpuError(">1 nonterminals from a state; run "
                                    "prepare_for_grammar_fst")
            idx = inst.parent_reentry_arcs.get(phone)
            if idx is None:
                raise KaldiTpuError(
                    f"sub-FST ends with left-context phone {phone} but "
                    "the parent does not support it at the return point")
            arcs.append(self._combine_arcs(leaving, parent_arcs[idx],
                                           cost_correction))
        return _ExpandedState(inst.parent_instance, arcs)

    def _expand_state_user_defined(self, instance_id: int, state_id: int
                                   ) -> _ExpandedState:
        fst = self.instances[instance_id].fst
        dest = -1
        arcs: List[Arc] = []
        for leaving in fst.arcs[state_id]:
            nonterminal, phone = decode_symbol(self.offset,
                                               leaving.ilabel)
            child = self._get_child_instance_id(instance_id, nonterminal,
                                                leaving.nextstate)
            if dest < 0:
                dest = child
            elif dest != child:
                raise KaldiTpuError("one state leaves to different FST "
                                    "instances; run "
                                    "prepare_for_grammar_fst")
            ci = self.instances[child]
            if not self.entry_arcs[ci.ifst_index]:
                if not self._init_entry_arcs(ci.ifst_index):
                    continue        # empty sub-FST
            entry = self.entry_arcs[ci.ifst_index]
            cost_correction = -math.log(max(len(entry), 1))
            idx = entry.get(phone)
            if idx is None:
                raise KaldiTpuError(
                    f"FST for nonterminal {nonterminal} has no entry "
                    f"point for left-context phone {phone}")
            arriving = ci.fst.arcs[ci.fst.start][idx]
            arcs.append(self._combine_arcs(leaving, arriving,
                                           cost_correction))
        return _ExpandedState(dest, arcs)


def prepare_for_grammar_fst(fst: VectorFst,
                            nonterm_phones_offset: int) -> VectorFst:
    """In-place equivalent of PrepareForGrammarFst
    (decoder/grammar-fst.cc PrepareGrammarFst): establish the
    invariants the lazy expansion relies on —

      * any state with encoded-nonterminal ("special") arcs carries the
        sentinel final-weight 4096.0 and ONLY special arcs of one
        nonterminal kind, all leading to one destination instance;
        mixed states are split with an inserted epsilon state;
      * special arcs never carry olabels (an olabel is pushed onto an
        inserted epsilon arc before the invocation point).

    Returns `fst` (modified in place)."""
    mult = get_encoding_multiple(nonterm_phones_offset)
    del mult  # encoding consistency is the caller's concern here

    def is_special(a: Arc) -> bool:
        return a.ilabel > NONTERM_BIG_NUMBER

    def special_kind(a: Arc) -> int:
        nt, _ = decode_symbol(nonterm_phones_offset, a.ilabel)
        # user-defined nonterminals of different ids still go to
        # different instances; group by exact nonterminal
        return nt

    for s in range(fst.num_states):
        arcs = fst.arcs[s]
        # push olabels off special arcs via an inserted eps arc
        for i, a in enumerate(arcs):
            if is_special(a) and a.olabel != EPS:
                mid = fst.add_state()
                fst.arcs[mid] = [Arc(a.ilabel, EPS, 0.0, a.nextstate)]
                fst.finals[mid] = KALDI_GRAMMAR_FST_SPECIAL_WEIGHT
                arcs[i] = Arc(EPS, a.olabel, a.weight, mid)
    for s in range(fst.num_states):
        arcs = fst.arcs[s]
        special = [a for a in arcs if is_special(a)]
        if not special:
            continue
        normal = [a for a in arcs if not is_special(a)]
        kinds = {special_kind(a) for a in special}
        # states must be PURE: only special arcs, one nonterminal kind,
        # no real final-prob
        by_kind: Dict[int, List[Arc]] = {}
        for a in special:
            by_kind.setdefault(special_kind(a), []).append(a)
        has_real_final = (fst.finals[s] != TropicalWeight.zero
                          and float(fst.finals[s])
                          != KALDI_GRAMMAR_FST_SPECIAL_WEIGHT)
        if normal or len(kinds) > 1 or has_real_final:
            new_arcs = list(normal)
            for kind, group in by_kind.items():
                mid = fst.add_state()
                fst.arcs[mid] = list(group)
                fst.finals[mid] = KALDI_GRAMMAR_FST_SPECIAL_WEIGHT
                new_arcs.append(Arc(EPS, EPS, 0.0, mid))
            fst.arcs[s] = new_arcs
        else:
            fst.finals[s] = KALDI_GRAMMAR_FST_SPECIAL_WEIGHT
    return fst
