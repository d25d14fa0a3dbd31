"""Context expansion: LG -> CLG (port of `kaldi_tpu/fstext/context.py`;
parity: fstext/context-fst.h:152 InverseContextFst + fstcomposecontext).
Host-side.

Direct deterministic construction: windows are emitted with a delay of
R = N-1-P phones so the right context is known when a window is output.
A state carries (lg_state, hist, pending) where hist is the last N-1
consumed phones (0-padded) and pending counts phones awaiting emission
(<= R). On consuming phone p with pending == R the oldest pending
phone's window is complete and equals hist + (p,); at final states the
remaining pending windows are flushed with right 0-padding.

Returns (clg, ilabel_info): ilabel_info[i] is the phone window of CLG
input label i (entry 0 = epsilon, the reference's ilabel_info
convention).  A disambiguation symbol d of `disambig_syms` gets the
entry (-d,), as upstream's context FST writes it at every width and as
`make_h_transducer` and `fstcomposecontext --write-disambig-syms` read
it: at N == 1 in place (label d keeps index d), at N > 1 after every
window, in the order of `disambig_syms`, and the CLG's disambiguation
arcs carry those indices.  The reference keeps `(d,)` at N == 1 and the
raw symbol d, which names a window, at N > 1 (ROADMAP.md section 3);
without `disambig_syms` the output is the reference's.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Tuple

from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst


def context_expand(lg: VectorFst, N: int = 3, P: int = 1,
                   disambig_syms: Sequence[int] = ()
                   ) -> Tuple[VectorFst, List[Tuple[int, ...]]]:
    if N == 1:
        max_l = 0
        for arcs in lg.arcs:
            for a in arcs:
                max_l = max(max_l, a.ilabel)
        dset = set(disambig_syms)
        info: List[Tuple[int, ...]] = [()] + [
            (-l,) if l in dset else (l,) for l in range(1, max_l + 1)]
        return lg, info
    R = N - 1 - P
    if R < 0:
        raise KaldiTpuError("central position beyond context width")
    disambig = set(disambig_syms)
    out = VectorFst(TropicalWeight)
    ilabel_info: List[Tuple[int, ...]] = [()]
    window_id: Dict[Tuple[int, ...], int] = {}

    def get_label(window: Tuple[int, ...]) -> int:
        if window not in window_id:
            ilabel_info.append(window)
            window_id[window] = len(ilabel_info) - 1
        return window_id[window]

    Key = Tuple[int, Tuple[int, ...], int]
    state_map: Dict[Key, int] = {}
    work: deque = deque()

    def get_state(key: Key) -> int:
        if key not in state_map:
            state_map[key] = out.add_state()
            work.append(key)
        return state_map[key]

    disambig_arcs: List[Arc] = []
    start_key = (lg.start, (0,) * (N - 1), 0)
    out.set_start(get_state(start_key))

    while work:
        key = work.popleft()
        s, hist, pending = key
        cur = state_map[key]
        if lg.finals[s] != TropicalWeight.zero:
            if pending == 0:
                out.finals[cur] = lg.finals[s]
            else:
                prev = cur
                h = hist
                for i in range(pending):
                    lbl = get_label(h + (0,))
                    nxt = out.add_state()
                    wgt = lg.finals[s] if i == 0 else TropicalWeight.one
                    out.add_arc(prev, Arc(lbl, EPS, wgt, nxt))
                    prev = nxt
                    h = h[1:] + (0,)
                out.finals[prev] = TropicalWeight.one
        for a in lg.arcs[s]:
            if a.ilabel == EPS or a.ilabel in disambig:
                ns = get_state((a.nextstate, hist, pending))
                out.add_arc(cur, Arc(a.ilabel, a.olabel, a.weight, ns))
                if a.ilabel != EPS:
                    disambig_arcs.append(out.arcs[cur][-1])
                continue
            p = a.ilabel
            new_hist = hist[1:] + (p,)
            if pending < R:
                ns = get_state((a.nextstate, new_hist, pending + 1))
                out.add_arc(cur, Arc(EPS, a.olabel, a.weight, ns))
            else:
                lbl = get_label(hist + (p,))
                ns = get_state((a.nextstate, new_hist, pending))
                out.add_arc(cur, Arc(lbl, a.olabel, a.weight, ns))
    index = {}
    for d in dict.fromkeys(disambig_syms):
        index[d] = len(ilabel_info)
        ilabel_info.append((-d,))
    for a in disambig_arcs:
        a.ilabel = index[a.ilabel]
    return out, ilabel_info
