"""WFST algorithms on the VectorFst core: `connect` (the one function of
`kaldi_tpu/fstext/ops.py` that lattice assembly needs).  Host-side."""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.fstext.fst import Arc, VectorFst


def connect(fst: VectorFst) -> VectorFst:
    """Trim states not both accessible and co-accessible (in place)."""
    n = fst.num_states
    if fst.start < 0:
        return fst
    # forward reachability
    acc = [False] * n
    stack = [fst.start]
    acc[fst.start] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs[s]:
            if not acc[a.nextstate]:
                acc[a.nextstate] = True
                stack.append(a.nextstate)
    # backward from finals
    preds: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            preds[a.nextstate].append(s)
    coacc = [False] * n
    stack = [s for s in range(n) if fst.is_final(s)]
    for s in stack:
        coacc[s] = True
    while stack:
        s = stack.pop()
        for p in preds[s]:
            if not coacc[p]:
                coacc[p] = True
                stack.append(p)
    keep = [s for s in range(n) if acc[s] and coacc[s]]
    remap = {s: i for i, s in enumerate(keep)}
    new_arcs = []
    new_finals = []
    for s in keep:
        new_arcs.append([Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate])
                         for a in fst.arcs[s] if a.nextstate in remap])
        new_finals.append(fst.finals[s])
    fst.arcs = new_arcs
    fst.finals = new_finals
    fst.start = remap.get(fst.start, -1)
    return fst
