"""Incremental lattice determinization (port of
`kaldi_tpu/decoder/incremental.py`; parity:
decoder/lattice-incremental-decoder.h): instead of determinizing one
raw lattice after the last frame, the lattice is determinized chunk by
chunk while decoding and spliced onto a growing determinized prefix, so
the raw links never outgrow a chunk (`stats["max_chunk_links"]`).

The splice uses the reference's marker labels: each chunk is built with
an entry and an exit olabel per frontier token (above any word id,
`_LABEL_BASE`), determinized alone (lat/functions.py
`determinize_lattice`) -- the markers keep distinct frontier tokens
apart -- and attached to the prefix by redirecting the marker arcs; the
markers are erased from the output.

One rule is upstream's, not the reference's (a reference fault,
repaired): a frontier token enters the next chunk with its forward cost
(`fwd`), as upstream's LatticeIncrementalDecoder keeps its tokens'
costs, so the beam, max-active and the lattice beam measure a token
with its history.  The reference restarts every frontier token at cost
0 in each chunk (the spliced final weight carries the difference): a
token within the beam of the true best can then be cut because its
chunk-local cost trails one that entered the chunk worse, and the best
path is lost (tests/test_torch_incremental.py shows it on the JAX
package).  The costs inside the lattice are not changed, so where no
token or link is pruned the lattices are the reference's, byte for
byte.  Kept from the reference: at a chunk's end the frontier is the
tokens within the lattice beam of the best (upstream keeps every token
within the beam).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.base.logging import warn
from kaldi_tpu_torch.decoder.lattice_decoder import LatticeFasterDecoderOptions
from kaldi_tpu_torch.fstext.fst import (EPS, INF, Arc, LatticeWeight,
                                        TropicalWeight, VectorFst)
from kaldi_tpu_torch.lat.functions import determinize_lattice
from kaldi_tpu_torch.lat.kaldi_lattice import Lattice

_LABEL_BASE = 10 ** 7   # marker olabels live above any word id


class LatticeIncrementalDecoder:
    """Chunk-wise determinizing decoder over a (H)CLG graph with
    transition-ids on input labels and words on output labels."""

    def __init__(self, fst: VectorFst,
                 opts: Optional[LatticeFasterDecoderOptions] = None,
                 chunk_frames: int = 50):
        self.fst = fst
        self.opts = opts or LatticeFasterDecoderOptions()
        self.chunk_frames = int(chunk_frames)
        self.stats: Dict[str, int] = {}

    # -- core ------------------------------------------------------------

    def decode(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray,
               acoustic_scale: float = 1.0) -> Optional[Lattice]:
        fst = self.fst
        opts = self.opts
        T = loglikes.shape[0]
        self.stats = {"chunks": 0, "max_chunk_links": 0}

        # determinized prefix (lattice semiring). The frontier maps a
        # graph state to (entry_extra_cost, prefix_state): the extra
        # cost not yet represented inside the prefix (nonzero only for
        # the initial epsilon closure; word labels on initial epsilon
        # arcs are not representable and are dropped, as in a
        # start-state-reachable-by-eps corner of HCLG)
        prefix = VectorFst(LatticeWeight)
        start = prefix.add_state()
        prefix.set_start(start)
        cur: Dict[int, Tuple[float, int]] = {fst.start: (0.0, start)}
        cur = self._eps_closure_frontier(cur)
        # each frontier token's forward cost
        fwd = {s: c for s, (c, _) in cur.items()}

        t = 0
        while t < T:
            t1 = min(T, t + self.chunk_frames)
            res = self._decode_chunk(prefix, cur, fwd, loglikes[t:t1],
                                     tid_to_pdf, acoustic_scale,
                                     final=(t1 == T))
            if res is None:
                return None
            cur, fwd = res
            t = t1
        return self._as_lattice(prefix)

    def _eps_closure_frontier(self, tokens):
        """Epsilon closure over (extra_cost, prefix_state) tokens."""
        fst = self.fst
        out = dict(tokens)
        stack = list(tokens)
        while stack:
            s = stack.pop()
            c, entry = out[s]
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                nc = c + a.weight
                if nc < out.get(a.nextstate, (INF, -1))[0] - 1e-9:
                    out[a.nextstate] = (nc, entry)
                    stack.append(a.nextstate)
        return out

    def _decode_chunk(self, prefix, frontier, fwd, loglikes, tid_to_pdf,
                      acoustic_scale, final):
        """One chunk from `frontier` (state -> (extra cost, prefix
        state)) whose tokens start at their forward costs `fwd`; splices
        the chunk onto `prefix` -> (the next frontier, its forward
        costs), or None when the search dies."""
        fst = self.fst
        opts = self.opts
        C = loglikes.shape[0]
        links: List[Tuple] = []
        # chunk-local token passing over (frame, state) keys
        cost: Dict[Tuple[int, int], float] = {
            (0, s): fwd[s] for s in frontier}
        cur: Dict[int, float] = {s: fwd[s] for s in frontier}
        for t in range(C):
            frame = loglikes[t]
            best = min(cur.values())
            cutoff = best + opts.beam
            if len(cur) > opts.max_active:
                cs = sorted(cur.values())
                cutoff = min(cutoff, cs[opts.max_active - 1])
            nxt: Dict[int, float] = {}
            for s, c in cur.items():
                if c > cutoff:
                    continue
                for a in fst.arcs[s]:
                    if a.ilabel == EPS:
                        continue
                    ac = -acoustic_scale * float(frame[tid_to_pdf[a.ilabel]])
                    nc = c + a.weight + ac
                    links.append(((t, s), (t + 1, a.nextstate), a.ilabel,
                                  a.olabel, a.weight, ac))
                    if nc < nxt.get(a.nextstate, INF):
                        nxt[a.nextstate] = nc
            if not nxt:
                warn("incremental decode: no tokens survived")
                return None
            nbest = min(nxt.values())
            nxt = {s: c for s, c in nxt.items() if c <= nbest + opts.beam}
            # eps closure within frame t+1
            stack = list(nxt)
            while stack:
                s = stack.pop()
                c = nxt[s]
                for a in fst.arcs[s]:
                    if a.ilabel != EPS:
                        continue
                    nc = c + a.weight
                    links.append(((t + 1, s), (t + 1, a.nextstate), EPS,
                                  a.olabel, a.weight, 0.0))
                    if nc < nxt.get(a.nextstate, INF) - 1e-9:
                        nxt[a.nextstate] = nc
                        stack.append(a.nextstate)
            for s, c in nxt.items():
                k = (t + 1, s)
                if c < cost.get(k, INF):
                    cost[k] = c
            cur = nxt
        self.stats["max_chunk_links"] = max(self.stats["max_chunk_links"],
                                            len(links))
        self.stats["chunks"] += 1

        # lattice-beam backward pruning w.r.t. the chunk end
        if final:
            finals = {s: float(fst.finals[s]) for s in cur
                      if fst.finals[s] != TropicalWeight.zero}
            if not finals:
                finals = {s: 0.0 for s in cur}
        else:
            finals = {s: 0.0 for s in cur}
        back: Dict[Tuple[int, int], float] = {(C, s): fw
                                              for s, fw in finals.items()}
        for src, dst, il, ol, g, a in reversed(links):
            b = back.get(dst)
            if b is None:
                continue
            nb = b + g + a
            if nb < back.get(src, INF):
                back[src] = nb
        best_total = min((cost[(C, s)] + fw for s, fw in finals.items()
                          if (C, s) in cost), default=INF)
        if best_total >= INF / 2:
            return None
        keep = {k for k in cost if k in back
                and cost[k] + back[k] <= best_total + opts.lattice_beam}

        # build the chunk FST with entry/exit marker labels
        chunk = VectorFst(LatticeWeight)
        st = chunk.add_state()
        chunk.set_start(st)
        state_of: Dict[Tuple[int, int], int] = {}

        def get(k):
            if k not in state_of:
                state_of[k] = chunk.add_state()
            return state_of[k]

        entry_label = {}
        for i, s in enumerate(sorted(frontier)):
            k = (0, s)
            if k not in keep:
                continue
            lab = _LABEL_BASE + i
            entry_label[lab] = s
            # the entry arc carries the cost not yet inside the prefix
            chunk.add_arc(st, Arc(EPS, lab, (frontier[s][0], 0.0),
                                  get(k)))
        for (src, dst, il, ol, g, a) in links:
            if src in keep and dst in keep:
                chunk.add_arc(get(src), Arc(il, ol, (g, a), get(dst)))
        exit_label = {}
        exit_states = {}
        for i, (s, fw) in enumerate(sorted(finals.items())):
            k = (C, s)
            if k not in keep:
                continue
            if final:
                chunk.finals[get(k)] = (fw, 0.0)
            else:
                lab = _LABEL_BASE + 2 * 10 ** 6 + i
                exit_label[lab] = s
                e = chunk.add_state()
                chunk.add_arc(get(k), Arc(EPS, lab, (0.0, 0.0), e))
                chunk.finals[e] = (0.0, 0.0)

        det = determinize_lattice(chunk)

        # splice det chunk onto the prefix, erasing marker labels
        offset: Dict[int, int] = {}

        def pstate(s):
            if s not in offset:
                offset[s] = prefix.add_state()
            return offset[s]

        # determinization may spread an arc's transition-id string over
        # chain states, so the exit marker can sit mid-chain: identify
        # exits at the det FINAL states instead (the marker is the last
        # word of the path, so each final state belongs to exactly one
        # exit token — walk forward from each marker arc)
        final_exit: Dict[int, int] = {}   # det final state -> exit label
        if not final:
            for s in range(det.num_states):
                for a in det.arcs[s]:
                    if a.olabel not in exit_label:
                        continue
                    stack = [a.nextstate]
                    seen = set()
                    while stack:
                        q = stack.pop()
                        if q in seen:
                            continue
                        seen.add(q)
                        if det.finals[q] != LatticeWeight.zero:
                            final_exit[q] = a.olabel
                        for b in det.arcs[q]:
                            stack.append(b.nextstate)

        new_frontier: Dict[int, Tuple[float, int]] = {}
        new_fwd: Dict[int, float] = {}
        exit_dest: Dict[int, int] = {}   # exit label -> shared state
        for s in range(det.num_states):
            for a in det.arcs[s]:
                ol = EPS if a.olabel >= _LABEL_BASE else a.olabel
                if a.olabel in entry_label and s == det.start:
                    src_graph = entry_label[a.olabel]
                    p_from = frontier[src_graph][1]
                    prefix.add_arc(p_from, Arc(a.ilabel, EPS, a.weight,
                                               pstate(a.nextstate)))
                else:
                    prefix.add_arc(pstate(s), Arc(a.ilabel, ol, a.weight,
                                                  pstate(a.nextstate)))
            if det.finals[s] == LatticeWeight.zero:
                continue
            if final:
                prefix.finals[pstate(s)] = det.finals[s]
            else:
                lab = final_exit.get(s)
                if lab is None:
                    warn("incremental splice: final state with no exit "
                         "label; dropping")
                    continue
                g_state = exit_label[lab]
                if lab not in exit_dest:
                    exit_dest[lab] = prefix.add_state()
                    new_frontier[g_state] = (0.0, exit_dest[lab])
                    new_fwd[g_state] = cost[(C, g_state)]
                w = det.finals[s]
                prefix.add_arc(pstate(s), Arc(EPS, EPS, w,
                                              exit_dest[lab]))
        if final:
            return {}, {}
        if not new_frontier:
            warn("incremental decode: empty frontier after splice")
            return None
        return new_frontier, new_fwd

    def _as_lattice(self, prefix: VectorFst) -> Lattice:
        from kaldi_tpu_torch.fstext.ops import connect
        connect(prefix)
        return prefix
