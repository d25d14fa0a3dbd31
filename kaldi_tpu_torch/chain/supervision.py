"""Chain supervision and denominator-graph construction (port of
`estimate_phone_lm`, `estimate_window_lm`, `_stationary_initial`,
`make_denominator_graph`,
`denominator_graph_from_phone_lm`, `alignment_to_phone_segments`,
`_chain_pdfs_for_phone`, `make_tolerance_supervision`,
`alignment_to_tolerance_numerator`, `union_graphs`,
`lattice_to_tolerance_numerator`, `transcript_to_e2e_numerator` and
`alignment_to_numerator_graph` of `kaldi_tpu/chain/supervision.py`).
Host-side numpy.

Parity: chain/chain-supervision.h (time-tolerant numerators from
alignments), chain/language-model.h (the phone LM), chain-den-graph.h:159
(the den graph: the phone LM expanded to an HMM acceptor over pdfs,
initial probs from the stationary distribution).
"""

from __future__ import annotations

import logging
import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.chain.graphs import (DenominatorGraph, PackedGraph,
                                          pack_emission_fst)
from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
from kaldi_tpu_torch.fstext.ops import rm_epsilon
from kaldi_tpu_torch.hmm.hmm_utils import expand_hmm
from kaldi_tpu_torch.hmm.transition_model import TransitionModel

_log = logging.getLogger(__name__)


def estimate_phone_lm(phone_seqs: Sequence[Sequence[int]],
                      phones: Sequence[int],
                      interp: float = 0.1) -> VectorFst:
    """Bigram phone LM as an acceptor (chain-est-phone-lm equivalent;
    bigram with unigram interpolation — dense over seen phones so the
    denominator stays compact)."""
    phones = sorted(set(phones))
    uni = Counter()
    bi: Dict[int, Counter] = defaultdict(Counter)
    end_count = Counter()
    start_count = Counter()
    n_seq = 0
    for seq in phone_seqs:
        if not seq:
            continue
        n_seq += 1
        start_count[seq[0]] += 1
        for p in seq:
            uni[p] += 1
        for a, b in zip(seq, seq[1:]):
            bi[a][b] += 1
        end_count[seq[-1]] += 1
    tot_uni = sum(uni.values())
    uni_p = {p: (uni[p] + 1.0) / (tot_uni + len(phones)) for p in phones}

    fst = VectorFst(TropicalWeight)
    start = fst.add_state()
    fst.set_start(start)
    state_of = {p: fst.add_state() for p in phones}

    # Above this size the dense interpolated form is intractable: at
    # ~10k context tokens (a vocabulary-scale ctx chain system,
    # recipes/chain.py train_chain_ctx) the dense bigram would emit
    # 1e8 arcs — and an epsilon-backoff state is no better, because
    # the denominator must be epsilon-free and rm_epsilon
    # re-materializes the dense product (measured: 148M arcs at 7.2k
    # tokens).  So past ~1k tokens (≈1M dense arcs) the sparse form
    # keeps ONLY the seen bigram successors, maximum-likelihood-
    # normalized per state: a pruned-support UN-SMOOTHED denominator —
    # exactly the reference's choice ("We don't do any smoothing",
    # chain/language-model.h:46; den fsts keep only seen histories).
    # Below the cutoff the smoothed dense form trains measurably
    # better on small corpora (test_bench_ctx_e2e fixture: 16.4% vs
    # 24.3% WER at acoustic scale 0.35).
    sparse = len(phones) > 1000
    _log.info("estimate_phone_lm: %d tokens, %s bigram", len(phones),
              "sparse unsmoothed" if sparse else "dense interpolated")

    def add_arcs(src: int, counts: Counter, total: float,
                 end_c: float = 0.0):
        total = total + end_c
        if sparse:
            for p, c in counts.items():
                fst.add_arc(src, Arc(p, p,
                                     -math.log(max(c / total, 1e-10)),
                                     state_of[p]))
            if total and end_c:
                fst.finals[src] = -math.log(max(end_c / total, 1e-10))
            elif not counts:
                # dead-end state: allow ending so the den acceptor
                # stays coaccessible
                fst.finals[src] = 0.0
            return
        for p in phones:
            prob = ((1 - interp) * counts.get(p, 0) / total
                    if total else 0.0) \
                + interp * uni_p[p]
            fst.add_arc(src, Arc(p, p, -math.log(max(prob, 1e-10)),
                                 state_of[p]))
        if total:
            fend = max(end_c / total, 1e-4)
        else:
            fend = 1e-4
        fst.finals[src] = -math.log(fend)

    add_arcs(start, start_count, float(n_seq))
    for p in phones:
        tot = float(sum(bi[p].values()))
        add_arcs(state_of[p], bi[p], tot, float(end_count[p]))
    # start state should not be final
    fst.finals[start] = TropicalWeight.zero
    return fst


def estimate_window_lm(window_seqs: Sequence[Sequence[tuple]],
                       interp: float = 0.1):
    """Denominator LM over CONTEXT WINDOWS with tied pair states —
    the scalable replacement for a token-level bigram when the token
    inventory is large (a vocabulary-scale ctx chain system has ~10k
    distinct triphone windows from only ~100k frames, so a bigram over
    *tokens* is hopelessly sparse; unsmoothed it makes the denominator
    miss realistic paths and LF-MMI collapses the AM to silence —
    measured: forcing it on the known-good V=30 fixture reproduces the
    scale failure bit-for-bit, WER 3.7% -> 96.8% with deletion-only
    output and a non-plateauing objective).

    Structure (the reference's chain den fst is the same object built
    by composition, chain-den-graph.cc + language-model.cc: a phone
    n-gram expanded through the context tree; here the windows ARE
    word-internal, so consecutive windows (l,c,r) -> (c,r,x) share
    (c,r), and word boundaries (r=0) pool into one boundary state):

      states:  B (word boundary / start) + {(c, r): r != 0}
      arcs:    B --(0,c,r)--> (c,r) or B;  (c,r) --(c,r,x)--> (r,x) or B
      weights: interpolated phone-space estimates — dense over the
               ~31-phone successor alphabet, independent of vocabulary.

    Every valid word-internal window path is in the support
    (numerator ⊆ denominator), the token arc count is
    O(num_phones^3), and the estimate is smoothed like the dense
    small-corpus path (interp to a marginal over the valid successor
    set).  Returns (fst, ilabel_info): an acceptor over 1-based window
    ids, ilabel_info[0] = ().
    """
    BOUND = ("B",)
    counts: Dict[object, Counter] = defaultdict(Counter)
    end_count = Counter()
    uni = Counter()
    phones = set()
    n_seq = 0
    for seq in window_seqs:
        if not seq:
            continue
        n_seq += 1
        state = BOUND
        for win in seq:
            win = tuple(win)
            counts[state][win] += 1
            uni[win] += 1
            c, r = win[-2], win[-1]
            phones.add(c)
            if r:
                phones.add(r)
            state = BOUND if r == 0 else (c, r)
        end_count[state] += 1
    phones.discard(0)
    ph = sorted(phones)
    ph0 = ph + [0]

    def succ(state):
        if state == BOUND:
            return [(0, c, r) for c in ph for r in ph0]
        c, r = state
        return [(c, r, x) for x in ph0]

    # full dense pair-state closure: every (c, r) over the phone set,
    # so every candidate arc has a real destination and the den
    # support is the complete word-internal window language
    pair_states = [(c, r) for c in ph for r in ph]
    tokens: List[tuple] = []
    seen_tok = set()
    for s in [BOUND] + pair_states:
        for t in succ(s):
            if t not in seen_tok:
                seen_tok.add(t)
                tokens.append(t)
    tok_id = {t: i + 1 for i, t in enumerate(tokens)}
    ilabel_info = [()] + tokens

    fst = VectorFst(TropicalWeight)
    state_ix = {BOUND: fst.add_state()}
    for s in pair_states:
        state_ix[s] = fst.add_state()
    fst.set_start(state_ix[BOUND])

    END = ("</s>",)
    for s in [BOUND] + pair_states:
        cand = succ(s)
        c_s = counts.get(s, Counter())
        tot = float(sum(c_s.values()) + end_count.get(s, 0))
        # backoff marginal over the valid successor set (+END), add-1
        q = np.asarray([uni[t] + 1.0 for t in cand] + [n_seq + 1.0])
        q = q / q.sum()
        for i, t in enumerate(cand):
            p = interp * q[i]
            if tot:
                p += (1 - interp) * c_s.get(t, 0) / tot
            c, r = t[-2], t[-1]
            dst = state_ix[BOUND] if r == 0 else state_ix.get((c, r))
            if dst is None:
                # unseen pair state: route its mass to the boundary
                # (keeps the graph over seen states only; the arc's
                # window still contributes its pdfs to the support)
                dst = state_ix[BOUND]
            fst.add_arc(state_ix[s],
                        Arc(tok_id[t], tok_id[t],
                            -math.log(max(p, 1e-10)), dst))
        p_end = interp * q[-1]
        if tot:
            p_end += (1 - interp) * end_count.get(s, 0) / tot
        fst.finals[state_ix[s]] = -math.log(max(p_end, 1e-10))
    _log.info("estimate_window_lm: %d states, %d window tokens, %d "
              "phones", len(pair_states) + 1, len(tokens), len(ph))
    return fst, ilabel_info


def _stationary_initial(pg: PackedGraph, iters: int = 100) -> np.ndarray:
    """Initial probs for the denominator = approximate stationary
    distribution of the transition structure (chain-den-graph.cc
    SetInitialProbs)."""
    S = pg.num_states
    probs = np.exp(np.maximum(pg.log_prob, -80))
    pi = np.exp(np.maximum(pg.initial, -80))
    if pi.sum() <= 0:
        pi = np.ones(S)
    pi = pi / pi.sum()
    for _ in range(iters):
        nxt = np.zeros(S)
        np.add.at(nxt, pg.dst, pi[pg.src] * probs)
        tot = nxt.sum()
        if tot <= 0:
            break
        pi = nxt / tot
    pi = np.maximum(pi, 1e-20)
    return np.log(pi).astype(np.float32)


def make_denominator_graph(phone_seqs: Sequence[Sequence[int]],
                           tm: TransitionModel, ctx_dep,
                           interp: float = 0.1) -> DenominatorGraph:
    """Phone LM -> HMM acceptor over pdfs -> packed arrays."""
    lm = estimate_phone_lm(phone_seqs, tm.get_phones(), interp)
    return denominator_graph_from_phone_lm(lm, tm, ctx_dep)


def denominator_graph_from_phone_lm(lm, tm: TransitionModel,
                                    ctx_dep,
                                    ilabel_info=None) -> DenominatorGraph:
    """Denominator graph from an existing phone-LM acceptor
    (chain-make-den-fst, chainbin/chain-make-den-fst.cc).  For
    context-dependent trees pass `ilabel_info` mapping LM ilabels to
    phone windows (the LM is then over context tokens, the CLG-level
    view of chain-den-graph.cc)."""
    # expand phones to HMMs with TRUE probabilities (scale 1/1)
    h = expand_hmm(lm, tm, ctx_dep, transition_scale=1.0,
                   self_loop_scale=1.0, ilabel_info=ilabel_info)
    # relabel transition-ids -> pdf+1 and strip output labels
    for arcs in h.arcs:
        for a in arcs:
            if a.ilabel != EPS:
                a.ilabel = int(tm.id2pdf_id[a.ilabel]) + 1
            a.olabel = a.ilabel
    h = rm_epsilon(h)
    # make all "phone boundary" structure final-free: the den graph in
    # the reference is an acceptor where ending anywhere is allowed via
    # final-probs; we keep the LM's final probs.
    pg = pack_emission_fst(h)
    pg.initial = _stationary_initial(pg)
    _log.info("denominator graph: %d states, %d arcs", pg.num_states,
              pg.num_arcs)
    return DenominatorGraph(pg)


def alignment_to_phone_segments(alignment: Sequence[int],
                                tm: TransitionModel
                                ) -> List[Tuple[int, int, int]]:
    """Frame-level transition-id alignment -> [(phone, start, end)),
    half-open at the alignment's frame rate."""
    segs: List[Tuple[int, int, int]] = []
    for t, tid in enumerate(alignment):
        phone = tm.transition_id_to_phone(tid)
        is_start = (tm.transition_id_to_hmm_state(tid) == 0
                    and not tm.is_self_loop(tid))
        if segs and segs[-1][0] == phone and not is_start:
            segs[-1] = (phone, segs[-1][1], t + 1)
        else:
            segs.append((phone, t, t + 1))
    return segs


def _chain_pdfs_for_phone(chain_tm: TransitionModel,
                          phone: int) -> Tuple[int, int]:
    """(forward_pdf, self_loop_pdf) of a phone in the chain topology."""
    for ts in range(1, chain_tm.num_transition_states + 1):
        if chain_tm.transition_state_to_phone(ts) != phone:
            continue
        fwd_pdf = self_pdf = None
        for idx in range(chain_tm.num_transition_indices(ts)):
            tid = chain_tm.pair_to_transition_id(ts, idx)
            pdf = int(chain_tm.id2pdf_id[tid])
            if chain_tm.is_self_loop(tid):
                self_pdf = pdf
            else:
                fwd_pdf = pdf
        if self_pdf is None:
            self_pdf = int(chain_tm.id2pdf_id[chain_tm.self_loop_of(ts)])
        return fwd_pdf, self_pdf
    raise ValueError(f"phone {phone} not in chain transition model")


def make_tolerance_supervision(segments: Sequence[Tuple[int, int, int]],
                               num_frames: int,
                               chain_tm: TransitionModel,
                               subsample: int = 3,
                               left_tolerance: int = 5,
                               right_tolerance: int = 5,
                               pdf_pairs: Optional[Sequence[
                                   Tuple[int, int]]] = None) -> PackedGraph:
    """Time-tolerant numerator (chain-supervision.cc
    AlignmentToProtoSupervision + TimeEnforcerFst, built directly as a
    packed DAG): each phone boundary may move within
    [-left_tolerance, +right_tolerance) input frames of its aligned
    position; every output frame emits exactly one pdf (forward pdf on
    the phone's first frame, self-loop pdf after), so the graph stays
    time-synchronous for the scan-based FB.

    States are (segment i, output frames consumed t); arcs consume one
    output frame each. Unweighted (the normalization-FST composition of
    the reference is folded into the denominator term)."""
    T_out = max(1, num_frames // subsample)
    N = len(segments)
    if N == 0:
        raise ValueError("empty supervision")
    lo = np.empty(N, np.int64)
    hi = np.empty(N, np.int64)
    for i, (_, s, e) in enumerate(segments):
        lo[i] = max(0, (s - left_tolerance) // subsample)
        hi[i] = min(T_out, -((e + right_tolerance) // -subsample))
    lo[0] = 0
    # monotonic feasibility: starts strictly increase; each segment and
    # all its successors must fit before T_out
    for i in range(1, N):
        lo[i] = max(lo[i], lo[i - 1] + 1)
    for i in range(N - 1, -1, -1):
        hi[i] = min(hi[i], T_out - (N - 1 - i))
        if i + 1 < N:
            hi[i] = min(hi[i], hi[i + 1] - 1 + 1)  # start_{i+1} < hi_{i+1}
    if np.any(lo >= hi):
        # degenerate window (very short segments / tight chunk): fall
        # back to the exact zero-tolerance boundaries
        pos = 0
        for i, (_, s, e) in enumerate(segments):
            lo[i] = max(pos, int(round(s / subsample)))
            pos = lo[i] + 1
        hi[:-1] = lo[1:]
        hi[-1] = T_out
        hi = np.maximum(hi, lo + 1)
        hi = np.minimum(hi, T_out)
        if np.any(lo >= hi):
            raise ValueError("infeasible supervision windows")
    # pdf_pairs: context-dependent (fwd_pdf, self_pdf) per segment
    # (the ctx-tree chain path passes window-computed pdfs; monophone
    # callers fall back to the per-phone lookup)
    pdfs = list(pdf_pairs) if pdf_pairs is not None else \
        [_chain_pdfs_for_phone(chain_tm, p) for p, _, _ in segments]

    # state ids: 0 = start; (i, t) for t in (lo[i], hi[i]] means "in
    # segment i, t output frames consumed"
    state_of: Dict[Tuple[int, int], int] = {}
    n_states = 1
    for i in range(N):
        for t in range(int(lo[i]) + 1, int(hi[i]) + 1):
            state_of[(i, t)] = n_states
            n_states += 1
    src: List[int] = []
    dst: List[int] = []
    pdf: List[int] = []
    if (0, 1) in state_of:
        src.append(0)
        dst.append(state_of[(0, 1)])
        pdf.append(pdfs[0][0])
    for (i, t), sid in state_of.items():
        if t < hi[i] and t < T_out:  # stay: self-loop pdf
            src.append(sid)
            dst.append(state_of[(i, t + 1)])
            pdf.append(pdfs[i][1])
        if (i + 1 < N and lo[i + 1] <= t < hi[i + 1] and t < T_out):
            src.append(sid)
            dst.append(state_of[(i + 1, t + 1)])
            pdf.append(pdfs[i + 1][0])
    ninf = np.float32(-1e30)
    final = np.full(n_states, ninf, np.float32)
    end_state = state_of.get((N - 1, T_out))
    if end_state is None:
        raise ValueError("tolerance supervision: final state unreachable")
    final[end_state] = 0.0
    # co-accessibility prune (keep arcs on paths reaching the end)
    src_a = np.asarray(src, np.int32)
    dst_a = np.asarray(dst, np.int32)
    pdf_a = np.asarray(pdf, np.int32)
    keep_state = np.zeros(n_states, bool)
    keep_state[end_state] = True
    changed = True
    while changed:
        live = keep_state[dst_a] & ~keep_state[src_a]
        changed = bool(live.any())
        keep_state[src_a[live]] = True
    keep_arc = keep_state[dst_a]
    initial = np.full(n_states, ninf, np.float32)
    initial[0] = 0.0
    return PackedGraph(src_a[keep_arc], dst_a[keep_arc], pdf_a[keep_arc],
                       np.zeros(int(keep_arc.sum()), np.float32),
                       initial, final)


def alignment_to_tolerance_numerator(alignment: Sequence[int],
                                     ali_tm: TransitionModel,
                                     chain_tm: TransitionModel,
                                     subsample: int = 3,
                                     left_tolerance: int = 5,
                                     right_tolerance: int = 5
                                     ) -> PackedGraph:
    """Frame-level alignment (in ali_tm's topology) -> time-tolerant
    chain numerator over chain_tm's pdfs."""
    segs = alignment_to_phone_segments(alignment, ali_tm)
    return make_tolerance_supervision(segs, len(alignment), chain_tm,
                                      subsample, left_tolerance,
                                      right_tolerance)


def union_graphs(graphs: Sequence[PackedGraph],
                 log_weights: Optional[Sequence[float]] = None
                 ) -> PackedGraph:
    """Union of numerator graphs (alternative supervision paths), with
    optional per-path initial log-weights (lattice posteriors)."""
    if len(graphs) == 1 and not log_weights:
        return graphs[0]
    offs = np.cumsum([0] + [g.num_states for g in graphs])
    if log_weights is None:
        log_weights = [0.0] * len(graphs)
    return PackedGraph(
        np.concatenate([g.src + offs[i] for i, g in enumerate(graphs)]),
        np.concatenate([g.dst + offs[i] for i, g in enumerate(graphs)]),
        np.concatenate([g.pdf for g in graphs]),
        np.concatenate([g.log_prob for g in graphs]),
        np.concatenate([g.initial + np.float32(log_weights[i])
                        for i, g in enumerate(graphs)]),
        np.concatenate([g.final for g in graphs]))


def lattice_to_tolerance_numerator(lat, ali_tm: TransitionModel,
                                   chain_tm: TransitionModel,
                                   subsample: int = 3,
                                   left_tolerance: int = 5,
                                   right_tolerance: int = 5,
                                   num_paths: int = 4,
                                   acoustic_scale: float = 0.1
                                   ) -> PackedGraph:
    """Lattice-derived chain supervision (chain-supervision.cc
    PhoneLatticeToProtoSupervision): the n best alignment paths of the
    lattice become alternative numerator paths, weighted by their
    normalized posteriors.  Paths with the same phone segments keep the
    cheaper one (the first on a tie), in the order the n-best list first
    reaches each segmentation."""
    from kaldi_tpu_torch.lat.functions import lattice_nbest, lattice_scale
    scaled = lattice_scale(lat, lm_scale=1.0, acoustic_scale=acoustic_scale)
    paths = lattice_nbest(scaled, num_paths)
    if not paths:
        raise ValueError("empty lattice")
    seen = {}
    for ali, _words, cost in paths:
        if not ali:
            continue
        segs = tuple(alignment_to_phone_segments(ali, ali_tm))
        if segs not in seen or cost < seen[segs][1]:
            seen[segs] = (ali, cost)
    graphs, costs = [], []
    for segs, (ali, cost) in seen.items():
        graphs.append(make_tolerance_supervision(
            list(segs), len(ali), chain_tm, subsample,
            left_tolerance, right_tolerance))
        costs.append(-cost)
    w = np.asarray(costs, np.float64)
    w = w - (np.max(w) + np.log(np.sum(np.exp(w - np.max(w)))))
    return union_graphs(graphs, list(w))


def transcript_to_e2e_numerator(phones: Sequence[int],
                                chain_tm: TransitionModel,
                                optional_sil: Optional[int] = None
                                ) -> PackedGraph:
    """Flat-start ('end2end' / e2e) numerator: the full chain-topology
    graph of the phone TRANSCRIPT with free durations — no alignment
    needed (chain-supervision.cc TrainingGraphToSupervisionE2e; the
    egs/wsj e2e flat-start recipes).  Each phone k contributes

        I_{k-1} --fwd_pdf(k)--> I_k --self_pdf(k)--> I_k (loop)

    and, when optional_sil is given, an optional silence may be
    traversed at every phone boundary (and utterance edges).  Arc
    log-probs are 0 (the reference normalizes its supervision FST;
    the constant offset does not affect gradients)."""
    phones = [int(p) for p in phones]
    K = len(phones)
    if K == 0:
        raise ValueError("transcript_to_e2e_numerator: empty transcript")
    pdfs = [_chain_pdfs_for_phone(chain_tm, p) for p in phones]
    sil = (_chain_pdfs_for_phone(chain_tm, optional_sil)
           if optional_sil is not None else None)
    # states: 0 = start, 1..K = I_k, then one sil state per boundary
    n_states = K + 1 + (K + 1 if sil else 0)
    sil0 = K + 1

    src: List[int] = []
    dst: List[int] = []
    pdf: List[int] = []

    def arc(s, d, p):
        src.append(s)
        dst.append(d)
        pdf.append(p)

    for k in range(K):
        fwd, slf = pdfs[k]
        arc(k, k + 1, fwd)          # enter phone k+1 (first frame)
        arc(k + 1, k + 1, slf)      # stay in it
        if sil:
            # boundary k silence: enterable from I_k, exits into
            # phone k+1
            arc(k, sil0 + k, sil[0])
            arc(sil0 + k, sil0 + k, sil[1])
            arc(sil0 + k, k + 1, fwd)
    if sil:                         # trailing silence after phone K
        arc(K, sil0 + K, sil[0])
        arc(sil0 + K, sil0 + K, sil[1])
    ninf = -1e30
    initial = np.full(n_states, ninf, np.float32)
    initial[0] = 0.0
    final = np.full(n_states, ninf, np.float32)
    final[K] = 0.0
    if sil:
        final[sil0 + K] = 0.0
    return PackedGraph(np.asarray(src, np.int32),
                       np.asarray(dst, np.int32),
                       np.asarray(pdf, np.int32),
                       np.zeros(len(src), np.float32), initial, final)


def alignment_to_numerator_graph(alignment: Sequence[int],
                                 tm: TransitionModel,
                                 subsample: int = 3) -> PackedGraph:
    """Exact linear numerator from a frame-level transition-id
    alignment, subsampled to the output frame rate: state t --pdf--> t+1
    for each output frame (chain supervision with zero tolerance)."""
    pdfs = tm.transition_ids_to_pdfs(alignment)
    sub = pdfs[subsample // 2::subsample]
    if len(sub) == 0:
        sub = pdfs[:1]
    T = len(sub)
    src = np.arange(T, dtype=np.int32)
    dst = src + 1
    ninf = -1e30
    initial = np.full(T + 1, ninf, np.float32)
    initial[0] = 0.0
    final = np.full(T + 1, ninf, np.float32)
    final[T] = 0.0
    return PackedGraph(src, dst, np.asarray(sub, np.int32),
                       np.zeros(T, np.float32), initial, final)
