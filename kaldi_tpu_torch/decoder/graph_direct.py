"""Direct vectorized construction of decoding graphs (HCLG) as flat
numpy arrays (numpy copy of `kaldi_tpu/decoder/graph_direct.py`:
`DirectGraphSpec`, `FlatGraph`, `synth_lexicon`, `synth_bigram`, the
phone-prefix trie and `build_direct_hclg`).  Same seeds, same draws, so
the port builds the same graphs as the reference.

`build_direct_hclg` builds an eps-free, reordered, self-loop-expanded
graph over 1-state chain-topology HMMs: the lexicon becomes a
phone-prefix trie whose word-final arc consumes the last phone and
carries the word label and the LM cost; the bigram is dense (backoff
folded in), so G needs no epsilon arcs; states are pairs (context u,
trie node n) and every arc carries -log(0.5).  pdf-ids mimic a
context-dependent tree by hashing (phone, trie node).

Not carried over yet: `to_dense_device_graph` (it needs
`decoder/dense_relax.py`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.fstext.fst import Arc, VectorFst

LN2 = float(np.log(2.0))
INF = np.float32(1e30)
_log = logging.getLogger(__name__)


@dataclass
class DirectGraphSpec:
    """Knobs for the synthetic-lexicon benchmark graph."""
    vocab: int = 700
    num_phones: int = 40
    min_pron: int = 3
    max_pron: int = 8
    num_pdfs: int = 3456
    eos_cost: float = 2.0          # -log P(</s> | u), flat
    bigram_range: Tuple[float, float] = (1.5, 12.0)
    seed: int = 0


@dataclass
class FlatGraph:
    """Eps-free decoding graph as flat arc arrays (CSR-packable).

    ilabel convention: 1-based transition-ids; tid2pdf maps them to
    pdf ids (rows of the acoustic output).  olabel 0 = eps."""
    src: np.ndarray        # (A,) int32
    dst: np.ndarray        # (A,) int32
    ilabel: np.ndarray     # (A,) int32  (tid, >=1)
    olabel: np.ndarray     # (A,) int32  (word id or 0)
    weight: np.ndarray     # (A,) float32
    finals: np.ndarray     # (S,) float32 (INF = non-final)
    start: int
    tid2pdf: np.ndarray    # (num_tids+1,) int32; [0] unused
    num_pdfs: int
    words: List[str]       # id -> word (index 0 = eps)

    @property
    def num_states(self) -> int:
        return len(self.finals)

    @property
    def num_arcs(self) -> int:
        return len(self.src)

    def to_vector_fst(self) -> VectorFst:
        """Small-graph escape hatch for cross-testing vs the host
        decoders (per-arc Python; do not call on million-state graphs)."""
        fst = VectorFst()
        for _ in range(self.num_states):
            fst.add_state()
        fst.start = self.start
        for i in range(self.num_arcs):
            fst.add_arc(int(self.src[i]),
                        Arc(int(self.ilabel[i]), int(self.olabel[i]),
                            float(self.weight[i]), int(self.dst[i])))
        for s in range(self.num_states):
            if self.finals[s] < INF / 2:
                fst.set_final(s, float(self.finals[s]))
        return fst


def synth_lexicon(spec: DirectGraphSpec) -> List[np.ndarray]:
    """Random pronunciations (unique per word), phone ids 1-based."""
    rng = np.random.default_rng(spec.seed)
    prons: List[np.ndarray] = []
    seen = set()
    while len(prons) < spec.vocab:
        k = int(rng.integers(spec.min_pron, spec.max_pron + 1))
        p = rng.integers(1, spec.num_phones + 1, size=k).astype(np.int32)
        key = tuple(p.tolist())
        if key in seen:
            continue
        seen.add(key)
        prons.append(p)
    return prons


def synth_bigram(spec: DirectGraphSpec) -> np.ndarray:
    """(V+1, V) costs -log P(w | u); row V is the sentence-begin
    context.  A densified backoff bigram: every transition exists."""
    rng = np.random.default_rng(spec.seed + 1)
    lo, hi = spec.bigram_range
    V = spec.vocab
    w = rng.uniform(lo, hi, size=(V + 1, V)).astype(np.float32)
    # make a few transitions per context clearly cheap (zipf-ish mass)
    hot = rng.integers(0, V, size=(V + 1, 8))
    rows = np.arange(V + 1)[:, None]
    w[rows, hot] = rng.uniform(lo, lo + 1.5, size=hot.shape)
    return w


class _Trie:
    """Phone-prefix trie over proper prefixes of the pronunciations."""

    def __init__(self, prons: Sequence[np.ndarray]):
        children: List[Dict[int, int]] = [{}]
        in_phone: List[int] = [0]          # 0 for root
        self.word_pre: List[int] = []      # node after len-1 prefix
        self.word_last: List[int] = []     # last phone of each word
        for p in prons:
            node = 0
            for ph in p[:-1]:
                nxt = children[node].get(int(ph))
                if nxt is None:
                    nxt = len(children)
                    children[node][int(ph)] = nxt
                    children.append({})
                    in_phone.append(int(ph))
                node = nxt
            self.word_pre.append(node)
            self.word_last.append(int(p[-1]))
        self.children = children
        self.in_phone = np.asarray(in_phone, np.int32)
        # flat edge arrays
        e_src, e_dst, e_ph = [], [], []
        for n, ch in enumerate(children):
            for ph, m in ch.items():
                e_src.append(n)
                e_dst.append(m)
                e_ph.append(ph)
        self.edge_src = np.asarray(e_src, np.int32)
        self.edge_dst = np.asarray(e_dst, np.int32)
        self.edge_phone = np.asarray(e_ph, np.int32)
        self.num_nodes = len(children)


def _pdf_hash(phone: np.ndarray, node: np.ndarray, num_pdfs: int,
              salt: int) -> np.ndarray:
    """Deterministic pseudo-tree pdf assignment for (phone, node)."""
    h = (np.asarray(phone, np.uint64) * np.uint64(2654435761)
         + np.asarray(node, np.uint64) * np.uint64(40503)
         + np.uint64(salt) * np.uint64(97))
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((h >> np.uint64(17)) % np.uint64(num_pdfs)).astype(np.int32)


def build_direct_hclg(spec: Optional[DirectGraphSpec] = None,
                      prons: Optional[Sequence[np.ndarray]] = None,
                      bigram: Optional[np.ndarray] = None) -> FlatGraph:
    """Build the eps-free reordered HCLG directly as flat arrays.

    States: idx(u, n) = u * N + n for u in 0..V (u=V is sentence
    begin), n a trie node; start = V*N + 0."""
    spec = spec or DirectGraphSpec()
    if prons is None:
        prons = synth_lexicon(spec)
    if bigram is None:
        bigram = synth_bigram(spec)
    V = len(prons)
    if bigram.shape != (V + 1, V):
        raise ValueError(f"bigram shape {bigram.shape} != ({V + 1}, {V})")
    trie = _Trie(prons)
    N = trie.num_nodes
    S = (V + 1) * N
    ctx = np.arange(V + 1, dtype=np.int64)

    # --- forward arcs --------------------------------------------------
    # interior trie arcs, replicated over every context u
    E = len(trie.edge_src)
    i_src = (ctx[:, None] * N + trie.edge_src[None, :]).reshape(-1)
    i_dst = (ctx[:, None] * N + trie.edge_dst[None, :]).reshape(-1)
    i_phone = np.broadcast_to(trie.edge_phone, (V + 1, E)).reshape(-1)
    # the forward pdf of an arc is determined by its DESTINATION state's
    # (phone, node) — one pdf per trie node, tree-like granularity
    i_pdf_node = np.broadcast_to(trie.edge_dst, (V + 1, E)).reshape(-1)
    i_weight = np.full(i_src.shape, LN2, np.float32)
    i_olabel = np.zeros(i_src.shape, np.int32)

    # word-final arcs: (u, pre_w) --last_phone(w)/w, LM cost--> (w, root)
    word_pre = np.asarray(trie.word_pre, np.int64)
    word_last = np.asarray(trie.word_last, np.int32)
    words = np.arange(V, dtype=np.int64)
    f_src = (ctx[:, None] * N + word_pre[None, :]).reshape(-1)
    f_dst = np.broadcast_to(words * N, (V + 1, V)).reshape(-1)  # (w, root)
    f_phone = np.broadcast_to(word_last, (V + 1, V)).reshape(-1)
    f_weight = (bigram.astype(np.float32) + LN2).reshape(-1)
    f_olabel = np.broadcast_to((words + 1).astype(np.int32),
                               (V + 1, V)).reshape(-1)
    # destination "node" for pdf purposes: word-end of w — give each
    # word-end its own pseudo tree leaf id N + w
    f_pdf_node = np.broadcast_to(N + words.astype(np.int32), (V + 1, V)
                                 ).reshape(-1)

    # --- self-loops (reordered): state (u, n) loops on its in-phone ----
    # in-phone of (u, n>0) = trie in_phone[n]; of (w, root) = last
    # phone of w; sentence-begin root (u=V, n=0) has none.
    loop_states_n = []     # state index
    loop_phone = []
    loop_pdf_node = []
    nz = np.nonzero(trie.in_phone > 0)[0]            # nodes with in-phone
    loop_states_n.append((ctx[:, None] * N + nz[None, :]).reshape(-1))
    loop_phone.append(np.broadcast_to(trie.in_phone[nz],
                                      (V + 1, len(nz))).reshape(-1))
    loop_pdf_node.append(np.broadcast_to(nz.astype(np.int32),
                                         (V + 1, len(nz))).reshape(-1))
    loop_states_n.append(words * N)                  # (w, root)
    loop_phone.append(word_last)
    loop_pdf_node.append(N + words.astype(np.int32))
    l_src = np.concatenate(loop_states_n)
    l_phone = np.concatenate(loop_phone).astype(np.int32)
    l_pdf_node = np.concatenate(loop_pdf_node)
    l_weight = np.full(l_src.shape, LN2, np.float32)

    # --- pdf / tid assignment -----------------------------------------
    num_pdfs = spec.num_pdfs
    fwd_pdf_i = _pdf_hash(i_phone, i_pdf_node, num_pdfs, salt=1)
    fwd_pdf_f = _pdf_hash(f_phone, f_pdf_node, num_pdfs, salt=1)
    self_pdf_l = _pdf_hash(l_phone, l_pdf_node, num_pdfs, salt=2)

    # transition-ids: forward tids = pdf+1, self-loop tids = num_pdfs+pdf+1
    # (a faithful TransitionModel numbering isn't needed for the device
    # graph; the tid->pdf map below is what decoding consumes)
    tid2pdf = np.concatenate([[0], np.arange(num_pdfs),
                              np.arange(num_pdfs)]).astype(np.int32)

    src = np.concatenate([i_src, f_src, l_src]).astype(np.int32)
    dst = np.concatenate([i_dst, f_dst, l_src]).astype(np.int32)
    ilabel = np.concatenate([fwd_pdf_i + 1, fwd_pdf_f + 1,
                             num_pdfs + self_pdf_l + 1]).astype(np.int32)
    olabel = np.concatenate([i_olabel, f_olabel,
                             np.zeros(l_src.shape, np.int32)])
    weight = np.concatenate([i_weight, f_weight, l_weight])

    finals = np.full(S, INF, np.float32)
    finals[words * N] = spec.eos_cost
    start = V * N + 0

    word_names = ["<eps>"] + [f"W{w:05d}" for w in range(V)]
    _log.info("build_direct_hclg: V=%d trie=%d -> %d states, %d arcs "
              "(%d interior x %d ctx, %d word-final, %d self-loops)",
              V, N, S, len(src), E, V + 1, V * (V + 1), len(l_src))
    return FlatGraph(src, dst, ilabel, olabel,
                     weight.astype(np.float32), finals, start,
                     tid2pdf, num_pdfs, word_names)
