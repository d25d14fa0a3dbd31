"""Training examples (egs) pipeline (port of `kaldi_tpu/nnet3/egs.py`;
parity: nnet3/nnet-example.h:111
NnetExample / nnet-chain-example.h:111 NnetChainExample + the
get/shuffle/merge-egs binaries and steps/*/get_egs.sh archive flow).

An example holds fixed-size feature chunks plus supervision (pdf
targets or a packed chain numerator graph). Examples serialize into
ark archives via the table system, shuffle on disk, merge into
minibatches, and stream into training — the same disk-mediated
pipeline the reference uses, with the merged minibatch shaped for one
device step.  Archives are byte for byte the JAX package's, the
discriminative examples' (`NnetDiscriminativeExample`: features, a
numerator alignment and a denominator lattice) included."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.chain.graphs import PackedGraph, batch_pack
from kaldi_tpu_torch.util.table import (Holder, SequentialTableReader,
                                        TableWriter)


@dataclass
class NnetChainExample:
    feats: np.ndarray                   # (T, D) float32
    num_graph: PackedGraph              # numerator supervision
    left_context: int = 0
    right_context: int = 0

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<Cegs>")
        iof.write_matrix(stream, binary, self.feats)
        g = self.num_graph
        iof.write_int32(stream, binary, g.num_states)
        iof.write_int_vector(stream, binary, g.src.tolist())
        iof.write_int_vector(stream, binary, g.dst.tolist())
        iof.write_int_vector(stream, binary, g.pdf.tolist())
        iof.write_vector(stream, binary, g.log_prob)
        iof.write_vector(stream, binary, g.initial)
        iof.write_vector(stream, binary, g.final)
        iof.write_int32(stream, binary, self.left_context)
        iof.write_int32(stream, binary, self.right_context)
        iof.write_token(stream, binary, "</Cegs>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "NnetChainExample":
        iof.expect_token(stream, binary, "<Cegs>")
        feats = iof.read_matrix(stream, binary)
        num_states = iof.read_int32(stream, binary)
        src = np.array(iof.read_int_vector(stream, binary), np.int32)
        dst = np.array(iof.read_int_vector(stream, binary), np.int32)
        pdf = np.array(iof.read_int_vector(stream, binary), np.int32)
        lp = iof.read_vector(stream, binary).astype(np.float32)
        initial = iof.read_vector(stream, binary).astype(np.float32)
        final = iof.read_vector(stream, binary).astype(np.float32)
        left = iof.read_int32(stream, binary)
        right = iof.read_int32(stream, binary)
        iof.expect_token(stream, binary, "</Cegs>")
        return cls(feats, PackedGraph(src, dst, pdf, lp, initial, final),
                   left, right)


class ChainExampleHolder(Holder):
    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return NnetChainExample.read(stream, binary)

    def write(self, stream, binary, value):
        value.write(stream, binary)


def generate_chain_egs(feats: Dict[str, np.ndarray],
                       alignments: Dict[str, List[int]], tm,
                       wspecifier: str, chunk_width: int = 140,
                       subsample: int = 3,
                       left_context: int = 13,
                       right_context: int = 13) -> int:
    """nnet3-chain-get-egs: cut utterances into fixed chunks with
    context and linear numerators from alignments."""
    from kaldi_tpu_torch.chain.supervision import alignment_to_numerator_graph
    n = 0
    with TableWriter(ChainExampleHolder(), wspecifier) as w:
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            ali = alignments[utt]
            T = min(f.shape[0], len(ali))
            for start in range(0, T - chunk_width + 1, chunk_width):
                lo = max(0, start - left_context)
                hi = min(T, start + chunk_width + right_context)
                chunk_feats = f[lo:hi]
                chunk_ali = ali[start:start + chunk_width]
                g = alignment_to_numerator_graph(chunk_ali, tm, subsample)
                w.write(f"{utt}-{start}",
                        NnetChainExample(chunk_feats, g,
                                         start - lo, hi - start - chunk_width))
                n += 1
    return n


def generate_chain_e2e_egs(feats: Dict[str, np.ndarray],
                           transcripts: Dict[str, List[int]], tm,
                           wspecifier: str,
                           optional_sil: Optional[int] = None,
                           left_context: int = 13,
                           right_context: int = 13) -> int:
    """nnet3-chain-e2e-get-egs: flat-start chain examples — one whole-
    utterance example per utterance, numerator = full transcript graph
    with free phone durations (no alignment; chain-supervision.cc
    TrainingGraphToSupervisionE2e)."""
    from kaldi_tpu_torch.chain.supervision import transcript_to_e2e_numerator
    n = 0
    with TableWriter(ChainExampleHolder(), wspecifier) as w:
        for utt, f in feats.items():
            if utt not in transcripts or not len(transcripts[utt]):
                continue
            g = transcript_to_e2e_numerator(transcripts[utt], tm,
                                            optional_sil=optional_sil)
            w.write(utt, NnetChainExample(np.asarray(f), g, 0, 0))
            n += 1
    return n


def write_packed_graph(stream, binary, g: PackedGraph) -> None:
    iof.write_token(stream, binary, "<Sup>")
    iof.write_int32(stream, binary, g.num_states)
    iof.write_int_vector(stream, binary, g.src.tolist())
    iof.write_int_vector(stream, binary, g.dst.tolist())
    iof.write_int_vector(stream, binary, g.pdf.tolist())
    iof.write_vector(stream, binary, g.log_prob)
    iof.write_vector(stream, binary, g.initial)
    iof.write_vector(stream, binary, g.final)
    iof.write_token(stream, binary, "</Sup>")


def read_packed_graph(stream, binary) -> PackedGraph:
    iof.expect_token(stream, binary, "<Sup>")
    iof.read_int32(stream, binary)      # num_states (implied by initial)
    src = np.array(iof.read_int_vector(stream, binary), np.int32)
    dst = np.array(iof.read_int_vector(stream, binary), np.int32)
    pdf = np.array(iof.read_int_vector(stream, binary), np.int32)
    lp = iof.read_vector(stream, binary).astype(np.float32)
    initial = iof.read_vector(stream, binary).astype(np.float32)
    final = iof.read_vector(stream, binary).astype(np.float32)
    iof.expect_token(stream, binary, "</Sup>")
    return PackedGraph(src, dst, pdf, lp, initial, final)


class SupervisionHolder(Holder):
    """Archive holder for bare chain supervision graphs
    (chain-get-supervision output; nnet-chain-example.h supervision)."""
    binary_container = True

    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return read_packed_graph(stream, binary)

    def write(self, stream, binary, value):
        write_packed_graph(stream, binary, value)


class NnetExample:
    """Plain (non-chain) frame-supervised example (nnet3/nnet-example.h
    NnetExample): feature rows + per-frame sparse posterior targets.
    A merged minibatch concatenates rows and records `batch` (the
    reference's multiple-n indexes)."""

    def __init__(self, feats: np.ndarray, targets, left_context: int = 0,
                 right_context: int = 0, batch: int = 1):
        self.feats = np.asarray(feats, np.float32)
        self.targets = targets      # list per row of [(pdf, weight)]
        self.left_context = int(left_context)
        self.right_context = int(right_context)
        self.batch = int(batch)

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        iof.write_token(stream, binary, "<Egs>")
        iof.write_matrix(stream, binary, self.feats)
        iof.write_int32(stream, binary, len(self.targets))
        for frame in self.targets:
            iof.write_int_vector(stream, binary,
                                 [p for p, _ in frame])
            iof.write_vector(
                stream, binary,
                np.asarray([w for _, w in frame], np.float64))
        iof.write_int32(stream, binary, self.left_context)
        iof.write_int32(stream, binary, self.right_context)
        iof.write_int32(stream, binary, self.batch)
        iof.write_token(stream, binary, "</Egs>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "NnetExample":
        iof.expect_token(stream, binary, "<Egs>")
        feats = iof.read_matrix(stream, binary)
        T = iof.read_int32(stream, binary)
        targets = []
        for _ in range(T):
            pdfs = iof.read_int_vector(stream, binary)
            ws = iof.read_vector(stream, binary)
            targets.append(list(zip([int(p) for p in pdfs],
                                    [float(w) for w in ws])))
        left = iof.read_int32(stream, binary)
        right = iof.read_int32(stream, binary)
        batch = iof.read_int32(stream, binary)
        iof.expect_token(stream, binary, "</Egs>")
        return cls(feats, targets, left, right, batch)


class ExampleHolder(Holder):
    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return NnetExample.read(stream, binary)

    def write(self, stream, binary, value):
        value.write(stream, binary)


def merge_plain_egs(egs: List["NnetExample"]) -> "NnetExample":
    """Concatenate same-width examples into one minibatch example."""
    assert egs, "merge_plain_egs: empty group"
    feats = np.concatenate([e.feats for e in egs], axis=0)
    targets: List = []
    for e in egs:
        targets.extend(e.targets)
    return NnetExample(feats, targets, egs[0].left_context,
                       egs[0].right_context,
                       batch=sum(e.batch for e in egs))


def shuffle_egs(rspecifier: str, wspecifier: str, seed: int = 0,
                buffer_size: int = 5000) -> int:
    """nnet3-shuffle-egs: randomized-buffer shuffle."""
    rng = random.Random(seed)
    buf: List[Tuple[str, NnetChainExample]] = []
    n = 0
    with TableWriter(ChainExampleHolder(), wspecifier) as w:
        for key, eg in SequentialTableReader(ChainExampleHolder(),
                                             rspecifier):
            buf.append((key, eg))
            if len(buf) >= buffer_size:
                i = rng.randrange(len(buf))
                k, e = buf[i]
                buf[i] = buf[-1]
                buf.pop()
                w.write(k, e)
                n += 1
        rng.shuffle(buf)
        for k, e in buf:
            w.write(k, e)
            n += 1
    return n


def merged_minibatches(rspecifier: str, minibatch_size: int,
                       drop_last: bool = True
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """nnet3-merge-egs + the trainer's input: yields device-ready
    batches {feats (B, T, D), num_graphs (stacked arrays)}. Chunks are
    grouped by shape (the structure-hashing of nnet-example.h:94)."""
    by_shape: Dict[Tuple, List[NnetChainExample]] = {}
    for key, eg in SequentialTableReader(ChainExampleHolder(), rspecifier):
        shape = (eg.feats.shape, eg.num_graph.num_states)
        group = by_shape.setdefault(shape, [])
        group.append(eg)
        if len(group) == minibatch_size:
            yield _merge(group)
            by_shape[shape] = []
    if not drop_last:
        for group in by_shape.values():
            if group:
                yield _merge(group)


def _merge(group: Sequence[NnetChainExample]) -> Dict[str, np.ndarray]:
    feats = np.stack([eg.feats for eg in group])
    num_arrays = batch_pack([eg.num_graph for eg in group])
    return {"feats": feats, "num_graphs": num_arrays,
            "left_context": group[0].left_context,
            "right_context": group[0].right_context}


@dataclass
class NnetDiscriminativeExample:
    """Discriminative (sMBR/MMI/MPFE) training example: a feature
    chunk with its numerator alignment and denominator lattice
    (parity: nnet3/nnet-discriminative-example.h NnetDiscriminativeExample;
    the container nnet3/discriminative_train.py's tools consume).  The
    lattice is written as an OpenFst compactlattice44 inside
    `<Degs>` ... `</Degs>`."""
    feats: np.ndarray                  # (T, D)
    num_ali: List[int]                 # transition-ids, output rate
    den_lat: object                    # Lattice
    left_context: int = 0
    right_context: int = 0

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        from kaldi_tpu_torch.fstext.openfst_io import write_fst
        iof.write_token(stream, binary, "<Degs>")
        iof.write_matrix(stream, binary, self.feats)
        iof.write_int_vector(stream, binary, list(self.num_ali))
        iof.write_int32(stream, binary, self.left_context)
        iof.write_int32(stream, binary, self.right_context)
        write_fst(stream, self.den_lat, as_compact_lattice=True)
        iof.write_token(stream, binary, "</Degs>")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "NnetDiscriminativeExample":
        from kaldi_tpu_torch.fstext.openfst_io import read_fst
        iof.expect_token(stream, binary, "<Degs>")
        feats = iof.read_matrix(stream, binary)
        ali = iof.read_int_vector(stream, binary)
        left = iof.read_int32(stream, binary)
        right = iof.read_int32(stream, binary)
        lat = read_fst(stream)
        iof.expect_token(stream, binary, "</Degs>")
        return cls(feats, list(ali), lat, left, right)


class DiscriminativeExampleHolder(Holder):
    binary_container = True

    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return NnetDiscriminativeExample.read(stream, binary)

    def write(self, stream, binary, value):
        value.write(stream, binary)


def den_lattice_range(lat, t0: int, t1: int):
    """The part of a denominator lattice between frames t0 and t1, as
    its own lattice of t1 - t0 frames (upstream's
    DiscriminativeSupervisionSplitter): the arcs that leave a state of
    time t0..t1-1; a new start state with an epsilon arc to each state
    that an emitting arc of frame t0 - 1 enters, weighted by the forward
    log-probability of that arc's path (the lattice's start itself when
    t0 = 0); each state that an emitting arc of frame t1 - 1 enters final
    with its backward log-probability.  Those boundary weights, the
    frames outside the range, sit in the graph cost, so a rescoring of
    the acoustic costs leaves them alone, and the range's total
    log-probability is the whole lattice's."""
    from kaldi_tpu_torch.fstext.fst import Arc, LatticeWeight, VectorFst
    from kaldi_tpu_torch.fstext.ops import connect
    from kaldi_tpu_torch.lat.functions import (_logadd, _topsort,
                                               lattice_state_times)
    times = lattice_state_times(lat)
    order = _topsort(lat)
    n = lat.num_states
    neg = -1e30

    def like(w):
        return -(w[0] + w[1])
    alpha = [neg] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] > neg / 2:
            for a in lat.arcs[s]:
                alpha[a.nextstate] = _logadd(alpha[a.nextstate],
                                             alpha[s] + like(a.weight))
    beta = [neg] * n
    for s in reversed(order):
        b = like(lat.finals[s]) if lat.is_final(s) else neg
        for a in lat.arcs[s]:
            b = _logadd(b, like(a.weight) + beta[a.nextstate])
        beta[s] = b
    enter = {}                   # state -> log-prob of entering at t0
    leave = {}                   # state -> log-prob after entering at t1
    if t0 == 0:
        enter[lat.start] = 0.0
    for s in range(n):
        if times[s] < 0:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                continue
            if times[s] == t0 - 1:
                enter[a.nextstate] = _logadd(
                    enter.get(a.nextstate, neg), alpha[s] + like(a.weight))
            if times[s] == t1 - 1:
                leave[a.nextstate] = beta[a.nextstate]
    out = VectorFst(LatticeWeight)
    out.add_states(n + 1)
    start = n
    out.set_start(start)
    for s in range(n):
        if t0 <= times[s] < t1:
            for a in lat.arcs[s]:
                out.add_arc(s, Arc(a.ilabel, a.olabel, tuple(a.weight),
                                   a.nextstate))
    for s, lp in enter.items():
        out.add_arc(start, Arc(0, 0, (-lp, 0.0), s))
    for s, lp in leave.items():
        if lp > neg / 2:
            out.set_final(s, (-lp, 0.0))
    return connect(out)
