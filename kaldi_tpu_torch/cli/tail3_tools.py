"""nnet3-discriminative-get-egs and nnet3-discriminative-copy-egs (ports
of those tools of `kaldi_tpu/cli/tail3_tools.py`; parity:
nnet3bin/nnet3-discriminative-{get,copy}-egs.cc).  Host tools: they read
and write archives of NnetDiscriminativeExample (nnet3/egs.py).

An utterance whose alignment fits in --num-frames becomes one example
with all of its features, its alignment and its lattice.  The JAX
package's tool cuts the features to the alignment's length, so for a
model that subsamples its output (a chain model's alignment and lattice
are at the output rate) the example kept only the first third of the
utterance's features; the two agree wherever features and alignment have
one rate.  A longer utterance is cut into chunks of --num-frames
alignment frames (features with --left-context and --right-context
around them, at the alignment's rate as in the JAX tool); the JAX tool
attaches the whole utterance's lattice to every chunk, which no chunk
can be scored against, and here each chunk carries the lattice cut to
its frames (`den_lattice_range`).
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def nnet3_discriminative_get_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Get frame-by-frame examples for nnet3 discriminative "
        "training (sMBR/MMI): feature chunks with numerator alignments "
        "and denominator lattices.\n"
        "Usage: nnet3-discriminative-get-egs [options] "
        "<features-rspecifier> <ali-rspecifier> "
        "<den-lat-rspecifier> <egs-wspecifier>")
    chunk_width = po.register_value("num-frames", 150,
                                    "Frames per chunk (output rate)")
    left = po.register_value("left-context", 13, "Left context frames")
    right = po.register_value("right-context", 13,
                              "Right context frames")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.egs import (NnetDiscriminativeExample,
                                           den_lattice_range)
    alis = RandomAccessTableReader("int-vector", po.get_arg(2))
    lats = RandomAccessTableReader("lattice", po.get_arg(3))
    n = 0
    cw = int(chunk_width[0])
    with TableWriter("degs", po.get_arg(4)) as w:
        for utt, feats in SequentialTableReader("matrix", po.get_arg(1)):
            if utt not in alis or utt not in lats:
                continue
            ali = list(alis[utt])
            lat = lats[utt]
            T = min(feats.shape[0], len(ali))
            if T <= cw:
                # the whole utterance: all of its features
                w.write(utt, NnetDiscriminativeExample(
                    feats if len(ali) <= feats.shape[0] else feats[:T],
                    ali[:T], lat, 0, 0))
                n += 1
                continue
            for start in range(0, T - cw + 1, cw):
                lo = max(0, start - int(left[0]))
                hi = min(T, start + cw + int(right[0]))
                w.write(f"{utt}-{start}", NnetDiscriminativeExample(
                    feats[lo:hi], ali[start:start + cw],
                    den_lattice_range(lat, start, start + cw),
                    start - lo, hi - start - cw))
                n += 1
    log(f"nnet3-discriminative-get-egs: {n} examples")
    return 0


def nnet3_discriminative_copy_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy examples for nnet3 discriminative training, possibly "
        "changing the binary mode; supports multiple output archives "
        "(round-robin split).\n"
        "Usage: nnet3-discriminative-copy-egs <egs-rspecifier> "
        "<egs-wspecifier1> [<egs-wspecifier2> ...]")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    writers = [TableWriter("degs", po.get_arg(i))
               for i in range(2, po.num_args() + 1)]
    n = 0
    for key, eg in SequentialTableReader("degs", po.get_arg(1)):
        writers[n % len(writers)].write(key, eg)
        n += 1
    for w in writers:
        w.close()
    log(f"nnet3-discriminative-copy-egs: {n} examples -> "
        f"{len(writers)} archives")
    return 0
