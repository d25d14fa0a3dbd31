"""Plain (non-chain) nnet3 egs + raw-model CLI tail (port of
`kaldi_tpu/cli/nnet3_tools2.py`; parity:
src/nnet3bin nnet3-get-egs.cc, nnet3-copy-egs.cc,
nnet3-shuffle-egs.cc, nnet3-merge-egs.cc, nnet3-subset-egs.cc,
nnet3-copy.cc, nnet3-average.cc, nnet3-compute-from-egs.cc,
nnet3-compute-prob.cc).

nnet3-compute-from-egs and nnet3-compute-prob run the compiled module
(nnet3/torch_bridge.py) on the card unless --use-gpu=no, which asks for
the host evaluator (Nnet3Graph.forward); neither falls back to the host
when the card fails."""

from __future__ import annotations

import random
from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.nnet3.egs import (ExampleHolder, NnetExample,
                                      merge_plain_egs)
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                  SequentialTableReader, TableWriter)


def nnet3_get_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Get frame-supervised examples for plain nnet3 training "
        "(targets = pdf posteriors, e.g. from ali-to-post | "
        "post-to-pdf-post).\n"
        "Usage: nnet3-get-egs [options] <features-rspecifier> "
        "<targets-post-rspecifier> <egs-wspecifier>")
    left = po.register_value("left-context", 0, "Left context frames")
    right = po.register_value("right-context", 0, "Right context frames")
    num_frames = po.register_value(
        "num-frames", 8, "Frames per example chunk")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    post_reader = RandomAccessTableReader("posterior", po.get_arg(2))
    writer = TableWriter(ExampleHolder(), po.get_arg(3))
    n_utt = n_egs = err = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if key not in post_reader:
            warn(f"no targets for {key}")
            err += 1
            continue
        post = post_reader[key]
        T = min(feats.shape[0], len(post))
        k = num_frames[0]
        for i, t0 in enumerate(range(0, T, k)):
            t1 = min(t0 + k, T)
            # context rows come from the utterance, edge-clamped
            lo = max(0, t0 - left[0])
            hi = min(T, t1 + right[0])
            eg = NnetExample(np.asarray(feats)[lo:hi],
                             [list(p) for p in post[t0:t1]],
                             left_context=t0 - lo,
                             right_context=hi - t1)
            writer.write(f"{key}-{i}", eg)
            n_egs += 1
        n_utt += 1
    writer.close()
    log(f"generated {n_egs} examples from {n_utt} utterances "
        f"({err} errors)")
    return 0 if n_egs else 1


def nnet3_copy_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy nnet3 examples, round-robin over output archives.\n"
        "Usage: nnet3-copy-egs [options] <egs-rspecifier> "
        "<egs-wspecifier1> [<egs-wspecifier2> ...]")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    writers = [TableWriter(ExampleHolder(), po.get_arg(i))
               for i in range(2, po.num_args() + 1)]
    n = 0
    for key, eg in SequentialTableReader(ExampleHolder(),
                                         po.get_arg(1)):
        writers[n % len(writers)].write(key, eg)
        n += 1
    for w in writers:
        w.close()
    log(f"copied {n} examples to {len(writers)} archives")
    return 0 if n else 1


def nnet3_shuffle_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Shuffle nnet3 examples (reservoir buffer).\n"
        "Usage: nnet3-shuffle-egs [options] <egs-rspecifier> "
        "<egs-wspecifier>")
    seed = po.register_value("srand", 0, "Random seed")
    buffer_size = po.register_value("buffer-size", 5000,
                                    "Shuffle reservoir size")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    rng = random.Random(seed[0])
    buf: list = []
    n = 0
    with TableWriter(ExampleHolder(), po.get_arg(2)) as w:
        for key, eg in SequentialTableReader(ExampleHolder(),
                                             po.get_arg(1)):
            buf.append((key, eg))
            if len(buf) >= buffer_size[0]:
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
    log(f"shuffled {n} examples")
    return 0 if n else 1


def nnet3_merge_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Merge nnet3 examples into minibatches (groups of equal "
        "frame count concatenate; the batch field records the "
        "original count).\n"
        "Usage: nnet3-merge-egs [options] <egs-rspecifier> "
        "<egs-wspecifier>")
    minibatch_size = po.register_value("minibatch-size", 32,
                                       "Examples per merged minibatch")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    groups: dict = {}
    n_in = n_out = 0
    with TableWriter(ExampleHolder(), po.get_arg(2)) as w:
        for key, eg in SequentialTableReader(ExampleHolder(),
                                             po.get_arg(1)):
            sig = (eg.feats.shape, len(eg.targets))
            groups.setdefault(sig, []).append(eg)
            n_in += 1
            if len(groups[sig]) >= minibatch_size[0]:
                w.write(f"merged-{n_out}", merge_plain_egs(groups[sig]))
                groups[sig] = []
                n_out += 1
        for egs in groups.values():
            if egs:
                w.write(f"merged-{n_out}", merge_plain_egs(egs))
                n_out += 1
    log(f"merged {n_in} examples into {n_out} minibatches")
    return 0 if n_out else 1


def nnet3_subset_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Keep a random subset of nnet3 examples.\n"
        "Usage: nnet3-subset-egs [options] <egs-rspecifier> "
        "<egs-wspecifier>")
    n_keep = po.register_value("n", 100, "Number of examples to keep")
    seed = po.register_value("srand", 0, "Random seed")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    rng = random.Random(seed[0])
    kept: list = []
    seen = 0
    for key, eg in SequentialTableReader(ExampleHolder(),
                                         po.get_arg(1)):
        seen += 1
        if len(kept) < n_keep[0]:
            kept.append((key, eg))
        else:
            i = rng.randrange(seen)
            if i < n_keep[0]:
                kept[i] = (key, eg)
    with TableWriter(ExampleHolder(), po.get_arg(2)) as w:
        for k, e in kept:
            w.write(k, e)
    log(f"kept {len(kept)} of {seen} examples")
    return 0 if kept else 1


# ---------------------------------------------------------------------------
# raw-model ops
# ---------------------------------------------------------------------------

def nnet3_copy(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy a raw nnet3 model, optionally changing the format.\n"
        "Usage: nnet3-copy [options] <raw-nnet-in> <raw-nnet-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3, write_raw_nnet3
    graph = read_raw_nnet3(po.get_arg(1))
    write_raw_nnet3(graph, po.get_arg(2), binary=binary[0])
    return 0


def nnet3_average(argv: List[str]) -> int:
    po = ParseOptions(
        "Average the parameters of raw nnet3 models (the reference's "
        "parallel-SGD model averaging, nnet3-average.cc).\n"
        "Usage: nnet3-average [options] <raw-nnet-in1> "
        "<raw-nnet-in2> ... <raw-nnet-out>")
    binary = po.register_value("binary", True, "Write output in binary mode")
    weights_s = po.register_value(
        "weights", "", "Colon-separated model weights (default equal)")
    po.read(argv)
    if po.num_args() < 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.mdl_io import read_raw_nnet3, write_raw_nnet3
    k = po.num_args() - 1
    graphs = [read_raw_nnet3(po.get_arg(i)) for i in range(1, k + 1)]
    ws = ([float(x) for x in weights_s[0].split(":")] if weights_s[0]
          else [1.0 / k] * k)
    if len(ws) != k:
        print("nnet3-average: #weights must equal #models", flush=True)
        return 1
    tot = sum(ws)
    ws = [w / tot for w in ws]
    out = graphs[0]
    for name, comp in out.components.items():
        for fkey, val in comp.fields.items():
            if isinstance(val, np.ndarray) and np.issubdtype(
                    val.dtype, np.floating):
                acc = ws[0] * val
                for g, w in zip(graphs[1:], ws[1:]):
                    acc = acc + w * g.components[name].fields[fkey]
                comp.fields[fkey] = acc
    write_raw_nnet3(out, po.get_arg(po.num_args()), binary=binary[0])
    log(f"averaged {k} models")
    return 0


def _graph_forward(path: str, use_gpu: str, use_xent: bool = False):
    """(T, D) features -> the model's (T, out) output as numpy: the
    compiled module on the card, or under --use-gpu=no the host
    evaluator."""
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    _, graph, _ = read_nnet3_any(path)
    head = "output-xent" if use_xent else "output"
    device = _device(use_gpu)
    if device == "cpu":
        def fwd(feats):
            return graph.forward(np.asarray(feats, np.float32),
                                 output_name=head)
        return fwd
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    net = compile_graph(graph, head, device=device)

    def fwd(feats):
        return net(np.asarray(feats, np.float32)[None])[0].cpu().numpy()
    return fwd


def _register_use_gpu(po: ParseOptions):
    return po.register_value("use-gpu", "yes",
                             "yes: the compiled model on the CUDA card "
                             "(fail without one); no: the host evaluator")


def nnet3_compute_from_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Propagate examples' features through a raw model, writing "
        "output matrices.\n"
        "Usage: nnet3-compute-from-egs [options] <raw-nnet-in> "
        "<egs-rspecifier> <matrix-wspecifier>")
    use_gpu = _register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    fwd = _graph_forward(po.get_arg(1), use_gpu[0])
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for key, eg in SequentialTableReader(ExampleHolder(),
                                         po.get_arg(2)):
        writer.write(key, fwd(eg.feats))
        n += 1
    writer.close()
    log(f"computed outputs for {n} examples")
    return 0 if n else 1


def nnet3_compute_prob(argv: List[str]) -> int:
    po = ParseOptions(
        "Average per-frame log-probability of example targets under "
        "a raw model (diagnostic; nnet3-compute-prob.cc).\n"
        "Usage: nnet3-compute-prob [options] <raw-nnet-in> "
        "<egs-rspecifier>")
    use_gpu = _register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    fwd = _graph_forward(po.get_arg(1), use_gpu[0])
    tot = frames = 0.0
    n = 0
    for key, eg in SequentialTableReader(ExampleHolder(),
                                         po.get_arg(2)):
        out = fwd(eg.feats)
        # log-softmax rows (the model may or may not end in LogSoftmax;
        # normalize defensively)
        mx = out.max(axis=1, keepdims=True)
        lsm = out - (mx + np.log(np.exp(out - mx).sum(axis=1,
                                                      keepdims=True)))
        # target rows align to the END of the (context-padded) output
        off = eg.left_context
        for t, frame in enumerate(eg.targets):
            row = lsm[min(off + t, lsm.shape[0] - 1)]
            for pdf, w in frame:
                tot += w * float(row[pdf])
                frames += w
        n += 1
    avg = tot / max(frames, 1.0)
    print(f"log-prob per frame: {avg:.4f} over {frames:.0f} frames "
          f"({n} examples)")
    return 0 if n else 1
