"""nnet3-compute, nnet3-compute-batch and nnet3-latgen-faster (ports of
`kaldi_tpu/cli/misc_tools.py` nnet3_compute, `kaldi_tpu/cli/tail15_tools.py`
nnet3_compute_batch and `kaldi_tpu/cli/nnet3_tools.py`
nnet3_latgen_faster), on the card unless --use-gpu=no.

nnet3-compute reads a Kaldi nnet3 model file (.raw or .mdl), compiled by
nnet3/torch_bridge.py, or an xconfig checkpoint directory
(parallel/checkpoint.py; a JAX package orbax directory is refused,
naming tools/jax_checkpoint_to_torch.py).  nnet3-compute-batch reads
model files.  nnet3-latgen-faster decodes an xconfig checkpoint's output
into lattices over an HCLG (cli/nnet3_latgen_tools.py).

Unlike the JAX package's tools, neither falls back to the host evaluator
when a component has no device mapping: the compile error ends the tool
with a nonzero status.  --use-device=false (nnet3-compute) asks for the
host evaluator, Nnet3Graph.forward, explicitly.

Both take --ivectors=<rspecifier>, one i-vector an utterance (the
reference's nnet3-compute option), for models with an "ivector" input.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError, log
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)


def _device(use_gpu: str) -> Optional[str]:
    """--use-gpu: yes -> the card (None: raise without one), no -> CPU."""
    if use_gpu == "yes":
        return None
    if use_gpu == "no":
        return "cpu"
    raise KaldiTpuError(f"--use-gpu={use_gpu!r}: expected yes or no")


def _read_model(path: str):
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    if os.path.isdir(path):
        raise KaldiTpuError(
            f"{path} is a directory: nnet3-compute-batch reads .raw or .mdl "
            "files (nnet3-compute reads xconfig checkpoint directories)")
    return read_nnet3_any(path)[1]


def _xconfig_forward(path: str, head: str, use_gpu: str):
    """nnet3-compute's forward over an xconfig checkpoint directory: the
    `head` output of (T, D) features (and an i-vector, when the model
    has an "ivector" input), float32 with TF32 off."""
    import torch

    from kaldi_tpu_torch.device import full_f32
    from kaldi_tpu_torch.parallel.checkpoint import load_xconfig_checkpoint
    model, _text, _step = load_xconfig_checkpoint(path,
                                                  device=_device(use_gpu))
    if head not in {l.name for l in model.layers
                    if l.layer_type == "output-layer"}:
        raise KaldiTpuError(f"{path}: the model has no output {head!r}")
    inputs = {l.name for l in model.layers if l.layer_type == "input"}

    def fwd(feats, iv):
        x = {"input": torch.from_numpy(feats[None])}
        if "ivector" in inputs:
            if iv is None:
                raise KaldiTpuError("the model has an ivector input: pass "
                                    "--ivectors")
            x["ivector"] = torch.from_numpy(iv[None])
        with torch.no_grad(), full_f32():
            return model(x)[head][0].cpu().numpy()
    return fwd


def _register_common(po: ParseOptions):
    use_xent = po.register_value("use-xent-output", False,
                                 "Use the output-xent head instead of output")
    use_gpu = po.register_value("use-gpu", "yes",
                                "yes: compute on the CUDA card (fail "
                                "without one); no: on the CPU")
    ivectors = po.register_value("ivectors", "",
                                 "Rspecifier of i-vectors, one a "
                                 "(utterance) key, for a model with an "
                                 "ivector input")
    return use_xent, use_gpu, ivectors


def nnet3_compute(argv: List[str]) -> int:
    po = ParseOptions(
        "Propagate the features through a raw neural network model, the "
        "network of an acoustic model, or an xconfig checkpoint directory.\n"
        "Usage: nnet3-compute [options] <model-in|nnet-dir> "
        "<features-rspecifier> <matrix-wspecifier>")
    use_xent, use_gpu, ivectors = _register_common(po)
    use_device = po.register_value(
        "use-device", True,
        "true: the compiled module (nnet3/torch_bridge.py; a component "
        "without a mapping fails); false: the host evaluator")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    head = "output-xent" if use_xent[0] else "output"
    iv_reader = (RandomAccessTableReader("vector", ivectors[0])
                 if ivectors[0] else None)
    if os.path.isdir(po.get_arg(1)):
        fwd = _xconfig_forward(po.get_arg(1), head, use_gpu[0])
    elif use_device[0]:
        graph = _read_model(po.get_arg(1))
        from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
        net = compile_graph(graph, head, device=_device(use_gpu[0]))

        def fwd(feats, iv):
            return net(feats[None], None if iv is None else iv[None])[0] \
                .cpu().numpy()
    else:
        graph = _read_model(po.get_arg(1))

        def fwd(feats, iv):
            return graph.forward(feats, ivector=iv, output_name=head)
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        iv = None if iv_reader is None else np.asarray(iv_reader[key],
                                                       np.float32)
        writer.write(key, fwd(np.asarray(feats, np.float32), iv))
        n += 1
    writer.close()
    log(f"computed outputs for {n} utterances")
    return 0


def pad_batch(feats: List[np.ndarray]) -> np.ndarray:
    """nnet3-compute-batch's device batch: the utterances zero-padded to
    the longest, rounded up to a multiple of 8 frames (tail15_tools.py
    :300-304).  The padding is context for the last frames of shorter
    lanes, so a lane's edge frames differ from nnet3-compute's."""
    t_max = -(-max(f.shape[0] for f in feats) // 8) * 8
    batch = np.zeros((len(feats), t_max, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        batch[i, :f.shape[0]] = f
    return batch


def nnet3_compute_batch(argv: List[str]) -> int:
    po = ParseOptions(
        "Propagate features through the network in batches (the "
        "NnetBatchComputer path, nnet3-compute-batch.cc): utterances are "
        "zero-padded into device batches instead of computed one by "
        "one.\nUsage: nnet3-compute-batch [options] <model-in> "
        "<features-rspecifier> <matrix-wspecifier>")
    batch_size = po.register_value("batch-size", 32,
                                   "Utterances per device batch")
    use_xent, use_gpu, ivectors = _register_common(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
    graph = _read_model(po.get_arg(1))
    head = "output-xent" if use_xent[0] else "output"
    net = compile_graph(graph, head, device=_device(use_gpu[0]))
    iv_reader = (RandomAccessTableReader("vector", ivectors[0])
                 if ivectors[0] else None)
    writer = TableWriter("matrix", po.get_arg(3))
    buf = []
    n = 0

    def flush():
        nonlocal n
        if not buf:
            return
        batch = pad_batch([f for _k, f in buf])
        ivs = None if iv_reader is None else np.stack(
            [np.asarray(iv_reader[k], np.float32) for k, _f in buf])
        out = net(batch, ivs).cpu().numpy()
        rate = max(1, int(round(batch.shape[1] / max(out.shape[1], 1))))
        for i, (k, f) in enumerate(buf):
            writer.write(k, out[i, :-(-f.shape[0] // rate)])
            n += 1
        buf.clear()

    for key, feats in SequentialTableReader("matrix", po.get_arg(2)):
        buf.append((key, np.asarray(feats, np.float32)))
        if len(buf) >= batch_size[0]:
            flush()
    flush()
    writer.close()
    log(f"batch-computed outputs for {n} utterances")
    return 0 if n else 1


def nnet3_latgen_faster(argv: List[str]) -> int:
    po = ParseOptions(
        "Generate lattices using neural net model.\n"
        "Usage: nnet3-latgen-faster [options] <trans-model> <nnet-dir> "
        "<fst-in> <features-rspecifier> <lattice-wspecifier> "
        "[<words-wspecifier>]")
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import (_decode_loop,
                                                         _load_tm_and_model,
                                                         parse_args,
                                                         register_latgen)
    dopts, acoustic_scale, use_gpu = register_latgen(po)
    if not parse_args(po, argv):
        return 1
    tm, forward = _load_tm_and_model(po.get_arg(1), po.get_arg(2),
                                     use_gpu[0])

    def items():
        for key, feats in SequentialTableReader("matrix", po.get_arg(4)):
            yield key, forward(feats[None])[0].cpu().numpy(), len(feats)

    return _decode_loop(items(), po.get_arg(3), tm, forward,
                        acoustic_scale[0], dopts, po.get_arg(5),
                        po.get_arg(6) if po.num_args() >= 6 else None,
                        "nnet3-latgen-faster")
