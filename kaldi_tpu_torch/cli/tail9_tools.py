"""nnet3-discriminative-train (port of that tool of
`kaldi_tpu/cli/tail9_tools.py`; parity:
nnet3bin/nnet3-discriminative-train.cc).

The xconfig checkpoint trains on the card unless --use-gpu=no
(nnet3/discriminative_train.py: the forward and the backward on the
card, the lattice rescoring and forward-backward of each utterance on
the host) and is written as step 0 of the output directory with the
input's metadata.  The tool logs a `nnet3-discriminative-train stats
{...}` JSON line at its end: the objective of each epoch, the steps, the
host seconds of the lattice work, the median device ms of a step's
forward and of its backward and update (CUDA events), the hand kernels'
launches and, on the card, the peak memory.

Not carried over yet: the module's other tools (the PLDA adaptation,
the i-vector dot products, SDC deltas, the combined pitch tool, the
online i-vector extractor).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu, stats_line
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader


def nnet3_discriminative_train(argv: List[str]) -> int:
    po = ParseOptions(
        "Sequence-discriminative (MMI/MPE/sMBR) fine-tuning of an "
        "xconfig checkpoint from alignments + denominator lattices "
        "(nnet3-discriminative-train.cc; lattice acoustics are "
        "recomputed from the live model every pass).\n"
        "Usage: nnet3-discriminative-train [options] <model-dir-in> "
        "<transition-model-in> <feats-rspecifier> <ali-rspecifier> "
        "<den-lat-rspecifier> <model-dir-out>")
    criterion = po.register_value("criterion", "smbr",
                                  "mmi | mpfe | smbr")
    num_epochs = po.register_value("num-epochs", 2, "Training epochs")
    learning_rate = po.register_value("learning-rate", 1e-4,
                                      "Adam learning rate")
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 6:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.nnet3_tools import _device
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.nnet3.discriminative_train import (
        DiscTrainOptions, train_discriminative)
    from kaldi_tpu_torch.nnet3.xconfig import xconfig_to_flax
    from kaldi_tpu_torch.parallel.checkpoint import (load_xconfig_checkpoint,
                                                     save_checkpoint)
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    base = os.path.abspath(po.get_arg(1))
    with open(os.path.join(base, "step_0.meta.json")) as f:
        meta = json.load(f)
    model, _text, _step = load_xconfig_checkpoint(
        base, device=_device(use_gpu[0]))
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(2))
    feats = {k: np.asarray(m) for k, m in
             SequentialTableReader("matrix", po.get_arg(3))}
    alis = {k: list(a) for k, a in
            SequentialTableReader("int-vector", po.get_arg(4))}
    lats = {k: l for k, l in
            SequentialTableReader("lattice", po.get_arg(5))}
    keys = sorted(set(feats) & set(alis) & set(lats))
    if not keys:
        warn("no utterances with feats+ali+lattice")
        return 1
    stats: dict = {}
    _params, objfs = train_discriminative(
        lambda f: model({"input": f})["output"], tm,
        {k: feats[k] for k in keys}, {k: alis[k] for k in keys},
        {k: lats[k] for k in keys}, tm.num_pdfs,
        DiscTrainOptions(num_epochs=num_epochs[0],
                         learning_rate=learning_rate[0],
                         acoustic_scale=acoustic_scale[0],
                         criterion=criterion[0]),
        params=dict(model.named_parameters()), device=model.device,
        stats=stats)
    model.requires_grad_(False)
    save_checkpoint(po.get_arg(6), xconfig_to_flax(model), 0, extra=meta)
    log(f"discriminative training ({criterion[0]}): objf "
        f"{objfs[0]:.4f} -> {objfs[-1]:.4f} over {len(keys)} utts")
    out = {"epoch_objf": objfs, "utterances": len(keys),
           "steps": len(keys) * num_epochs[0], "host_s": stats["host_s"]}
    for name in ("forward_ms", "backward_ms"):
        out[name + "_median"] = (float(np.median(stats[name]))
                                 if stats[name] else None)
    stats_line("nnet3-discriminative-train", out, model.device)
    return 0
