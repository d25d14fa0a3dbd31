"""nnet3 training tail (port of `nnet3-train`, `nnet3-combine`,
`nnet3-chain-train2` and `nnet3-chain-combine2` of
`kaldi_tpu/cli/nnet3_tail2_tools.py`; parity: src/nnet3bin
nnet3-train.cc, nnet3-combine.cc, src/chainbin nnet3-chain-train2.cc,
nnet3-chain-combine2.cc).  nnet3-train runs on the card unless
--use-gpu=no.

Not carried over yet: the module's other tools (am-train-transitions,
the LDA statistics, the dense and simple egs, the discriminative egs,
chain add-post, chain-make-num-fst-e2e, rnnlm-get-egs).
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.cli.chain_tools import _device
from kaldi_tpu_torch.util.parse_options import ParseOptions


def nnet3_train(argv: List[str]) -> int:
    po = ParseOptions(
        "Train an nnet3 model with frame-level cross-entropy from "
        "prepared examples; writes a raw nnet (nnet3-train.cc — this "
        "framework trains its native TDNN stack at frame rate 1).\n"
        "Usage: nnet3-train [options] <egs-rspecifier> <raw-nnet-out>")
    num_epochs = po.register_value("num-epochs", 4, "Epochs over egs")
    mb = po.register_value("minibatch-size", 32, "Minibatch size")
    lr = po.register_value("learning-rate", 1e-3, "Adam learning rate")
    hidden = po.register_value("hidden-dim", 256, "Hidden dim")
    bottleneck = po.register_value("bottleneck-dim", 64,
                                   "Bottleneck dim")
    layers = po.register_value("num-layers", 4, "TDNN-F layers")
    num_pdfs = po.register_value(
        "num-pdfs", 0, "Output dimension (0 = infer from targets)")
    use_gpu = po.register_value("use-gpu", "yes",
                                "yes: train on the CUDA card (fail "
                                "without one); no: on the CPU")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.parallel.trainer import train_xent_from_egs
    n_steps, objf = train_xent_from_egs(
        po.get_arg(1), po.get_arg(2), num_epochs=num_epochs[0],
        minibatch_size=mb[0], learning_rate=lr[0],
        hidden_dim=hidden[0], bottleneck_dim=bottleneck[0],
        num_layers=layers[0], num_pdfs=num_pdfs[0],
        device=_device(use_gpu[0]))
    log(f"nnet3-train: {n_steps} steps, final objf {objf:.4f}")
    return 0


def nnet3_combine(argv: List[str]) -> int:
    po = ParseOptions(
        "Combine (average) the parameters of several nnet3 models "
        "(nnet3-combine.cc; the equal-weight --enforce-sum-to-one "
        "case).\n"
        "Usage: nnet3-combine [options] <model-in1> <model-in2> ... "
        "<model-out>")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.cli.chain_tools import average_models
    return average_models([po.get_arg(i)
                           for i in range(1, po.num_args())],
                          po.get_arg(po.num_args()))


def nnet3_chain_train2(argv: List[str]) -> int:
    from kaldi_tpu_torch.cli.chain_tools import nnet3_chain_train
    return nnet3_chain_train(["nnet3-chain-train2"] + argv[1:])


def nnet3_chain_combine2(argv: List[str]) -> int:
    from kaldi_tpu_torch.cli.chain_tools import nnet3_chain_combine
    return nnet3_chain_combine(["nnet3-chain-combine2"] + argv[1:])
