"""nnet3 training tail (port of `nnet3-train`, `nnet3-combine`,
`nnet3-chain-train2`, `nnet3-chain-combine2` and the discriminative egs
tools of `kaldi_tpu/cli/nnet3_tail2_tools.py`; parity: src/nnet3bin
nnet3-train.cc, nnet3-combine.cc, nnet3-discriminative-{merge,shuffle,
subset}-egs.cc, nnet3-discriminative-compute-objf.cc,
nnet3-discriminative-compute-from-egs.cc, src/chainbin
nnet3-chain-train2.cc, nnet3-chain-combine2.cc).  nnet3-train and the
discriminative objective and forward tools run the model on the card
unless --use-gpu=no.

nnet3-discriminative-compute-objf rescores each example's lattice with
the live model's outputs, an arc of frame t reading output row t plus the
example's left context (the JAX tool reads row t: the same for the
whole-utterance examples, which have none; for a chunk it read the
wrong rows), and scores it with the MPFE / sMBR forward-backward
(`--criterion=mmi` scores MPFE, as the JAX tool does).

Not carried over yet: the module's other tools (am-train-transitions,
the LDA statistics, the dense and simple egs, chain add-post,
chain-make-num-fst-e2e, rnnlm-get-egs).
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.cli.chain_tools import _device
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


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


def _degs_each(argv, name, fn):
    """The body of the one-archive-in, one-archive-out egs tools."""
    po = ParseOptions(
        f"{name}: see the chain/plain egs variant for semantics.\n"
        f"Usage: {name} [options] <egs-rspecifier> <egs-wspecifier>")
    srand = po.register_value("srand", 0, "Shuffle seed")
    n_keep = po.register_value("n", 10, "Subset size (subset only)")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    items = list(SequentialTableReader("degs", po.get_arg(1)))
    items = fn(items, srand[0], n_keep[0])
    with TableWriter("degs", po.get_arg(2)) as w:
        for k, v in items:
            w.write(k, v)
    log(f"{name}: wrote {len(items)} examples")
    return 0 if items else 1


def nnet3_discriminative_shuffle_egs(argv: List[str]) -> int:
    def fn(items, srand, _n):
        rng = np.random.default_rng(srand)
        order = rng.permutation(len(items))
        return [items[i] for i in order]
    return _degs_each(argv, "nnet3-discriminative-shuffle-egs", fn)


def nnet3_discriminative_subset_egs(argv: List[str]) -> int:
    def fn(items, _srand, n):
        return items[:n]
    return _degs_each(argv, "nnet3-discriminative-subset-egs", fn)


def nnet3_discriminative_merge_egs(argv: List[str]) -> int:
    # discriminative egs hold whole chunks with lattices; "merging" in
    # the reference groups minibatches, and the trainer batches at read
    # time, so merge is a copy that accepts --minibatch-size
    po = ParseOptions(
        "Copy discriminative examples (minibatch grouping happens in "
        "the trainer; nnet3-discriminative-merge-egs.cc surface).\n"
        "Usage: nnet3-discriminative-merge-egs [options] "
        "<egs-rspecifier> <egs-wspecifier>")
    po.register_value("minibatch-size", 64,
                      "Accepted for compatibility")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    n = 0
    with TableWriter("degs", po.get_arg(2)) as w:
        for k, v in SequentialTableReader("degs", po.get_arg(1)):
            w.write(k, v)
            n += 1
    log(f"copied {n} discriminative examples")
    return 0 if n else 1


def _degs_forward(mdl_dir: str, use_gpu: str):
    """The xconfig checkpoint's "output" head over (1, T, D) features
    (cli/nnet3_latgen_tools.py's _Forward: its device, float32, TF32
    off)."""
    from kaldi_tpu_torch.cli.nnet3_latgen_tools import _Forward
    from kaldi_tpu_torch.parallel.checkpoint import load_xconfig_checkpoint
    model, _text, _step = load_xconfig_checkpoint(mdl_dir,
                                                  device=_device(use_gpu))
    return _Forward(model)


def _degs_objf(mdl_dir: str, tm_path: str, egs_rspec: str,
               criterion: str, acoustic_scale: float, use_gpu: str):
    """Shared MMI/sMBR/MPFE objective over discriminative egs with a
    live model forward -> (objective, frames, posteriors by key)."""
    from kaldi_tpu_torch.fstext.fst import Arc
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.lat.functions import (
        lattice_forward_backward_mpe_variants, lattice_scale,
        lattice_state_times)
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tm = read_kaldi_object(TransitionModel.read, tm_path)
    forward = _degs_forward(mdl_dir, use_gpu)
    sil = []
    tot_objf = tot_frames = 0.0
    posts = {}
    for key, eg in SequentialTableReader("degs", egs_rspec):
        ll = forward(eg.feats[None])[0].cpu().numpy()
        # rescore the den lattice acoustics from the live model
        lat = eg.den_lat
        times = lattice_state_times(lat)
        for s in range(lat.num_states):
            for i, a in enumerate(lat.arcs[s]):
                if a.ilabel:
                    pdf = tm.transition_id_to_pdf(a.ilabel)
                    t = min(times[s] + eg.left_context, ll.shape[0] - 1)
                    lat.arcs[s][i] = Arc(
                        a.ilabel, a.olabel,
                        (a.weight[0], -float(ll[t, pdf])), a.nextstate)
        scaled = lattice_scale(lat, 1.0, acoustic_scale)
        objf, post = lattice_forward_backward_mpe_variants(
            tm, sil, scaled, eg.num_ali,
            criterion="smbr" if criterion == "smbr" else "mpfe")
        tot_objf += objf
        tot_frames += len(eg.num_ali)
        posts[key] = post
    return tot_objf, tot_frames, posts


def nnet3_discriminative_compute_objf(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute the discriminative (sMBR/MPFE) objective over "
        "examples with a live model forward "
        "(nnet3-discriminative-compute-objf.cc).\n"
        "Usage: nnet3-discriminative-compute-objf [options] "
        "<model-dir> <trans-model> <egs-rspecifier>")
    criterion = po.register_value("criterion", "smbr", "smbr | mpfe")
    acoustic_scale = po.register_value(
        "acoustic-scale", 0.1, "Scaling factor for acoustic likelihoods")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    objf, frames, _p = _degs_objf(po.get_arg(1), po.get_arg(2),
                                  po.get_arg(3), criterion[0],
                                  acoustic_scale[0], use_gpu[0])
    print(f"{criterion[0]} objective per frame is "
          f"{objf / max(frames, 1):.6f} over {frames:.0f} frames",
          flush=True)
    return 0


def nnet3_discriminative_compute_from_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Forward nnet3 outputs for discriminative examples "
        "(nnet3-discriminative-compute-from-egs.cc).\n"
        "Usage: nnet3-discriminative-compute-from-egs [options] "
        "<model-dir> <egs-rspecifier> <matrix-wspecifier>")
    use_gpu = register_use_gpu(po)
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    forward = _degs_forward(po.get_arg(1), use_gpu[0])
    writer = TableWriter("matrix", po.get_arg(3))
    n = 0
    for key, eg in SequentialTableReader("degs", po.get_arg(2)):
        writer.write(key, np.asarray(forward(eg.feats[None])[0].cpu(),
                                     np.float32))
        n += 1
    writer.close()
    log(f"computed outputs for {n} examples")
    return 0 if n else 1
