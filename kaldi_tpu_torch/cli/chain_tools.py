"""chainbin-equivalent CLIs (port of `kaldi_tpu/cli/chain_tools.py`;
src/chainbin/*.cc): chain-est-phone-lm, chain-make-den-fst,
chain-get-supervision, and the nnet3-chain-*egs / train / compute-prob /
combine surface over the port's chain stack (chain/supervision.py,
chain/objective.py, parallel/trainer.py).

nnet3-chain-train and nnet3-chain-compute-prob run on the card unless
--use-gpu=no; compute-prob's forward is then the compiled module
(nnet3/torch_bridge.py), and under --use-gpu=no the host evaluator
(Nnet3Graph.forward).  Neither falls back to the host when the card
fails.  The egs tools run on the host; their archives are the JAX
package's, byte for byte.

Each eg's stored context is trimmed by the trainer (the model pads
inside) but read by nnet3-chain-compute-prob (the exported graph clamps
offsets at the chunk's edges), so chunk edges score differently in
training and in diagnosis, as in the JAX package."""

from __future__ import annotations

import random
from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError, log, warn
from kaldi_tpu_torch.cli.online_tools2 import use_gpu_device as _device
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def _read_tree_tm(tree_path: str, model_path: str):
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.tree.context_dep import ContextDependency
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tree = read_kaldi_object(ContextDependency.read, tree_path)
    tm = read_kaldi_object(TransitionModel.read, model_path)
    return tree, tm


def chain_est_phone_lm(argv: List[str]) -> int:
    po = ParseOptions(
        "Initialize un-smoothed phone language model for 'chain' "
        "training\n"
        "Usage: chain-est-phone-lm [options] <phone-seqs-rspecifier> "
        "<phone-lm-fst-out>\n(src/chainbin/chain-est-phone-lm.cc)")
    interp = po.register_value(
        "ngram-interp", 0.1, "Unigram interpolation weight of the "
        "bigram phone LM")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.chain.supervision import estimate_phone_lm
    from kaldi_tpu_torch.fstext.openfst_io import write_fst
    from kaldi_tpu_torch.util.kaldi_io import output_stream
    seqs = []
    phones = set()
    for _key, seq in SequentialTableReader("int-vector", po.get_arg(1)):
        seqs.append(list(seq))
        phones.update(int(p) for p in seq)
    if not seqs:
        raise KaldiTpuError("chain-est-phone-lm: no phone sequences")
    lm = estimate_phone_lm(seqs, sorted(phones), interp[0])
    with output_stream(po.get_arg(2)) as f:
        write_fst(f, lm)
    log(f"estimated phone LM over {len(seqs)} sequences, "
        f"{len(phones)} phones -> {po.get_arg(2)}")
    return 0


def chain_make_den_fst(argv: List[str]) -> int:
    po = ParseOptions(
        "Created denominator FST and normalization FST for 'chain' "
        "training\n"
        "Usage: chain-make-den-fst [options] <tree-in> "
        "<transition-model-in> <phone-lm-fst-in> <den-fst-out> "
        "<normalization-fst-out>\n"
        "(src/chainbin/chain-make-den-fst.cc)")
    po.read(argv)
    if po.num_args() != 5:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.chain.graphs import den_graph_to_fsts
    from kaldi_tpu_torch.chain.supervision import \
        denominator_graph_from_phone_lm
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file, write_fst
    from kaldi_tpu_torch.util.kaldi_io import output_stream
    tree, tm = _read_tree_tm(po.get_arg(1), po.get_arg(2))
    lm = read_fst_file(po.get_arg(3))
    den = denominator_graph_from_phone_lm(lm, tm, tree)
    den_fst, norm_fst = den_graph_to_fsts(den)
    with output_stream(po.get_arg(4)) as f:
        write_fst(f, den_fst)
    with output_stream(po.get_arg(5)) as f:
        write_fst(f, norm_fst)
    log(f"den graph: {den.num_states} states, "
        f"{den.graph.num_arcs} arcs")
    return 0


def chain_get_supervision(argv: List[str]) -> int:
    po = ParseOptions(
        "Get a 'chain' supervision object for each file of training "
        "data\n"
        "Usage: chain-get-supervision [options] <tree> "
        "<transition-model> <alignments-rspecifier> "
        "<supervision-wspecifier>\n"
        "(src/chainbin/chain-get-supervision.cc; tolerance numerators "
        "per chain/chain-supervision.h)")
    sub = po.register_value("frame-subsampling-factor", 3,
                            "Frame subsampling factor of the output")
    left_tol = po.register_value("left-tolerance", 5,
                                 "Left tolerance in input frames")
    right_tol = po.register_value("right-tolerance", 5,
                                  "Right tolerance in input frames")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.chain.supervision import (
        alignment_to_phone_segments, make_tolerance_supervision)
    from kaldi_tpu_torch.nnet3.egs import SupervisionHolder
    _tree, tm = _read_tree_tm(po.get_arg(1), po.get_arg(2))
    n = 0
    with TableWriter(SupervisionHolder(), po.get_arg(4)) as w:
        for key, ali in SequentialTableReader("int-vector",
                                              po.get_arg(3)):
            segs = alignment_to_phone_segments(ali, tm)
            g = make_tolerance_supervision(
                segs, len(ali), tm, subsample=sub[0],
                left_tolerance=left_tol[0],
                right_tolerance=right_tol[0])
            w.write(key, g)
            n += 1
    log(f"chain-get-supervision: {n} supervisions")
    return 0 if n else 1


def nnet3_chain_get_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Get frame-by-frame examples of data for nnet3+chain "
        "training\n"
        "Usage: nnet3-chain-get-egs [options] <transition-model> "
        "<features-rspecifier> <ali-rspecifier> <egs-wspecifier>\n"
        "(src/chainbin/nnet3-chain-get-egs.cc)")
    chunk_width = po.register_value("chunk-width", 140,
                                    "Chunk width in input frames")
    subsample = po.register_value("frame-subsampling-factor", 3,
                                  "Output frame subsampling")
    left = po.register_value("left-context", 13, "Left feat context")
    right = po.register_value("right-context", 13, "Right feat context")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.nnet3.egs import generate_chain_egs
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(1))
    feats = {k: np.asarray(m) for k, m in
             SequentialTableReader("matrix", po.get_arg(2))}
    alis = {k: list(a) for k, a in
            SequentialTableReader("int-vector", po.get_arg(3))}
    n = generate_chain_egs(feats, alis, tm, po.get_arg(4),
                           chunk_width=chunk_width[0],
                           subsample=subsample[0],
                           left_context=left[0],
                           right_context=right[0])
    log(f"nnet3-chain-get-egs: {n} examples")
    return 0 if n else 1


def nnet3_chain_e2e_get_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Get whole-utterance FLAT-START chain examples: the numerator "
        "is the transcript graph with free phone durations — no "
        "alignment needed (src/chainbin/nnet3-chain-e2e-get-egs.cc).\n"
        "Usage: nnet3-chain-e2e-get-egs [options] <transition-model> "
        "<features-rspecifier> <phone-transcripts-rspecifier> "
        "<egs-wspecifier>")
    optional_sil = po.register_value(
        "optional-silence-phone", 0, "Phone id of the optional "
        "silence insertable at every boundary (0 = none)")
    po.read(argv)
    if po.num_args() != 4:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.nnet3.egs import generate_chain_e2e_egs
    from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object
    tm = read_kaldi_object(TransitionModel.read, po.get_arg(1))
    feats = {k: np.asarray(m) for k, m in
             SequentialTableReader("matrix", po.get_arg(2))}
    trans = {k: [int(p) for p in v] for k, v in
             SequentialTableReader("int-vector", po.get_arg(3))}
    n = generate_chain_e2e_egs(
        feats, trans, tm, po.get_arg(4),
        optional_sil=optional_sil[0] or None)
    log(f"nnet3-chain-e2e-get-egs: {n} examples")
    return 0 if n else 1


def nnet3_chain_copy_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy examples for nnet3+chain training, possibly changing "
        "the binary mode; supports multiple wspecifiers (round-robin "
        "distribution)\n"
        "Usage: nnet3-chain-copy-egs [options] <egs-rspecifier> "
        "<egs-wspecifier1> [<egs-wspecifier2> ...]\n"
        "(src/chainbin/nnet3-chain-copy-egs.cc)")
    frame_shift = po.register_value("frame-shift", 0,
                                    "Allows a frame shift (ignored: "
                                    "kept for script parity)")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    _ = frame_shift
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder
    writers = [TableWriter(ChainExampleHolder(), po.get_arg(i))
               for i in range(2, po.num_args() + 1)]
    n = 0
    for key, eg in SequentialTableReader(ChainExampleHolder(),
                                         po.get_arg(1)):
        writers[n % len(writers)].write(key, eg)
        n += 1
    for w in writers:
        w.close()
    log(f"nnet3-chain-copy-egs: {n} examples to {len(writers)} "
        "archives")
    return 0 if n else 1


def nnet3_chain_shuffle_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Copy examples for nnet3+chain training, from the input to "
        "output, while randomly shuffling the order\n"
        "Usage: nnet3-chain-shuffle-egs [options] <egs-rspecifier> "
        "<egs-wspecifier>\n"
        "(src/chainbin/nnet3-chain-shuffle-egs.cc)")
    seed = po.register_value("srand", 0, "Seed for random number "
                             "generator")
    buffer_size = po.register_value("buffer-size", 5000,
                                    "Reservoir size for shuffling")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.egs import shuffle_egs
    n = shuffle_egs(po.get_arg(1), po.get_arg(2), seed=seed[0],
                    buffer_size=buffer_size[0])
    log(f"nnet3-chain-shuffle-egs: {n} examples")
    return 0 if n else 1


def nnet3_chain_subset_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Creates a random subset of the input nnet3+chain examples\n"
        "Usage: nnet3-chain-subset-egs [options] <egs-rspecifier> "
        "<subset-egs-wspecifier>\n"
        "(src/chainbin/nnet3-chain-subset-egs.cc)")
    n_sub = po.register_value("n", 10, "Number of examples to keep")
    randomize = po.register_value("randomize-order", True,
                                  "If true, randomize the order")
    seed = po.register_value("srand", 0, "Random seed")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder
    rng = random.Random(seed[0])
    kept: List = []
    n_in = 0
    for key, eg in SequentialTableReader(ChainExampleHolder(),
                                         po.get_arg(1)):
        n_in += 1
        if len(kept) < n_sub[0]:
            kept.append((key, eg))
        elif randomize[0]:
            j = rng.randrange(n_in)
            if j < n_sub[0]:
                kept[j] = (key, eg)
    with TableWriter(ChainExampleHolder(), po.get_arg(2)) as w:
        for key, eg in kept:
            w.write(key, eg)
    log(f"nnet3-chain-subset-egs: kept {len(kept)} of {n_in}")
    return 0 if kept else 1


def nnet3_chain_merge_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Merge examples to minibatches (this implementation writes "
        "each minibatch back as stacked single examples keyed "
        "mb-N-i; the trainer merges in memory via "
        "nnet3.egs.merged_minibatches)\n"
        "Usage: nnet3-chain-merge-egs [options] <egs-rspecifier> "
        "<egs-wspecifier>\n"
        "(src/chainbin/nnet3-chain-merge-egs.cc)")
    mb = po.register_value("minibatch-size", 64, "Minibatch size")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder
    by_shape = {}
    n_out = 0
    with TableWriter(ChainExampleHolder(), po.get_arg(2)) as w:
        for key, eg in SequentialTableReader(ChainExampleHolder(),
                                             po.get_arg(1)):
            shape = (eg.feats.shape, eg.num_graph.num_states)
            group = by_shape.setdefault(shape, [])
            group.append((key, eg))
            if len(group) == mb[0]:
                for i, (k, e) in enumerate(group):
                    w.write(f"mb-{n_out}-{i}", e)
                n_out += 1
                by_shape[shape] = []
        for group in by_shape.values():
            if group:
                for i, (k, e) in enumerate(group):
                    w.write(f"mb-{n_out}-{i}", e)
                n_out += 1
    log(f"nnet3-chain-merge-egs: {n_out} minibatches")
    return 0 if n_out else 1


def nnet3_chain_normalize_egs(argv: List[str]) -> int:
    po = ParseOptions(
        "Add weights from the normalization FST to the supervision "
        "graphs of chain examples\n"
        "Usage: nnet3-chain-normalize-egs [options] "
        "<normalization-fst> <egs-rspecifier> <egs-wspecifier>\n"
        "(src/chainbin/nnet3-chain-normalize-egs.cc)")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.chain.graphs import pack_emission_fst
    from kaldi_tpu_torch.fstext.fst import EPS, Arc, TropicalWeight, VectorFst
    from kaldi_tpu_torch.fstext.openfst_io import read_fst_file
    from kaldi_tpu_torch.fstext.ops import (arcsort, compose, connect,
                                            rm_epsilon)
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder
    norm = arcsort(read_fst_file(po.get_arg(1)), "ilabel")
    n = 0
    n_fail = 0
    with TableWriter(ChainExampleHolder(), po.get_arg(3)) as w:
        for key, eg in SequentialTableReader(ChainExampleHolder(),
                                             po.get_arg(2)):
            g = eg.num_graph
            # numerator PackedGraph -> pdf+1 acceptor
            f = VectorFst(TropicalWeight)
            for _ in range(g.num_states):
                f.add_state()
            init = np.asarray(g.initial)
            starts = np.nonzero(np.isfinite(init))[0]
            if len(starts) == 1:
                f.set_start(int(starts[0]))
            else:
                s0 = f.add_state()
                f.set_start(s0)
                for s in starts:
                    f.add_arc(s0, Arc(EPS, EPS, -float(init[s]),
                                      int(s)))
            fin = np.asarray(g.final)
            for s in np.nonzero(np.isfinite(fin))[0]:
                f.finals[int(s)] = -float(fin[s])
            for a in range(g.num_arcs):
                lbl = int(g.pdf[a]) + 1
                f.add_arc(int(g.src[a]),
                          Arc(lbl, lbl, -float(g.log_prob[a]),
                              int(g.dst[a])))
            comp = connect(compose(f, norm))
            if comp.num_states == 0:
                warn(f"nnet3-chain-normalize-egs: empty composition "
                     f"for {key}")
                n_fail += 1
                continue
            comp = rm_epsilon(comp)
            eg.num_graph = pack_emission_fst(comp)
            w.write(key, eg)
            n += 1
    log(f"nnet3-chain-normalize-egs: {n} normalized, {n_fail} failed")
    return 0 if n else 1


def nnet3_chain_compute_prob(argv: List[str]) -> int:
    po = ParseOptions(
        "Computes and prints the average log-prob per frame of the "
        "given data under the chain objective\n"
        "Usage: nnet3-chain-compute-prob [options] <model-in> "
        "<den-fst> <egs-rspecifier>\n"
        "(src/chainbin/nnet3-chain-compute-prob.cc; model is a .mdl "
        "written by this framework's exporter)")
    lm_scale = po.register_value("leaky-hmm-coefficient", 0.1,
                                 "Leaky HMM coefficient")
    use_gpu = po.register_value("use-gpu", "yes",
                                "yes: the compiled model and the objective "
                                "on the CUDA card (fail without one); no: "
                                "the host evaluator and the CPU")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    import torch

    from kaldi_tpu_torch.chain.graphs import (batch_pack,
                                              den_graph_from_fst_file)
    from kaldi_tpu_torch.chain.objective import (ChainTrainingOptions,
                                                 chain_loss)
    from kaldi_tpu_torch.device import full_f32
    from kaldi_tpu_torch.nnet3.egs import ChainExampleHolder
    from kaldi_tpu_torch.nnet3.mdl_io import read_nnet3_any
    dev = _device(use_gpu[0])
    _tm, graph, _info = read_nnet3_any(po.get_arg(1))
    if dev.type == "cuda":
        from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
        net = compile_graph(graph, "output", device=dev)

        def forward(feats):
            return net(feats[None])[0]
    else:
        def forward(feats):
            return torch.from_numpy(graph.forward(feats))
    den = den_graph_from_fst_file(po.get_arg(2))
    opts = ChainTrainingOptions(leaky_hmm_coefficient=lm_scale[0],
                                xent_regularize=0.0)
    tot_objf, tot_frames = 0.0, 0
    for key, eg in SequentialTableReader(ChainExampleHolder(),
                                         po.get_arg(3)):
        out = forward(np.asarray(eg.feats, np.float32))
        # trim the eg's stored acoustic context (the exported graph
        # evaluates at the full input rate with clamped offsets), then
        # take every sub-th frame: the exporter multiplies offsets
        # after the subsample point so t in {0, sub, 2*sub, ...}
        # reproduces the training model's output frames
        lc, rc = eg.left_context, eg.right_context
        out = out[lc:out.shape[0] - rc if rc else None]
        T_sup = max(1, eg.num_graph.num_states - 1)  # linear numerator
        sub = max(1, round(out.shape[0] / T_sup))
        out = out[::sub][:T_sup]
        T_out = out.shape[0]
        num = batch_pack([eg.num_graph])
        with torch.no_grad(), full_f32():
            objf, _aux = chain_loss(opts, den, num, out[None].contiguous())
        tot_objf += float(objf) * T_out
        tot_frames += T_out
    if tot_frames == 0:
        raise KaldiTpuError("no examples")
    log(f"Overall log-probability for 'output' is "
        f"{tot_objf / tot_frames:.4f} per frame, over {tot_frames} "
        "frames.")
    return 0


def nnet3_chain_train(argv: List[str]) -> int:
    po = ParseOptions(
        "Train nnet3+chain parameters with backprop and the chain "
        "objective from prepared examples (this framework trains its "
        "native TDNN-F config and writes an exporter .mdl)\n"
        "Usage: nnet3-chain-train [options] <den-fst> "
        "<egs-rspecifier> <model-out>\n"
        "(src/chainbin/nnet3-chain-train.cc)")
    num_epochs = po.register_value("num-epochs", 4, "Epochs over egs")
    mb = po.register_value("minibatch-size", 32, "Minibatch size")
    lr = po.register_value("learning-rate", 1e-3, "Initial LR")
    hidden = po.register_value("hidden-dim", 256, "TDNN-F hidden dim")
    bottleneck = po.register_value("bottleneck-dim", 64,
                                   "TDNN-F bottleneck dim")
    layers = po.register_value("num-layers", 6, "TDNN-F layers")
    xent = po.register_value("xent-regularize", 0.1,
                             "Cross-entropy regularization weight")
    sub = po.register_value("frame-subsampling-factor", 3,
                            "Frame subsampling factor")
    use_gpu = po.register_value("use-gpu", "yes",
                                "yes: train on the CUDA card (fail "
                                "without one); no: on the CPU")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    import json
    import time

    from kaldi_tpu_torch.parallel.trainer import train_chain_from_egs
    stats: dict = {}
    t0 = time.perf_counter()
    n_steps, objf = train_chain_from_egs(
        den_fst_path=po.get_arg(1), egs_rspecifier=po.get_arg(2),
        model_out=po.get_arg(3), num_epochs=num_epochs[0],
        minibatch_size=mb[0], learning_rate=lr[0],
        hidden_dim=hidden[0], bottleneck_dim=bottleneck[0],
        num_layers=layers[0], xent_regularize=xent[0],
        frame_subsampling_factor=sub[0], device=_device(use_gpu[0]),
        stats=stats)
    stats["seconds"] = time.perf_counter() - t0
    log(f"nnet3-chain-train: {n_steps} steps, final objf {objf:.4f}")
    log(f"nnet3-chain-train stats {json.dumps(stats)}")
    return 0


def average_models(paths: List[str], out_path: str) -> int:
    """Equal-weight parameter average of nnet3 models (.mdl or raw).
    The reference's nnet3-combine/nnet3-chain-combine default to
    --enforce-sum-to-one averaging over the last few iters'
    models; this implements that equal-weight case."""
    from kaldi_tpu_torch.nnet3.mdl_io import (read_nnet3_any,
                                              write_nnet3_am,
                                              write_raw_nnet3)
    tm, base, info = read_nnet3_any(paths[0])
    others = [read_nnet3_any(p)[1] for p in paths[1:]]
    n = len(paths)
    for name, comp in base.components.items():
        for key, val in comp.fields.items():
            arr = np.asarray(val)
            if arr.dtype.kind != "f" or arr.ndim == 0:
                continue
            acc = arr.astype(np.float64)
            for g in others:
                acc += np.asarray(g.components[name].fields[key],
                                  np.float64)
            comp.fields[key] = (acc / n).astype(np.float32)
    if tm is None:
        write_raw_nnet3(base, out_path)
    else:
        write_nnet3_am(out_path, tm, base,
                       left_context=info["left_context"],
                       right_context=info["right_context"],
                       priors=info["priors"])
    log(f"averaged {n} models -> {out_path}")
    return 0


def nnet3_chain_combine(argv: List[str]) -> int:
    po = ParseOptions(
        "Using a subset of training or held-out nnet3+chain "
        "examples, compute an average over the parameters of the "
        "input models (equal-weight combination)\n"
        "Usage: nnet3-chain-combine [options] <model-in1> "
        "<model-in2> ... <model-out>\n"
        "(src/chainbin/nnet3-chain-combine.cc)")
    po.read(argv)
    if po.num_args() < 2:
        po.print_usage()
        return 1
    return average_models([po.get_arg(i)
                           for i in range(1, po.num_args())],
                          po.get_arg(po.num_args()))
