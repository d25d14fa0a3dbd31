"""nnet3-discriminative-train, add-deltas-sdc,
compute-and-process-kaldi-pitch-feats, wav-perturb-speed and
wav-perturb-volume (port of those tools of `kaldi_tpu/cli/tail9_tools.py`;
parity: nnet3bin/nnet3-discriminative-train.cc, featbin/add-deltas-sdc.cc,
compute-and-process-kaldi-pitch-feats.cc, and the speed and volume
perturbation of utils/perturb_data_dir_{speed,volume}.sh).  The feature
and wave tools are host numpy, as in the reference.

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
the i-vector dot products, the online i-vector extractor).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.cli.online_tools2 import register_use_gpu, stats_line
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


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


def compute_sdc(feats: np.ndarray, n: int, d: int, p: int,
                k: int) -> np.ndarray:
    """Shifted delta cepstra (add-deltas-sdc.cc; the N-d-P-k
    configuration, classically 7-1-3-7): output row t =
    [c_t[:n], Δ(t), Δ(t+P), ..., Δ(t+(k-1)P)] with
    Δ(u) = c[u+d] - c[u-d], indices edge-clamped."""
    x = np.asarray(feats, np.float64)[:, :n]
    T = x.shape[0]
    t = np.arange(T)

    def at(idx):
        return x[np.clip(idx, 0, T - 1)]

    blocks = [x]
    for i in range(k):
        u = t + i * p
        blocks.append(at(u + d) - at(u - d))
    return np.concatenate(blocks, axis=1).astype(np.float32)


def add_deltas_sdc(argv: List[str]) -> int:
    po = ParseOptions(
        "Append shifted delta cepstra (the language-id feature; "
        "add-deltas-sdc.cc N-d-P-k, default 7-1-3-7).\n"
        "Usage: add-deltas-sdc [options] <feats-rspecifier> "
        "<feats-wspecifier>")
    n_cep = po.register_value("num-cepstra", 7,
                              "N: leading cepstra to use")
    d_opt = po.register_value("delta-spread", 1, "d: delta spread")
    p_opt = po.register_value("block-shift", 3, "P: block shift")
    k_opt = po.register_value("num-blocks", 7, "k: number of blocks")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        if feats.shape[1] < n_cep[0]:
            warn(f"{key}: dim {feats.shape[1]} < N={n_cep[0]}")
            continue
        writer.write(key, compute_sdc(feats, n_cep[0], d_opt[0],
                                      p_opt[0], k_opt[0]))
        n += 1
    writer.close()
    log(f"wrote SDC features for {n} utterances "
        f"({n_cep[0]}-{d_opt[0]}-{p_opt[0]}-{k_opt[0]})")
    return 0 if n else 1


def wav_perturb_speed(argv: List[str]) -> int:
    po = ParseOptions(
        "Speed-perturb waveforms by a factor (the 3-way 0.9/1.0/1.1 "
        "augmentation of utils/perturb_data_dir_speed.sh, done by "
        "resampling like sox speed: the output keeps the input "
        "sample rate but is 1/factor as long, shifting pitch and "
        "tempo together).\n"
        "Usage: wav-perturb-speed [options] <factor> <wav-rspecifier> "
        "<wav-wspecifier>")
    prefix = po.register_value(
        "utt-prefix", "", "Prefix for output utterance ids "
        "(e.g. 'sp0.9-'; empty keeps the key)")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.resample import LinearResample
    from kaldi_tpu_torch.feat.wave import WaveData
    factor = float(po.get_arg(1))
    if factor <= 0:
        print("wav-perturb-speed: factor must be positive", flush=True)
        return 1
    writer = TableWriter("wave", po.get_arg(3))
    resamplers = {}
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(2)):
        fs = wav.samp_freq
        # sox speed F == play the samples at rate fs*F, i.e. resample
        # from fs*F to fs (integer rates for the gcd-phase resampler)
        rin = int(round(fs * factor))
        if rin not in resamplers:
            resamplers[rin] = LinearResample(rin, int(fs))
        out = np.stack([resamplers[rin].resample(ch)
                        for ch in wav.data])
        writer.write(prefix[0] + key, WaveData(fs, out))
        n += 1
    writer.close()
    log(f"speed-perturbed {n} waveforms by {factor}")
    return 0 if n else 1


def wav_perturb_volume(argv: List[str]) -> int:
    po = ParseOptions(
        "Scale waveform amplitudes (utils/perturb_data_dir_volume.sh; "
        "a fixed --factor or a random factor per utterance in "
        "[--low, --high]).\n"
        "Usage: wav-perturb-volume [options] <wav-rspecifier> "
        "<wav-wspecifier>")
    factor = po.register_value("factor", 0.0,
                               "Fixed scale (0 = random per utt)")
    low = po.register_value("low", 0.125, "Random range low")
    high = po.register_value("high", 2.0, "Random range high")
    seed = po.register_value("srand", 0, "Random seed")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.wave import WaveData
    rng = np.random.default_rng(seed[0])
    writer = TableWriter("wave", po.get_arg(2))
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(1)):
        f = factor[0] or float(rng.uniform(low[0], high[0]))
        out = np.clip(wav.data * f, -32768.0, 32767.0)
        writer.write(key, WaveData(wav.samp_freq,
                                   out.astype(np.float32)))
        n += 1
    writer.close()
    log(f"volume-perturbed {n} waveforms")
    return 0 if n else 1


def compute_and_process_kaldi_pitch_feats(argv: List[str]) -> int:
    po = ParseOptions(
        "Compute Kaldi pitch and post-process it into the standard "
        "(POV, normalized-log-pitch, delta) features in one tool "
        "(compute-and-process-kaldi-pitch-feats.cc).\n"
        "Usage: compute-and-process-kaldi-pitch-feats [options] "
        "<wav-rspecifier> <feats-wspecifier>")
    samp_freq = po.register_value("sample-frequency", 16000.0,
                                  "Waveform sampling frequency")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.pitch import (PitchExtractionOptions,
                                      ProcessPitchOptions,
                                      compute_kaldi_pitch,
                                      process_pitch)
    popts = PitchExtractionOptions(samp_freq=samp_freq[0])
    oopts = ProcessPitchOptions()
    writer = TableWriter("matrix", po.get_arg(2))
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(1)):
        raw = compute_kaldi_pitch(
            np.asarray(wav.channel(0), np.float32), popts)
        writer.write(key, process_pitch(raw, oopts))
        n += 1
    writer.close()
    log(f"computed+processed pitch for {n} utterances")
    return 0 if n else 1
