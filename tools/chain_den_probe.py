#!/usr/bin/env python3
"""The chain objective at the --scale recipe's size on one NVIDIA GPU,
from synthetic data: the window-LM denominator over the committed
flagship_ng tree (seeded word sequences over its 31 phones), its in-arc
layout on the card, then with seeded chunks (random features and
i-vectors, time-tolerant numerators of seeded phone segments):

  den        the graph's host build seconds, the layout's seconds and
             sizes (states, arcs, slots by bucket, the transposes'
             buckets);
  loss       `chain_loss` forward + backward of B=32 chunks of 50 output
             frames on seeded outputs, three times: ms by CUDA events, the
             objective, the gradient bit-equal run to run, peak memory;
  den_fb     the denominator's forward and backward alone, ms;
  cpu_check  the same loss on 2 chunks in float64 on the CPU against the
             card's float32: objective and gradient (against its
             largest) relative error;
  fit        12 steps of `_fit_chain` of the 17 x 1536 TDNN-F with
             i-vectors over 384 chunks: each step's ms and objective, peak
             memory.

Prints the card's name and power limit, then one JSON line a phase.
Run: python3 tools/chain_den_probe.py   (needs CUDA)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kaldi_tpu_torch.chain import graphs as cg  # noqa: E402
from kaldi_tpu_torch.chain import objective as obj  # noqa: E402
from kaldi_tpu_torch.chain import supervision as sup  # noqa: E402
from kaldi_tpu_torch.hmm.transition_model import TransitionModel  # noqa
from kaldi_tpu_torch.recipes import chain as tchain  # noqa: E402
from kaldi_tpu_torch.recipes import train_scale  # noqa: E402
from kaldi_tpu_torch.tree.context_dep import ContextDependency  # noqa
from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")
CW, SUB, CHUNKS = 150, 3, 32 * 12


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def segments(rng, phones):
    """Seeded utterances of 12 words and silences: (window tokens,
    [(window, phone, start, end)] at the input frame rate)."""
    seq, segs, t = [], [], 0
    sil = (0, phones[0], 0)
    for _ in range(12):
        pron = [int(x) for x in rng.choice(phones[1:],
                                           size=int(rng.integers(2, 6)))]
        pad = [0] + pron + [0]
        for i in range(len(pron)):
            win = tuple(pad[i:i + 3])
            d = int(rng.integers(6, 14))
            seq.append(win)
            segs.append((win, pron[i], t, t + d))
            t += d
        d = int(rng.integers(3, 10))
        seq.append(sil)
        segs.append((sil, phones[0], t, t + d))
        t += d
    return seq, segs


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_den_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    tm = read_kaldi_object(TransitionModel.read,
                           os.path.join(ART, "flagship_ng.tm"))
    tree = read_kaldi_object(ContextDependency.read,
                             os.path.join(ART, "flagship_ng.tree"))
    phones = list(tm.get_phones())
    rng = np.random.default_rng(0)
    utts = [segments(rng, phones) for _ in range(400)]
    t0 = time.perf_counter()
    lm, info = sup.estimate_window_lm([seq for seq, _ in utts])
    den = sup.denominator_graph_from_phone_lm(lm, tm, tree,
                                              ilabel_info=info)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arcs = obj.den_arcs(den, tm.num_pdfs, dev)
    torch.cuda.synchronize()
    emit("den", host_s=host_s, layout_s=time.perf_counter() - t0,
         **arcs.slot_sizes(), pdf_buckets=arcs.from_pdf.buckets,
         src_buckets=arcs.from_src.buckets)

    chunks, nums = [], []
    for _, segs in utts:
        for start in range(0, segs[-1][3] - CW + 1, CW):
            clip = [(ph, max(s, start) - start, min(e, start + CW) - start,
                     w) for (w, ph, s, e) in segs
                    if s < start + CW and e > start]
            pairs = [(tree.compute(list(w), 0), tree.compute(list(w), 1))
                     for (_, _, _, w) in clip]
            try:
                g = sup.make_tolerance_supervision(
                    [(p, s, e) for (p, s, e, _) in clip], CW, tm, SUB, 5, 5,
                    pdf_pairs=pairs)
            except ValueError:
                continue
            chunks.append((rng.normal(size=(CW, 40)).astype(np.float32),
                           None, rng.normal(size=32).astype(np.float32)))
            nums.append(g)
    chunks, nums = chunks[:CHUNKS], nums[:CHUNKS]

    B, T, P = 32, CW // SUB, tm.num_pdfs
    x0 = torch.randn(B, T, P, device=dev,
                     generator=torch.Generator(dev).manual_seed(0)) * 2
    packed = cg.batch_pack(nums[:B])
    opts = train_scale.train_options(1)
    grads, objfs, ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        x = x0.clone().requires_grad_(True)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        objf, _ = obj.chain_loss(opts.chain, den, packed, x)
        objf.backward()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        grads.append(x.grad)
        objfs.append(float(objf.detach()))
    emit("loss", ms=ms, objf=objfs,
         bit_equal=bool(torch.equal(grads[1], grads[2])),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        ll = obj._forward_loglike(x, arcs, 0.1)
        e[1].record()
        ll.sum().backward()
        e[2].record()
        torch.cuda.synchronize()
        emit("den_fb", fwd_ms=e[0].elapsed_time(e[1]),
             bwd_ms=e[1].elapsed_time(e[2]))

    xs = x0[:2].double().cpu().requires_grad_(True)
    t0 = time.perf_counter()
    oc, _ = obj.chain_loss(opts.chain, den, cg.batch_pack(nums[:2]), xs)
    oc.backward()
    cpu_s = time.perf_counter() - t0
    xg = x0[:2].clone().requires_grad_(True)
    og, _ = obj.chain_loss(opts.chain, den, cg.batch_pack(nums[:2]), xg)
    og.backward()
    ref = xs.grad.numpy()
    emit("cpu_check", cpu_s=cpu_s,
         objf_rel=abs(float(og.detach()) - float(oc.detach()))
         / abs(float(oc.detach())),
         grad_rel_to_max=float(np.abs(xg.grad.cpu().numpy() - ref).max()
                               / np.abs(ref).max()))

    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tchain._fit_chain(train_scale.scale_config(P), den, chunks, nums,
                      train_scale.train_options(1), CW, 40, device=dev,
                      stats=stats, use_ivectors=True)
    emit("fit", seconds=time.perf_counter() - t0,
         steps=len(stats["step_ms"]), step_ms=stats["step_ms"],
         objf=stats["step_objf"], peak_memory_gb=stats["peak_memory_gb"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
