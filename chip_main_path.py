#!/usr/bin/env python3
"""The main path's phases of chip_smoke.py alone, on one NVIDIA GPU,
plus two diagnostics of its WER.

Runs what chip_smoke.py runs for the main path (ng_graph, slice_ng,
profile_ng, ng_cpu_check, cross_check_ng: the V=20,000 bench corpus and
graph, 128 test utterances through BatchedOfflinePipeline2 with the
n-gram decoder, WER), without the kernel phases, so that work on the
main path's search can be measured in about two minutes.  Then:
  probe_f32_am      the WER of the same utterances with the flagship
                    model in float32 instead of bf16;
  probe_exact_pool  16 lanes' loglikes decoded with every
                    virtual-context row in the pool (exact search)
                    against the bench's pool of 128 rows, beam 16.
The WER band of chip_smoke.py is not applied here.  JSON lines as in
chip_smoke.py; exits nonzero on any failed check.

Run: python3 chip_main_path.py   (needs CUDA)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_main_path: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    cfg, variables, model, ivec, fe = cs.flagship_am()
    ng = cs.build_ng_path()
    cs.NG_WER_BAND = float("inf")
    res = cs.run_ng_slice(ng, model, ivec, fe)
    ll, lens = res["loglikes"], res["out_lens"]
    cs.ng_cpu_check(ng, ll, lens)
    cs.cross_check_ng(ng)
    graph, dec, test_txt = ng["graph"], ng["dec"], ng["test_txt"]
    utts = sorted(ng["test_wav"])
    waves = [cs.mulaw_encode(np.clip(ng["test_wav"][u], -32767, 32767))
             for u in utts]

    def wer(outs, lanes):
        return cs.wer_of({u: [graph.words[w] for w in o[0]]
                          for u, o in zip(lanes, outs)},
                         {u: test_txt[u] for u in lanes})

    pipe32 = cs.BatchedOfflinePipeline2(
        cs.chain_tdnnf_from_flax(cfg, variables, device="cuda"), dec, fe,
        ivector_extractor=ivec, search_kwargs=cs.NG_SEARCH, device="cuda")
    cs.emit("probe_f32_am", wer=wer(pipe32.decode_batch(waves), utts))
    n = 16
    t0 = time.perf_counter()
    exact = dec.decode_batch(ll[:n], lengths=lens[:n])
    exact_s = time.perf_counter() - t0
    pruned = dec.decode_batch(ll[:n], lengths=lens[:n], **cs.NG_SEARCH)
    cs.emit("probe_exact_pool", lanes=n, wer_exact=wer(exact, utts[:n]),
            wer_pruned=wer(pruned, utts[:n]), exact_s=exact_s,
            lanes_words_equal=sum(a[0] == b[0]
                                  for a, b in zip(exact, pruned)),
            cost_exact=[a[2] for a in exact[:4]],
            cost_pruned=[b[2] for b in pruned[:4]])
    cs.emit("probe_done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
