#!/usr/bin/env python3
"""Stage 8 of the generic corpus recipe (egs/template/run.py, the
flat-start e2e chain model) over seeds and epoch counts, on the CPU: how
far its WER depends on the initial draw.

DIR is a directory that tools/template_jax_bar.py filled (its corpus,
features, lang dir and G.fst; `--chain-epochs 0` stops it after stage
7).  For each epoch count and seed it trains and decodes stage 8 with
ChainTrainOptions.seed set to the seed, through

  jax        the JAX recipe's stage 8 (egs/template/run.py --stage 8)
  port       the port's (kaldi_tpu_torch.recipes.template_run --stage 8
             --use-gpu=no)
  port-jax   the port's, from the initial weights that the JAX
             package's stage 8 draws for that seed

and prints one JSON line a run: framework, seed, epochs, WER, word
errors, the epoch objectives.

Run: JAX_PLATFORMS=cpu python tools/template_chain_seeds.py DIR
     --framework jax port port-jax --epochs 2 3 4 --seeds 0 1 2 3 4
"""

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "egs", "template"))


def args_for(root: str, epochs: int) -> list:
    return ["--train", f"{root}/train", "--test", f"{root}/test",
            "--lexicon", f"{root}/lexicon.txt", "--arpa", f"{root}/lm.arpa",
            "--dir", f"{root}/exp", "--stage", "8",
            "--chain-epochs", str(epochs)]


def run_jax(root: str, epochs: int, seed: int) -> dict:
    import run as jax_run
    from kaldi_tpu.recipes import chain as jchain
    objf, said = [], []
    options, log = jchain.ChainTrainOptions, jchain.log

    def seeded(**kw):
        return options(**kw, seed=seed)

    def kept_log(msg):
        m = re.match(r"chain-e2e epoch \d+: objf/frame (\S+)", msg)
        if m:
            objf.append(float(m.group(1)))
        log(msg)

    jchain.ChainTrainOptions, jchain.log = seeded, kept_log
    jax_run.print = lambda *a, **kw: said.append(" ".join(map(str, a)))
    try:
        with contextlib.redirect_stdout(sys.stderr):
            wer = jax_run.main(args_for(root, epochs))
    finally:
        jchain.ChainTrainOptions, jchain.log = options, log
        del jax_run.print
    m = re.search(r"%WER \S+ \[ (\d+) /", [s for s in said if s.startswith(
        "chain (e2e flat-start)")][-1])
    return {"wer": wer, "word_errors": int(m.group(1)), "epoch_objf": objf}


def jax_draw(cfg, seed: int) -> dict:
    """The initial variables that the JAX package's train_chain_e2e draws
    for `seed` (kaldi_tpu/recipes/chain.py:688-690; every utterance of
    the fabricated corpus is 228 frames)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_tpu.nnet3.models import ChainTdnnf, ChainTdnnfConfig
    v = ChainTdnnf(ChainTdnnfConfig(**dataclasses.asdict(cfg)),
                   train=True).init(jax.random.PRNGKey(seed),
                                    jnp.zeros((2, 228, cfg.feat_dim)))
    return jax.tree.map(np.asarray, {"params": dict(v["params"]),
                                     "batch_stats": dict(v["batch_stats"])})


def run_port(root: str, epochs: int, seed: int, jax_init: bool) -> dict:
    from kaldi_tpu_torch.recipes import chain as tchain
    from kaldi_tpu_torch.recipes import template_run
    options, init = tchain.ChainTrainOptions, tchain.chain_tdnnf_init

    def seeded(**kw):
        return options(**kw, seed=seed)

    tchain.ChainTrainOptions = seeded
    if jax_init:
        tchain.chain_tdnnf_init = lambda cfg, _gen: jax_draw(cfg, seed)
    report = {}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            wer = template_run.main(args_for(root, epochs) + ["--use-gpu=no"],
                                    report=report)
    finally:
        tchain.ChainTrainOptions, tchain.chain_tdnnf_init = options, init
    return {"wer": wer, "word_errors": report["chain"]["word_errors"],
            "epoch_objf": report["chain"]["train"]["epoch_objf"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--framework", nargs="+", default=["jax", "port"],
                    choices=("jax", "port", "port-jax"))
    ap.add_argument("--epochs", nargs="+", type=int, default=[2])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    args = ap.parse_args()
    for framework in args.framework:
        for epochs in args.epochs:
            for seed in args.seeds:
                if framework == "jax":
                    out = run_jax(args.dir, epochs, seed)
                else:
                    out = run_port(args.dir, epochs, seed,
                                   framework == "port-jax")
                print(json.dumps({"framework": framework, "seed": seed,
                                  "epochs": epochs, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
