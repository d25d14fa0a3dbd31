"""Convert a JAX package xconfig checkpoint directory (orbax `step_N`
plus `step_0.meta.json`, as kaldi_tpu/parallel/checkpoint.py writes it)
into the PyTorch port's layout (`step_N/variables.npz` plus the same
metadata, kaldi_tpu_torch/parallel/checkpoint.py).

It needs JAX, flax and orbax, so it runs where those are installed, not
on a machine that has only the port.  The model's variables are restored
with a template made from the directory's own xconfig text, as the JAX
package's tools restore them.

Run: python tools/jax_checkpoint_to_torch.py <jax-dir> <out-dir> [--step N]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def convert(jax_dir: str, out_dir: str, step=None) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kaldi_tpu.nnet3.xconfig import build_xconfig_model, parse_xconfig
    from kaldi_tpu.parallel.checkpoint import restore_checkpoint
    from kaldi_tpu_torch.parallel.checkpoint import save_checkpoint
    base = os.path.abspath(jax_dir)
    with open(os.path.join(base, "step_0.meta.json")) as f:
        text = json.load(f)["xconfig"]
    model = build_xconfig_model(text, train=False)
    dims = {l.name: l.get_int("dim") for l in parse_xconfig(text)
            if l.layer_type == "input"}
    template = model.init(jax.random.PRNGKey(0),
                          {n: jnp.zeros((1, 21, d)) for n, d in dims.items()})
    variables, extra, step = restore_checkpoint(base, template, step)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             dict(variables))
    path = save_checkpoint(out_dir, variables, step, extra=extra)
    meta0 = os.path.join(base, "step_0.meta.json")
    out0 = os.path.join(os.path.abspath(out_dir), "step_0.meta.json")
    if not os.path.exists(out0):
        shutil.copyfile(meta0, out0)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("jax_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to convert (default: the latest)")
    args = ap.parse_args(argv)
    print(convert(args.jax_dir, args.out_dir, args.step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
