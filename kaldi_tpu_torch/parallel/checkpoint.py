"""Checkpoint directories of xconfig models (port of
`kaldi_tpu/parallel/checkpoint.py`; the reference's per-iteration model
writes and --stage resumability).

The directory layout is the reference's: `step_N` holds one step's
variables and `step_N.meta.json` its metadata (the xconfig text of the
model, under "xconfig", or a trainer's data position); `restore_checkpoint`
takes the latest step unless one is asked for.

`step_N` is not orbax's format, which needs orbax and tensorstore: it is
a directory holding `variables.npz`, an uncompressed numpy archive (no
pickle) keyed by each array's path in the {"params", "batch_stats"} tree
("params/tdnnf3/linear", "batch_stats/tdnn1_bn/bn/mean").  A step in the
JAX package's orbax format is refused with a message naming
tools/jax_checkpoint_to_torch.py, which converts such a directory where
JAX and orbax are installed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.base.logging import KaldiTpuError, log

VARIABLES = "variables.npz"
CONVERTER = "tools/jax_checkpoint_to_torch.py"


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a/b": x}, the leaves as numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise KaldiTpuError(f"checkpoint key {k!r} contains '/'")
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "/"))
        elif isinstance(v, torch.Tensor):
            out[path] = v.detach().cpu().numpy()
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_checkpoint(ckpt_dir: str, state: dict, step: int,
                    extra: Optional[Dict] = None) -> str:
    """Write a tree of arrays as `step_<step>/variables.npz` (and the
    JSON metadata `extra` beside it); -> the step's path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, VARIABLES + ".tmp.npz")
    np.savez(tmp, **flatten_tree(state))
    os.replace(tmp, os.path.join(path, VARIABLES))
    if extra:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    log(f"saved checkpoint {path}")
    return path


def checkpoint_steps(ckpt_dir: str) -> list:
    base = os.path.abspath(ckpt_dir)
    return sorted(int(d.split("_")[1]) for d in os.listdir(base)
                  if d.startswith("step_") and not d.endswith(".json"))


def restore_checkpoint(ckpt_dir: str, template: Optional[Any] = None,
                       step: Optional[int] = None
                       ) -> Tuple[dict, Optional[dict], int]:
    """Restore the given (or the latest) step -> (state, extra, step).
    With a template tree, the restored arrays must have its paths and
    shapes."""
    base = os.path.abspath(ckpt_dir)
    if step is None:
        steps = checkpoint_steps(base)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {base}")
        step = steps[-1]
    path = os.path.join(base, f"step_{step}")
    npz = os.path.join(path, VARIABLES)
    if not os.path.isfile(npz):
        if os.path.isdir(path):
            raise KaldiTpuError(
                f"{path} is not a {VARIABLES} checkpoint step (a JAX/orbax "
                f"checkpoint?); convert the directory with {CONVERTER} "
                "where JAX and orbax are installed")
        raise FileNotFoundError(f"no checkpoint step {path}")
    with np.load(npz, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    if template is not None:
        want = {k: np.shape(v) for k, v in flatten_tree(template).items()}
        got = {k: v.shape for k, v in flat.items()}
        if want != got:
            raise KaldiTpuError(
                f"{path}: arrays differ from the template: "
                f"{sorted(set(want.items()) ^ set(got.items()))[:6]}")
    extra = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return unflatten_tree(flat), extra, step


def load_xconfig_checkpoint(ckpt_dir: str, device=None,
                            step: Optional[int] = None):
    """-> (xconfig model in eval mode on `device`, xconfig text, step):
    the text from `step_0.meta.json`, as the reference's tools read it,
    the weights of the given (or latest) step."""
    from kaldi_tpu_torch.nnet3.xconfig import xconfig_from_flax
    base = os.path.abspath(ckpt_dir)
    meta = os.path.join(base, "step_0.meta.json")
    if not os.path.isfile(meta):
        raise KaldiTpuError(f"{meta} not found: not an xconfig checkpoint "
                            "directory")
    with open(meta) as f:
        text = json.load(f)["xconfig"]
    variables, _, step = restore_checkpoint(base, step=step)
    return xconfig_from_flax(text, variables, device=device), text, step


class ObjectiveInfo:
    """Running objective logging (nnet-training.h:123
    ObjectiveFunctionInfo): a phase report every `interval` minibatches."""

    def __init__(self, name: str = "output", interval: int = 100):
        self.name = name
        self.interval = interval
        self.phase_objf = 0.0
        self.phase_frames = 0.0
        self.total_objf = 0.0
        self.total_frames = 0.0
        self.minibatches = 0

    def update(self, objf_per_frame: float, num_frames: float) -> None:
        self.phase_objf += objf_per_frame * num_frames
        self.phase_frames += num_frames
        self.total_objf += objf_per_frame * num_frames
        self.total_frames += num_frames
        self.minibatches += 1
        if self.minibatches % self.interval == 0:
            start = self.minibatches - self.interval
            log(f"Average objective function for '{self.name}' for "
                f"minibatches {start}-{self.minibatches - 1} is "
                f"{self.phase_objf / max(self.phase_frames, 1):.4f} over "
                f"{self.phase_frames:.0f} frames.")
            self.phase_objf = self.phase_frames = 0.0

    def print_total(self) -> float:
        avg = self.total_objf / max(self.total_frames, 1)
        log(f"Overall average objective for '{self.name}' is {avg:.4f} "
            f"over {self.total_frames:.0f} frames.")
        return avg
