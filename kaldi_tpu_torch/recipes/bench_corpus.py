"""Loaders for the committed bench-corpus model files (numpy copies of
the loaders in `kaldi_tpu/recipes/bench_corpus.py`).

`egs/bench_corpus/flagship_ng_params.npz` holds the flagship chain
TDNN-F as "/"-joined flax paths ("params/tdnnf1/linear", ...), the big
arrays stored as float16; `flagship_ng_ivec.npz` holds the i-vector
extractor with its diagonal UBM.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_params(path: str) -> dict:
    """-> {"params": {...}, "batch_stats": {...}} nested dicts of numpy
    arrays, float16 upcast to float32 (the layout flax's `model.init`
    gives, which `chain_tdnnf_from_flax` reads)."""
    out: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            a = data[key]
            if a.dtype == np.float16:
                a = a.astype(np.float32)
            node[parts[-1]] = a
    return out


def load_ivector_extractor(path: str) -> Dict[str, np.ndarray]:
    """-> the arrays BatchedIvectorExtractor takes: M (G, D, R) and
    sigma_inv (G, D) as float64, prior (the prior offset), and the
    diagonal UBM's weights, means and inv_vars."""
    with np.load(path) as d:
        return {
            "M": d["M"].astype(np.float64),
            "sigma_inv": d["sigma_inv"].astype(np.float64),
            "prior": float(d["prior"]),
            "weights": np.asarray(d["weights"], np.float64),
            "means": np.asarray(d["means"], np.float64),
            "inv_vars": np.asarray(d["inv_vars"], np.float64),
        }
