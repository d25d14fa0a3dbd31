"""Lattice type (the part of `kaldi_tpu/lat/kaldi_lattice.py` that the
lattice decoders need).

Lattice — VectorFst over LatticeWeight (graph_cost, acoustic_cost);
ilabels = transition-ids, olabels = words.
"""

from __future__ import annotations

from kaldi_tpu_torch.fstext.fst import VectorFst

Lattice = VectorFst  # semiring=LatticeWeight, ilabel=tid, olabel=word
