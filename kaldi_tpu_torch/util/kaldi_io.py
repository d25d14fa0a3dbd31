"""Whole-object reads of Kaldi files (port of `read_kaldi_object` of
`kaldi_tpu/util/kaldi_io.py`, for plain file paths)."""

from __future__ import annotations

from kaldi_tpu_torch.base import io_funcs


def read_kaldi_object(read_fn, path: str):
    """ReadKaldiObject (kaldi-io.h:239): detect the binary marker, then
    read_fn(stream, binary)."""
    with open(path, "rb") as f:
        binary = io_funcs.init_input_stream(f)
        return read_fn(f, binary)
