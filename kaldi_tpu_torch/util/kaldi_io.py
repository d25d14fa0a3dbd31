"""Whole-object reads and writes of Kaldi files (port of
`read_kaldi_object` and `write_kaldi_object` of
`kaldi_tpu/util/kaldi_io.py`, for plain file paths)."""

from __future__ import annotations

from kaldi_tpu_torch.base import io_funcs


def read_kaldi_object(read_fn, path: str):
    """ReadKaldiObject (kaldi-io.h:239): detect the binary marker, then
    read_fn(stream, binary)."""
    with open(path, "rb") as f:
        binary = io_funcs.init_input_stream(f)
        return read_fn(f, binary)


def write_kaldi_object(write_fn, path: str, binary: bool = True) -> None:
    """WriteKaldiObject (kaldi-io.h:226): the binary marker when binary,
    then write_fn(stream, binary)."""
    with open(path, "wb") as f:
        io_funcs.init_output_stream(f, binary)
        write_fn(f, binary)
