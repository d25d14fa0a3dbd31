"""Extended filenames and whole-object reads and writes of Kaldi files
(port of `kaldi_tpu/util/kaldi_io.py`; the reference's util/kaldi-io.h
Input/Output, kaldi-io.h:124,190).

An rxfilename (read) or wxfilename (write) is a plain path, "-" or ""
(stdin/stdout), a pipe ("gunzip -c foo.gz|" to read, "|gzip -c >
foo.gz" to write) or, to read, a path with a byte offset
("foo.ark:1234").  Paths ending in ".gz" are read and written through
gzip directly (the reference relies on a shell gunzip).
"""

from __future__ import annotations

import gzip
import io
import re
import subprocess
import sys
from contextlib import contextmanager
from typing import BinaryIO

from kaldi_tpu_torch.base import io_funcs
from kaldi_tpu_torch.base.logging import KaldiTpuError


def classify_rxfilename(name: str) -> str:
    """One of 'standard', 'pipe', 'offset', 'file', 'none'."""
    if name == "" or name == "-":
        return "standard"
    if name.endswith("|"):
        return "pipe"
    if re.search(r":[0-9]+$", name) and not name.startswith("|"):
        return "offset"
    if name.startswith("|"):
        return "none"  # an output pipe is not readable
    return "file"


def classify_wxfilename(name: str) -> str:
    """One of 'standard', 'pipe', 'file', 'none'."""
    if name == "" or name == "-":
        return "standard"
    if name.startswith("|"):
        return "pipe"
    if name.endswith("|"):
        return "none"
    return "file"


class _PipeInput(io.BufferedReader):
    def __init__(self, cmd: str):
        self._proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        super().__init__(self._proc.stdout)

    def close(self):
        try:
            super().close()
        finally:
            rc = self._proc.wait()
            if rc not in (0, -13):  # SIGPIPE is tolerated, as upstream
                raise KaldiTpuError(
                    f"input pipe command failed (status {rc})")


class _PipeOutput(io.BufferedWriter):
    def __init__(self, cmd: str):
        self._proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        super().__init__(self._proc.stdin)

    def close(self):
        try:
            super().close()
        finally:
            rc = self._proc.wait()
            if rc != 0:
                raise KaldiTpuError(
                    f"output pipe command failed (status {rc})")


def _open_path_for_read(path: str) -> BinaryIO:
    if path.endswith(".gz"):
        return io.BufferedReader(gzip.open(path, "rb"))
    return open(path, "rb")


def open_input(rxfilename: str) -> BinaryIO:
    """Open an rxfilename for binary reading; the caller closes it.
    stdin and pipes cannot seek, so they are read through
    io_funcs.PeekableReader, whose multi-byte peeks the readers need."""
    kind = classify_rxfilename(rxfilename)
    if kind == "standard":
        return io_funcs.PeekableReader(sys.stdin.buffer)
    if kind == "pipe":
        return io_funcs.PeekableReader(_PipeInput(rxfilename[:-1]))
    if kind == "offset":
        path, offset = rxfilename.rsplit(":", 1)
        f = _open_path_for_read(path)
        f.seek(int(offset))
        return f
    if kind == "file":
        return _open_path_for_read(rxfilename)
    raise KaldiTpuError(f"invalid rxfilename: {rxfilename!r}")


def open_output(wxfilename: str) -> BinaryIO:
    """Open a wxfilename for binary writing; the caller closes it
    (stdout is flushed, not closed: output_stream)."""
    kind = classify_wxfilename(wxfilename)
    if kind == "standard":
        return sys.stdout.buffer
    if kind == "pipe":
        return _PipeOutput(wxfilename[1:])
    if kind == "file":
        if wxfilename.endswith(".gz"):
            return io.BufferedWriter(gzip.open(wxfilename, "wb"))
        return open(wxfilename, "wb")
    raise KaldiTpuError(f"invalid wxfilename: {wxfilename!r}")


@contextmanager
def input_stream(rxfilename: str):
    f = open_input(rxfilename)
    try:
        yield f
    finally:
        if getattr(f, "_raw", f) is not sys.stdin.buffer:
            f.close()


@contextmanager
def output_stream(wxfilename: str):
    f = open_output(wxfilename)
    try:
        yield f
    finally:
        if f is not sys.stdout.buffer:
            f.close()
        else:
            f.flush()


def read_kaldi_object(read_fn, rxfilename: str):
    """ReadKaldiObject (kaldi-io.h:239): detect the binary marker, then
    read_fn(stream, binary)."""
    with input_stream(rxfilename) as f:
        binary = io_funcs.init_input_stream(f)
        return read_fn(f, binary)


def write_kaldi_object(write_fn, wxfilename: str, binary: bool = True) -> None:
    """WriteKaldiObject (kaldi-io.h:226): the binary marker when binary,
    then write_fn(stream, binary)."""
    with output_stream(wxfilename) as f:
        io_funcs.init_output_stream(f, binary)
        write_fn(f, binary)
