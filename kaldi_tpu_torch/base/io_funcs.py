"""Readers of the Kaldi wire format (numpy copy of the reading half of
`kaldi_tpu/base/io_funcs.py`, as far as the transition model, the HMM
topology and the decision tree need it).

Binary streams open with the two-byte marker b"\\x00B"
(base/io-funcs.h).  Basic types are written as a size byte and the
little-endian value; tokens are whitespace-terminated.  In text mode
every value is a whitespace-delimited token.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List

import numpy as np

BINARY_MARKER = b"\x00B"


def peek_bytes(stream: BinaryIO, n: int) -> bytes:
    """n bytes ahead without consuming them (fewer only at EOF)."""
    peek = getattr(stream, "peek", None)
    if peek is not None:
        buf = peek(n)
        if len(buf) >= n or not stream.seekable():
            return buf[:n]
    pos = stream.tell()
    data = stream.read(n)
    stream.seek(pos)
    return data


def init_input_stream(stream: BinaryIO) -> bool:
    """Consume the binary marker and return True if the stream has one."""
    if peek_bytes(stream, 2) == BINARY_MARKER:
        stream.read(2)
        return True
    return False


def _skip_ws(stream: BinaryIO) -> None:
    while True:
        c = peek_bytes(stream, 1)
        if not c or not c.isspace():
            return
        stream.read(1)


def read_token(stream: BinaryIO, binary: bool) -> str:
    """A whitespace-delimited token; leading whitespace is skipped and
    one terminating whitespace byte consumed (ReadToken, io-funcs.cc)."""
    _skip_ws(stream)
    chars = bytearray()
    while True:
        c = stream.read(1)
        if not c:
            if chars:
                break
            raise ValueError("read_token: unexpected EOF")
        if c.isspace():
            break
        chars += c
    return chars.decode("utf-8")


def peek_token(stream: BinaryIO, binary: bool) -> str:
    """The next token, not consumed."""
    buf = peek_bytes(stream, 64).lstrip()
    end = 0
    while end < len(buf) and not chr(buf[end]).isspace():
        end += 1
    return buf[:end].decode("utf-8")


def expect_token(stream: BinaryIO, binary: bool, token: str) -> None:
    got = read_token(stream, binary)
    if got != token:
        raise ValueError(f"expected token {token!r}, got {got!r}")


def read_int32(stream: BinaryIO, binary: bool) -> int:
    if binary:
        size = stream.read(1)
        if size != b"\x04":
            raise ValueError(f"read_int32: bad size byte {size!r}")
        return struct.unpack("<i", stream.read(4))[0]
    return int(read_token(stream, binary))


def read_uint32(stream: BinaryIO, binary: bool) -> int:
    """Unsigned int32: the reference marks it with the size byte -4
    (0xfc); the signed marker is accepted as well."""
    if binary:
        size = stream.read(1)
        if size == b"\xfc":
            return struct.unpack("<I", stream.read(4))[0]
        if size == b"\x04":
            return struct.unpack("<i", stream.read(4))[0]
        raise ValueError(f"read_uint32: bad size byte {size!r}")
    return int(read_token(stream, binary))


def read_float(stream: BinaryIO, binary: bool) -> float:
    """A float or a double (by its size byte in binary mode)."""
    if binary:
        size = stream.read(1)
        if size == b"\x04":
            return struct.unpack("<f", stream.read(4))[0]
        if size == b"\x08":
            return struct.unpack("<d", stream.read(8))[0]
        raise ValueError(f"read_float: bad size byte {size!r}")
    return float(read_token(stream, binary))


def read_int_vector(stream: BinaryIO, binary: bool) -> List[int]:
    """ReadIntegerVector of int32 (io-funcs-inl.h)."""
    if binary:
        size = stream.read(1)
        if size != b"\x04":
            raise ValueError(f"read_int_vector: bad size byte {size!r}")
        n = struct.unpack("<i", stream.read(4))[0]
        return np.frombuffer(stream.read(4 * n), dtype="<i4").tolist()
    expect_token(stream, binary, "[")
    out: List[int] = []
    while True:
        tok = read_token(stream, binary)
        if tok == "]":
            return out
        out.append(int(tok))


def read_vector(stream: BinaryIO, binary: bool) -> np.ndarray:
    """A Kaldi Vector: "FV"/"DV" + dim + data in binary, "[ ... ]" in
    text (float32)."""
    if binary:
        tok = read_token(stream, binary)
        if tok not in ("FV", "DV"):
            raise ValueError(f"read_vector: bad token {tok!r}")
        dt = "<f4" if tok == "FV" else "<f8"
        dim = read_int32(stream, binary)
        return np.frombuffer(stream.read(dim * (4 if tok == "FV" else 8)),
                             dtype=dt).copy()
    expect_token(stream, binary, "[")
    vals: List[float] = []
    while True:
        tok = read_token(stream, binary)
        if tok == "]":
            return np.asarray(vals, dtype=np.float32)
        vals.append(float(tok))
