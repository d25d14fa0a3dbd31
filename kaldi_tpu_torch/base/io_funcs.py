"""Readers and writers of the Kaldi wire format (numpy copy of
`kaldi_tpu/base/io_funcs.py`, as far as the transition model, the HMM
topology and the decision tree need it).

Binary streams open with the two-byte marker b"\\x00B"
(base/io-funcs.h).  Basic types are written as a size byte and the
little-endian value; tokens are whitespace-terminated.  In text mode
every value is a whitespace-delimited token.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Sequence

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


# -- writers (the writing half of the same module, as far as the
# transition model, the HMM topology and the decision tree need it) ------

def init_output_stream(stream: BinaryIO, binary: bool) -> None:
    if binary:
        stream.write(BINARY_MARKER)


def write_token(stream: BinaryIO, binary: bool, token: str) -> None:
    if " " in token or not token:
        raise ValueError(f"invalid token to write: {token!r}")
    stream.write(token.encode("utf-8") + b" ")


def write_int32(stream: BinaryIO, binary: bool, value: int) -> None:
    if binary:
        stream.write(b"\x04" + struct.pack("<i", int(value)))
    else:
        stream.write(f"{int(value)} ".encode())


def write_uint32(stream: BinaryIO, binary: bool, value: int) -> None:
    """Unsigned int32: the reference marks unsignedness with the size
    byte -4 (0xfc; io-funcs-inl.h WriteBasicType)."""
    if binary:
        stream.write(b"\xfc" + struct.pack("<I", int(value)))
    else:
        stream.write(f"{int(value)} ".encode())


def _format_float(v: float) -> str:
    """The shortest text that reads back as the same float32."""
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


def write_float(stream: BinaryIO, binary: bool, value: float) -> None:
    if binary:
        stream.write(b"\x04" + struct.pack("<f", float(value)))
    else:
        stream.write(_format_float(float(value)).encode() + b" ")


def write_int_vector(stream: BinaryIO, binary: bool,
                     values: Sequence[int]) -> None:
    """WriteIntegerVector of int32 (io-funcs-inl.h)."""
    values = [int(v) for v in values]
    if binary:
        stream.write(b"\x04" + struct.pack("<i", len(values)))
        stream.write(np.asarray(values, dtype="<i4").tobytes())
    else:
        stream.write(b"[ " + " ".join(str(v) for v in values).encode()
                     + (b" ]\n" if values else b"]\n"))


def write_vector(stream: BinaryIO, binary: bool, vec: np.ndarray) -> None:
    """A Kaldi Vector: "DV" for float64, else "FV" (float32)."""
    vec = np.asarray(vec).reshape(-1)
    if binary:
        if vec.dtype == np.float64:
            token, dt = "DV", "<f8"
        else:
            token, dt = "FV", "<f4"
            vec = vec.astype(np.float32, copy=False)
        write_token(stream, binary, token)
        write_int32(stream, binary, vec.shape[0])
        stream.write(np.ascontiguousarray(vec, dtype=dt).tobytes())
    else:
        stream.write(b" [ " + " ".join(_format_float(v) for v in vec).encode()
                     + b" ]\n")
