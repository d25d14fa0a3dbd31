"""Readers and writers of the Kaldi wire format (numpy copy of
`kaldi_tpu/base/io_funcs.py`: the basic types, tokens, integer and pair
vectors, vectors and matrices, binary and text, byte for byte as that
module writes them).

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


class PeekableReader:
    """A reader whose peek(n) returns n bytes unless the stream ends
    first (read + pushback).  BufferedReader.peek(n) may return fewer
    bytes mid-stream, so pipes and stdin, which cannot seek, are read
    through this wrapper (util/kaldi_io.py open_input)."""

    def __init__(self, raw: BinaryIO):
        self._raw = raw
        self._buf = b""

    def peek(self, n: int = 1) -> bytes:
        while len(self._buf) < n:
            chunk = self._raw.read(n - len(self._buf))
            if not chunk:
                break
            self._buf += chunk
        return self._buf

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            data = self._buf + self._raw.read()
            self._buf = b""
            return data
        take, self._buf = self._buf[:n], self._buf[n:]
        if len(take) < n:
            take += self._raw.read(n - len(take))
        return take

    def readline(self, limit: int = -1) -> bytes:
        if b"\n" in self._buf:
            i = self._buf.index(b"\n") + 1
            line, self._buf = self._buf[:i], self._buf[i:]
            return line
        line, self._buf = self._buf, b""
        return line + self._raw.readline(limit)

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def close(self) -> None:
        self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __getattr__(self, name):
        return getattr(self._raw, name)


def peek_bytes(stream: BinaryIO, n: int) -> bytes:
    """n bytes ahead without consuming them (fewer only at EOF, or from
    a non-seekable stream that is not a PeekableReader)."""
    peek = getattr(stream, "peek", None)
    if peek is not None:
        buf = peek(n)
        if len(buf) >= n or not stream.seekable():
            return buf[:n]
    pos = stream.tell()
    data = stream.read(n)
    stream.seek(pos)
    return data


def peek_byte(stream: BinaryIO) -> bytes:
    return peek_bytes(stream, 1)


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


read_double = read_float


def read_bool(stream: BinaryIO, binary: bool) -> bool:
    c = stream.read(1) if binary else read_token(stream, binary).encode()
    if c == b"T":
        return True
    if c == b"F":
        return False
    raise ValueError(f"read_bool: bad byte {c!r}")


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


def read_int_pair_vector(stream: BinaryIO, binary: bool) -> List[tuple]:
    if binary:
        size = stream.read(1)
        if size != b"\x04":
            raise ValueError("read_int_pair_vector: bad size byte")
        n = struct.unpack("<i", stream.read(4))[0]
        arr = np.frombuffer(stream.read(8 * n), dtype="<i4").reshape(n, 2)
        return [tuple(row) for row in arr.tolist()]
    expect_token(stream, binary, "[")
    out: List[tuple] = []
    while True:
        tok = read_token(stream, binary)
        if tok == "]":
            return out
        if not tok.startswith("("):
            raise ValueError(f"bad pair token {tok}")
        a = int(tok[1:])
        b_tok = read_token(stream, binary)
        if not b_tok.endswith(")"):
            raise ValueError(f"bad pair token {b_tok}")
        out.append((a, int(b_tok[:-1])))


def read_matrix(stream: BinaryIO, binary: bool) -> np.ndarray:
    """A Kaldi Matrix: "FM"/"DM" + rows + cols + data in binary, " [ rows
    ]" in text (float32).  Compressed matrices ("CM", "CM2", "CM3") need
    the compressed-matrix codec, which is not ported yet."""
    if binary:
        tok = read_token(stream, binary)
        if tok in ("CM", "CM2", "CM3"):
            raise NotImplementedError(
                f"read_matrix: compressed matrix {tok!r} needs "
                "kaldi_tpu/matrix/compressed.py, not ported yet")
        if tok not in ("FM", "DM"):
            raise ValueError(f"read_matrix: bad token {tok!r}")
        dt = "<f4" if tok == "FM" else "<f8"
        rows = read_int32(stream, binary)
        cols = read_int32(stream, binary)
        data = stream.read(rows * cols * (4 if tok == "FM" else 8))
        return np.frombuffer(data, dtype=dt).reshape(rows, cols).copy()
    # Text: " [ \n r0 ... \n r1 ... ]".  Tokens are scanned without
    # consuming their delimiter so that a row break is seen with or
    # without a space before the newline, and through peek_byte only, so
    # that a PeekableReader-wrapped pipe reads it too.
    expect_token(stream, binary, "[")
    rows: List[List[float]] = []
    cur: List[float] = []
    while True:
        saw_nl = False
        while True:                       # skip whitespace, note \n
            c = peek_byte(stream)
            if not c:
                raise ValueError("read_matrix: unexpected EOF")
            if not c.isspace():
                break
            if c == b"\n":
                saw_nl = True
            stream.read(1)
        if saw_nl and cur:
            rows.append(cur)
            cur = []
        chars = bytearray()               # read token, keep delimiter
        while True:
            c = peek_byte(stream)
            if not c or c.isspace():
                break
            chars += stream.read(1)
        tok = chars.decode("utf-8")
        if tok == "]":
            if (peek_byte(stream) or b" ").isspace():
                stream.read(1)            # one trailing whitespace byte
            if cur:
                rows.append(cur)
            break
        if tok.endswith("]"):             # "4]": no space before close
            cur.append(float(tok[:-1]))
            rows.append(cur)
            break
        cur.append(float(tok))
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    ncol = len(rows[0])
    if any(len(r) != ncol for r in rows):
        raise ValueError("read_matrix: ragged text matrix")
    return np.asarray(rows, dtype=np.float32)


# -- writers -------------------------------------------------------------

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


def write_double(stream: BinaryIO, binary: bool, value: float) -> None:
    if binary:
        stream.write(b"\x08" + struct.pack("<d", float(value)))
    else:
        stream.write(repr(float(value)).encode() + b" ")


def write_bool(stream: BinaryIO, binary: bool, value: bool) -> None:
    if binary:
        stream.write(b"T" if value else b"F")
    else:
        stream.write(b"T " if value else b"F ")


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


def write_int_pair_vector(stream: BinaryIO, binary: bool,
                          pairs: Sequence[tuple]) -> None:
    if binary:
        stream.write(b"\x04" + struct.pack("<i", len(pairs)))
        arr = np.asarray(pairs, dtype="<i4").reshape(len(pairs), 2)
        stream.write(arr.tobytes())
    else:
        stream.write(b"[ ")
        for a, b in pairs:
            stream.write(f"({a} {b}) ".encode())
        stream.write(b"]\n")


def write_matrix(stream: BinaryIO, binary: bool, mat: np.ndarray) -> None:
    """A Kaldi Matrix: "DM" for float64, else "FM" (float32)."""
    mat = np.atleast_2d(np.asarray(mat))
    if binary:
        if mat.dtype == np.float64:
            token, dt = "DM", "<f8"
        else:
            token, dt = "FM", "<f4"
            mat = mat.astype(np.float32, copy=False)
        write_token(stream, binary, token)
        write_int32(stream, binary, mat.shape[0])
        write_int32(stream, binary, mat.shape[1])
        stream.write(np.ascontiguousarray(mat, dtype=dt).tobytes())
    else:
        if mat.shape[1] == 0:
            stream.write(b" [ ]\n")
            return
        stream.write(b" [")
        for row in mat:
            stream.write(b"\n  " + " ".join(_format_float(v) for v in row)
                         .encode() + b" ")
        stream.write(b"]\n")
