"""Lossy 8/16-bit feature matrix compression (host numpy copy of
`kaldi_tpu/matrix/compressed.py`), byte-compatible with the reference's
CompressedMatrix (matrix/compressed-matrix.h:91).

Formats: "CM" (one byte/elem with per-column percentile headers, the
speech-feature default for >8 rows), "CM2" (uint16/elem), "CM3"
(uint8/elem). Implemented vectorized in numpy — the per-column
percentile headers and quantization are data-parallel over columns.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError

_GLOBAL_HEADER = struct.Struct("<iffii")  # format, min_value, range, rows, cols


def _float_to_uint16(min_value: float, rng: float, x: np.ndarray) -> np.ndarray:
    f = np.clip((x - min_value) / rng, 0.0, 1.0)
    return (f * 65535 + 0.499).astype(np.int64).clip(0, 65535).astype(np.uint16)


def _uint16_to_float(min_value: float, rng: float, v: np.ndarray) -> np.ndarray:
    return (min_value + rng * np.float32(1.52590218966964e-05) *
            v.astype(np.float32)).astype(np.float32)


def _compute_range(mat: np.ndarray):
    min_value = float(mat.min()) if mat.size else 0.0
    max_value = float(mat.max()) if mat.size else 0.0
    if max_value == min_value:
        max_value = min_value + (1.0 + abs(min_value))
    if not np.isfinite([min_value, max_value]).all():
        raise KaldiTpuError("cannot compress a matrix with NaN/Inf")
    return np.float32(min_value), np.float32(max_value - min_value)


def _col_headers(min_value, rng, mat: np.ndarray) -> np.ndarray:
    """Per-column uint16 percentiles (0,25,75,100), shape (cols, 4)."""
    num_rows, num_cols = mat.shape
    s = np.sort(mat, axis=0)  # (rows, cols)
    if num_rows >= 5:
        q = num_rows // 4
        picks = s[[0, q, 3 * q, num_rows - 1], :]  # (4, cols)
    else:
        idx = [min(i, num_rows - 1) for i in range(4)]
        picks = s[idx, :]
    u = _float_to_uint16(min_value, rng, picks).astype(np.int64)  # (4, cols)
    p0 = np.minimum(u[0], 65532)
    p25 = (np.minimum(np.maximum(u[1], p0 + 1), 65533)
           if num_rows >= 2 else p0 + 1)
    p75 = (np.minimum(np.maximum(u[2], p25 + 1), 65534)
           if num_rows >= 3 else p25 + 1)
    p100 = (np.maximum(u[3], p75 + 1)
            if num_rows >= 4 else p75 + 1)
    return np.stack([p0, p25, p75, p100], axis=1).astype(np.uint16)


def _float_to_char(p: np.ndarray, mat: np.ndarray,
                   min_value, rng) -> np.ndarray:
    """Quantize (rows, cols) into uint8 given per-column float percentiles
    p (cols, 4)."""
    pf = _uint16_to_float(min_value, rng, p).astype(np.float32)  # (cols,4)
    p0, p25, p75, p100 = pf[:, 0], pf[:, 1], pf[:, 2], pf[:, 3]
    x = mat.astype(np.float32)
    low = np.clip(((x - p0) / (p25 - p0)) * 64 + 0.5, 0, 64)
    mid = 64 + np.clip(((x - p25) / (p75 - p25)) * 128 + 0.5, 0, 128)
    high = 192 + np.clip(((x - p75) / (p100 - p75)) * 63 + 0.5, 0, 63)
    ans = np.where(x < p25, low, np.where(x < p75, mid, high))
    return np.floor(ans).astype(np.uint8)


def _char_to_float(p: np.ndarray, data: np.ndarray,
                   min_value, rng) -> np.ndarray:
    pf = _uint16_to_float(min_value, rng, p).astype(np.float32)
    p0, p25, p75, p100 = pf[:, 0], pf[:, 1], pf[:, 2], pf[:, 3]
    v = data.astype(np.float32)
    low = p0 + (p25 - p0) * v * np.float32(1 / 64.0)
    mid = p25 + (p75 - p25) * (v - 64) * np.float32(1 / 128.0)
    high = p75 + (p100 - p75) * (v - 192) * np.float32(1 / 63.0)
    return np.where(data <= 64, low, np.where(data <= 192, mid, high))


def write_compressed_matrix(stream: BinaryIO, mat: np.ndarray,
                            method: int = 1) -> None:
    """method: 1=automatic, 2=speech-feature(CM), 3=two-byte(CM2),
    5=one-byte(CM3) — reference CompressionMethod numbering."""
    mat = np.atleast_2d(np.asarray(mat, dtype=np.float32))
    rows, cols = mat.shape
    if method == 1:
        method = 2 if rows > 8 else 3
    min_value, rng = _compute_range(mat)
    if method == 2:  # CM: per-column headers + uint8
        stream.write(b"CM ")
        stream.write(struct.pack("<ffii", min_value, rng, rows, cols))
        headers = _col_headers(min_value, rng, mat)  # (cols, 4)
        body = _float_to_char(headers, mat, min_value, rng)  # (rows, cols)
        # reference layout (compressed-matrix.cc:149-156): ALL per-column
        # headers contiguous after the global header, then the uint8 data
        # column-major.
        stream.write(headers.astype("<u2").tobytes())
        stream.write(body.T.tobytes())
    elif method in (3, 4):  # CM2: uint16 row-major
        if method == 4:
            min_value, rng = np.float32(-32768.0), np.float32(65535.0)
        stream.write(b"CM2 ")
        stream.write(struct.pack("<ffii", min_value, rng, rows, cols))
        stream.write(_float_to_uint16(min_value, rng, mat).astype("<u2").tobytes())
    elif method in (5, 6, 7):  # CM3: uint8 row-major
        if method == 6:
            min_value, rng = np.float32(0.0), np.float32(255.0)
        elif method == 7:
            min_value, rng = np.float32(0.0), np.float32(1.0)
        stream.write(b"CM3 ")
        stream.write(struct.pack("<ffii", min_value, rng, rows, cols))
        f = np.clip((mat - min_value) / rng, 0.0, 1.0)
        stream.write((f * 255 + 0.499).astype(np.uint8).tobytes())
    else:
        raise KaldiTpuError(f"unknown compression method {method}")


def read_compressed_matrix_body(stream: BinaryIO, token: str) -> np.ndarray:
    """Read after the 'CM'/'CM2'/'CM3' token; returns decompressed float32."""
    min_value, rng, rows, cols = struct.unpack("<ffii", stream.read(16))
    if rows == 0 or cols == 0:
        return np.zeros((rows, cols), dtype=np.float32)
    if token == "CM":
        raw = stream.read(cols * (8 + rows))
        # headers block (cols x 4 uint16) then column-major uint8 data
        headers = np.frombuffer(raw[:cols * 8], dtype="<u2").reshape(cols, 4)
        body = np.frombuffer(raw[cols * 8:], dtype=np.uint8) \
            .reshape(cols, rows).T
        return _char_to_float(headers, body, np.float32(min_value),
                              np.float32(rng)).astype(np.float32)
    if token == "CM2":
        data = np.frombuffer(stream.read(2 * rows * cols),
                             dtype="<u2").reshape(rows, cols)
        return _uint16_to_float(np.float32(min_value), np.float32(rng), data)
    if token == "CM3":
        data = np.frombuffer(stream.read(rows * cols),
                             dtype=np.uint8).reshape(rows, cols)
        f = data.astype(np.float32) / np.float32(255.0)
        return (np.float32(min_value) + np.float32(rng) * f).astype(np.float32)
    raise KaldiTpuError(f"bad compressed-matrix token {token}")
