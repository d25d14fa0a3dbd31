"""Sparse matrix/vector wire formats (copy of `kaldi_tpu/matrix/sparse.py`;
parity:
src/matrix/sparse-matrix.cc SparseVector::Write:147,
SparseMatrix::Write:443).

A SparseMatrix is stored as a list of per-row (index, value) pairs;
this repo keeps it as exactly that — a dim plus a list of numpy
(indices, values) row pairs — since its only consumers are the egs /
posterior-format tools (`post-to-smat`) and supervision I/O, where the
dense equivalent is what compute paths use.
"""

from __future__ import annotations

from typing import BinaryIO, List, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof


class SparseMatrix:
    """dim = num-cols; rows = [(indices int32, values float32), ...]."""

    def __init__(self, dim: int,
                 rows: List[Tuple[np.ndarray, np.ndarray]]):
        self.dim = int(dim)
        self.rows = [(np.asarray(i, np.int32), np.asarray(v, np.float32))
                     for i, v in rows]

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.rows), self.dim)

    def todense(self) -> np.ndarray:
        out = np.zeros((len(self.rows), self.dim), np.float32)
        for r, (idx, val) in enumerate(self.rows):
            np.add.at(out[r], idx, val)
        return out

    @classmethod
    def from_dense(cls, mat: np.ndarray) -> "SparseMatrix":
        mat = np.asarray(mat)
        rows = []
        for r in range(mat.shape[0]):
            idx = np.nonzero(mat[r])[0]
            rows.append((idx.astype(np.int32),
                         mat[r, idx].astype(np.float32)))
        return cls(mat.shape[1], rows)

    def write(self, stream: BinaryIO, binary: bool = True) -> None:
        if binary:
            iof.write_token(stream, True, "SM")
            iof.write_int32(stream, True, len(self.rows))
            for idx, val in self.rows:
                _write_sparse_vector(stream, True, self.dim, idx, val)
        else:
            stream.write(f"rows={len(self.rows)} ".encode())
            for idx, val in self.rows:
                _write_sparse_vector(stream, False, self.dim, idx, val)
            stream.write(b"\n")

    @classmethod
    def read(cls, stream: BinaryIO, binary: bool = True
             ) -> "SparseMatrix":
        if binary:
            iof.expect_token(stream, True, "SM")
            num_rows = iof.read_int32(stream, True)
            rows = []
            dim = 0
            for _ in range(num_rows):
                dim, idx, val = _read_sparse_vector(stream, True)
                rows.append((idx, val))
            return cls(dim, rows)
        tok = iof.read_token(stream, False)
        if not tok.startswith("rows="):
            raise ValueError(f"bad SparseMatrix text header {tok!r}")
        num_rows = int(tok[5:])
        rows = []
        dim = 0
        for _ in range(num_rows):
            dim, idx, val = _read_sparse_vector(stream, False)
            rows.append((idx, val))
        return cls(dim, rows)


def _write_sparse_vector(stream: BinaryIO, binary: bool, dim: int,
                         idx: np.ndarray, val: np.ndarray) -> None:
    if binary:
        iof.write_token(stream, True, "SV")
        iof.write_int32(stream, True, dim)
        iof.write_int32(stream, True, len(idx))
        for i, v in zip(idx, val):
            iof.write_int32(stream, True, int(i))
            iof.write_float(stream, True, float(v))
    else:
        stream.write(f"dim={dim} [ ".encode())
        for i, v in zip(idx, val):
            stream.write(f"{int(i)} {float(v):g} ".encode())
        stream.write(b"] ")


def _read_sparse_vector(stream: BinaryIO, binary: bool):
    if binary:
        iof.expect_token(stream, True, "SV")
        dim = iof.read_int32(stream, True)
        n = iof.read_int32(stream, True)
        idx = np.empty(n, np.int32)
        val = np.empty(n, np.float32)
        for k in range(n):
            idx[k] = iof.read_int32(stream, True)
            val[k] = iof.read_float(stream, True)
        return dim, idx, val
    tok = iof.read_token(stream, False)
    if not tok.startswith("dim="):
        raise ValueError(f"bad SparseVector text header {tok!r}")
    dim = int(tok[4:])
    if iof.read_token(stream, False) != "[":
        raise ValueError("expected [ in SparseVector")
    idx, val = [], []
    while True:
        tok = iof.read_token(stream, False)
        if tok == "]":
            break
        idx.append(int(tok))
        val.append(float(iof.read_token(stream, False)))
    return dim, np.asarray(idx, np.int32), np.asarray(val, np.float32)


class SparseMatrixHolder:
    """Table holder for "sparse-matrix" archives (the \\0B marker is
    written by TableWriter)."""

    binary_container = True

    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return SparseMatrix.read(stream, binary)

    def write(self, stream, binary, value):
        value.write(stream, binary)
