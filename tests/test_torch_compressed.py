"""Port parity: `matrix/compressed.py` (CompressedMatrix, methods 1-7:
CM, CM2 and CM3) and `matrix/sparse.py` (SparseMatrix and its holder)
against the JAX package's: the bytes equal, each package's reader on the
other's bytes gives equal arrays, on matrices made from a seed (tall,
short, one-row, constant, wide-ranged); the sparse holder in binary and
text archives."""

import io

import numpy as np
import pytest

from kaldi_tpu.base import io_funcs as jiof
from kaldi_tpu.matrix import compressed as jcm
from kaldi_tpu.matrix import sparse as jsp
from kaldi_tpu.util.table import SequentialTableReader as JReader
from kaldi_tpu.util.table import TableWriter as JWriter
from kaldi_tpu_torch.base import io_funcs as tiof
from kaldi_tpu_torch.matrix import compressed as tcm
from kaldi_tpu_torch.matrix import sparse as tsp
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def matrices():
    rng = np.random.default_rng(0)
    return {"tall": rng.normal(size=(40, 13)).astype(np.float32) * 5,
            "short": rng.normal(size=(6, 4)).astype(np.float32),
            "row": rng.normal(size=(1, 9)).astype(np.float32),
            "four": rng.normal(size=(4, 3)).astype(np.float32),
            "const": np.full((12, 3), 2.5, np.float32),
            "wide": (rng.normal(size=(20, 5)) * [1, 10, 100, 1e3, 1e4]
                     ).astype(np.float32),
            "unit": rng.uniform(0, 1, size=(10, 6)).astype(np.float32)}


@pytest.mark.parametrize("method", range(1, 8))
@pytest.mark.parametrize("name", sorted(matrices()))
def test_compressed_bytes_equal_and_read_across(name, method):
    mat = matrices()[name]
    a, b = io.BytesIO(), io.BytesIO()
    tcm.write_compressed_matrix(a, mat, method)
    jcm.write_compressed_matrix(b, mat, method)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    b.seek(0)
    ours = jiof.read_matrix(a, True)        # JAX's reader, the port's bytes
    theirs = tiof.read_matrix(b, True)      # the port's reader, JAX's bytes
    np.testing.assert_array_equal(ours, theirs)
    assert theirs.dtype == np.float32 and theirs.shape == mat.shape


def test_compressed_refuses_nan_and_bad_method():
    with pytest.raises(Exception):
        tcm.write_compressed_matrix(io.BytesIO(),
                                    np.array([[np.nan, 1.0]]), 2)
    with pytest.raises(Exception, match="method"):
        tcm.write_compressed_matrix(io.BytesIO(), np.ones((2, 2)), 9)


def sparse_pair(seed, rows=9, dim=7):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(rows, dim)).astype(np.float32)
    m[rng.random(m.shape) < 0.7] = 0.0
    m[3] = 0.0                              # an empty row
    return m, jsp.SparseMatrix.from_dense(m), tsp.SparseMatrix.from_dense(m)


@pytest.mark.parametrize("binary", [True, False])
def test_sparse_matrix_bytes_equal(binary):
    m, j, t = sparse_pair(1)
    a, b = io.BytesIO(), io.BytesIO()
    t.write(a, binary)
    j.write(b, binary)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    got = jsp.SparseMatrix.read(a, binary)
    b.seek(0)
    back = tsp.SparseMatrix.read(b, binary)
    # text keeps %g's six digits, the reference's format
    np.testing.assert_array_equal(got.todense(), back.todense())
    np.testing.assert_allclose(back.todense(), m, rtol=0 if binary else 1e-5)
    assert back.shape == t.shape == m.shape


@pytest.mark.parametrize("mode", ["ark", "ark,t"])
def test_sparse_holder_archives(tmp_path, mode):
    """Both holders' archives, binary and text: equal bytes, and each
    reader on the other's archive."""
    entries = {f"u{i}": sparse_pair(i) for i in range(3)}
    for writer, side, idx in ((TableWriter, "torch", 2),
                              (JWriter, "jax", 1)):
        with writer("sparse-matrix", f"{mode}:{tmp_path / side}.ark") as w:
            for k, v in entries.items():
                w.write(k, v[idx])
    assert (tmp_path / "torch.ark").read_bytes() == \
        (tmp_path / "jax.ark").read_bytes()
    ours = dict(SequentialTableReader("sparse-matrix",
                                      f"ark:{tmp_path}/jax.ark"))
    theirs = dict(JReader("sparse-matrix", f"ark:{tmp_path}/torch.ark"))
    assert sorted(ours) == sorted(theirs) == sorted(entries)
    for k, v in entries.items():
        np.testing.assert_array_equal(ours[k].todense(), theirs[k].todense())
        np.testing.assert_allclose(ours[k].todense(), v[0],
                                   rtol=0 if mode == "ark" else 1e-5)


@pytest.mark.parametrize("method", [1, 2, 3, 5])
def test_compressed_holder_archive_reads_as_matrix(tmp_path, method):
    """A compressed archive of the port's holder: JAX's bytes, and read
    back through the plain "matrix" holder of both packages."""
    from kaldi_tpu.util.table import CompressedMatrixHolder as JHolder
    from kaldi_tpu_torch.util.table import CompressedMatrixHolder
    mats = matrices()
    for writer, holder, side in ((TableWriter, CompressedMatrixHolder,
                                  "torch"), (JWriter, JHolder, "jax")):
        with writer(holder(method), f"ark:{tmp_path / side}.ark") as w:
            for k in sorted(mats):
                w.write(k, mats[k])
    assert (tmp_path / "torch.ark").read_bytes() == \
        (tmp_path / "jax.ark").read_bytes()
    ours = dict(SequentialTableReader("matrix", f"ark:{tmp_path}/jax.ark"))
    theirs = dict(JReader("matrix", f"ark:{tmp_path}/torch.ark"))
    for k in mats:
        np.testing.assert_array_equal(ours[k], theirs[k])
