"""HTK feature-file I/O (copy of `kaldi_tpu/feat/htk.py`; parity:
util/kaldi-io ReadHtk/WriteHtk as used by feat/feature-*-test.cc):
12-byte big-endian header
(nSamples int32, samplePeriod int32, sampleSize int16, parmKind int16)
followed by float32 big-endian rows."""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np


def read_htk(stream: BinaryIO) -> Tuple[np.ndarray, int, int]:
    """Returns (features (T, D) float32, sample_period_100ns, parm_kind)."""
    header = stream.read(12)
    if len(header) != 12:
        raise ValueError("HTK header truncated")
    n, period, size, kind = struct.unpack(">iihh", header)
    dim = size // 4
    data = stream.read(n * size)
    feats = np.frombuffer(data, dtype=">f4").reshape(n, dim)
    return feats.astype(np.float32), period, kind


def write_htk(stream: BinaryIO, feats: np.ndarray,
              sample_period: int = 100000, parm_kind: int = 9) -> None:
    feats = np.asarray(feats, np.float32)
    stream.write(struct.pack(">iihh", feats.shape[0], sample_period,
                             feats.shape[1] * 4, parm_kind))
    stream.write(feats.astype(">f4").tobytes())
