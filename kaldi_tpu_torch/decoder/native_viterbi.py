"""The host's native aligner: `csrc/beam_viterbi.cpp` built with g++ at
first use and loaded with ctypes (port of `get_lib` and `NativeViterbi`
of `kaldi_tpu/native.py`, the beam Viterbi alone).

The library goes into `kaldi_tpu_torch/_build/` (git-ignored) under a
name that carries a hash of the source and the flags.  Where no compiler
is found or the build fails, `get_lib()` returns None and the callers
fall back to the Python `FasterDecoder`, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.decoder.batched_viterbi import DeviceGraph, pack_graph
from kaldi_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "beam_viterbi.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_log = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path():
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"beam_viterbi-{h.hexdigest()[:12]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.beam_viterbi.restype = ctypes.c_int
    lib.beam_viterbi.argtypes = [
        i32p, i32p, i32p, i32p, i32p, f32p, ctypes.c_int64,   # emitting
        i32p, i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32,  # eps
        ctypes.c_int32, ctypes.c_int32, f32p,                 # S,start,final
        f32p, ctypes.c_int64, ctypes.c_int64,                 # ll,T,P
        ctypes.c_float, ctypes.c_float,                       # scale,beam
        i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded aligner library, built first if needed; None (once,
    with a warning) where it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _lib = _bind(ctypes.CDLL(str(so)))
    except (OSError, subprocess.CalledProcessError) as e:
        _log.warning("native aligner unavailable (%s); using the Python "
                     "FasterDecoder", e)
        _lib = None
    return _lib


class NativeViterbi:
    """Native beam Viterbi over one packed graph."""

    def __init__(self, graph):
        if not isinstance(graph, DeviceGraph):
            graph = pack_graph(graph)
        self.g = graph
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("the native aligner could not be built")

    def decode(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray,
               acoustic_scale: float = 1.0, beam: float = 1e9
               ) -> Optional[Tuple[List[int], List[int], float]]:
        """loglikes (T, P) -> (alignment tids, word ids, cost) of the
        best path reaching a final state, or None."""
        g = self.g
        ll = np.ascontiguousarray(loglikes, np.float32)
        T, P = ll.shape
        e_pdf = np.ascontiguousarray(
            np.asarray(tid_to_pdf)[np.clip(g.e_ilabel, 0,
                                           len(tid_to_pdf) - 1)], np.int32)
        # word-labelled epsilon chains make the words unbounded by T: the
        # native side returns -3 when a capacity is exceeded, and the call
        # is retried with bigger buffers
        words_cap = T + g.num_states + 1
        for _attempt in range(3):
            out_ali = np.zeros(T + 1, np.int32)
            out_words = np.zeros(words_cap, np.int32)
            ali_len = ctypes.c_int32()
            words_len = ctypes.c_int32()
            cost = ctypes.c_float()
            rc = self.lib.beam_viterbi(
                np.ascontiguousarray(g.e_src), np.ascontiguousarray(g.e_dst),
                e_pdf, np.ascontiguousarray(g.e_ilabel),
                np.ascontiguousarray(g.e_olabel),
                np.ascontiguousarray(g.e_weight), len(g.e_src),
                np.ascontiguousarray(g.ne_src),
                np.ascontiguousarray(g.ne_dst),
                np.ascontiguousarray(g.ne_olabel),
                np.ascontiguousarray(g.ne_weight), len(g.ne_src),
                max(g.eps_depth, 3), g.num_states, g.start,
                np.ascontiguousarray(g.final, np.float32),
                ll, T, P, acoustic_scale, beam,
                out_ali, len(out_ali), ctypes.byref(ali_len),
                out_words, len(out_words), ctypes.byref(words_len),
                ctypes.byref(cost))
            if rc == -3:
                words_cap *= 8
                continue
            if rc != 0:
                return None
            return (out_ali[:ali_len.value].tolist(),
                    out_words[:words_len.value].tolist(), float(cost.value))
        return None
