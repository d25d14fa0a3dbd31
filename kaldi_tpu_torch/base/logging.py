"""Errors and leveled logging (copy of `kaldi_tpu/base/logging.py`;
the reference's base/kaldi-error.h
KALDI_ERR / KALDI_WARN / KALDI_LOG / KALDI_VLOG): messages go to stderr
with the program name, the time and file:line; `KaldiTpuError` is the
raisable error."""

from __future__ import annotations

import inspect
import os
import sys
import time

_verbose_level = 0


class KaldiTpuError(RuntimeError):
    """Fatal error (KaldiFatalError, base/kaldi-error.h:89)."""


def set_verbose_level(level: int) -> None:
    global _verbose_level
    _verbose_level = int(level)


def _caller(depth: int = 2) -> str:
    frame = inspect.stack()[depth]
    return f"{os.path.basename(frame.filename)}:{frame.lineno}"


def _emit(tag: str, msg: str, depth: int = 3) -> None:
    prog = os.path.basename(sys.argv[0] or "python")
    print(f"{tag} ({prog}[{time.strftime('%H:%M:%S')}]:{_caller(depth)}) "
          f"{msg}", file=sys.stderr, flush=True)


def log(msg: str) -> None:
    _emit("LOG", msg)


def vlog(level: int, msg: str) -> None:
    if _verbose_level >= level:
        _emit(f"VLOG[{level}]", msg)


def warn(msg: str) -> None:
    _emit("WARNING", msg)
