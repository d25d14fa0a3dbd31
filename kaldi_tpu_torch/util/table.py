"""The ark/scp table system (port of `kaldi_tpu/util/table.py`; the
reference's util/kaldi-table.h): keyed, ordered streams of typed objects
addressed by rspecifiers (read) and wspecifiers (write).

  rspecifiers:  "ark:foo.ark", "scp:foo.scp", "ark:-", "ark:gunzip -c f.gz|",
                with options o (once), p (permissive), s (sorted),
                cs (called-sorted), t/b (ignored: the reader detects the
                mode), bg (background).
  wspecifiers:  "ark:foo.ark", "ark,t:-", "ark,scp:f.ark,f.scp",
                with options b/t (binary/text), f/nf (flush), p (permissive).

An archive entry is "<key> " followed by the object (after the b"\\0B"
marker when binary); a script line is "<key> <rxfilename>", the
rxfilename possibly with a byte offset ("foo.ark:1234"): the reference's
own format, so either implementation reads what the other writes.

Holders of types whose codec is not ported yet (compressed and sparse
matrices) raise, naming the module they wait for.
"""

from __future__ import annotations

import io
import os
import sys
from dataclasses import dataclass
from typing import BinaryIO, Dict, Iterator, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs
from kaldi_tpu_torch.base.logging import KaldiTpuError, warn
from kaldi_tpu_torch.util import kaldi_io


# -- specifiers (ClassifyRspecifier/ClassifyWspecifier, kaldi-table.h:124,225)

@dataclass
class RspecifierOptions:
    once: bool = False
    sorted: bool = False
    called_sorted: bool = False
    permissive: bool = False
    background: bool = False


@dataclass
class WspecifierOptions:
    binary: bool = True
    flush: bool = False
    permissive: bool = False


_R_FLAGS = {"o": ("once", True), "no": ("once", False),
            "p": ("permissive", True), "np": ("permissive", False),
            "s": ("sorted", True), "ns": ("sorted", False),
            "cs": ("called_sorted", True), "ncs": ("called_sorted", False),
            "bg": ("background", True)}
_W_FLAGS = {"t": ("binary", False), "b": ("binary", True),
            "f": ("flush", True), "nf": ("flush", False),
            "p": ("permissive", True)}


def parse_rspecifier(rspecifier: str) -> Tuple[str, str, RspecifierOptions]:
    """-> (kind 'ark' or 'scp', rxfilename, options)."""
    if ":" not in rspecifier:
        raise KaldiTpuError(f"invalid rspecifier {rspecifier!r}")
    prefix, rxfilename = rspecifier.split(":", 1)
    opts = RspecifierOptions()
    kind = None
    for part in prefix.split(","):
        if part in ("ark", "scp"):
            kind = part
        elif part in _R_FLAGS:
            setattr(opts, *_R_FLAGS[part])
        elif part not in ("t", "b"):
            raise KaldiTpuError(
                f"invalid rspecifier option {part!r} in {rspecifier!r}")
    if kind is None:
        raise KaldiTpuError(f"invalid rspecifier {rspecifier!r}")
    return kind, rxfilename, opts


def parse_wspecifier(wspecifier: str
                     ) -> Tuple[str, str, Optional[str], WspecifierOptions]:
    """-> (kind 'ark', 'scp' or 'ark,scp', archive wxfilename, script
    wxfilename or None, options)."""
    if ":" not in wspecifier:
        raise KaldiTpuError(f"invalid wspecifier {wspecifier!r}")
    prefix, rest = wspecifier.split(":", 1)
    parts = prefix.split(",")
    opts = WspecifierOptions()
    for part in parts:
        if part in ("ark", "scp"):
            continue
        if part not in _W_FLAGS:
            raise KaldiTpuError(
                f"invalid wspecifier option {part!r} in {wspecifier!r}")
        setattr(opts, *_W_FLAGS[part])
    has_ark, has_scp = "ark" in parts, "scp" in parts
    if has_ark and has_scp:
        if "," not in rest:
            raise KaldiTpuError(
                f"ark,scp wspecifier needs two filenames: {wspecifier!r}")
        ark_name, scp_name = rest.split(",", 1)
        return "ark,scp", ark_name, scp_name, opts
    if has_ark:
        return "ark", rest, None, opts
    if has_scp:
        return "scp", rest, None, opts
    raise KaldiTpuError(f"invalid wspecifier {wspecifier!r}")


# -- holders (util/kaldi-holder.h): how one value is read and written ----

class Holder:
    """read(stream) -> value; write(stream, binary, value)."""

    #: False: entries are always text and never get the \0B marker
    binary_container = True

    def read(self, stream: BinaryIO):
        raise NotImplementedError

    def write(self, stream: BinaryIO, binary: bool, value) -> None:
        raise NotImplementedError


class MatrixHolder(Holder):
    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        return io_funcs.read_matrix(stream, binary)

    def write(self, stream, binary, value):
        io_funcs.write_matrix(stream, binary, np.asarray(value))


class VectorHolder(Holder):
    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        return io_funcs.read_vector(stream, binary)

    def write(self, stream, binary, value):
        io_funcs.write_vector(stream, binary, np.asarray(value))


class _ScalarHolder(Holder):
    """int, float, bool: the basic type; a newline after it in text."""

    def __init__(self, read_fn, write_fn):
        self._read, self._write = read_fn, write_fn

    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        return self._read(stream, binary)

    def write(self, stream, binary, value):
        self._write(stream, binary, value)
        if not binary:
            stream.write(b"\n")


class IntVectorHolder(Holder):
    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        if binary:
            return io_funcs.read_int_vector(stream, binary)
        return [int(t) for t in stream.readline().decode("utf-8").split()]

    def write(self, stream, binary, value):
        if binary:
            io_funcs.write_int_vector(stream, binary, value)
        else:
            stream.write((" ".join(str(int(v)) for v in value)
                          + "\n").encode())


class IntVectorVectorHolder(Holder):
    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        if binary:
            n = io_funcs.read_int32(stream, binary)
            return [io_funcs.read_int_vector(stream, binary)
                    for _ in range(n)]
        out, cur = [], []
        for tok in stream.readline().decode("utf-8").split():
            if tok == ";":
                out.append(cur)
                cur = []
            else:
                cur.append(int(tok))
        if cur:
            out.append(cur)
        return out

    def write(self, stream, binary, value):
        if binary:
            io_funcs.write_int32(stream, binary, len(value))
            for v in value:
                io_funcs.write_int_vector(stream, binary, v)
        else:
            stream.write((" ; ".join(" ".join(str(int(x)) for x in v)
                                     for v in value) + " ; \n").encode())


class IntPairVectorHolder(Holder):
    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        if binary:
            return io_funcs.read_int_pair_vector(stream, binary)
        toks = stream.readline().decode("utf-8").split()
        if len(toks) % 2:
            raise KaldiTpuError("bad int-pair-vector text entry")
        return [(int(toks[i]), int(toks[i + 1]))
                for i in range(0, len(toks), 2)]

    def write(self, stream, binary, value):
        if binary:
            io_funcs.write_int_pair_vector(stream, binary, value)
        else:
            stream.write((" ".join(f"{a} {b}" for a, b in value)
                          + "\n").encode())


class TokenHolder(Holder):
    binary_container = False

    def read(self, stream):
        return io_funcs.read_token(stream, False)

    def write(self, stream, binary, value):
        stream.write(value.encode() + b"\n")


class TokenVectorHolder(Holder):
    """A line of whitespace-separated tokens (e.g. the `text` file)."""
    binary_container = False

    def read(self, stream):
        return stream.readline().decode("utf-8").split()

    def write(self, stream, binary, value):
        stream.write((" ".join(value) + "\n").encode())


class ObjectHolder(Holder):
    """Any class with classmethod read(stream, binary) and method
    write(stream, binary): models, trees, transition models."""

    def __init__(self, cls):
        self.cls = cls

    def read(self, stream):
        binary = io_funcs.init_input_stream(stream)
        return self.cls.read(stream, binary)

    def write(self, stream, binary, value):
        value.write(stream, binary)


class WaveHolder(Holder):
    """RIFF wave entries (feat/wave-reader.h:158).  An archive entry
    carries the \\0B marker; a .wav named by a script starts with 'RIFF',
    which init_input_stream leaves in place."""

    def read(self, stream):
        from kaldi_tpu_torch.feat.wave import WaveData
        io_funcs.init_input_stream(stream)
        return WaveData.read(stream)

    def write(self, stream, binary, value):
        if not binary:
            raise KaldiTpuError("wave data requires binary mode")
        value.write(stream)


def _fst_holder() -> Holder:
    from kaldi_tpu_torch.fstext.openfst_io import FstHolder
    return FstHolder()


def _lattice_holder() -> Holder:
    from kaldi_tpu_torch.lat.kaldi_lattice import LatticeHolder
    return LatticeHolder()


def _posterior_holder() -> Holder:
    from kaldi_tpu_torch.hmm.posterior import PosteriorHolder
    return PosteriorHolder()


def _gauss_post_holder() -> Holder:
    from kaldi_tpu_torch.hmm.posterior import GaussPostHolder
    return GaussPostHolder()


def _compact_lattice_holder() -> Holder:
    from kaldi_tpu_torch.lat.kaldi_lattice import CompactLatticeHolder
    return CompactLatticeHolder()


def _degs_holder() -> Holder:
    from kaldi_tpu_torch.nnet3.egs import DiscriminativeExampleHolder
    return DiscriminativeExampleHolder()


_HOLDERS = {
    "matrix": MatrixHolder,
    "vector": VectorHolder,
    "int": lambda: _ScalarHolder(io_funcs.read_int32, io_funcs.write_int32),
    "float": lambda: _ScalarHolder(io_funcs.read_float,
                                   io_funcs.write_float),
    "bool": lambda: _ScalarHolder(io_funcs.read_bool, io_funcs.write_bool),
    "int-vector": IntVectorHolder,
    "int-vector-vector": IntVectorVectorHolder,
    "int-pair-vector": IntPairVectorHolder,
    "token": TokenHolder,
    "token-vector": TokenVectorHolder,
    "wave": WaveHolder,
    "fst": _fst_holder,
    "lattice": _lattice_holder,
    "compact-lattice": _compact_lattice_holder,
    "posterior": _posterior_holder,
    "gauss-post": _gauss_post_holder,
    "degs": _degs_holder,
}

# holder name -> the module of the JAX package whose codec it waits for
_NOT_PORTED = {
    "compressed-matrix": "kaldi_tpu/matrix/compressed.py",
    "sparse-matrix": "kaldi_tpu/matrix/sparse.py",
}


def _make_holder(holder) -> Holder:
    if isinstance(holder, Holder):
        return holder
    if isinstance(holder, str):
        if holder in _NOT_PORTED:
            raise NotImplementedError(
                f"the {holder!r} table holder needs "
                f"{_NOT_PORTED[holder]}, not ported yet")
        if holder not in _HOLDERS:
            raise KaldiTpuError(f"unknown holder {holder!r}")
        return _HOLDERS[holder]()
    if isinstance(holder, type) and issubclass(holder, Holder):
        return holder()
    if isinstance(holder, type):
        return ObjectHolder(holder)
    raise KaldiTpuError(f"cannot make holder from {holder!r}")


def _read_scp(rxfilename: str):
    """(key, rxfilename) pairs of a script file, blank lines skipped."""
    with kaldi_io.input_stream(rxfilename) as f:
        lines = f.read().decode("utf-8").splitlines()
    for line in lines:
        line = line.strip()
        if line:
            key, _, rx = line.partition(" ")
            yield key, rx.strip()


# -- readers and the writer ----------------------------------------------

class SequentialTableReader:
    """(key, value) in archive order (kaldi-table.h:287).  `holder` is a
    holder name ("matrix", "int-vector", ...), a Holder, or a class with
    read/write methods."""

    def __init__(self, holder, rspecifier: str):
        self.holder = _make_holder(holder)
        self.kind, self.rxfilename, self.opts = parse_rspecifier(rspecifier)

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        if self.kind == "scp":
            for key, rx in _read_scp(self.rxfilename):
                try:
                    value = self._read_one(rx)
                except Exception:
                    if self.opts.permissive:
                        warn(f"skipping unreadable scp entry {key} -> {rx}")
                        continue
                    raise
                yield key, value
            return
        stream = kaldi_io.open_input(self.rxfilename)
        if not hasattr(stream, "peek"):
            stream = io.BufferedReader(io.BytesIO(stream.read()))
        try:
            while True:
                # whitespace between entries (a text value may end short
                # of its newline) before deciding the archive has ended
                b = io_funcs.peek_byte(stream)
                while b and b in b" \t\n\r":
                    stream.read(1)
                    b = io_funcs.peek_byte(stream)
                if not b:
                    return
                key = io_funcs.read_token(stream, True)
                try:
                    value = self.holder.read(stream)
                except Exception:
                    if self.opts.permissive:
                        warn(f"skipping bad entry for key {key}")
                        continue
                    raise
                yield key, value
        finally:
            if getattr(stream, "_raw", stream) is not sys.stdin.buffer:
                stream.close()

    def _read_one(self, rxfilename: str):
        with kaldi_io.input_stream(rxfilename) as f:
            if not hasattr(f, "peek"):
                f = io.BufferedReader(f)  # type: ignore[arg-type]
            return self.holder.read(f)

    def as_dict(self) -> Dict[str, object]:
        return dict(iter(self))


class RandomAccessTableReader:
    """Access by key (kaldi-table.h:233).  Script sources open an entry
    when asked (a small cache); archives are read whole at first use."""

    def __init__(self, holder, rspecifier: str):
        self.holder = _make_holder(holder)
        self.kind, self.rxfilename, self.opts = parse_rspecifier(rspecifier)
        self._scp: Optional[Dict[str, str]] = None
        self._data: Optional[Dict[str, object]] = None
        self._cache: Dict[str, object] = {}

    def _ensure_loaded(self):
        if self.kind == "scp":
            if self._scp is None:
                self._scp = dict(_read_scp(self.rxfilename))
        elif self._data is None:
            self._data = SequentialTableReader(
                self.holder, f"ark:{self.rxfilename}").as_dict()

    def _table(self) -> dict:
        self._ensure_loaded()
        return self._scp if self.kind == "scp" else self._data

    def __contains__(self, key: str) -> bool:
        return key in self._table()

    def __getitem__(self, key: str):
        table = self._table()
        if key not in table:
            raise KeyError(key)
        if self.kind != "scp":
            return table[key]
        if key not in self._cache:
            with kaldi_io.input_stream(table[key]) as f:
                if not hasattr(f, "peek"):
                    f = io.BufferedReader(f)  # type: ignore[arg-type]
                value = self.holder.read(f)
            if len(self._cache) > 16:
                self._cache.clear()
            self._cache[key] = value
        return self._cache[key]

    def keys(self):
        return self._table().keys()


class RandomAccessTableReaderMapped:
    """RandomAccessTableReaderMapped (kaldi-table.h:432): looks up
    through a key map (classically utt2spk) when provided."""

    def __init__(self, holder, rspecifier: str, map_rspecifier: str = ""):
        self.reader = RandomAccessTableReader(holder, rspecifier)
        self.key_map: Optional[Dict[str, str]] = None
        if map_rspecifier:
            self.key_map = {
                k: v[0] for k, v in SequentialTableReader("token-vector",
                                                          map_rspecifier)
            }

    def _map(self, key: str) -> str:
        if self.key_map is None:
            return key
        if key not in self.key_map:
            raise KeyError(f"no map entry for {key}")
        return self.key_map[key]

    def __contains__(self, key):
        try:
            return self._map(key) in self.reader
        except KeyError:
            return False

    def __getitem__(self, key):
        return self.reader[self._map(key)]


class TableWriter:
    """(key, value) entries to ark, or ark,scp (kaldi-table.h:368)."""

    def __init__(self, holder, wspecifier: str):
        self.holder = _make_holder(holder)
        self.kind, self.ark_name, self.scp_name, self.opts = \
            parse_wspecifier(wspecifier)
        if self.kind == "scp":
            raise KaldiTpuError("scp-only TableWriter is not supported "
                                "(write ark,scp instead)")
        if self.scp_name and kaldi_io.classify_wxfilename(
                self.ark_name) != "file":
            raise KaldiTpuError("ark,scp output requires a plain ark path")
        self._ark = kaldi_io.open_output(self.ark_name)
        self._scp = (kaldi_io.open_output(self.scp_name)
                     if self.scp_name else None)
        self._closed = False

    def write(self, key: str, value) -> None:
        if self._closed:
            raise KaldiTpuError("TableWriter is closed")
        if not key or any(c.isspace() for c in key):
            raise KaldiTpuError(f"invalid table key {key!r}")
        binary = self.opts.binary and self.holder.binary_container
        self._ark.write(key.encode() + b" ")
        if self._scp is not None:
            offset = self._ark.tell()
            abspath = os.path.abspath(self.ark_name)
            self._scp.write(f"{key} {abspath}:{offset}\n".encode())
        if binary:
            self._ark.write(io_funcs.BINARY_MARKER)
        self.holder.write(self._ark, binary, value)
        if self.opts.flush:
            self._ark.flush()
            if self._scp is not None:
                self._scp.flush()

    __setitem__ = write

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._ark is not sys.stdout.buffer:
            self._ark.close()
        else:
            self._ark.flush()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
