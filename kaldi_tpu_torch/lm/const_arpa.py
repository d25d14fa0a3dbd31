"""ConstArpaLm: compact, mmap-able n-gram LM for large-ARPA rescoring
(port of `kaldi_tpu/lm/const_arpa.py`; host-side, file bytes equal).

Parity: lm/const-arpa-lm.h:211 (ConstArpaLm — the reference packs
LmStates into a relocatable int32 buffer with relative child pointers
so multi-GB ARPA LMs load as one flat allocation and can be mmapped).

The design here is the numpy-native equivalent of that trie:

  * each n-gram level is a SORTED int64 key array, with
    key = (parent_state << 32) | word — binary search replaces the
    reference's per-state sorted child vectors, with the same
    O(log n)-per-hop cost but contiguous cache-friendly storage;
  * "states" are the n-grams of order < N (the only histories that can
    be extended), numbered globally: 0 = empty history, then level 1,
    level 2, ... in key order.  Per state we store the backoff weight
    and a SUFFIX pointer (the state reached by dropping the oldest
    word), which makes GetNgramLogprob's backoff recursion
    (const-arpa-lm.h:42-55) an iterative pointer chase;
  * the on-disk format is a fixed header plus the raw little-endian
    arrays, 8-byte aligned, so `read(..., mmap=True)` maps the file
    with np.memmap and touches only the pages binary search visits —
    a multi-GB 4-gram LM costs no load time and no resident copy.

Log probabilities are stored in natural log (ln), matching the
reference's Log(10.0) conversion at parse time.  Out-of-vocabulary
words score -99 * ln(10), mirroring ArpaLm (lm/arpa.py).

The scoring surface matches DeterministicLm (lm/rescore.py): states
are opaque ints, `start()/step()/final()` return -ln COSTS, so
`lattice_lmrescore` and `compose_lattice_pruned` accept either.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, IO, List, Optional, Sequence, Tuple, Union

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError, warn

M_LN10 = math.log(10.0)
OOV_LOGPROB_LN = -99.0 * M_LN10
_MAGIC = b"KTCARPA1"
_SHIFT = np.int64(32)


def _align8(f: IO[bytes]) -> None:
    pad = (-f.tell()) % 8
    if pad:
        f.write(b"\0" * pad)


class ConstArpaLm:
    """Packed n-gram LM over integer word ids.

    Attributes (per level n = 1..order, 0-indexed lists):
      keys[n-1]  : int64 sorted, (parent_state << 32) | word
      logp[n-1]  : float32 ln probabilities, aligned with keys
    Global state arrays (state 0 = empty history, then levels 1..N-1):
      g_level    : int8   n-gram order of the state's history
      g_bo       : float32 ln backoff weight
      g_suffix   : int32  state for the history minus its oldest word
    """

    def __init__(self, order: int, keys: List[np.ndarray],
                 logp: List[np.ndarray], g_level: np.ndarray,
                 g_bo: np.ndarray, g_suffix: np.ndarray,
                 level_off: np.ndarray, bos_id: int, eos_id: int,
                 unk_id: int = -1,
                 symbols: Optional[Dict[str, int]] = None):
        self.order = order
        self.keys = keys
        self.logp = logp
        self.g_level = g_level
        self.g_bo = g_bo
        self.g_suffix = g_suffix
        self.level_off = level_off          # (order,) int64; [n-1] = level n
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.symbols = symbols

    # -- scoring -------------------------------------------------------
    def _unigram_state(self, word: int) -> int:
        ks = self.keys[0]
        i = int(np.searchsorted(ks, word))
        if i < len(ks) and int(ks[i]) == word and self.order > 1:
            return int(self.level_off[0]) + i
        return 0

    def _advance(self, state: int, word: int) -> int:
        """Next history state after emitting `word` from `state` when
        the matched n-gram is of the highest order (not itself a
        state): longest existing suffix of (history, word)."""
        if self.order == 1:
            return 0
        s = int(self.g_suffix[state])
        while True:
            lvl = int(self.g_level[s])
            if lvl + 1 < self.order:
                ks = self.keys[lvl]
                key = (s << 32) | word
                i = int(np.searchsorted(ks, key))
                if i < len(ks) and int(ks[i]) == key:
                    return int(self.level_off[lvl]) + i
            if s == 0:
                return self._unigram_state(word)
            s = int(self.g_suffix[s])

    def logprob_ln(self, state: int, word: int) -> Tuple[int, float]:
        """(next_state, ln P(word | history of state)) with backoff."""
        bo = 0.0
        s = int(state)
        word = int(word)
        if not (0 <= word < (1 << 31)):
            return 0, OOV_LOGPROB_LN
        while True:
            lvl = int(self.g_level[s]) if s else 0
            ks = self.keys[lvl]
            key = (s << 32) | word
            i = int(np.searchsorted(ks, key))
            if i < len(ks) and int(ks[i]) == key:
                lp = float(self.logp[lvl][i])
                if lvl + 1 < self.order:
                    ns = int(self.level_off[lvl]) + i
                else:
                    ns = self._advance(s, word)
                return ns, bo + lp
            if s == 0:
                return self._unigram_state(word), bo + OOV_LOGPROB_LN
            bo += float(self.g_bo[s])
            s = int(self.g_suffix[s])

    # DeterministicLm-compatible surface (costs in -ln)
    def start(self) -> int:
        return self._unigram_state(self.bos_id)

    def step(self, state: int, word: int) -> Tuple[int, float]:
        ns, lp = self.logprob_ln(state, word)
        return ns, -lp

    def final(self, state: int) -> float:
        return -self.logprob_ln(state, self.eos_id)[1]

    def score_sequence_ln(self, words: Sequence[int]) -> float:
        """Total ln P(words </s> | <s>) — for tests vs ArpaLm."""
        s, total = self.start(), 0.0
        for w in words:
            s, lp = self.logprob_ln(s, int(w))
            total += lp
        return total + self.logprob_ln(s, self.eos_id)[1]

    @property
    def num_ngrams(self) -> List[int]:
        return [len(k) for k in self.keys]

    # -- construction ---------------------------------------------------
    @classmethod
    def build_from_arpa(cls, source: Union[str, IO[str]],
                        symbols: Optional[Dict[str, int]] = None,
                        bos: str = "<s>", eos: str = "</s>",
                        unk: str = "<unk>") -> "ConstArpaLm":
        """Stream-parse an ARPA file into the packed representation.

        `symbols`: word -> id (words.txt).  Without it, tokens that are
        all integers are used directly (the reference's arpa-to-const-
        arpa convention of pre-mapped ARPA); otherwise a fresh table is
        built from the unigram section and kept in `self.symbols`.
        """
        close = False
        if isinstance(source, str):
            source = open(source, "r", encoding="utf-8",
                          errors="replace")
            close = True
        try:
            return cls._build(source, symbols, bos, eos, unk)
        finally:
            if close:
                source.close()

    @classmethod
    def _build(cls, f: IO[str], symbols, bos, eos, unk) -> "ConstArpaLm":
        for line in f:
            if line.strip() == "\\data\\":
                break
        else:
            raise KaldiTpuError("no \\data\\ section in ARPA input")
        counts: List[int] = []
        for line in f:
            line = line.strip()
            if line.startswith("ngram"):
                counts.append(int(line.split("=")[1]))
            elif line.startswith("\\"):
                section = line
                break
        order = len(counts)
        if order == 0:
            raise KaldiTpuError("ARPA header lists no ngram counts")

        auto_syms: Optional[Dict[str, int]] = None
        int_words: Optional[bool] = None   # decided on the first token

        def wid(tok: str) -> int:
            nonlocal auto_syms, int_words
            if symbols is not None:
                i = symbols.get(tok, -1)
                if i < 0:
                    raise KaldiTpuError(f"ARPA word not in symbols: {tok}")
                return i
            if int_words is None:
                int_words = tok.lstrip("-").isdigit()
            if int_words:
                try:
                    return int(tok)
                except ValueError:
                    raise KaldiTpuError(
                        f"integer-word ARPA has non-integer token {tok!r};"
                        " pass a symbol table") from None
            if auto_syms is None:
                auto_syms = {}
            return auto_syms.setdefault(tok, len(auto_syms))

        keys: List[np.ndarray] = []
        logp: List[np.ndarray] = []
        bo_lv: List[np.ndarray] = []
        # global state tables; state 0 = empty history
        g_level = [np.zeros(1, np.int8)]
        g_bo = [np.zeros(1, np.float32)]
        g_suffix = [np.zeros(1, np.int32)]
        level_off = np.zeros(order, np.int64)
        next_state = 1

        for n in range(1, order + 1):
            exp = f"\\{n}-grams:"
            if section != exp:
                raise KaldiTpuError(f"expected {exp}, got {section}")
            W = np.empty((counts[n - 1], n), np.int64)
            lp = np.empty(counts[n - 1], np.float32)
            bo = np.zeros(counts[n - 1], np.float32)
            m = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\"):
                    section = line
                    break
                parts = line.split()
                nb = len(parts) == n + 2      # trailing backoff
                if len(parts) != n + 1 and not nb:
                    warn(f"malformed {n}-gram line skipped: {line[:60]}")
                    continue
                if m >= len(W):               # header undercounted
                    W = np.resize(W, (m * 2 + 16, n))
                    lp = np.resize(lp, m * 2 + 16)
                    bo = np.resize(bo, m * 2 + 16)
                lp[m] = float(parts[0]) * M_LN10
                for j in range(n):
                    W[m, j] = wid(parts[1 + j])
                if nb:
                    bo[m] = float(parts[-1]) * M_LN10
                m += 1
            W, lp, bo = W[:m], lp[:m], bo[:m]
            # parent state of (w1..w_{n-1}) via the lower levels
            parent = np.zeros(m, np.int64)
            ok = np.ones(m, bool)
            for j in range(n - 1):
                key = (parent << _SHIFT) | W[:, j]
                pos = np.searchsorted(keys[j], key)
                pos_c = np.minimum(pos, max(len(keys[j]) - 1, 0))
                hit = ok & (len(keys[j]) > 0) & (keys[j][pos_c] == key)
                parent = np.where(hit, level_off[j] + pos_c, 0)
                ok &= hit
            if not ok.all():
                warn(f"{int((~ok).sum())} {n}-grams with missing context "
                     "dropped")
                W, lp, bo, parent = W[ok], lp[ok], bo[ok], parent[ok]
                m = len(W)
            k = (parent << _SHIFT) | W[:, n - 1]
            srt = np.argsort(k, kind="stable")
            k, lp, bo, W, parent = k[srt], lp[srt], bo[srt], W[srt], \
                parent[srt]
            dup = np.zeros(m, bool)
            if m:
                dup[1:] = k[1:] == k[:-1]
            if dup.any():
                warn(f"{int(dup.sum())} duplicate {n}-grams dropped")
                keep = ~dup
                k, lp, bo, W, parent = k[keep], lp[keep], bo[keep], \
                    W[keep], parent[keep]
                m = len(k)
            keys.append(k)
            logp.append(lp.astype(np.float32))
            if n < order:
                bo_lv.append(bo.astype(np.float32))
                level_off[n - 1] = next_state
                next_state += m
                # suffix states: state of (w2..wn)
                g_suf_arr = np.concatenate(g_suffix)
                if n == 1:
                    suf = np.zeros(m, np.int32)
                else:
                    g_lvl_arr = np.concatenate(g_level)
                    s = g_suf_arr[parent]         # suffix of parent
                    suf = np.full(m, -1, np.int64)
                    wlast = W[:, n - 1]
                    for _ in range(order + 1):
                        un = suf < 0
                        if not un.any():
                            break
                        lv = g_lvl_arr[s]
                        for L in np.unique(lv[un]):
                            rows = un & (lv == L)
                            kk = keys[L] if L < n - 1 else k
                            off = level_off[L]
                            key2 = (s[rows] << _SHIFT) | wlast[rows]
                            pos = np.searchsorted(kk, key2)
                            pos_c = np.minimum(pos, max(len(kk) - 1, 0))
                            hit = (len(kk) > 0) & (kk[pos_c] == key2)
                            ridx = np.nonzero(rows)[0]
                            suf[ridx[hit]] = off + pos_c[hit]
                            # chain: suffix of s (state 0 stays 0)
                            miss = ridx[~hit]
                            s[miss] = g_suf_arr[s[miss]]
                        # words absent even as unigrams resolve to 0
                        done0 = (suf < 0) & (s == 0)
                        if done0.any():
                            u = np.searchsorted(keys[0], wlast[done0])
                            u_c = np.minimum(u, len(keys[0]) - 1)
                            hit0 = keys[0][u_c] == wlast[done0]
                            res = np.where(hit0, level_off[0] + u_c, 0)
                            suf[np.nonzero(done0)[0]] = res
                    suf = np.maximum(suf, 0).astype(np.int32)
                # NOTE: suffix of a level-n state always points at a
                # level < n state, so this in-order build is complete.
                g_level.append(np.full(m, n, np.int8))
                g_bo.append(bo.astype(np.float32))
                g_suffix.append(suf.astype(np.int32))
        syms_out = None
        if symbols is not None:
            syms_out = dict(symbols)
        elif auto_syms is not None:
            syms_out = auto_syms

        def sid(tok, default=-1):
            if syms_out is not None:
                return syms_out.get(tok, default)
            return default

        lm = cls(order, keys, logp, np.concatenate(g_level),
                 np.concatenate(g_bo), np.concatenate(g_suffix),
                 level_off, bos_id=sid(bos, 0), eos_id=sid(eos, 0),
                 unk_id=sid(unk, -1), symbols=syms_out)
        if symbols is None and auto_syms is None:
            # integer-word ARPA: bos/eos ids must come from the caller
            # via attributes; default to kaldi's format_lm convention
            # of the literal tokens "<s>"/"</s>" being absent.
            lm.bos_id, lm.eos_id = -1, -1
        return lm

    # -- serialization ---------------------------------------------------
    def write(self, filename: str) -> None:
        with open(filename, "wb") as fo:
            fo.write(_MAGIC)
            fo.write(struct.pack("<iiiii", self.order, self.bos_id,
                                 self.eos_id, self.unk_id,
                                 1 if self.symbols else 0))
            for n in range(self.order):
                fo.write(struct.pack("<q", len(self.keys[n])))
            fo.write(struct.pack("<q", len(self.g_level)))
            for arr in self._array_seq():
                _align8(fo)
                fo.write(np.ascontiguousarray(arr).tobytes())
            if self.symbols:
                blob = "".join(f"{w} {i}\n" for w, i in
                               self.symbols.items()).encode()
                _align8(fo)
                fo.write(struct.pack("<q", len(blob)))
                fo.write(blob)

    def _array_seq(self):
        for n in range(self.order):
            yield self.keys[n]
        for n in range(self.order):
            yield self.logp[n]
        yield self.g_level
        yield self.g_bo
        yield self.g_suffix

    @classmethod
    def read(cls, filename: str, mmap: bool = True) -> "ConstArpaLm":
        sz = os.path.getsize(filename)
        with open(filename, "rb") as fi:
            if fi.read(8) != _MAGIC:
                raise KaldiTpuError(f"{filename}: not a KTCARPA1 file")
            order, bos, eos, unk, has_syms = struct.unpack("<iiiii",
                                                           fi.read(20))
            counts = [struct.unpack("<q", fi.read(8))[0]
                      for _ in range(order)]
            n_states = struct.unpack("<q", fi.read(8))[0]
            pos = fi.tell()

        def view(dtype, count):
            nonlocal pos
            pos += (-pos) % 8
            itm = np.dtype(dtype).itemsize
            if mmap:
                a = np.memmap(filename, dtype=dtype, mode="r",
                              offset=pos, shape=(count,))
            else:
                a = np.fromfile(filename, dtype=dtype, count=count,
                                offset=pos)
            pos += count * itm
            return a

        keys = [view(np.int64, c) for c in counts]
        logp = [view(np.float32, c) for c in counts]
        g_level = view(np.int8, n_states)
        g_bo = view(np.float32, n_states)
        g_suffix = view(np.int32, n_states)
        symbols = None
        if has_syms:
            pos += (-pos) % 8
            with open(filename, "rb") as fi:
                fi.seek(pos)
                blob_len = struct.unpack("<q", fi.read(8))[0]
                blob = fi.read(blob_len).decode()
            symbols = {}
            for ln in blob.splitlines():
                w, i = ln.rsplit(" ", 1)
                symbols[w] = int(i)
        level_off = np.zeros(order, np.int64)
        nxt = 1
        for n in range(order - 1):
            level_off[n] = nxt
            nxt += counts[n]
        if nxt != n_states and order > 1:
            raise KaldiTpuError(f"{filename}: corrupt state count "
                                f"({nxt} vs {n_states}, size {sz})")
        return cls(order, keys, logp, g_level, g_bo, g_suffix,
                   level_off, bos, eos, unk, symbols)
