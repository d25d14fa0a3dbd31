"""Posterior type and holders (port of `kaldi_tpu/hmm/posterior.py`;
parity: hmm/posterior.h).

A Posterior is, per frame, a list of (index, weight) pairs — indices
are transition-ids (or pdf-ids after post-to-pdf)."""

from __future__ import annotations

from typing import BinaryIO, List, Tuple

import numpy as np

from kaldi_tpu_torch.base import io_funcs as iof
from kaldi_tpu_torch.util.table import Holder

Posterior = List[List[Tuple[int, float]]]


def write_posterior(stream: BinaryIO, binary: bool, post: Posterior) -> None:
    if binary:
        iof.write_int32(stream, binary, len(post))
        for frame in post:
            iof.write_int32(stream, binary, len(frame))
            for idx, w in frame:
                iof.write_int32(stream, binary, idx)
                iof.write_float(stream, binary, w)
    else:
        parts = []
        for frame in post:
            parts.append("[")
            for idx, w in frame:
                parts.append(f"{idx} {w}")
            parts.append("]")
        stream.write((" ".join(parts) + "\n").encode())


def read_posterior(stream: BinaryIO, binary: bool) -> Posterior:
    if binary:
        n = iof.read_int32(stream, binary)
        post = []
        for _ in range(n):
            m = iof.read_int32(stream, binary)
            post.append([(iof.read_int32(stream, binary),
                          iof.read_float(stream, binary))
                         for _ in range(m)])
        return post
    line = stream.readline().decode()
    toks = line.split()
    post: Posterior = []
    i = 0
    while i < len(toks):
        assert toks[i] == "["
        i += 1
        frame = []
        while toks[i] != "]":
            frame.append((int(toks[i]), float(toks[i + 1])))
            i += 2
        i += 1
        post.append(frame)
    return post


class PosteriorHolder(Holder):
    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return read_posterior(stream, binary)

    def write(self, stream, binary, value):
        write_posterior(stream, binary, value)


# GaussPost: per frame, (pdf-id, per-Gaussian posterior vector) pairs
# (posterior.h:98 GaussPostHolder; gmm-post-to-gpost writes pdf-ids).
GaussPost = List[List[Tuple[int, np.ndarray]]]


def write_gauss_post(stream: BinaryIO, binary: bool,
                     gpost: GaussPost) -> None:
    iof.write_int32(stream, binary, len(gpost))
    for frame in gpost:
        iof.write_int32(stream, binary, len(frame))
        for idx, vec in frame:
            iof.write_int32(stream, binary, idx)
            iof.write_vector(stream, binary, vec)
    if not binary:
        stream.write(b"\n")


def read_gauss_post(stream: BinaryIO, binary: bool) -> GaussPost:
    n = iof.read_int32(stream, binary)
    gpost: GaussPost = []
    for _ in range(n):
        m = iof.read_int32(stream, binary)
        gpost.append([(iof.read_int32(stream, binary),
                       iof.read_vector(stream, binary))
                      for _ in range(m)])
    return gpost


class GaussPostHolder(Holder):
    def read(self, stream):
        binary = iof.init_input_stream(stream)
        return read_gauss_post(stream, binary)

    def write(self, stream, binary, value):
        write_gauss_post(stream, binary, value)


def posterior_to_pdf(post: Posterior, tm) -> Posterior:
    """post-to-pdf: convert transition-id posteriors to pdf posteriors,
    merging weights."""
    out = []
    for frame in post:
        acc = {}
        for tid, w in frame:
            pdf = tm.transition_id_to_pdf(tid)
            acc[pdf] = acc.get(pdf, 0.0) + w
        out.append(sorted(acc.items()))
    return out
