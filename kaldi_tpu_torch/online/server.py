"""TCP streaming decode server (port of `kaldi_tpu/online/server.py`; the
protocol of the reference's online2bin/online2-tcp-nnet3-decode-faster.cc).

A client streams raw 16-bit little-endian PCM at `samp_freq` over a TCP
connection; the server decodes as the audio arrives and writes text
lines back:
  - a partial hypothesis after each chunk, ended by '\\r' (a terminal
    overwrites it in place),
  - a final one at an endpoint, or once the client shuts down its write
    side, ended by '\\n'.

One thread a connection, all over the shared read-only model and graph.
The scorer is either one function of a chunk of features shared by all
connections (`scorer`), or a factory of a streaming scorer for each
utterance (`make_scorer`, e.g. nnet3/streaming.py's OnlineNnetScorer).
A connection's handler catches only the connection's own errors; any
other error is kept in `errors`, so that the caller can fail on it, and
raised on to the socket server, which prints it.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import traceback
from typing import Callable, Optional

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.decoder.viterbi import FasterDecoderOptions
from kaldi_tpu_torch.online.decoding import (OnlineEndpointConfig,
                                             SingleUtteranceDecoder)


class DecodeSession:
    """One utterance of a connection: its pipeline and decoder."""

    def __init__(self, server: "TcpDecodeServer"):
        self.server = server
        self.pipeline = server.make_pipeline()
        scorer = (server.make_scorer() if server.make_scorer is not None
                  else server.scorer)
        self.decoder = SingleUtteranceDecoder(
            server.hclg, server.tm, scorer, self.pipeline,
            acoustic_scale=server.acoustic_scale, opts=server.decoder_opts)

    def _text(self, res) -> str:
        if res is None:
            return ""
        return " ".join(self.server.word_names.get(w, str(w))
                        for w in res[1])

    def accept_pcm(self, data: bytes) -> Optional[str]:
        """Feed raw PCM bytes; -> the partial hypothesis (None when
        nothing is decodable yet)."""
        pcm = np.frombuffer(data, "<i2").astype(np.float32)
        self.pipeline.accept_waveform(self.server.samp_freq, pcm)
        self.decoder.advance_decoding()
        res = self.decoder.decoder.best_path(use_final_probs=False)
        return None if res is None else self._text(res)

    def endpoint(self) -> bool:
        return self.decoder.endpoint_detected(self.server.endpoint_config)

    def finalize(self) -> str:
        self.pipeline.input_finished()
        self.decoder.advance_decoding()
        text = self._text(self.decoder.finalize_decoding())
        self.server._account(self)
        return text


class TcpDecodeServer:
    def __init__(self, hclg, tm, scorer: Optional[Callable], word_names,
                 make_pipeline: Callable[[], object],
                 samp_freq: float = 8000.0,
                 acoustic_scale: float = 0.1,
                 chunk_ms: int = 180,
                 endpoint_config: Optional[OnlineEndpointConfig] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 make_scorer: Optional[Callable[[], object]] = None,
                 decoder_opts: Optional[FasterDecoderOptions] = None):
        if (scorer is None) == (make_scorer is None):
            raise ValueError("give one of scorer and make_scorer")
        self.hclg = hclg
        self.tm = tm
        self.scorer = scorer
        self.make_scorer = make_scorer
        self.word_names = dict(word_names)
        self.make_pipeline = make_pipeline
        self.samp_freq = samp_freq
        self.acoustic_scale = acoustic_scale
        self.decoder_opts = decoder_opts
        self.chunk_bytes = max(2, int(samp_freq * chunk_ms / 1000) * 2)
        self.endpoint_config = endpoint_config or OnlineEndpointConfig()
        self.num_served = 0       # connections ended (the CLI's exit rule)
        self.errors = []          # (client, traceback) of failed handlers
        # host seconds of scoring and of search, chunks and output frames
        self.stats = dict(utterances=0, chunks=0, frames=0, scorer_s=0.0,
                          search_s=0.0)
        self._lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: D401
                try:
                    self._handle()
                except (ConnectionError, BrokenPipeError) as e:
                    warn(f"client {self.client_address} dropped: {e}")
                except Exception:
                    with outer._lock:
                        outer.errors.append((self.client_address,
                                             traceback.format_exc()))
                    raise
                finally:
                    with outer._lock:
                        outer.num_served += 1

            def _handle(self):
                sess = DecodeSession(outer)
                buf = b""
                sock: socket.socket = self.request
                while True:
                    data = sock.recv(4096)
                    if not data:
                        break
                    buf += data
                    while len(buf) >= outer.chunk_bytes:
                        chunk, buf = buf[:outer.chunk_bytes], \
                            buf[outer.chunk_bytes:]
                        partial = sess.accept_pcm(chunk)
                        if partial is not None:
                            sock.sendall((partial + "\r").encode())
                        if sess.endpoint():
                            sock.sendall((sess.finalize() + "\n").encode())
                            sess = DecodeSession(outer)
                if buf:
                    sess.accept_pcm(buf[:len(buf) // 2 * 2])
                sock.sendall((sess.finalize() + "\n").encode())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _account(self, sess: DecodeSession) -> None:
        d = sess.decoder
        with self._lock:
            self.stats["utterances"] += 1
            self.stats["chunks"] += d.chunks
            self.stats["frames"] += d.frames
            self.stats["scorer_s"] += d.scorer_s
            self.stats["search_s"] += d.search_s

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        log(f"TCP decode server listening on {self.host}:{self.port}")

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
