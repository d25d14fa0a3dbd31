"""RIFF WAV read and write (port of `kaldi_tpu/feat/wave.py`; the
reference's feat/wave-reader.h:106 WaveData).

Kaldi's convention: samples are float32 with int16-range values (not
scaled to +-1), laid out (num_channels, num_samples).  PCM16, PCM8,
PCM32 and float32 are read; chunks other than "fmt " and "data" are
skipped; a data chunk of size 0 or 0xFFFFFFFF (a wav written to a pipe)
is read to the end of the stream.  Writing gives PCM16.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from kaldi_tpu_torch.base.logging import KaldiTpuError


class WaveData:
    def __init__(self, samp_freq: float, data: np.ndarray):
        self.samp_freq = float(samp_freq)
        self.data = np.atleast_2d(np.asarray(data, dtype=np.float32))

    @property
    def duration(self) -> float:
        return self.data.shape[1] / self.samp_freq

    def channel(self, c: int = 0) -> np.ndarray:
        return self.data[c]

    @classmethod
    def read(cls, stream: BinaryIO) -> "WaveData":
        riff = stream.read(4)
        if riff not in (b"RIFF", b"RIFX"):
            raise KaldiTpuError(f"not a RIFF file (got {riff!r})")
        e = ">" if riff == b"RIFX" else "<"
        stream.read(4)          # the RIFF size: often wrong for piped wavs
        wave = stream.read(4)
        if wave != b"WAVE":
            raise KaldiTpuError(f"not a WAVE file (got {wave!r})")
        fmt = data = None
        while True:
            head = stream.read(8)
            if len(head) < 8:
                break
            chunk_id = head[:4]
            size = struct.unpack(e + "I", head[4:])[0]
            if chunk_id == b"fmt ":
                fmt = stream.read(size)
            elif chunk_id == b"data":
                data = (stream.read() if size in (0, 0xFFFFFFFF)
                        else stream.read(size))
                break
            else:
                stream.read(size + (size & 1))
        if fmt is None or data is None:
            raise KaldiTpuError("missing fmt/data chunk in wav")
        (audio_format, channels, samp_freq, _br, _block_align,
         bits) = struct.unpack(e + "HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_format = struct.unpack(e + "H", fmt[24:26])[0]
        if audio_format == 1 and bits == 16:
            arr = np.frombuffer(data, dtype=e + "i2").astype(np.float32)
        elif audio_format == 1 and bits == 8:
            arr = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                   - 128.0) * 256.0
        elif audio_format == 1 and bits == 32:
            arr = np.frombuffer(data, dtype=e + "i4").astype(np.float32) \
                / 65536.0
        elif audio_format == 1:
            raise KaldiTpuError(f"unsupported PCM bit depth {bits}")
        elif audio_format == 3 and bits == 32:
            arr = np.frombuffer(data, dtype=e + "f4").astype(np.float32) \
                * 32768.0
        else:
            raise KaldiTpuError(f"unsupported wav format {audio_format}")
        n = (len(arr) // channels) * channels
        return cls(samp_freq, arr[:n].reshape(-1, channels).T.copy())

    def write(self, stream: BinaryIO) -> None:
        channels = self.data.shape[0]
        payload = np.clip(np.round(self.data.T), -32768, 32767) \
            .astype("<i2").tobytes()
        stream.write(b"RIFF")
        stream.write(struct.pack("<I", 36 + len(payload)))
        stream.write(b"WAVE")
        rate = int(self.samp_freq)
        stream.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                                           rate * channels * 2,
                                           channels * 2, 16))
        stream.write(b"data" + struct.pack("<I", len(payload)))
        stream.write(payload)
