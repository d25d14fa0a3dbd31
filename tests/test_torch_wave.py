"""Port parity of the wave files and the "wave" table holder:
kaldi_tpu_torch/feat/wave.py and util/table.py against
kaldi_tpu/feat/wave.py and kaldi_tpu/util/table.py, on the same seeded
samples.  The bytes each package writes are equal; each reads the
other's files, every sample equal; the holder reads archives and
scripts (with and without byte offsets) written by either package."""

import io
import struct

import numpy as np
import pytest

from kaldi_tpu.feat.wave import WaveData as JaxWave
from kaldi_tpu.util import table as JT
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.feat.wave import WaveData
from kaldi_tpu_torch.util import table as PT


def samples(seed, channels=1, n=4001):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(scale=6000.0, size=(channels, n)),
                   -40000, 40000).astype(np.float32)


def wav_bytes(cls, fs, data):
    buf = io.BytesIO()
    cls(fs, data).write(buf)
    return buf.getvalue()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [8000, 16000])
def test_write_bytes_equal_and_cross_read(channels, fs):
    data = samples(channels, channels)
    got, want = wav_bytes(WaveData, fs, data), wav_bytes(JaxWave, fs, data)
    assert got == want
    for reader, raw in ((WaveData, want), (JaxWave, got)):
        w = reader.read(io.BytesIO(raw))
        assert w.samp_freq == fs and w.data.shape == (channels, data.shape[1])
        np.testing.assert_array_equal(
            w.data, np.clip(np.round(data), -32768, 32767))
    assert WaveData.read(io.BytesIO(got)).duration == data.shape[1] / fs


def _riff(fmt_body: bytes, payload: bytes, extra=b"", size=None) -> bytes:
    size = len(payload) if size is None else size
    return (b"RIFF" + struct.pack("<I", 0) + b"WAVE" + extra
            + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", size) + payload)


@pytest.mark.parametrize("kind", ["pcm8", "pcm32", "float32", "piped",
                                  "extra_chunk", "extensible"])
def test_read_formats_match_jax(kind):
    rng = np.random.default_rng(3)
    extra, size = b"", None
    if kind == "pcm8":
        payload, fmt = rng.integers(0, 256, 300, np.uint8).tobytes(), \
            (1, 1, 8000, 8000, 1, 8)
    elif kind == "pcm32":
        payload, fmt = rng.integers(-2**31, 2**31, 300, np.int64).astype(
            "<i4").tobytes(), (1, 1, 8000, 32000, 4, 32)
    elif kind == "float32":
        payload, fmt = rng.uniform(-1, 1, 300).astype("<f4").tobytes(), \
            (3, 1, 8000, 32000, 4, 32)
    else:
        payload, fmt = rng.integers(-3000, 3000, 300).astype(
            "<i2").tobytes(), (1, 1, 16000, 32000, 2, 16)
        if kind == "piped":
            size = 0xFFFFFFFF
        elif kind == "extra_chunk":
            extra = b"LIST" + struct.pack("<I", 3) + b"abc\0"
    body = struct.pack("<HHIIHH", *fmt)
    if kind == "extensible":
        body = struct.pack("<HHIIHH", 0xFFFE, *fmt[1:]) + b"\0" * 8 \
            + struct.pack("<H", 1) + b"\0" * 14
    raw = _riff(body, payload, extra, size)
    got, want = WaveData.read(io.BytesIO(raw)), JaxWave.read(io.BytesIO(raw))
    assert got.samp_freq == want.samp_freq
    np.testing.assert_array_equal(got.data, want.data)


def test_bad_files_raise():
    with pytest.raises(KaldiTpuError, match="RIFF"):
        WaveData.read(io.BytesIO(b"NOPE" + b"\0" * 40))
    with pytest.raises(KaldiTpuError, match="fmt/data"):
        WaveData.read(io.BytesIO(b"RIFF\0\0\0\0WAVE"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wave_holder_reads_ark_and_scp(writer, tmp_path):
    waves = {f"utt{i}": samples(10 + i, n=1600 + 37 * i) for i in range(3)}
    ark, scp = tmp_path / "w.ark", tmp_path / "w.scp"
    mod, cls = (PT, WaveData) if writer == "port" else (JT, JaxWave)
    with mod.TableWriter("wave", f"ark,scp:{ark},{scp}") as w:
        for k, v in waves.items():
            w.write(k, cls(16000, v))
    # a script of plain .wav files too, as wav.scp lists them
    files = tmp_path / "files.scp"
    with open(files, "w") as f:
        for k, v in waves.items():
            path = tmp_path / f"{k}.wav"
            path.write_bytes(wav_bytes(cls, 16000, v))
            f.write(f"{k} {path}\n")
    for spec in (f"ark:{ark}", f"scp:{scp}", f"scp:{files}"):
        got = dict(PT.SequentialTableReader("wave", spec))
        want = dict(JT.SequentialTableReader("wave", spec))
        assert sorted(got) == sorted(want) == sorted(waves)
        for k in waves:
            np.testing.assert_array_equal(got[k].data, want[k].data)
            assert got[k].samp_freq == 16000
        ra = PT.RandomAccessTableReader("wave", spec)
        np.testing.assert_array_equal(ra["utt1"].data, want["utt1"].data)


def test_wave_holder_refuses_text_mode(tmp_path):
    with PT.TableWriter("wave", f"ark,t:{tmp_path / 'w.ark'}") as w:
        with pytest.raises(KaldiTpuError, match="binary"):
            w.write("a", WaveData(8000, samples(0, n=10)))
