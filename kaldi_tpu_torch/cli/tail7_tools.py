"""extend-wav-with-silence (port of that tool of
`kaldi_tpu/cli/tail7_tools.py`; parity:
src/featbin/extend-wav-with-silence.cc).  Host numpy.

Not carried over yet: the module's other tools.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def extend_wav_with_silence(argv: List[str]) -> int:
    po = ParseOptions(
        "Append (and prepend) silence to waveforms "
        "(extend-wav-with-silence.cc).\n"
        "Usage: extend-wav-with-silence [options] <wav-rspecifier> "
        "<wav-wspecifier>")
    extra = po.register_value("extra-silence-length", 1.0,
                              "Seconds of silence to append")
    prepend = po.register_value("prepend", False,
                                "Also prepend the same amount")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.wave import WaveData
    writer = TableWriter("wave", po.get_arg(2))
    n = 0
    for key, wav in SequentialTableReader("wave", po.get_arg(1)):
        fs = wav.samp_freq
        pad = np.zeros((wav.data.shape[0], int(extra[0] * fs)),
                       np.float32)
        parts = ([pad, wav.data, pad] if prepend[0]
                 else [wav.data, pad])
        writer.write(key, WaveData(fs, np.concatenate(parts, axis=1)))
        n += 1
    writer.close()
    log(f"extended {n} waveforms by {extra[0]}s of silence")
    return 0 if n else 1
