"""prepare-lang, validate-data-dir and validate-lang (ports of the
stage-0 tools of `kaldi_tpu/cli/misc_tools.py`): a lang directory from a
lexicon file (utils/prepare_lang.sh), and the consistency checks of a
data directory and a lang directory (utils/validate_data_dir.sh,
utils/validate_lang.pl); and its feature and wave tools copy-feats-to-htk
(one HTK file an utterance, feat/htk.py) and wav-reverberate (an impulse
response, additive noise at an SNR, a volume; feat/perturb.py).
Host-side.

Not carried over yet: the module's other tools.
"""

from __future__ import annotations

import os
from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.util import kaldi_io
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader


def prepare_lang(argv: List[str]) -> int:
    po = ParseOptions(
        "Prepare a lang directory from a lexicon file "
        "(utils/prepare_lang.sh equivalent).\n"
        "Usage: prepare-lang [options] <lexicon-file> <lang-dir>")
    sil_phone = po.register_value("sil-phone", "SIL", "Silence phone symbol")
    sil_prob = po.register_value("sil-prob", 0.5, "Probability of optional silence")
    oov_word = po.register_value("oov-word", "", "Word mapped to out-of-vocabulary words")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.decoder.lang_dir import prepare_lang as _prep
    _prep(po.get_arg(1), po.get_arg(2), sil_phone=sil_phone[0],
          sil_prob=sil_prob[0], oov_word=oov_word[0] or None)
    return 0


def validate_data_dir_cli(argv: List[str]) -> int:
    po = ParseOptions(
        "Validate a data directory (wav.scp/text/utt2spk/... consistency)\n"
        "Usage: validate-data-dir [options] <data-dir>")
    from kaldi_tpu_torch.util.validation import validate_data_dir
    no_text = po.register_value("no-text", False, "Do not require a text file")
    no_feats = po.register_value("no-feats", True, "Do not require feats.scp")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    problems = validate_data_dir(po.get_arg(1),
                                 require_text=not no_text[0],
                                 require_feats=not no_feats[0])
    for p in problems:
        warn(p)
    if not problems:
        log(f"{po.get_arg(1)}: valid data directory")
    return 0 if not problems else 1


def validate_lang_cli(argv: List[str]) -> int:
    po = ParseOptions("Validate a lang directory\n"
                      "Usage: validate-lang [options] <lang-dir>")
    from kaldi_tpu_torch.util.validation import validate_lang_dir
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    problems = validate_lang_dir(po.get_arg(1))
    for p in problems:
        warn(p)
    if not problems:
        log(f"{po.get_arg(1)}: valid lang directory")
    return 0 if not problems else 1


def wav_reverberate(argv: List[str]) -> int:
    po = ParseOptions(
        "Corrupts the wave files supplied via input pipe with the specified\n"
        "room-impulse response and additive noise distortions.\n"
        "Usage: wav-reverberate [options] <wav-in-rxfilename> <wav-out-wxfilename>")
    impulse_response = po.register_value("impulse-response", "", "rxfilename of the impulse response wav")
    additive_signals = po.register_value("additive-signals", "", "rxfilename of additive noise wav")
    snrs = po.register_value("snrs", "20", "SNR(dB) for the additive noise")
    volume = po.register_value("volume", 0.0, "If nonzero, scale the output wave by this factor")
    po.read(argv)
    if po.num_args() != 2:
        po.print_usage()
        return 1
    from kaldi_tpu_torch.feat.perturb import (add_noise, reverberate,
                                              volume_perturb)
    from kaldi_tpu_torch.feat.wave import WaveData
    with kaldi_io.input_stream(po.get_arg(1)) as f:
        wav = WaveData.read(f)
    out = wav.channel(0)
    if impulse_response[0]:
        with kaldi_io.input_stream(impulse_response[0]) as f:
            rir = WaveData.read(f).channel(0)
        out = reverberate(out, rir)
    if additive_signals[0]:
        with kaldi_io.input_stream(additive_signals[0]) as f:
            noise = WaveData.read(f).channel(0)
        out = add_noise(out, noise, float(snrs[0].split(":")[0]))
    if volume[0]:
        out = volume_perturb(out, volume[0])
    with kaldi_io.output_stream(po.get_arg(2)) as f:
        WaveData(wav.samp_freq, out[None, :]).write(f)
    return 0


def copy_feats_to_htk(argv: List[str]) -> int:
    po = ParseOptions(
        "Save features as HTK-format files (one per utterance)\n"
        "Usage: copy-feats-to-htk [options] <feats-rspecifier>")
    from kaldi_tpu_torch.feat.htk import write_htk
    output_dir = po.register_value("output-dir", "./", "Output directory")
    output_ext = po.register_value("output-ext", "fea", "Output extension")
    sample_period = po.register_value("sample-period", 100000, "HTK sample period (100ns units)")
    po.read(argv)
    if po.num_args() != 1:
        po.print_usage()
        return 1
    os.makedirs(output_dir[0], exist_ok=True)
    n = 0
    for key, feats in SequentialTableReader("matrix", po.get_arg(1)):
        path = os.path.join(output_dir[0], f"{key}.{output_ext[0]}")
        with open(path, "wb") as f:
            write_htk(f, feats, sample_period=sample_period[0],
                      parm_kind=9)  # USER kind
        n += 1
    log(f"wrote {n} HTK feature files to {output_dir[0]}")
    return 0 if n else 1
