"""prepare-lang, validate-data-dir and validate-lang (ports of the
stage-0 tools of `kaldi_tpu/cli/misc_tools.py`): a lang directory from a
lexicon file (utils/prepare_lang.sh), and the consistency checks of a
data directory and a lang directory (utils/validate_data_dir.sh,
utils/validate_lang.pl).  Host-side.

Not carried over yet: the module's other tools.
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.util.parse_options import ParseOptions


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
