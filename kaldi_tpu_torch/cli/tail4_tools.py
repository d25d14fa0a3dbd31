"""post-to-pdf-post (port of the tool of `kaldi_tpu/cli/tail4_tools.py`;
bin/post-to-pdf-post.cc): posteriors over transition-ids to posteriors
over pdf-ids, the weights of one pdf in a frame summed.

Not carried over yet: the module's other tools.
"""

from __future__ import annotations

from typing import List

from kaldi_tpu_torch.base.logging import log
from kaldi_tpu_torch.util.parse_options import ParseOptions
from kaldi_tpu_torch.util.table import SequentialTableReader, TableWriter


def _each_post(rspec, wspec, fn, name):
    n = 0
    with TableWriter("posterior", wspec) as w:
        for key, post in SequentialTableReader("posterior", rspec):
            out = fn(key, post)
            if out is not None:
                w.write(key, out)
                n += 1
    log(f"{name}: {n} utterances")
    return 0


def _merge(pairs):
    acc = {}
    for i, p in pairs:
        acc[i] = acc.get(i, 0.0) + p
    return sorted(acc.items())


def post_to_pdf_post(argv: List[str]) -> int:
    po = ParseOptions(
        "Convert posteriors over transition-ids to posteriors over "
        "pdf-ids\n"
        "Usage: post-to-pdf-post <model> <post-rspecifier> "
        "<post-wspecifier>")
    po.read(argv)
    if po.num_args() != 3:
        po.print_usage()
        return 1
    # any model file starting with a TransitionModel works (gmm .mdl,
    # chain .mdl — the reference binaries read the same prefix)
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.util import kaldi_io
    tm = kaldi_io.read_kaldi_object(TransitionModel.read, po.get_arg(1))
    return _each_post(
        po.get_arg(2), po.get_arg(3),
        lambda k, post: [_merge([(tm.transition_id_to_pdf(i), p)
                                 for i, p in frame]) for frame in post],
        "post-to-pdf-post")
