"""Port of kaldi_tpu.decoder."""

from kaldi_tpu_torch.decoder.graph import (  # noqa: F401
    Lang,
    make_lexicon_fst,
    add_lex_disambig,
    make_decoding_graph,
    TrainingGraphCompiler,
)
from kaldi_tpu_torch.decoder.viterbi import (  # noqa: F401
    FasterDecoder,
    FasterDecoderOptions,
    align_equal,
    best_path_through,
)
from kaldi_tpu_torch.decoder.incremental import (  # noqa: F401
    LatticeIncrementalDecoder,
)
