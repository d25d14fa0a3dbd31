"""Kaldi-compatible command-line tools of the port (the ported subset of
`kaldi_tpu/cli`): each mirrors a reference binary's positional
arguments, options and table specifiers.  Run one as
`python -m kaldi_tpu_torch.cli <tool> [args...]`."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

# tool name -> (module, function)
_ALI = "kaldi_tpu_torch.cli.ali_tools"
_CHAIN = "kaldi_tpu_torch.cli.chain_tools"
_LAT = "kaldi_tpu_torch.cli.lat_tools"
_LATGEN = "kaldi_tpu_torch.cli.nnet3_latgen_tools"
_NNET3 = "kaldi_tpu_torch.cli.nnet3_tools2"
_TAIL2 = "kaldi_tpu_torch.cli.nnet3_tail2_tools"

TOOLS: Dict[str, Tuple[str, str]] = {
    "ali-to-pdf": (_ALI, "ali_to_pdf"),
    "ali-to-post": (_ALI, "ali_to_post"),
    "chain-est-phone-lm": (_CHAIN, "chain_est_phone_lm"),
    "chain-get-supervision": (_CHAIN, "chain_get_supervision"),
    "chain-make-den-fst": (_CHAIN, "chain_make_den_fst"),
    "compute-wer": (_ALI, "compute_wer"),
    "lattice-1best": (_LAT, "lattice_1best"),
    "lattice-add-penalty": (_LAT, "lattice_add_penalty"),
    "lattice-best-path": (_LAT, "lattice_best_path_cli"),
    "lattice-copy": (_LAT, "lattice_copy"),
    "lattice-determinize": (_LAT, "lattice_determinize_cli"),
    "lattice-determinize-pruned": (_LAT, "lattice_determinize_pruned_cli"),
    "lattice-prune": (_LAT, "lattice_prune_cli"),
    "lattice-scale": (_LAT, "lattice_scale_cli"),
    "nnet3-average": (_NNET3, "nnet3_average"),
    "nnet3-chain-combine": (_CHAIN, "nnet3_chain_combine"),
    "nnet3-chain-combine2": (_TAIL2, "nnet3_chain_combine2"),
    "nnet3-chain-compute-prob": (_CHAIN, "nnet3_chain_compute_prob"),
    "nnet3-chain-copy-egs": (_CHAIN, "nnet3_chain_copy_egs"),
    "nnet3-chain-e2e-get-egs": (_CHAIN, "nnet3_chain_e2e_get_egs"),
    "nnet3-chain-get-egs": (_CHAIN, "nnet3_chain_get_egs"),
    "nnet3-chain-merge-egs": (_CHAIN, "nnet3_chain_merge_egs"),
    "nnet3-chain-normalize-egs": (_CHAIN, "nnet3_chain_normalize_egs"),
    "nnet3-chain-shuffle-egs": (_CHAIN, "nnet3_chain_shuffle_egs"),
    "nnet3-chain-subset-egs": (_CHAIN, "nnet3_chain_subset_egs"),
    "nnet3-chain-train": (_CHAIN, "nnet3_chain_train"),
    "nnet3-chain-train2": (_TAIL2, "nnet3_chain_train2"),
    "nnet3-combine": (_TAIL2, "nnet3_combine"),
    "nnet3-compute": ("kaldi_tpu_torch.cli.nnet3_tools", "nnet3_compute"),
    "nnet3-compute-batch": ("kaldi_tpu_torch.cli.nnet3_tools",
                            "nnet3_compute_batch"),
    "nnet3-compute-from-egs": (_NNET3, "nnet3_compute_from_egs"),
    "nnet3-compute-prob": (_NNET3, "nnet3_compute_prob"),
    "nnet3-copy": (_NNET3, "nnet3_copy"),
    "nnet3-copy-egs": (_NNET3, "nnet3_copy_egs"),
    "nnet3-get-egs": (_NNET3, "nnet3_get_egs"),
    "nnet3-latgen-faster": ("kaldi_tpu_torch.cli.nnet3_tools",
                            "nnet3_latgen_faster"),
    "nnet3-latgen-faster-batch": (_LATGEN, "nnet3_latgen_faster_batch"),
    "nnet3-latgen-faster-looped": (_LATGEN, "nnet3_latgen_faster_looped"),
    "nnet3-merge-egs": (_NNET3, "nnet3_merge_egs"),
    "nnet3-shuffle-egs": (_NNET3, "nnet3_shuffle_egs"),
    "nnet3-subset-egs": (_NNET3, "nnet3_subset_egs"),
    "nnet3-train": (_TAIL2, "nnet3_train"),
    "online2-tcp-nnet3-decode-faster": ("kaldi_tpu_torch.cli.online_tools2",
                                        "online2_tcp_nnet3_decode_faster"),
    "online2-wav-dump-features": ("kaldi_tpu_torch.cli.online_tools2",
                                  "online2_wav_dump_features"),
    "online2-wav-nnet3-latgen-faster": ("kaldi_tpu_torch.cli.online_tools",
                                        "online2_wav_nnet3_latgen_faster"),
    "post-to-pdf-post": ("kaldi_tpu_torch.cli.tail4_tools",
                         "post_to_pdf_post"),
}


def get_tool(name: str) -> Callable[[List[str]], int]:
    module_name, func = TOOLS[name]
    return getattr(importlib.import_module(module_name), func)
