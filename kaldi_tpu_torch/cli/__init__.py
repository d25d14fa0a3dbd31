"""Kaldi-compatible command-line tools of the port (the ported subset of
`kaldi_tpu/cli`): each mirrors a reference binary's positional
arguments, options and table specifiers.  Run one as
`python -m kaldi_tpu_torch.cli <tool> [args...]`."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

# tool name -> (module, function)
_LAT = "kaldi_tpu_torch.cli.lat_tools"
_LATGEN = "kaldi_tpu_torch.cli.nnet3_latgen_tools"

TOOLS: Dict[str, Tuple[str, str]] = {
    "compute-wer": ("kaldi_tpu_torch.cli.ali_tools", "compute_wer"),
    "lattice-1best": (_LAT, "lattice_1best"),
    "lattice-add-penalty": (_LAT, "lattice_add_penalty"),
    "lattice-best-path": (_LAT, "lattice_best_path_cli"),
    "lattice-copy": (_LAT, "lattice_copy"),
    "lattice-determinize": (_LAT, "lattice_determinize_cli"),
    "lattice-determinize-pruned": (_LAT, "lattice_determinize_pruned_cli"),
    "lattice-prune": (_LAT, "lattice_prune_cli"),
    "lattice-scale": (_LAT, "lattice_scale_cli"),
    "nnet3-compute": ("kaldi_tpu_torch.cli.nnet3_tools", "nnet3_compute"),
    "nnet3-compute-batch": ("kaldi_tpu_torch.cli.nnet3_tools",
                            "nnet3_compute_batch"),
    "nnet3-latgen-faster": ("kaldi_tpu_torch.cli.nnet3_tools",
                            "nnet3_latgen_faster"),
    "nnet3-latgen-faster-batch": (_LATGEN, "nnet3_latgen_faster_batch"),
    "nnet3-latgen-faster-looped": (_LATGEN, "nnet3_latgen_faster_looped"),
    "online2-tcp-nnet3-decode-faster": ("kaldi_tpu_torch.cli.online_tools2",
                                        "online2_tcp_nnet3_decode_faster"),
    "online2-wav-dump-features": ("kaldi_tpu_torch.cli.online_tools2",
                                  "online2_wav_dump_features"),
    "online2-wav-nnet3-latgen-faster": ("kaldi_tpu_torch.cli.online_tools",
                                        "online2_wav_nnet3_latgen_faster"),
}


def get_tool(name: str) -> Callable[[List[str]], int]:
    module_name, func = TOOLS[name]
    return getattr(importlib.import_module(module_name), func)
