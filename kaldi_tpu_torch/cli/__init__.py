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
_FEAT = "kaldi_tpu_torch.cli.feat_tools"
_GMM = "kaldi_tpu_torch.cli.gmm_tools"
_MISC = "kaldi_tpu_torch.cli.misc_tools"
_TREE = "kaldi_tpu_torch.cli.tree_tools"
_XFORM = "kaldi_tpu_torch.cli.transform_tools"

TOOLS: Dict[str, Tuple[str, str]] = {
    "acc-lda": (_XFORM, "acc_lda"),
    "acc-tree-stats": (_TREE, "acc_tree_stats"),
    "add-deltas": (_FEAT, "add_deltas"),
    "ali-to-pdf": (_ALI, "ali_to_pdf"),
    "ali-to-phones": (_ALI, "ali_to_phones"),
    "ali-to-post": (_ALI, "ali_to_post"),
    "align-equal-compiled": (_ALI, "align_equal_compiled"),
    "apply-cmvn": (_FEAT, "apply_cmvn"),
    "build-tree": (_TREE, "build_tree_cli"),
    "chain-est-phone-lm": (_CHAIN, "chain_est_phone_lm"),
    "chain-get-supervision": (_CHAIN, "chain_get_supervision"),
    "chain-make-den-fst": (_CHAIN, "chain_make_den_fst"),
    "cluster-phones": (_TREE, "cluster_phones_cli"),
    "compile-train-graphs": (_GMM, "compile_train_graphs"),
    "compose-transforms": (_XFORM, "compose_transforms"),
    "compute-cmvn-stats": (_FEAT, "compute_cmvn_stats"),
    "compute-mfcc-feats": (_FEAT, "compute_mfcc_feats"),
    "compute-wer": (_ALI, "compute_wer"),
    "convert-ali": (_TREE, "convert_ali"),
    "copy-feats": (_FEAT, "copy_feats"),
    "copy-int-vector": (_ALI, "copy_int_vector"),
    "est-lda": (_XFORM, "est_lda"),
    "est-mllt": (_XFORM, "est_mllt"),
    "extract-segments": (_FEAT, "extract_segments"),
    "feat-to-dim": (_FEAT, "feat_to_dim"),
    "feat-to-len": (_FEAT, "feat_to_len"),
    "gmm-acc-mllt": (_XFORM, "gmm_acc_mllt"),
    "gmm-acc-stats-ali": (_GMM, "gmm_acc_stats_ali"),
    "gmm-align-compiled": (_GMM, "gmm_align_compiled"),
    "gmm-est": (_GMM, "gmm_est"),
    "gmm-est-fmllr": (_XFORM, "gmm_est_fmllr"),
    "gmm-info": (_GMM, "gmm_info"),
    "gmm-init-mono": (_GMM, "gmm_init_mono"),
    "gmm-latgen-faster": (_GMM, "gmm_latgen_faster"),
    "gmm-sum-accs": (_GMM, "gmm_sum_accs"),
    "gmm-transform-means": (_XFORM, "gmm_transform_means"),
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
    "prepare-lang": (_MISC, "prepare_lang"),
    "splice-feats": (_FEAT, "splice_feats"),
    "sum-tree-stats": (_TREE, "sum_tree_stats"),
    "transform-feats": (_XFORM, "transform_feats"),
    "validate-data-dir": (_MISC, "validate_data_dir_cli"),
    "validate-lang": (_MISC, "validate_lang_cli"),
    "wav-to-duration": (_FEAT, "wav_to_duration"),
}


def get_tool(name: str) -> Callable[[List[str]], int]:
    module_name, func = TOOLS[name]
    return getattr(importlib.import_module(module_name), func)
