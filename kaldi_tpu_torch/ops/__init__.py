"""Port of kaldi_tpu.ops."""


def kernel_launch_counts() -> dict:
    """Launches of each hand-written kernel in this process since its
    count was last set to 0."""
    from kaldi_tpu_torch.ops import block_chain_lattice_step as bcl
    from kaldi_tpu_torch.ops import block_chain_step as bcs
    from kaldi_tpu_torch.ops import viterbi_relax as vr
    return {"block_chain_step": bcs.launches,
            "block_chain_lattice_step": bcl.launches,
            "viterbi_relax": vr.launches}
