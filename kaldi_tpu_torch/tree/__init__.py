"""Port of kaldi_tpu.tree."""
