"""Port of kaldi_tpu.matrix."""
