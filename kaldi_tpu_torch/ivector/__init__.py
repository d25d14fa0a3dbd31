"""Port of kaldi_tpu.ivector."""
