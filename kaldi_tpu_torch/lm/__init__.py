"""Port of kaldi_tpu.lm."""
