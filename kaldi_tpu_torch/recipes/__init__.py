"""Port of kaldi_tpu.recipes."""
