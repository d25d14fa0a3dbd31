"""Port of kaldi_tpu.online."""
