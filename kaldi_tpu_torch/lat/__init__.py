"""Port of kaldi_tpu.lat."""
