"""Port of kaldi_tpu.base."""
