"""Port of kaldi_tpu.fstext."""
