"""Port of kaldi_tpu.parallel (the checkpoint layout so far)."""
