"""Port of kaldi_tpu.ops."""
