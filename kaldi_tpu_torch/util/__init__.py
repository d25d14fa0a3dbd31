"""Port of kaldi_tpu.util."""
