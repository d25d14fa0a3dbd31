"""Port of kaldi_tpu.feat."""
