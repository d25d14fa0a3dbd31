"""Port of kaldi_tpu.decoder."""
