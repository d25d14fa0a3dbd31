"""Port of kaldi_tpu.hmm."""
