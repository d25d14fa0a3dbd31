"""Port of kaldi_tpu.nnet3."""
