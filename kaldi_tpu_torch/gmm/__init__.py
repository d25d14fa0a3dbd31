"""Port of kaldi_tpu.gmm (the diagonal GMMs of monophone training)."""
