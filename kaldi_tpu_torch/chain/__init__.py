"""Port of kaldi_tpu.chain (LF-MMI graphs, supervision, objective)."""
