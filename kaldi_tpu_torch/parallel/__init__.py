"""Port of kaldi_tpu.parallel: the checkpoint layout, the chain trainer
of the egs tools, its optimizer transformations and the divergence
guard (one device; the mesh waits for torch.distributed)."""
