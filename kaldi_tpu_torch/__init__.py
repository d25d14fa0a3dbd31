"""PyTorch + CUDA port of kaldi_tpu for NVIDIA Hopper.

Mirrors the module paths and class names of `kaldi_tpu` (the JAX
reference, which this package never imports).  Plain device code is
PyTorch; each Pallas TPU kernel of `kaldi_tpu` becomes a hand-written
CUDA kernel under `csrc/`, built with nvcc at first use
(`kaldi_tpu_torch.ops._build`).  The host's native aligner of GMM
training, `csrc/beam_viterbi.cpp`, is built with g++ at first use
(`kaldi_tpu_torch.decoder.native_viterbi`).

Every entry point takes a `device` argument and runs on CUDA unless the
caller passes `device="cpu"`; asking for CUDA on a machine without it
raises (see `kaldi_tpu_torch.device.resolve_device`).
"""

from kaldi_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
