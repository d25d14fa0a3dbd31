"""Feature-space transforms of GMM training (port of the LDA, MLLT and
fMLLR modules of `kaldi_tpu/transform/`): the statistics as float64
torch ops on the system's device, the small solves on the host in numpy
float64, as the reference has them."""

from kaldi_tpu_torch.transform.fmllr import (  # noqa: F401
    FmllrDiagGmmAccs, apply_affine_transform, estimate_fmllr)
from kaldi_tpu_torch.transform.lda import LdaEstimate, LdaOptions  # noqa: F401
from kaldi_tpu_torch.transform.mllt import MlltAccs  # noqa: F401
