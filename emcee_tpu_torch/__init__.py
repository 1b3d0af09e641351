"""emcee_tpu_torch: the PyTorch and CUDA port of emcee_tpu.

The affine-invariant ensemble sampler on one NVIDIA GPU (Hopper,
``sm_90a``).  It keeps the JAX package's module and public names; the
proposal (K1) and the accept/select write-back (K2) are hand-written CUDA
kernels beside plain PyTorch versions.  Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""

from . import autocorr, backends, moves
from .sampler import EnsembleSampler
from .state import State

__all__ = ["EnsembleSampler", "State", "autocorr", "backends", "moves"]
