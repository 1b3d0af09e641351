"""emcee_tpu_torch: the PyTorch and CUDA port of emcee_tpu.

The affine-invariant ensemble sampler on one NVIDIA GPU (Hopper,
``sm_90a``).  It keeps the JAX package's module and public names.  The
hot path's fused op chains are hand-written CUDA kernels beside plain
PyTorch versions: the stretch proposal (K1), the accept/select
write-back (K2), the DE and DE-snooker proposals (K5a, K5b); the chunk
program (K3) replays each proposal as a CUDA graph.  The gradient
moves (MALA, HMC, ChEES-HMC, ensemble MALA and HMC) differentiate the
log-prob with ``torch.func.grad`` and run their Langevin step (K11),
Hastings and kinetic reductions (K12) and leapfrog (K13) as kernels
too.  The Gaussian, Metropolis-Hastings, walk and KDE moves, the
autocorrelation and R-hat diagnostics and the convergence monitor are
plain PyTorch on the walkers' device.  Blobs ride through K2 with the coordinates, into the
host, device and HDF5 backends; ``checkpoint`` saves and loads states.
``PTSampler`` runs a tempered ladder: the stretch, DE and DE-snooker
moves propose every rung at once through the rung axis of K1, K5a, K5b
and K2, the MALA, HMC, ensemble MALA and ensemble HMC moves through the
rung axis of K11, K12, K13 and K2 (in mixtures too, ``mixture_block``
included), other moves (the
looped slice and ChEES moves among them) rung by rung, the
even/odd swap is a kernel of its own (K15) that moves the walkers' blobs
with them, the ladder may adapt, and the chain goes into the host
``PTBackend``, the device ``PTDeviceBackend`` or ``PTHDFBackend``.
Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from . import autocorr, backends, checkpoint, moves, utils
from .monitor import ConvergenceMonitor, run_until_converged
from .ops.autocorr import AutocorrError
from .parallel import PTSampler, PTState
from .sampler import EnsembleSampler
from .state import State, walkers_independent

__version__ = "0.6.0"

__all__ = [
    "EnsembleSampler",
    "PTSampler",
    "PTState",
    "State",
    "walkers_independent",
    "ConvergenceMonitor",
    "run_until_converged",
    "AutocorrError",
    "moves",
    "checkpoint",
    "autocorr",
    "backends",
    "utils",
    "__version__",
]
