"""emcee_tpu_torch: the PyTorch and CUDA port of emcee_tpu.

The affine-invariant ensemble sampler on one NVIDIA GPU (Hopper,
``sm_90a``).  It keeps the JAX package's module and public names.  The
hot path's fused op chains are hand-written CUDA kernels beside plain
PyTorch versions: the stretch proposal (K1), the accept/select
write-back (K2), the DE and DE-snooker proposals (K5a, K5b), the
counter-based Philox draws (K14) and the shuffled split's order (K16)
and row moves (K17); the chunk program (K3) replays each proposal as a
CUDA graph.  The gradient moves (MALA, HMC, ChEES-HMC, ensemble MALA and
HMC) differentiate the log-prob with ``torch.func.grad`` and run their
Langevin step (K11), Hastings and kinetic reductions (K12) and leapfrog
(K13) as kernels too.  The KDE move's log-density is a kernel (K7, no
distance matrix), DIME's moments, factor and proposal are K8, DE-Z's
spread, proposal and archive fold K10, the slice move's stepping-out
and shrinkage K9 (loops over the walkers still looping), the side move
K5a's side mode, and the walk move K8a, K8b's walk mode and K18a (the
shared covariance) or K18b (each walker's subset), the Gaussian move's
proposal K19 and the blended move's choice and select K20; the
autocorrelation and R-hat diagnostics' chains are K6.  A
Metropolis-Hastings move's function, the rest of the KDE move and the
convergence monitor are plain PyTorch on the walkers' device.  Blobs ride through K2
with the coordinates, into the host, device and HDF5 backends;
``checkpoint``
saves and loads states.  ``PTSampler`` runs a tempered ladder: the
stretch, DE and DE-snooker moves propose every rung at once through the
rung axis of K1, K5a, K5b and K2, the MALA, HMC, ensemble MALA and
ensemble HMC moves through the rung axis of K11, K12, K13 and K2, the
KDE move through K7's, DIME through K8's, DE-Z through K10's, the side
move through K5a's, the walk move through K8's and K18's, the slice
move through K9's, the Gaussian move through K19's and the
Metropolis-Hastings move's function a rung at a time into one K2 launch,
the blended move through its sub-moves' and K20's (in mixtures too,
``mixture_block`` included; the shuffled split through K14, K16 and K17
for every rung at once), and ChEES-HMC through K21a's and K21b's and
K13's masked rung mode, one read of the longest trip count serving every
rung; the even/odd swap is a kernel of its own (K15) that moves the walkers' blobs
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
