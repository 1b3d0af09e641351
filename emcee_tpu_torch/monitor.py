"""Built-in convergence monitoring.

The counterpart of ``emcee_tpu/monitor.py``: check the integrated
autocorrelation time every ``check_every`` steps and stop when the chain
is longer than ``tau_factor * tau`` and tau has settled to within
``dtau_rel`` (the reference's monitor tutorial, as a driver), with an
optional rank-normalised split R-hat gate.

With a :class:`~.backends.DeviceBackend` the monitor reads the device
rows (``backend.chain[:backend.iteration]``), not ``get_chain()``, which
returns a numpy copy: tau's FFTs and the R-hat run on the card, and only
their ``(n_param,)`` results cross to the host, as the JAX monitor's do
(``emcee_tpu/monitor.py:56-60``).  A :class:`~.parallel.PTSampler` is
judged on its cold rung (``get_chain(temp=0)``, the rows whose samples
are the posterior's), as the JAX monitor judges it
(``emcee_tpu/monitor.py:101-118``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .ops import autocorr

__all__ = ["ConvergenceMonitor", "run_until_converged"]


@dataclass
class ConvergenceMonitor:
    """Tracks tau estimates across checkpoints.

    Args:
        tau_factor: required chain length in units of tau (the reference
            pattern uses 100; ``integrated_time``'s own default tol is 50).
        dtau_rel: required relative change of tau between checks.
        rhat_threshold: optional; when set, also require the
            rank-normalised split R-hat (walkers as chains, second half
            of the chain) below this per parameter (1.01 is the usual
            gate).
    """

    tau_factor: float = 100.0
    dtau_rel: float = 0.01
    rhat_threshold: Optional[float] = None
    history: List[np.ndarray] = field(default_factory=list)
    iterations: List[int] = field(default_factory=list)
    rhat_history: List[np.ndarray] = field(default_factory=list)

    def update(self, chain) -> bool:
        """Record a tau estimate from ``chain`` ``(nsteps, nwalkers,
        ndim)``, a numpy array or a tensor (reduced on its device).
        Returns True when converged."""
        tau = autocorr.integrated_time(chain, quiet=True)
        n = chain.shape[0]
        self.history.append(tau)
        self.iterations.append(n)
        if self.rhat_threshold is not None and n // 2 >= 4:
            # The second half only: the gate judges the stationary
            # segment, not the burn-in.
            self.rhat_history.append(autocorr.rhat(chain[n // 2:]))
        if np.any(~np.isfinite(tau)):
            return False
        converged = np.all(tau * self.tau_factor < n)
        if len(self.history) > 1:
            prev = self.history[-2]
            converged &= np.all(np.abs(prev - tau) / tau < self.dtau_rel)
        if self.rhat_threshold is not None:
            converged &= bool(self.rhat_history) and bool(
                np.all(self.rhat_history[-1] < self.rhat_threshold)
            )
        return bool(converged)

    @property
    def tau(self) -> Optional[np.ndarray]:
        return self.history[-1] if self.history else None

    @property
    def rhat(self) -> Optional[np.ndarray]:
        return self.rhat_history[-1] if self.rhat_history else None


def stored_chain(sampler):
    """The sampler's stored chain as the monitor reads it: the device
    rows of a device-resident backend (no host copy), else
    ``get_chain()``; a tempered sampler's cold rung."""
    backend = sampler.backend
    tempered = hasattr(sampler, "betas")
    if getattr(backend, "wants_device_arrays", False):
        rows = backend.chain[:backend.iteration]
        return rows[:, 0] if tempered else rows
    return sampler.get_chain(temp=0) if tempered else sampler.get_chain()


def run_until_converged(sampler, initial_state, max_steps=100_000,
                        check_every=1_000,
                        monitor: Optional[ConvergenceMonitor] = None,
                        progress=False, **kwargs):
    """Advance the chain in blocks of ``check_every`` steps until the
    monitor's criterion is met or ``max_steps`` are run.  Returns
    ``(last sample, monitor)``; ``monitor.tau`` holds the final
    estimate.  Each block after the first resumes the sampler's previous
    run (``run_mcmc(None, n)``)."""
    if monitor is None:
        monitor = ConvergenceMonitor()
    state = initial_state
    done = 0
    while done < max_steps:
        n = min(check_every, max_steps - done)
        sampler.run_mcmc(state, n, progress=progress, **kwargs)
        done += n
        if monitor.update(stored_chain(sampler)):
            break
        state = None
    return sampler.get_last_sample(), monitor
