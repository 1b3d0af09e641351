"""Gaussian Metropolis move.

The counterpart of ``emcee_tpu/moves/gaussian.py:25-152``: scalar,
diagonal or full-covariance proposals; the ``vector``, ``random`` and
``sequential`` modes; the optional random scale ``exp(U(-log f, log
f))``; Robbins-Monro tuning of the scale toward ``tune_target``.  An
:class:`~.mh.MHMove`, so the accept/select is K2 at ``nsplits=1``.

The draws are the port's Philox stream (``ops/philox.py``): the normals
at ``(walker, NORMAL_BLOCK | k)``, the ``random`` mode's dimension from
word 0 at ``(walker, 0)``, the factor's uniform from word 0 at
``(ROLL_LANE, 0)``.  The full covariance's step is ``z @ chol.T``, a
plain ``torch.matmul``, as the JAX package leaves it to XLA.  The
``sequential`` mode's dimension is a 0-d int32 carry, advanced in
place, so a recorded proposal cycles at every replay.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.philox import normals, roll_uniforms, to_uniform, walker_words
from .base import robbins_monro_tune
from .mh import MHMove

__all__ = ["GaussianMove", "gaussian_step"]

_ALLOWED_MODES = ("vector", "random", "sequential")


def gaussian_step(x0, z, scale, chol, f, mode, dims=None):
    """The proposal of ``emcee_tpu/moves/gaussian.py:118-150`` from its
    draws: ``x0 + f * step`` with ``step = z @ chol.T`` (full covariance)
    or ``z * scale``, kept in dimension ``dims`` of each walker only in
    the ``random`` and ``sequential`` modes.  ``scale``, ``chol`` are
    tensors (or None), ``f`` a number or a 0-d tensor, ``dims`` an int
    tensor broadcasting to ``(nwalkers,)``."""
    step = torch.matmul(z, chol.T) if chol is not None else z * scale
    xnew = x0 + f * step
    if mode == "vector":
        return xnew
    nd = x0.shape[1]
    mask = torch.arange(nd, device=x0.device)[None, :] == dims.reshape(-1, 1)
    return torch.where(mask, xnew, x0)


class GaussianMove(MHMove):
    """Metropolis step with a Gaussian proposal.

    Args:
        cov: scalar (isotropic), vector (axis-aligned) or square matrix
            (general) proposal covariance.
        mode: ``"vector"`` (all dims), ``"random"`` (one random dim per
            walker) or ``"sequential"`` (one dim for all walkers, in
            turn).
        factor: optional random scale range: the step is multiplied by
            ``exp(U(-log factor, log factor))``.
        tune_target: optional target acceptance rate for
            ``run_mcmc(..., tune=True)``.
        tune_rate: adaptation step size (decays as ``1/sqrt(t)``).
    """

    def __init__(self, cov, mode="vector", factor=None, tune_target=None,
                 tune_rate=0.2):
        self._full_cov = None
        self._scale = None
        self._chol = None
        ndim = None
        try:
            float(cov)
            self._scale = np.sqrt(float(cov))
        except TypeError:
            cov = np.atleast_1d(np.asarray(cov))
            if cov.ndim == 1:
                ndim = len(cov)
                self._scale = np.sqrt(cov)
            elif cov.ndim == 2 and cov.shape[0] == cov.shape[1]:
                ndim = cov.shape[0]
                self._full_cov = cov
                self._chol = np.linalg.cholesky(cov)
            else:
                raise ValueError("Invalid proposal scale dimensions")
        if self._full_cov is not None and mode != "vector":
            raise ValueError(
                "'{0}' is not a recognized mode. Please select from: {1}"
                .format(mode, ["vector"])
            )
        if mode not in _ALLOWED_MODES:
            raise ValueError(
                "'{0}' is not a recognized mode. Please select from: {1}"
                .format(mode, list(_ALLOWED_MODES))
            )
        if factor is not None and factor < 1.0:
            raise ValueError("'factor' must be >= 1.0")
        self._log_factor = None if factor is None else float(np.log(factor))
        self.tune_target = tune_target
        self.tune_rate = float(tune_rate)
        self.mode = mode
        # The scale or Cholesky factor as tensors, per (device, dtype):
        # made at the first (eager) proposal on a device, so a recorded
        # proposal copies nothing from the host.
        self._consts = {}
        super().__init__(self._proposal, ndim=ndim)

    def init_carry(self, nwalkers, ndim, device=None):
        carry = {}
        if self.mode == "sequential":
            carry["index"] = torch.zeros((), dtype=torch.int32, device=device)
        if self.tune_target is not None:
            carry["log_adj"] = torch.zeros((), dtype=torch.float32,
                                           device=device)
            carry["t"] = torch.zeros((), dtype=torch.int32, device=device)
        return carry

    def tune(self, carry, state, accepted, model=None):
        """Robbins-Monro adaptation of the scale toward
        ``tune_target``."""
        if self.tune_target is None:
            return carry
        return robbins_monro_tune(carry, accepted, self.tune_target,
                                  self.tune_rate, model)

    def _tensors(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._consts:
            def t(a):
                return None if a is None else torch.as_tensor(
                    np.asarray(a, dtype=np.float32), dtype=dtype,
                    device=device)
            self._consts[key] = (t(self._scale), t(self._chol))
        return self._consts[key]

    def _proposal(self, rng, x0, carry):
        seed, offset = rng
        nw, nd = x0.shape
        dev = x0.device
        scale, chol = self._tensors(dev, x0.dtype)
        dims = None
        if self.mode == "random":
            u = to_uniform(walker_words(nw, 0, seed, offset, dev)[0])
            dims = torch.clamp((u * nd).to(torch.int64), max=nd - 1)
        f = 1.0
        if self._log_factor is not None:
            lf = self._log_factor
            u = roll_uniforms(seed, 0, offset, dev)[0].to(x0.dtype)
            f = torch.exp(-lf + u * (2.0 * lf))
        if isinstance(carry, dict) and "log_adj" in carry:
            f = f * torch.exp(carry["log_adj"]).to(x0.dtype)
        z = normals(nw, nd, seed, offset, dev, x0.dtype)
        if self.mode == "sequential":
            dims = carry["index"] % nd
            carry["index"].copy_((carry["index"] + 1) % nd)
        q = gaussian_step(x0, z, scale, chol, f, self.mode, dims)
        return q, torch.zeros(nw, dtype=x0.dtype, device=dev), carry
