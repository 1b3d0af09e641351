"""Integrated autocorrelation time estimation.

The counterpart of ``emcee_tpu/ops/autocorr.py:27-200``: FFT-based
normalized ACF per (walker, dim) series, walker-averaged in chunks, then
Sokal's automated window ``tau = taus[argmin(arange < c * taus)]`` with a
``tol * tau > n`` check.

The FFTs run with ``torch.fft`` on the chain's device (cuFFT on the card,
a library call as XLA's FFT was), so a device-resident chain does not
leave the card: only the walker-averaged ACF ``(n_t, n_d)`` comes back.
The windowing and the estimate are float64 on the host.  The JAX package
computes the estimate in float32 (reference defect R2,
``ops/autocorr.py:146``), so the two agree to float32 tolerance.  A numpy
chain is transformed in float64 on the CPU.

Not ported yet (ROADMAP P5): Geyer's estimator, ``ess`` and ``rhat``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["AutocorrError", "function_1d", "integrated_time", "next_pow_two"]

logger = logging.getLogger(__name__)


class AutocorrError(Exception):
    """Raised when the chain is too short for a reliable tau estimate.

    The current estimate is available as the ``tau`` attribute.
    """

    def __init__(self, tau, *args, **kwargs):
        self.tau = tau
        super().__init__(*args, **kwargs)


def next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.double()
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _acf_batched(x):
    """Normalized autocorrelation functions along axis 0 of a tensor."""
    n = x.shape[0]
    m = next_pow_two(n)
    xc = x - x.mean(dim=0, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * m, dim=0)
    acf = torch.fft.irfft(f * f.conj(), n=2 * m, dim=0)[:n]
    return acf / acf[:1]


def function_1d(x):
    """Normalized ACF of a 1-D series (reference ``autocorr.py:20-39``)."""
    x = torch.atleast_1d(_as_tensor(x))
    if x.dim() != 1:
        raise ValueError("invalid dimensions for 1D autocorrelation function")
    return _acf_batched(x).cpu().numpy()


def _walker_mean_acf(x):
    """(n_t, n_w, n_d) -> walker-averaged ACF (n_t, n_d), float64 on the
    host.  The walker average accumulates chunk by chunk, each chunk
    budgeted at ~256 MB of FFT scratch (the padded spectra are
    ``2 * next_pow_two(n_t)`` complex values per series)."""
    n_t, n_w, n_d = x.shape
    per_walker = 2 * next_pow_two(n_t) * n_d * 2 * x.element_size()
    chunk = max(1, min(n_w, (256 << 20) // max(per_walker, 1)))
    f = None
    for lo in range(0, n_w, chunk):
        part = _acf_batched(x[:, lo:lo + chunk, :]).sum(dim=1)
        f = part if f is None else f + part
    return f.cpu().double().numpy() / n_w


def _tau_from_f(f, c):
    """Sokal windowing of the walker-averaged ACF ``f`` (n_t, n_d)."""
    n_t = f.shape[0]
    taus = 2.0 * np.cumsum(f, axis=0) - 1.0
    mask = np.arange(n_t)[:, None] < c * taus
    windows = np.where(mask.any(axis=0), np.argmin(mask, axis=0), n_t - 1)
    return np.take_along_axis(taus, windows[None, :], axis=0)[0]


def integrated_time(x, c=5, tol=50, quiet=False, has_walkers=True,
                    method="sokal"):
    """Estimate the integrated autocorrelation time.

    Accepts ``(n_step,)``, ``(n_step, n_walker)`` (or ``(n_step,
    n_param)`` with ``has_walkers=False``), or ``(n_step, n_walker,
    n_param)`` arrays or tensors; same semantics, tolerances and errors
    as ``emcee_tpu.autocorr.integrated_time`` with ``method="sokal"``.
    """
    if method != "sokal":
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP P5); use 'sokal'"
        )
    x = torch.atleast_1d(_as_tensor(x))
    if x.dim() == 1:
        x = x[:, None, None]
    elif x.dim() == 2:
        x = x[:, None, :] if not has_walkers else x[:, :, None]
    if x.dim() != 3:
        raise ValueError("invalid dimensions")

    n_t = x.shape[0]
    tau_est = _tau_from_f(_walker_mean_acf(x), float(c))

    flag = tol * tau_est > n_t
    if np.any(flag):
        msg = (
            "The chain is shorter than {0} times the integrated "
            "autocorrelation time for {1} parameter(s). Use this estimate "
            "with caution and run a longer chain!\n"
        ).format(tol, np.sum(flag))
        msg += "N/{0} = {1:.0f};\ntau: {2}".format(tol, n_t / tol, tau_est)
        if not quiet:
            raise AutocorrError(tau_est, msg)
        logger.warning(msg)

    return tau_est
