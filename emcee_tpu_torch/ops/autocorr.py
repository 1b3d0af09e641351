"""Integrated autocorrelation time estimation.

The counterpart of ``emcee_tpu/ops/autocorr.py:27-200``: FFT-based
normalized ACF per (walker, dim) series, walker-averaged in chunks, then
Sokal's automated window ``tau = taus[argmin(arange < c * taus)]`` with a
``tol * tau > n`` check.

The FFTs run with ``torch.fft`` on the chain's device (cuFFT on the card,
a library call as XLA's FFT was), so a device-resident chain does not
leave the card.  With Sokal's window only the walker-averaged ACF
``(n_t, n_d)`` comes back, and the windowing and the estimate are
float64 on the host.  Geyer's initial monotone sequence
(``emcee_tpu/ops/autocorr.py:115-149``) and the rank-normalised split
R-hat (``:219-371``) run on the chain's device too, as torch operations:
only their ``(n_d,)`` result leaves it.  The JAX package computes the
estimates in float32 (reference defect R2, ``ops/autocorr.py:146``), so
the two agree to float32 tolerance.  A numpy chain stays float64 on the
host: its FFTs and Geyer's sums run in float64 torch on the CPU, and its
R-hat in numpy and scipy, as the JAX host path computes it.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["AutocorrError", "ess", "function_1d", "integrated_time",
           "next_pow_two", "rhat"]

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
    """(n_t, n_w, n_d) -> walker-averaged ACF (n_t, n_d), a tensor on the
    chain's device.  The walker average accumulates chunk by chunk, each
    chunk budgeted at ~256 MB of FFT scratch (the padded spectra are
    ``2 * next_pow_two(n_t)`` complex values per series)."""
    n_t, n_w, n_d = x.shape
    per_walker = 2 * next_pow_two(n_t) * n_d * 2 * x.element_size()
    chunk = max(1, min(n_w, (256 << 20) // max(per_walker, 1)))
    f = None
    for lo in range(0, n_w, chunk):
        part = _acf_batched(x[:, lo:lo + chunk, :]).sum(dim=1)
        f = part if f is None else f + part
    return f / n_w


def _tau_from_f(f, c):
    """Sokal windowing of the walker-averaged ACF ``f`` (n_t, n_d)."""
    n_t = f.shape[0]
    taus = 2.0 * np.cumsum(f, axis=0) - 1.0
    mask = np.arange(n_t)[:, None] < c * taus
    windows = np.where(mask.any(axis=0), np.argmin(mask, axis=0), n_t - 1)
    return np.take_along_axis(taus, windows[None, :], axis=0)[0]


def _tau_geyer(f):
    """Geyer's (1992) initial-monotone-sequence tau from the
    walker-averaged ACF ``f`` (n_t, n_d), a tensor, on its device: the
    pair sums ``G_k = rho_2k + rho_2k+1``, truncated at the first that is
    not positive, made monotone by a running minimum (``torch.cummin``),
    and ``tau = -1 + 2 sum_k G_k``, floored at ``1 / log10(n_t)`` (Stan's
    cap on ESS) as ``emcee_tpu/ops/autocorr.py:115-149`` computes it.
    Returns an ``(n_d,)`` tensor (NaN when ``n_t < 2``)."""
    n_t = f.shape[0]
    npairs = n_t // 2
    if npairs < 1:
        return torch.full(f.shape[1:], float("nan"), dtype=f.dtype,
                          device=f.device)
    g = f[0:2 * npairs:2] + f[1:2 * npairs:2]
    pos = g > 0.0
    k_stop = torch.where((~pos).any(dim=0),
                         pos.to(torch.int8).argmin(dim=0), npairs)
    g_mono = torch.cummin(g, dim=0).values
    keep = torch.arange(npairs, device=f.device)[:, None] < k_stop[None, :]
    tau = -1.0 + 2.0 * torch.where(keep, g_mono, 0.0).sum(dim=0)
    return tau.clamp_min(1.0 / np.log10(max(float(n_t), 10.0)))


def integrated_time(x, c=5, tol=50, quiet=False, has_walkers=True,
                    method="sokal"):
    """Estimate the integrated autocorrelation time.

    Accepts ``(n_step,)``, ``(n_step, n_walker)`` (or ``(n_step,
    n_param)`` with ``has_walkers=False``), or ``(n_step, n_walker,
    n_param)`` arrays or tensors; same semantics, tolerances and errors
    as ``emcee_tpu.autocorr.integrated_time``.  ``method`` is
    ``"sokal"`` (the reference's automated window ``c * tau``) or
    ``"geyer"`` (the initial monotone sequence, the Stan / arviz
    convention; ``c`` is ignored).  Returns a float64 ``(n_param,)``
    numpy array.
    """
    if method not in ("sokal", "geyer"):
        raise ValueError(f"unknown method: {method!r}")
    x = _as_3d(x, has_walkers)
    n_t = x.shape[0]
    f = _walker_mean_acf(x)
    if method == "sokal":
        tau_est = _tau_from_f(f.cpu().double().numpy(), float(c))
    else:
        tau_est = _tau_geyer(f).cpu().double().numpy()

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


def _as_3d(x, has_walkers=True):
    """A chain as an ``(n_t, n_w, n_d)`` tensor (numpy input: float64 on
    the CPU)."""
    x = torch.atleast_1d(_as_tensor(x))
    if x.dim() == 1:
        x = x[:, None, None]
    elif x.dim() == 2:
        x = x[:, None, :] if not has_walkers else x[:, :, None]
    if x.dim() != 3:
        raise ValueError("invalid dimensions")
    return x


def ess(x, c=5, tol=50, quiet=False, has_walkers=True, method="sokal"):
    """Effective sample size per parameter, ``n_step * n_walker / tau``
    with tau from :func:`integrated_time` (``emcee_tpu/ops/autocorr.py:
    200-216``): the number of independent draws the chain is worth."""
    tau = integrated_time(x, c=c, tol=tol, quiet=quiet,
                          has_walkers=has_walkers, method=method)
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)
    n_w = shape[1] if (len(shape) >= 2 and has_walkers) else 1
    return shape[0] * n_w / tau


def _psrf_device(x):
    """Plain PSRF of an ``(n, m, d)`` tensor, on its device; a zero
    within-chain variance gives NaN (0 / 0), as in the JAX package."""
    n = x.shape[0]
    between = n * x.mean(dim=0).var(dim=0, correction=1)
    within = x.var(dim=0, correction=1).mean(dim=0)
    var_hat = (n - 1) / n * within + between / n
    return torch.sqrt(var_hat / within)


def _avg_ranks(v):
    """Tie-averaged ranks of each column of an ``(S, d)`` tensor, and its
    column medians, on its device.  A stable sort, group ids of the runs
    of equal values, and ``scatter_add`` of the 1-based positions and of
    the counts per group, in float64 (exact: a rank is a mean of
    positions): equal values share the mean of their positions, as
    ``scipy.stats.rankdata(method="average")`` and the JAX package's
    ``_avg_ranks_1d`` give them.  The median is the mean of the two
    middle order statistics, numpy's and JAX's median (``torch.median``
    would take the lower one)."""
    s = v.shape[0]
    sv, order = torch.sort(v, dim=0, stable=True)
    new = torch.ones_like(sv, dtype=torch.bool)
    new[1:] = sv[1:] != sv[:-1]
    gid = torch.cumsum(new, dim=0) - 1
    pos = torch.arange(1, s + 1, dtype=torch.float64,
                       device=v.device)[:, None].expand_as(gid)
    gsum = torch.zeros(gid.shape, dtype=torch.float64, device=v.device)
    gsum.scatter_add_(0, gid, pos)
    gcnt = torch.zeros_like(gsum).scatter_add_(0, gid, torch.ones_like(pos))
    ranks_sorted = (gsum / gcnt.clamp_min(1)).gather(0, gid)
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    median = 0.5 * (sv[(s - 1) // 2] + sv[s // 2])
    return ranks, median


def _rank_normalize_device(x):
    """Normal scores of the pooled tie-averaged ranks of an ``(n, m, d)``
    tensor, ``ndtri((r - 3/8) / (S + 1/4))`` (float64), and the pooled
    median per parameter.  One parameter at a time, so the float64
    temporaries of a chain of 1e5 walkers stay a few ``S``-sized
    columns."""
    n, m, d = x.shape
    flat = x.reshape(n * m, d)
    z = torch.empty(flat.shape, dtype=torch.float64, device=x.device)
    median = torch.empty(d, dtype=x.dtype, device=x.device)
    for j in range(d):
        ranks, median[j] = _avg_ranks(flat[:, j:j + 1])
        z[:, j] = torch.special.ndtri((ranks[:, 0] - 0.375)
                                      / (n * m + 0.25))
    return z.reshape(n, m, d), median


def _rhat_device(x):
    """Rank-normalised ``max(bulk, tail)`` R-hat of an ``(n, m, d)``
    tensor, on its device (``emcee_tpu/ops/autocorr.py:253-271``)."""
    z, median = _rank_normalize_device(x)
    bulk = _psrf_device(z)
    tail = _psrf_device(_rank_normalize_device((x - median).abs())[0])
    return torch.maximum(bulk, tail)


def _psrf(x):
    """Plain potential scale reduction factor of an (n, m, d) block."""
    n = x.shape[0]
    means = x.mean(axis=0)
    between = n * means.var(axis=0, ddof=1)
    within = x.var(axis=0, ddof=1).mean(axis=0)
    var_hat = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_hat / within)


def _rank_normalize(x):
    """Normal scores of the pooled average ranks of an (n, m, d) block
    (``scipy.stats.rankdata`` ``method="average"``, then
    ``Phi^-1((r - 3/8) / (S + 1/4))``, Vehtari et al. 2021, eq. 14).
    Tied values share a rank, so a collapsed ensemble has no spread and
    its R-hat is NaN."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    n, m, d = x.shape
    ranks = rankdata(x.reshape(n * m, d), axis=0, method="average")
    return ndtri((ranks - 0.375) / (n * m + 0.25)).reshape(n, m, d)


def rhat(x, split=True, rank_normalized=True):
    """Potential scale reduction factor R-hat, per parameter
    (``emcee_tpu/ops/autocorr.py:308-371``).

    By default the rank-normalised split R-hat of Vehtari et al. (2021):
    each chain split in half, the pooled draws rank-normalised, and the
    larger of the bulk statistic and that of the folded draws ``|x -
    median|``.  ``rank_normalized=False`` gives the classic split
    Gelman-Rubin R-hat of the raw draws.

    Args:
        x: ``(n_step, n_chain)`` or ``(n_step, n_chain, n_param)``, the
            ``get_chain()`` layout with walkers as chains.  A tensor is
            reduced on its device (a ``DeviceBackend`` chain stays on the
            card); a numpy array in float64 on the host.
        split: split each chain into halves first.
        rank_normalized: rank-normalise and report ``max(bulk, tail)``.

    Returns a float64 ``(n_param,)`` numpy array.  Walkers of one
    ensemble are dependent chains, so on one ensemble this is a
    stuck-mode / non-stationarity diagnostic (see the JAX docstring).
    """
    on_device = isinstance(x, torch.Tensor)
    if not on_device:
        x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.ndim != 3:
        raise ValueError("invalid dimensions")
    n = x.shape[0]
    if split:
        h = n // 2
        if h < 2:
            raise ValueError("need at least 4 steps for split R-hat")
        if on_device:
            x = torch.cat([x[:h], x[n - h:]], dim=1)
        else:
            x = np.concatenate([x[:h], x[n - h:]], axis=1)
    if x.shape[1] < 2:
        raise ValueError("R-hat needs at least 2 chains")
    if on_device:
        x = x if x.is_floating_point() else x.double()
        r = _rhat_device(x) if rank_normalized else _psrf_device(x)
        return r.cpu().double().numpy()
    if not rank_normalized:
        return _psrf(x)
    bulk = _psrf(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[-1]), axis=0))
    return np.maximum(bulk, _psrf(_rank_normalize(folded)))
