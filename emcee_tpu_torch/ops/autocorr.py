"""Integrated autocorrelation time estimation.

The counterpart of ``emcee_tpu/ops/autocorr.py:27-200``: FFT-based
normalized ACF per (walker, dim) series, walker-averaged in chunks, then
Sokal's automated window ``tau = taus[argmin(arange < c * taus)]`` with a
``tol * tau > n`` check, Geyer's initial monotone sequence
(``:115-149``), and the rank-normalised split R-hat (``:219-371``).

Each entry point runs by its input:

* a CUDA tensor takes K6 (:mod:`.autocorr_kernel`): the hand-written
  passes around cuFFT (``torch.fft``), the walker sum and both windows in
  float64 on the card, the keys, K16's stable sort, the tie-averaged ranks'
  normal scores and the PSRF; only the ``(n_d,)`` result leaves the card
  (a float16 or bfloat16 chain is widened to float32 there first);
* a CPU tensor takes the plain versions below, as torch operations on
  the CPU (Sokal's window float64 on the host);
* a numpy chain stays float64 on the host: its FFTs and Geyer's sums run
  in float64 torch on the CPU, and its R-hat in numpy and scipy, as the
  JAX host path computes it.

Nothing falls back from one route to another.  The JAX package computes
the estimates in float32 (reference defect R2, ``ops/autocorr.py:146``),
so the routes agree with it to float32 tolerance.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import autocorr_kernel as ak
from .autocorr_kernel import (FFT_BUDGET, geyer_plain, next_pow_two,
                              psrf_block, sokal_plain)

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
    if _on_kernels(x):
        x = _widen(x)
        f, _ = _acf_kernels(x[:, None, None])
        return f[:, 0].to(x.dtype).cpu().numpy()
    return _acf_batched(x).cpu().numpy()


def _on_kernels(x):
    """Whether ``x`` takes K6: a CUDA tensor does."""
    return isinstance(x, torch.Tensor) and x.is_cuda


def _widen(x):
    """A float16 or bfloat16 chain as float32 (on its device)."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def _walker_mean_acf(x, budget=FFT_BUDGET):
    """(n_t, n_w, n_d) -> walker-averaged ACF (n_t, n_d), a tensor on the
    chain's device.  The walker average accumulates chunk by chunk, each
    chunk budgeted at ``budget`` bytes (~256 MB) of FFT scratch (the padded
    spectra are ``2 * next_pow_two(n_t)`` complex values per series)."""
    n_t, n_w, n_d = x.shape
    per_walker = 2 * next_pow_two(n_t) * n_d * 2 * x.element_size()
    chunk = max(1, min(n_w, budget // max(per_walker, 1)))
    f = None
    for lo in range(0, n_w, chunk):
        part = _acf_batched(x[:, lo:lo + chunk, :]).sum(dim=1)
        f = part if f is None else f + part
    return f / n_w


def _tau_from_f(f, c):
    """Sokal windowing of the walker-averaged ACF ``f`` (n_t, n_d), a
    float64 numpy array (:func:`.autocorr_kernel.sokal_plain`)."""
    return sokal_plain(f, c)[0]


def _tau_geyer(f):
    """Geyer's tau from the walker-averaged ACF ``f`` (n_t, n_d), a
    tensor, on its device (:func:`.autocorr_kernel.geyer_plain`); an
    ``(n_d,)`` tensor, NaN when ``n_t < 2``."""
    return geyer_plain(f)[0]


def _acf_kernels(x, method="sokal", c=5.0, budget=FFT_BUDGET):
    """K6a and K6b on the chain ``x`` ``(n_t, n_w, n_d)`` (float32 or
    float64, read in place through its strides): per walker chunk of the
    FFT budget, the centred series (``acf_center``), ``rfft``, ``|F|^2``
    (``acf_power``), ``irfft`` into the same buffer and the walker sum
    into float64 partials (``acf_reduce``); then the mean ACF and the
    window (``tau_window``).  Returns ``(f, tau)``: the walker-averaged ACF
    ``(n_t, n_d)`` and tau ``(n_d,)``, float64 tensors on ``x``'s
    device."""
    n_t, n_w, n_d = x.shape
    dev = x.device
    plan = ak.acf_plan(n_t, n_w, n_d, x.element_size(), ak.plan_sms(dev),
                       budget)
    cplx = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    buf = torch.empty(plan.chunk * n_d, plan.m2, dtype=x.dtype, device=dev)
    spec = torch.empty(plan.chunk * n_d, plan.m2 // 2 + 1, dtype=cplx,
                       device=dev)
    part = torch.empty(plan.groups, n_t, n_d, dtype=torch.float64,
                       device=dev)
    for lo in range(0, n_w, plan.chunk):
        w = min(plan.chunk, n_w - lo)
        b, s = buf[:w * n_d], spec[:w * n_d]
        ak.acf_center(x, lo, w, b)
        torch.fft.rfft(b, dim=-1, out=s)
        ak.acf_power(s)
        torch.fft.irfft(s, n=plan.m2, dim=-1, out=b)
        ak.acf_reduce(b, part, n_t, n_d, w, plan.wg, lo == 0)
    f = torch.empty(n_t, n_d, dtype=torch.float64, device=dev)
    tau = torch.empty(n_d, dtype=torch.float64, device=dev)
    win = torch.empty(n_d, dtype=torch.int64, device=dev)
    ak.tau_window(part, n_w, method, c, f, tau, win)
    return f, tau


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
    if _on_kernels(x):
        tau_est = _acf_kernels(_widen(x), method, float(c))[1].cpu().numpy()
    elif method == "sokal":
        tau_est = _tau_from_f(_walker_mean_acf(x).cpu().double().numpy(),
                              float(c))
    else:
        tau_est = _tau_geyer(_walker_mean_acf(x)).cpu().double().numpy()

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


#: plain PSRF of an ``(n, m, d)`` tensor, on its device (NaN for a zero
#: within-chain variance, as in the JAX package)
_psrf_device = psrf_block


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


def _rhat_kernels(x, split, rank_normalized, budget=ak.RHAT_BUDGET):
    """K6c and K6d on the chain ``x`` ``(n, m, d)`` (float32 or float64;
    a split chain's halves read in place): ``psrf`` of the raw draws, or,
    the parameters in groups of ``ak.rhat_group`` (the buffers within
    ``budget`` bytes), for the bulk and then the folded draws ``|x -
    median|`` the keys (``rank_keys``), K16's sorted words
    (``stable_order``), the normal scores and the median
    (``rank_scores``) and ``psrf`` (its maximum with the bulk value for
    the tail).  The buffers serve both passes and every group.  Returns
    the ``(d,)`` float64 R-hat on ``x``'s device."""
    draws = ak.split_draws(x, split)
    d, S, dev = draws.d, draws.S, x.device
    out = torch.empty(d, dtype=torch.float64, device=dev)
    if not rank_normalized:
        ak.psrf(draws, out)
        return out
    if S > ak.DRAWS_MAX:
        raise ValueError(f"rhat: {S} draws a parameter to rank; K16 sorts "
                         f"at most {ak.DRAWS_MAX}")
    f64 = x.dtype == torch.float64
    g = ak.rhat_group(d, S, f64, budget)
    lo, sw = (torch.empty(g, S, dtype=torch.int64, device=dev)
              for _ in range(2))
    hi, sh = ((torch.empty_like(lo), torch.empty_like(lo)) if f64
              else (None, None))
    grp = torch.empty(g * S, dtype=torch.int32, device=dev)
    z = torch.empty(g, S, dtype=torch.float64, device=dev)
    med = torch.empty(g, dtype=x.dtype, device=dev)
    for j0 in range(0, d, g):
        k = min(g, d - j0)
        part = draws._replace(x=draws.x[..., j0:j0 + k])
        keys = (lo[:k], None if hi is None else hi[:k])
        words = (sw[:k], None if sh is None else sh[:k])
        scores = ak.score_draws(z[:k], draws.h, draws.C)
        for tail in (False, True):
            ak.rank_keys(part, *keys, med[:k] if tail else None)
            ak.stable_order(*keys, *words)
            ak.rank_scores(part, *words, grp[:k * S], z[:k],
                           None if tail else med[:k])
            ak.psrf(scores, out[j0:j0 + k], prior=tail)
    return out


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
    h = n // 2
    if split and h < 2:
        raise ValueError("need at least 4 steps for split R-hat")
    if x.shape[1] * (2 if split else 1) < 2:
        raise ValueError("R-hat needs at least 2 chains")
    if _on_kernels(x):
        x = _widen(x if x.is_floating_point() else x.double())
        return _rhat_kernels(x, split, rank_normalized).cpu().numpy()
    if split:
        if on_device:
            x = torch.cat([x[:h], x[n - h:]], dim=1)
        else:
            x = np.concatenate([x[:h], x[n - h:]], axis=1)
    if on_device:
        x = x if x.is_floating_point() else x.double()
        r = _rhat_device(x) if rank_normalized else _psrf_device(x)
        return r.cpu().double().numpy()
    if not rank_normalized:
        return _psrf(x)
    bulk = _psrf(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[-1]), axis=0))
    return np.maximum(bulk, _psrf(_rank_normalize(folded)))
