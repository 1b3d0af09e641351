"""K6: the diagnostics' fused chains (the walker-averaged ACF, Sokal's and
Geyer's tau, the rank-normalised split R-hat), as CUDA kernels and as
plain PyTorch.

Held against ``emcee_tpu/ops/autocorr.py``, whose chain XLA fuses around
its FFT and sort: the ACF of each (walker, parameter) series
(``_acf_batched``, ``:46-56``), its walker average (``_mean_acf`` and the
chunk loop of ``_walker_mean_acf``, ``:67-107``), Sokal's window
(``_tau_from_f``, ``:75-85``), Geyer's initial monotone sequence
(``_tau_geyer_device``, ``:115-143``), the tie-averaged ranks, their normal
scores and the PSRF of ``_rhat_device`` (``:219-271``) with the pooled
median (``:364``).  The FFTs stay ``torch.fft`` (cuFFT), a library call as
XLA's FFT was; the sort is K16 (:mod:`.shuffle_kernel`).

* **K6a** (``csrc/acf.cu``): :func:`acf_center` reads a walker chunk of a
  chain through its strides and writes each series centred and zero-padded
  to ``2 next_pow_two(n_t)``, series-major, for ``rfft(dim=-1)``;
  :func:`acf_power` writes ``|F|^2`` in place between the FFTs.
* **K6b** (``csrc/acf.cu``): :func:`acf_reduce` divides each ACF by its
  lag 0 and adds it over the walkers of each group into float64 partials
  ``(groups, n_t, n_d)``, written by a chunk's first launch and added to by
  the next chunks'; :func:`tau_window` (one block a parameter) merges the
  partials into the mean ACF and runs Sokal's or Geyer's window in float64.
  Only the ``(n_d,)`` tau leaves the card.
* **K6c** (``csrc/rhat.cu``): :func:`rank_keys` writes each parameter's
  order-preserving integer keys of the pooled draws (or of ``|x -
  median|``), reading a split chain's halves in place; K16 sorts them
  stably and writes them in sorted order beside each draw's position
  (:func:`stable_order`: one pass for float32 keys, two for float64's,
  the high words gathered through the first order by K17);
  :func:`rank_scores` reads them contiguously, finds each tie group's ends
  by a scan with a decoupled look-back and writes each draw's normal
  score ``ndtri((r - 3/8) / (S + 1/4))`` at its own position, and the
  median.  The parameters go in groups (:func:`rhat_group`) so that these
  buffers stay within ``RHAT_BUDGET`` bytes.
* **K6d** (``csrc/rhat.cu``): :func:`psrf` reduces each chain's mean and
  variance and every chain's moments by Chan's combine; its last block
  writes ``sqrt(var_hat / within)``, or its maximum with the bulk value.

The plain versions are the torch operations of the port's route before
the kernels (``x - x.mean()``, ``f * f.conj()``, ``acf / acf[:1]`` and a
sum, numpy's ``cumsum`` window, ``torch.cummin``, ``torch.sort`` via
K16's plain version, ``cummax`` / ``cummin`` for the tie groups,
``torch.special.ndtri``, ``torch.var``).  On the card the keys, the
order, the tie groups (and so the ranks), the medians, the mean ACF from
given partials and the windows equal them bit for bit; the walker sums
(float64 here, the chain's type there, in another order), the means and
variances (Welford and Chan's combine) and ``ndtri`` (CUDA's ``log`` and
``sqrt``) round otherwise (``tests/test_torch_autocorr_kernel.py``,
``chip_smoke.py`` phase 24 state the tolerances).

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back, and counts its launches in
``<wrapper>.launches`` (``_wrap.count_launches``).  Nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._wrap import count_launches, device_sm_count, launch
from .shuffle_kernel import gather_rows, sorted_words

__all__ = ["AcfPlan", "Draws", "FFT_BUDGET", "RHAT_BUDGET", "SCAN_TILE",
           "acf_center", "acf_center_plain", "acf_plan", "acf_power",
           "acf_power_plain", "acf_reduce", "acf_reduce_plain",
           "geyer_plain", "next_pow_two", "order_keys_plain", "plan_sms",
           "pooled_values", "psrf", "psrf_block", "psrf_plain", "rank_keys",
           "rank_keys_plain", "rank_scores", "rank_scores_plain",
           "rhat_group", "score_draws", "sokal_plain", "split_draws",
           "stable_order", "tau_window", "tau_window_plain"]

#: FFT scratch a walker chunk may take: the padded spectra are ``2
#: next_pow_two(n_t)`` complex values a series (emcee_tpu/ops/
#: autocorr.py:100)
FFT_BUDGET = 256 << 20
#: lags of an ``acf_reduce`` block, series of an ``acf_center`` block
#: (kTile in csrc/acf.cu)
TILE = 32
#: ``acf_reduce``'s blocks for every SM, where the walkers allow it
GROUP_BLOCKS_PER_SM = 4
#: ``acf_reduce``'s walkers a warp at least (kRows: a block's warps)
ROWS = 8
#: ``acf_power``'s blocks for every SM (a grid-stride loop)
POWER_BLOCKS_PER_SM = 8
#: positions a block of ``rank_scores``' scan takes (kScanTile in
#: csrc/rhat.cu: 256 threads x 8)
SCAN_TILE = 2048
#: the threads of a ``psrf`` block, a chain each (kThreads)
PSRF_THREADS = 256
#: the SM count the plan assumes for CPU tensors (the plain versions), so
#: that they take several walker groups as the card does
CPU_SMS = 4
#: the most draws a parameter K16 sorts (its n < 2**29); the raw PSRF,
#: which does not sort, takes any number
DRAWS_MAX = (1 << 29) - 1
#: the most keys one K16 call sorts (its T n < 2**31)
SORT_KEYS_MAX = (1 << 31) - 1
#: device bytes the rank passes' buffers may take at once: the parameters
#: go in groups of at least one (a parameter of ``S`` draws takes
#: ``RHAT_BYTES`` a draw)
RHAT_BUDGET = 1 << 30
#: bytes a draw of one parameter takes in the rank passes, float32 and
#: float64 draws: the keys and the sorted words (8 each; float64 twice,
#: with the first pass's order and words and the gathered high words),
#: the links (4), the scores (8) and K16's scratch (16; its look-back
#: words and digit counts add under a byte)
RHAT_BYTES = {False: 8 + 8 + 4 + 8 + 16, True: 8 * 8 + 4 + 8 + 16}
#: the keys' value for every NaN: above +inf's, one for float32 and one
#: for float64 draws (as an int64 bit pattern)
NAN_KEY32 = 0xFFFFFFFF
NAN_KEY64 = -1

_METHODS = {"sokal": 0, "geyer": 1}


def next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def plan_sms(device):
    """The SM count K6's plans take for ``device``'s tensors."""
    return device_sm_count(device) if device.type == "cuda" else CPU_SMS


def _cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")


def _f64(name, t):
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64 draws, got {t.dtype}")
    return int(t.dtype == torch.float64)


def _check(name, t, dtype, shape, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# -- K6a, K6b: the walker-averaged ACF and its windows --------------------


class AcfPlan(NamedTuple):
    """How K6a and K6b take an ``(n_t, n_w, n_d)`` chain."""

    m2: int  #: the padded series' length, ``2 next_pow_two(n_t)``
    chunk: int  #: walkers a chunk (the FFT budget's)
    groups: int  #: ``acf_reduce``'s walker groups (partials)
    wg: int  #: walkers a group


def acf_plan(n_t, n_w, n_d, itemsize, n_sm, budget=FFT_BUDGET):
    """K6's chunks and groups: walker chunks of ``budget`` bytes of FFT
    scratch (``2 m2`` values of ``itemsize`` a series, as
    ``emcee_tpu/ops/autocorr.py:101`` budgets them), and the walkers of a
    chunk cut into groups so that ``acf_reduce``'s blocks (``TILE`` lags
    each) fill ``n_sm`` SMs ``GROUP_BLOCKS_PER_SM`` times, with a warp at
    least a walker."""
    m2 = 2 * next_pow_two(n_t)
    per_walker = m2 * n_d * 2 * itemsize
    chunk = max(1, min(n_w, budget // max(per_walker, 1)))
    tiles = -(-n_t // TILE)
    groups = max(1, min(-(-chunk // ROWS),
                        -(-GROUP_BLOCKS_PER_SM * n_sm // tiles), 65535))
    wg = -(-chunk // groups)
    return AcfPlan(m2, chunk, -(-chunk // wg), wg)


def acf_center_plain(x, lo, w, out):
    """Plain K6a centring: walkers ``[lo, lo + w)`` of ``x`` ``(n_t, n_w,
    n_d)``, each series less its mean, into ``out`` ``(w n_d, m2)``,
    zero-padded."""
    n_t, _, n_d = x.shape
    xs = x[:, lo:lo + w]
    xc = xs - xs.mean(dim=0, keepdim=True)
    o = out.view(w, n_d, out.shape[1])
    o[..., :n_t] = xc.permute(1, 2, 0)
    o[..., n_t:] = 0
    return out


def acf_center(x, lo, w, out):
    """K6a: walkers ``[lo, lo + w)`` of the chain ``x`` ``(n_t, n_w, n_d)``
    (float32 or float64, any strides: read in place), each (walker,
    parameter) series centred on its mean, into ``out`` ``(w n_d, m2)`` of
    ``x``'s type, series-major (series ``w' n_d + j``), zeros from lag
    ``n_t``.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return acf_center_plain(x, lo, w, out)
    _cuda("acf_center", x)
    f64 = _f64("acf_center", x)
    n_t, n_w, n_d = x.shape
    if not (0 <= lo and 1 <= w and lo + w <= n_w):
        raise ValueError(f"walkers [{lo}, {lo + w}) of {n_w}")
    m2 = out.shape[-1] if out.dim() == 2 else 0
    _check("acf_center's out", out, x.dtype, (w * n_d, m2), x.device)
    if m2 < n_t or w * n_d >= 2**31:
        raise ValueError(f"acf_center: {w * n_d} series of {m2} lags for "
                         f"{n_t} steps")
    launch("acf_center", x.device, x.data_ptr(), out.data_ptr(),
           *x.stride(), n_t, lo, w * n_d, n_d, m2, f64)
    count_launches(acf_center)
    return out


def acf_power_plain(f):
    """Plain K6a power spectrum: ``f * f.conj()`` in place."""
    return f.copy_(f * f.conj())


def acf_power(f):
    """K6a: the power spectrum ``|F|^2`` of the contiguous complex64 or
    complex128 spectrum ``f``, in place.  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if f.device.type == "cpu":
        return acf_power_plain(f)
    _cuda("acf_power", f)
    if f.dtype not in (torch.complex64, torch.complex128) or \
            not f.is_contiguous() or f.numel() < 1:
        raise ValueError(f"acf_power: a contiguous complex spectrum, got "
                         f"{f.dtype} {tuple(f.shape)}")
    launch("acf_power", f.device, f.data_ptr(), f.numel(),
           int(f.dtype == torch.complex128),
           POWER_BLOCKS_PER_SM * device_sm_count(f.device))
    count_launches(acf_power)
    return f


def acf_reduce_plain(acf, part, n_t, n_d, nw, wg, first):
    """Plain K6b walker sum: ``acf / acf[:1]`` of each series, widened to
    float64 and summed over each group's walkers into ``part``."""
    m2 = acf.shape[1]
    a = acf.view(nw, n_d, m2)[..., :n_t]
    r = (a / a[..., :1]).double()
    for g in range(part.shape[0]):
        s = r[g * wg:(g + 1) * wg].sum(dim=0).T
        if first:
            part[g] = s
        else:
            part[g] += s
    return part


def acf_reduce(acf, part, n_t, n_d, nw, wg, first):
    """K6b: the ACFs ``acf`` ``(nw n_d, m2)`` of a chunk's ``nw`` walkers
    (``irfft``'s output), each divided by its lag 0 in the chain's type and
    summed in float64 over the walkers of each group of ``wg`` into
    ``part`` ``(groups, n_t, n_d)``: written where ``first``, else added.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if acf.device.type == "cpu":
        return acf_reduce_plain(acf, part, n_t, n_d, nw, wg, first)
    _cuda("acf_reduce", acf)
    f64 = _f64("acf_reduce", acf)
    groups = part.shape[0] if part.dim() == 3 else 0
    m2 = acf.shape[-1] if acf.dim() == 2 else 0
    _check("acf_reduce's acf", acf, acf.dtype, (nw * n_d, m2), acf.device)
    _check("acf_reduce's part", part, torch.float64, (groups, n_t, n_d),
           acf.device)
    if not (1 <= wg and groups * wg >= nw and m2 >= n_t):
        raise ValueError(f"acf_reduce: {nw} walkers in {groups} groups of "
                         f"{wg}, {m2} lags for {n_t} steps")
    launch("acf_reduce", acf.device, acf.data_ptr(), part.data_ptr(), n_t,
           n_d, m2, nw, wg, groups, int(bool(first)), f64)
    count_launches(acf_reduce)
    return part


def sokal_plain(f, c):
    """Sokal's automated window of the walker-averaged ACF ``f`` (a float64
    numpy ``(n_t, n_d)``): ``taus = 2 cumsum(f) - 1`` and the first lag
    where ``t < c tau`` fails, else ``n_t - 1``.  Returns ``(tau,
    window)``."""
    n_t = f.shape[0]
    taus = 2.0 * np.cumsum(f, axis=0) - 1.0
    mask = np.arange(n_t)[:, None] < c * taus
    windows = np.where(mask.any(axis=0), np.argmin(mask, axis=0), n_t - 1)
    return np.take_along_axis(taus, windows[None, :], axis=0)[0], windows


def geyer_plain(f):
    """Geyer's (1992) initial-monotone-sequence tau from the
    walker-averaged ACF ``f`` (n_t, n_d), a tensor, on its device: the
    pair sums ``G_k = rho_2k + rho_2k+1``, truncated at the first that is
    not positive, made monotone by a running minimum (``torch.cummin``),
    and ``tau = -1 + 2 sum_k G_k``, floored at ``1 / log10(n_t)`` (Stan's
    cap on ESS) as ``emcee_tpu/ops/autocorr.py:115-149`` computes it.
    Returns ``(tau, k_stop)``, ``(n_d,)`` tensors (NaN when ``n_t <
    2``)."""
    n_t = f.shape[0]
    npairs = n_t // 2
    if npairs < 1:
        return (torch.full(f.shape[1:], float("nan"), dtype=f.dtype,
                           device=f.device),
                torch.zeros(f.shape[1:], dtype=torch.int64, device=f.device))
    g = f[0:2 * npairs:2] + f[1:2 * npairs:2]
    pos = g > 0.0
    k_stop = torch.where((~pos).any(dim=0),
                         pos.to(torch.int8).argmin(dim=0), npairs)
    g_mono = torch.cummin(g, dim=0).values
    keep = torch.arange(npairs, device=f.device)[:, None] < k_stop[None, :]
    tau = -1.0 + 2.0 * torch.where(keep, g_mono, 0.0).sum(dim=0)
    return tau.clamp_min(1.0 / np.log10(max(float(n_t), 10.0))), k_stop


def tau_window_plain(part, n_w, method, c, f, tau, win):
    """Plain K6b window: the partials added in group order and divided by
    ``n_w`` (a tensor: on the card torch would multiply by the reciprocal
    of a number) into ``f``, then :func:`sokal_plain` on the host or
    :func:`geyer_plain`."""
    acc = torch.zeros_like(part[0])
    for g in range(part.shape[0]):
        acc = acc + part[g]
    f.copy_(acc / torch.tensor(float(n_w), dtype=torch.float64,
                               device=part.device))
    if method == "sokal":
        t, w = sokal_plain(f.cpu().numpy(), float(c))
        tau.copy_(torch.from_numpy(np.ascontiguousarray(t)))
        win.copy_(torch.from_numpy(np.asarray(w, dtype=np.int64)))
    else:
        t, w = geyer_plain(f)
        tau.copy_(t)
        win.copy_(w)


def tau_window(part, n_w, method, c, f, tau, win):
    """K6b: the walker-averaged ACF ``f`` ``(n_t, n_d)`` (float64) of the
    partials ``part`` ``(groups, n_t, n_d)`` over ``n_w`` walkers, and each
    parameter's ``tau`` and window ``win`` ``(n_d,)`` (float64, int64):
    ``method`` ``"sokal"`` (``c``) or ``"geyer"`` (the window is the pair
    count kept).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if method not in _METHODS:
        raise ValueError(f"unknown method: {method!r}")
    if part.device.type == "cpu":
        return tau_window_plain(part, n_w, method, c, f, tau, win)
    _cuda("tau_window", part)
    if part.dim() != 3:
        raise ValueError("tau_window: part must be (groups, n_t, n_d)")
    groups, n_t, n_d = part.shape
    dev = part.device
    _check("tau_window's part", part, torch.float64, (groups, n_t, n_d), dev)
    _check("tau_window's f", f, torch.float64, (n_t, n_d), dev)
    _check("tau_window's tau", tau, torch.float64, (n_d,), dev)
    _check("tau_window's win", win, torch.int64, (n_d,), dev)
    floor = 1.0 / np.log10(max(float(n_t), 10.0))
    launch("tau_window", dev, part.data_ptr(), f.data_ptr(), tau.data_ptr(),
           win.data_ptr(), groups, n_t, n_d, float(n_w), _METHODS[method],
           float(c), float(floor))
    count_launches(tau_window)


# -- K6c, K6d: the rank-normalised split R-hat ----------------------------


class Draws(NamedTuple):
    """The pooled draws of an ``(n, m, d)`` block as R-hat reads them:
    step ``t < h``, chain ``c < C``, parameter ``j``; chains ``c < m`` are
    ``x[t, c]``, the others ``x[shift + t, c - m]`` (a split chain's second
    half); the pooled position is ``p = t C + c``, as
    ``jnp.concatenate([x[:h], x[n - h:]], axis=1).reshape(h C, d)`` pools
    them."""

    x: torch.Tensor
    h: int
    m: int
    C: int
    shift: int

    @property
    def d(self):
        return self.x.shape[-1]

    @property
    def S(self):
        return self.h * self.C

    def block(self):
        """The ``(h, C, d)`` block (a copy for a split chain)."""
        first = self.x[:self.h]
        if self.C == self.m:
            return first
        return torch.cat([first, self.x[self.shift:self.shift + self.h]],
                         dim=1)


def split_draws(x, split):
    """The draws of chain ``x`` ``(n, m, d)`` (``get_chain()``'s layout,
    walkers as chains), each chain split in halves where ``split``."""
    n, m, _ = x.shape
    if split:
        h = n // 2
        return Draws(x, h, m, 2 * m, n - h)
    return Draws(x, n, m, m, 0)


def score_draws(z, h, C):
    """The normal scores ``z`` ``(d, S)`` (pooled positions) as draws of
    ``h`` steps and ``C`` chains."""
    d = z.shape[0]
    return Draws(z.view(d, h, C).permute(1, 2, 0), h, C, C, 0)


class RhatArgs(ctypes.Structure):
    """The arguments of the K6c and K6d entry points (``RhatArgs`` in
    ``csrc/rhat.cu``, field for field)."""

    _fields_ = [("x", ctypes.c_void_p)] + [
        (name, ctypes.c_longlong) for name in ("st", "sc", "sd", "shift")
    ] + [(name, ctypes.c_void_p) for name in (
        "center", "lo", "hi", "sw", "sh", "grp", "z", "med", "status")
    ] + [("denom", ctypes.c_double), ("coef", ctypes.c_double),
         ("part", ctypes.c_void_p), ("done", ctypes.c_void_p),
         ("out", ctypes.c_void_p), ("nan_key", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "h", "m", "C", "d", "f64", "tiles", "blocks", "prior")]


def _draw_args(name, draws, sort=True, **kw):
    x = draws.x
    _cuda(name, x)
    f64 = _f64(name, x)
    if x.dim() != 3 or draws.C < 2 or draws.h < 1:
        raise ValueError(f"{name}: draws of {draws.h} steps x {draws.C} "
                         f"chains of a {tuple(x.shape)} block")
    if sort and draws.S > DRAWS_MAX:
        raise ValueError(f"{name}: {draws.S} draws a parameter; K16 sorts "
                         f"at most {DRAWS_MAX}")
    return RhatArgs(x=x.data_ptr(), st=x.stride(0), sc=x.stride(1),
                    sd=x.stride(2), shift=draws.shift, h=draws.h, m=draws.m,
                    C=draws.C, d=draws.d, f64=f64, **kw)


def rhat_group(d, S, f64, budget=RHAT_BUDGET):
    """Parameters a group of the rank passes takes: as many of ``d`` as
    keep ``RHAT_BYTES`` a draw of ``S`` within ``budget`` bytes and one
    K16 call within ``SORT_KEYS_MAX`` keys, one at least."""
    return max(1, min(d, budget // (S * RHAT_BYTES[bool(f64)]),
                      SORT_KEYS_MAX // S))


def order_keys_plain(v):
    """The keys of ``v`` (float32 or float64) as :func:`rank_keys` writes
    them: ``(lo, hi)`` int64 tensors, ``hi`` None for float32 (the 32-bit
    key in ``lo``); float64's 64-bit key as its low and high words."""
    v = v.contiguous()
    if v.dtype == torch.float32:
        u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = torch.where(v == 0, 0, u)
        k = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)
        return torch.where(torch.isnan(v), NAN_KEY32, k), None
    b = v.view(torch.int64)
    b = torch.where(v == 0, 0, b)
    k = torch.where(b < 0, ~b, b ^ torch.iinfo(torch.int64).min)
    k = torch.where(torch.isnan(v), NAN_KEY64, k)
    return k & 0xFFFFFFFF, (k >> 32) & 0xFFFFFFFF


def pooled_values(draws):
    """The draws as ``(d, S)`` in pooled order."""
    return draws.block().reshape(draws.S, draws.d).T


def rank_keys_plain(draws, lo, hi=None, center=None):
    """Plain K6c keys: of the pooled draws (of ``|x - center|`` where
    ``center`` is given) into ``lo`` (and ``hi``)."""
    v = pooled_values(draws)
    if center is not None:
        v = (v - center[:, None]).abs()
    k_lo, k_hi = order_keys_plain(v)
    lo.copy_(k_lo)
    if hi is not None:
        hi.copy_(k_hi)


def rank_keys(draws, lo, hi=None, center=None):
    """K6c: each parameter's order-preserving keys of the pooled
    :class:`Draws` (read in place), of ``|x - center|`` where ``center``
    ``(d,)`` (the draws' type) is given: ``lo`` ``(d, S)`` int64 holds a
    float32 draw's 32-bit key, or a float64 draw's low word with its high
    word in ``hi``.  -0.0 ties +0.0; every NaN has the one key above
    +inf's.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if draws.x.device.type == "cpu":
        return rank_keys_plain(draws, lo, hi, center)
    dev = draws.x.device
    args = _draw_args("rank_keys", draws)
    shape = (draws.d, draws.S)
    _check("rank_keys' lo", lo, torch.int64, shape, dev)
    if args.f64 != (hi is not None):
        raise ValueError("rank_keys: high words for float64 draws only")
    if hi is not None:
        _check("rank_keys' hi", hi, torch.int64, shape, dev)
    if center is not None:
        _check("rank_keys' center", center, draws.x.dtype, (draws.d,), dev)
    args.lo = lo.data_ptr()
    args.hi = None if hi is None else hi.data_ptr()
    args.center = None if center is None else center.data_ptr()
    launch("rank_keys", dev, ctypes.addressof(args))
    count_launches(rank_keys)


def stable_order(lo, hi, sw, sh=None):
    """Each row's stable order of the keys ``lo`` (and ``hi``) ``(d, S)``
    by K16, as its sorted words: ``sw[j, k]`` is ``(low key word << 32) |
    p`` of the draw at sorted position ``k``, ``p`` its pooled position.
    One pass for 32-bit keys; for 64-bit keys a pass on the low words,
    then one on the high words gathered through its order (K17), whose
    words (``high word << 32``) go to ``sh``, and the first pass's words
    gathered through the second's order into ``sw``."""
    if hi is None:
        sorted_words(lo, sw)
        return
    d, S = lo.shape
    first, second = (torch.empty(d * S, dtype=torch.int64, device=lo.device)
                     for _ in range(2))
    words = torch.empty_like(lo)
    sorted_words(lo, words, first)
    high = gather_rows(first, [hi.view(-1)])[0]
    sorted_words(high.view(d, S), sh, second)
    gather_rows(second, [words.view(-1)], [sw.view(-1)])


def rank_scores_plain(draws, sw, sh, grp, z, med=None):
    """Plain K6c scores: the sorted keys' tie groups by ``cummax`` /
    ``cummin``, the average ranks, ``torch.special.ndtri`` of ``(r -
    3/8) / (S + 1/4)`` (a tensor divisor) scattered to each draw's
    position, ``grp`` as the kernel writes it, and the medians."""
    d, S = sw.shape
    key = (sw >> 32) & 0xFFFFFFFF
    if sh is not None:
        key = key | (sh >> 32 << 32)
    pos = sw & 0xFFFFFFFF
    nan = NAN_KEY32 if sh is None else NAN_KEY64
    start = torch.ones_like(key, dtype=torch.bool)
    start[:, 1:] = key[:, 1:] != key[:, :-1]
    start |= key == nan
    end = torch.ones_like(start)
    end[:, :-1] = start[:, 1:]
    at = torch.arange(S, device=sw.device).expand(d, S)
    first = torch.cummax(torch.where(start, at, -1), dim=1).values
    last = torch.cummin(torch.where(end, at, S).flip(1), dim=1).values.flip(1)
    grp.copy_(torch.where(start, last, first).reshape(-1))
    rank = (first + last + 2).double() * 0.5
    u = (rank - 0.375) / torch.tensor(S + 0.25, dtype=torch.float64,
                                      device=sw.device)
    z.scatter_(1, pos, torch.special.ndtri(u))
    if med is not None:
        v = pooled_values(draws).gather(1, pos[:, [(S - 1) // 2, S // 2]])
        med.copy_(0.5 * (v[:, 0] + v[:, 1]))


def rank_scores(draws, sw, sh, grp, z, med=None):
    """K6c: from the sorted words ``sw`` (and ``sh``) ``(d, S)`` of the
    :class:`Draws`' keys (:func:`stable_order`), each draw's normal score
    ``ndtri((r - 3/8) / (S + 1/4))`` of its tie-averaged rank ``r`` into
    ``z`` ``(d, S)`` float64 at its pooled position, the groups' links
    into ``grp`` ``(d S,)`` int32 (``grp[k]``: the group's first position
    where ``k`` does not start it, else its last), and, where ``med``
    ``(d,)`` (the draws' type) is given, the medians ``(v_(S-1)/2 +
    v_S/2) / 2``.  Two launches (the scan, the scores).  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if draws.x.device.type == "cpu":
        return rank_scores_plain(draws, sw, sh, grp, z, med)
    dev = draws.x.device
    d, S = draws.d, draws.S
    tiles = -(-S // SCAN_TILE)
    # the look-back's status words, zero (not published) for this launch
    status = torch.zeros(d * tiles, dtype=torch.int64, device=dev)
    args = _draw_args("rank_scores", draws, denom=S + 0.25,
                      nan_key=NAN_KEY32 if sh is None else 2**64 - 1,
                      tiles=tiles)
    _check("rank_scores' sw", sw, torch.int64, (d, S), dev)
    if args.f64 != (sh is not None):
        raise ValueError("rank_scores: high words for float64 draws only")
    if sh is not None:
        _check("rank_scores' sh", sh, torch.int64, (d, S), dev)
    _check("rank_scores' grp", grp, torch.int32, (d * S,), dev)
    _check("rank_scores' z", z, torch.float64, (d, S), dev)
    if med is not None:
        _check("rank_scores' med", med, draws.x.dtype, (d,), dev)
    args.sw = sw.data_ptr()
    args.sh = None if sh is None else sh.data_ptr()
    args.grp = grp.data_ptr()
    args.z = z.data_ptr()
    args.med = None if med is None else med.data_ptr()
    args.status = status.data_ptr()
    launch("rank_scores", dev, ctypes.addressof(args))
    count_launches(rank_scores, 2)


def psrf_block(x):
    """Plain PSRF of an ``(n, m, d)`` tensor, on its device; a zero
    within-chain variance gives NaN (0 / 0), as in the JAX package."""
    n = x.shape[0]
    between = n * x.mean(dim=0).var(dim=0, correction=1)
    within = x.var(dim=0, correction=1).mean(dim=0)
    var_hat = (n - 1) / n * within + between / n
    return torch.sqrt(var_hat / within)


def psrf_plain(draws, out, prior=False):
    """Plain K6d: :func:`psrf_block` of the draws' block, or its
    ``torch.maximum`` with ``out``'s values where ``prior``."""
    r = psrf_block(draws.block()).double()
    out.copy_(torch.maximum(out, r) if prior else r)


def psrf(draws, out, prior=False):
    """K6d: the potential scale reduction factor of the :class:`Draws`
    (read in place) into ``out`` ``(d,)`` float64, or, where ``prior``, the
    maximum (NaN if either is) of ``out``'s values and it.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if draws.x.device.type == "cpu":
        return psrf_plain(draws, out, prior)
    dev = draws.x.device
    blocks = -(-draws.C // PSRF_THREADS)
    part = torch.empty(draws.d * blocks * 4, dtype=torch.float64, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    args = _draw_args("psrf", draws, False, coef=(draws.h - 1) / draws.h,
                      part=part.data_ptr(), done=done.data_ptr(),
                      blocks=blocks, prior=int(bool(prior)))
    _check("psrf's out", out, torch.float64, (draws.d,), dev)
    args.out = out.data_ptr()
    launch("psrf", dev, ctypes.addressof(args))
    count_launches(psrf)


for _fn in (acf_center, acf_power, acf_reduce, tau_window, rank_keys,
            rank_scores, psrf):
    _fn.launches = 0
    _fn.device_launches = None
del _fn
