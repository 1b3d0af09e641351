"""K19: the Gaussian Metropolis proposal, as a CUDA kernel and as plain
PyTorch.

Held against ``emcee_tpu/moves/gaussian.py:118-150`` (``GaussianMove``'s
proposal: the random scale ``exp(U(-log f, log f))``, the tuned scale
``exp(log_adj)``, ``z * scale`` or ``z @ chol^T``, ``x0 + f step`` and the
``random`` / ``sequential`` mask), vmapped over a ladder by
``emcee_tpu/parallel/tempering.py:538``.  The kernel is
``csrc/gaussian_propose.cu``: one thread a walker (a walker's pair of
columns in the vector mode with a scalar or diagonal scale), the grid's
second dimension the rung.  It draws at the counters the plain move drew
at:

* the normals at ``(walker, NORMAL_BLOCK | k, offset)``, as
  :func:`~.philox.normals`;
* the ``random`` mode's dimension from word 0 at ``(walker, 0, offset)``,
  ``min(int(u nd), nd - 1)``;
* the factor's uniform from word 0 at ``(ROLL_LANE, 0, offset)``, as
  :func:`~.philox.roll_uniforms`.

The step is ``x0 + f (z scale)`` for a scalar or diagonal scale, and
``x0 + f sum_{k <= d} z_k L[d, k]`` (``k`` in column order, from +0.0, as
K18a sums it: ``csrc/walk_propose.cu``) for a full covariance, whose
rounding differs from the JAX package's matmul (``ROADMAP.md`` section 3).
The ``random`` and ``sequential`` modes change one dimension a walker.
The ``sequential`` index (``()`` or ``(T,)`` int32, a carry) is read by
the kernel and advanced by a second launch on the same stream, so no block
reads an index another has already advanced; a recorded proposal reads the
previous replay's write.

On the rung axis ``x`` is ``(T, nw, nd)``, ``log_adj`` and ``index``
``(T,)`` and ``seed`` the rungs' :class:`~.philox.RungKeys`: rung ``r``
draws its one-ensemble counters under its own key; ``scale`` and ``L`` are
shared by every rung.

:func:`gaussian_propose` launches the kernel for CUDA tensors and runs
:func:`gaussian_propose_plain` for CPU tensors; it never falls back, and
counts its launches in ``gaussian_propose.launches`` (two in the
``sequential`` mode: the proposal and the index's advance; and
``gaussian_propose.device_launches`` when set: ``_wrap.count_launches``).
The plain version equals the kernel bit for bit and draws the same numbers
(``plain=True``, the torch rounds of ``ops/philox.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._wrap import (
    check_f32, check_i32, count_launches, key_args, launch, ptr, rng_args)
from .philox import ROLL_LANE, RungKeys, normals, rung_keys, word_uniforms

__all__ = ["MODES", "gaussian_propose", "gaussian_propose_plain"]

#: mode name -> the kernel's code for it
MODES = {"vector": 0, "random": 1, "sequential": 2}
#: threads a block
THREADS = 128


def _layout(x):
    """``(lead, nw, nd)`` of a ``(nw, nd)`` / ``(T, nw, nd)`` buffer."""
    if x.dim() not in (2, 3):
        raise ValueError("x must be (nwalkers, ndim) or (T, nwalkers, ndim)")
    lead = tuple(int(t) for t in x.shape[:-2])
    return (lead,) + tuple(int(t) for t in x.shape[-2:])


def _check_mode(mode, L):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if L is not None and mode != "vector":
        raise ValueError("a full covariance takes the vector mode only")


def gaussian_propose_plain(x, scale, L, seed, offset, mode="vector",
                           log_factor=None, log_adj=None, index=None, z=None,
                           u=None, dims=None):
    """Plain PyTorch K19: ``(q, factor)`` of every walker of ``x`` (``(nw,
    nd)``, or ``(T, nw, nd)`` on the rung axis).  ``scale`` is the ``()``
    or ``(nd,)`` standard deviation (None with ``L``, the ``(nd, nd)``
    Cholesky factor), ``log_factor`` the move's ``log(factor)`` (a Python
    float) or None, ``log_adj`` the tuned log-scale (``()`` / ``(T,)``) or
    None, ``index`` the ``sequential`` mode's carry, advanced in place.
    ``z`` ``(..., nw, nd)``, ``u`` (the factor's uniform, ``()`` / ``(T,)``)
    and ``dims`` (``(..., nw)`` int64, the ``random`` mode's) inject the
    draws."""
    _check_mode(mode, L)
    lead, nw, nd = _layout(x)
    dev, dt = x.device, x.dtype
    if lead and not isinstance(seed, RungKeys):
        seed = rung_keys(seed, lead[0], dev)
    f = None
    if log_factor is not None:
        if u is None:
            u = word_uniforms(1, 1, 0, seed, offset, dev, row0=ROLL_LANE,
                              plain=True).reshape(lead)
        f = torch.exp(-log_factor + u.to(dt) * (2.0 * log_factor))
    if log_adj is not None:
        adj = torch.exp(log_adj).to(dt)
        f = adj if f is None else f * adj
    if mode == "random" and dims is None:
        ud = word_uniforms(nw, 1, 0, seed, offset, dev, plain=True)[..., 0]
        dims = torch.clamp((ud * nd).to(torch.int64), max=nd - 1)
    elif mode == "sequential":
        dims = torch.remainder(index.to(torch.int64), nd)[..., None]
    if z is None:
        z = normals(nw, nd, seed, offset, dev, dt, plain=True)
    z = z.to(dt)
    if L is not None:
        L = L.to(dt)
        step = torch.zeros(lead + (nw, nd), dtype=dt, device=dev)
        for k in range(nd):
            step[..., k:] = step[..., k:] + z[..., k:k + 1] * L[k:, k]
    else:
        step = z * scale.to(dt)
    if f is not None:
        step = f[..., None, None] * step
    q = x + step
    if mode != "vector":
        mask = torch.arange(nd, device=dev) == dims[..., None]
        q = torch.where(mask, q, x)
    if mode == "sequential":
        index.copy_(torch.remainder(index + 1, nd))
    return q, torch.zeros(lead + (nw,), dtype=dt, device=dev)


class _Args(ctypes.Structure):
    """The arguments of the entry point (``GaussArgs`` in
    ``csrc/gaussian_propose.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "q", "factor", "scale", "L", "log_adj", "index", "z_in", "u_in",
        "dims_in", "offset_dev", "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong),
         ("neg_lf", ctypes.c_float), ("two_lf", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "nw", "nd", "ntemps", "mode", "diag", "has_factor", "threads")]


def gaussian_propose(x, scale, L, seed, offset, mode="vector",
                     log_factor=None, log_adj=None, index=None, z=None,
                     u=None, dims=None):
    """K19 on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Arguments as
    :func:`gaussian_propose_plain`."""
    if x.device.type == "cpu":
        return gaussian_propose_plain(x, scale, L, seed, offset, mode,
                                      log_factor, log_adj, index, z, u, dims)
    _check_mode(mode, L)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no K19 kernel for device {dev}")
    lead, nw, nd = _layout(x)
    check_f32("x", x, dev)
    if x.numel() >= 2**31 or (lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"bad K19 shape {tuple(x.shape)}")
    if L is None:
        check_f32("scale", scale, dev)
        if scale is None or scale.numel() not in (1, nd):
            raise ValueError(f"scale must hold 1 or {nd} values")
    else:
        check_f32("L", L, dev, (nd, nd))
    check_f32("log_adj", log_adj, dev, lead)
    check_f32("z", z, dev, None if z is None else lead + (nw, nd))
    check_f32("u", u, dev, None if u is None else lead)
    if dims is not None and (dims.device != dev or dims.dtype != torch.int64
                             or tuple(dims.shape) != lead + (nw,)
                             or not dims.is_contiguous()):
        raise ValueError(f"dims must be a contiguous {lead + (nw,)} int64 "
                         f"tensor on {dev}")
    if mode == "sequential":
        if index is None:
            raise ValueError("the sequential mode needs its index")
        check_i32("index", index, dev, lead)
    q = torch.empty(lead + (nw, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (nw,), dtype=torch.float32, device=dev)
    ntemps = lead[0] if lead else 1
    injected = z is not None and (u is not None or log_factor is None) and (
        dims is not None or mode != "random")
    ntemps, keys, seed64 = key_args(seed, dev, ntemps, injected=injected)
    _, off_ptr, off = rng_args(0, offset, dev)
    lf = 0.0 if log_factor is None else float(log_factor)
    args = _Args(
        x=x.data_ptr(), q=q.data_ptr(), factor=factor.data_ptr(),
        scale=ptr(scale) if L is None else None, L=ptr(L),
        log_adj=ptr(log_adj), index=ptr(index) if mode == "sequential"
        else None, z_in=ptr(z), u_in=ptr(u), dims_in=ptr(dims),
        offset_dev=off_ptr, keys=keys, offset_inc=off, seed=seed64,
        neg_lf=float(np.float32(-lf)), two_lf=float(np.float32(2.0 * lf)),
        nw=nw, nd=nd, ntemps=ntemps, mode=MODES[mode],
        diag=int(L is None and scale.numel() == nd and nd > 1),
        has_factor=int(log_factor is not None), threads=THREADS)
    launch("gaussian_propose", dev, ctypes.addressof(args))
    count_launches(gaussian_propose, 2 if mode == "sequential" else 1)
    return q, factor


gaussian_propose.launches = 0
gaussian_propose.device_launches = None
