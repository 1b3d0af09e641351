"""K21a and K21b: ChEES-HMC's start and tuning gradient, as CUDA kernels
and as plain PyTorch.

Held against ``emcee_tpu/moves/gradient.py``'s ``ChEESHMCMove.propose``
(``:461-554``), vmapped over a ladder by
``emcee_tpu/parallel/tempering.py:538``.  The kernels are
``csrc/chees.cu``:

* **K21a, the start** (:func:`chees_start`, ``:468-483`` and
  ``_van_der_corput``, ``:348-359``): from each rung's carry (``log_adj``,
  ``log_T``, the counter ``n``) and the step size, one block writes each
  rung's ``eps = step exp(log_adj)``, ``u`` (the base-2 van der Corput
  value of ``n``), ``T = exp(log_T)`` and trips after the first, ``more =
  clamp(ceil(u T / eps), 1, max_leapfrog) - 1`` (clamped in float before
  the int cast), then ``top``, the largest ``more``, and zeroes ``trip``,
  the word K13's masked rung mode counts the trips in.  The host reads
  ``top`` once a proposal, for every rung at once.
* **K21b, the tuning gradient** (:func:`chees_gradient`, ``:514-548``):
  each rung's acceptance-weighted ChEES gradient with respect to ``log
  T``, from the ensemble before the accept ``x``, the proposal ``q``, the
  end point's momentum ``p``, the log-probs, the kinetic factors, ``u``
  and ``T``, written into the carry's ``g``.  Its sums run in a fixed
  order (:class:`GradPlan`), which :func:`chees_gradient_plain` repeats,
  so the two agree bit for bit; against the JAX package's sums (XLA's
  order, its matmul by ``L``) they agree to rounding.

On the rung axis the carry's words are ``(T,)``, the rows ``(T, n, nd)``
and every output ``(T,)``; one ensemble is the ``()`` / ``(n, nd)`` case.
Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other, and
counts its launches in ``<wrapper>.launches`` (and in
``<wrapper>.device_launches``, when set, on the card:
``_wrap.count_launches``).  The plain versions divide only by tensors,
as the kernels divide by the float row count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._wrap import check_f32, check_i32, count_launches, launch, ptr

__all__ = ["GRAD_ROWS", "GRAD_THREADS", "FUSED_MAX", "GradPlan",
           "GradScratch", "StartOut", "chees_gradient",
           "chees_gradient_plain", "chees_start", "chees_start_plain",
           "grad_plan", "grad_scratch", "start_out", "van_der_corput"]

#: K21b's threads a block (kThreads in csrc/chees.cu)
GRAD_THREADS = 256
#: rows a block where a rung's rows take more than one block
GRAD_ROWS = 1024
#: up to this many rows a rung, one block a rung runs both passes in one
#: launch
FUSED_MAX = 2048
#: the widest row K21b takes (its means sit in 48 KB of shared memory
#: beside the block's 16 KB of partials)
GRAD_ND_MAX = 4096


class GradPlan(NamedTuple):
    """How K21b cuts a rung's rows; its sums follow it."""

    rows: int  #: rows a block, a multiple of ``threads``
    blocks: int  #: blocks a rung, ``ceil(n / rows)``
    threads: int  #: threads a block

    @property
    def launches(self):
        """Launches a call: 1 with one block a rung, else 2."""
        return 1 if self.blocks == 1 else 2


def grad_plan(n, rows=None):
    """K21b's plan for ``n`` rows a rung: one block a rung up to
    ``FUSED_MAX`` rows (the smallest multiple of ``GRAD_THREADS`` that
    holds them), else blocks of ``rows`` (``GRAD_ROWS`` by default) rows."""
    t = GRAD_THREADS
    if rows is None:
        if n <= FUSED_MAX:
            return GradPlan(max(t, -(-n // t) * t), 1, t)
        rows = GRAD_ROWS
    if rows < t or rows % t:
        raise ValueError(f"rows a block must be a multiple of {t}")
    return GradPlan(rows, max(1, -(-n // rows)), t)


class StartOut(NamedTuple):
    """K21a's outputs: ``eps``, ``u`` and ``T`` (float32), ``more``
    (int64), each ``()`` or ``(T,)``, and the 0-d int64 words ``top`` and
    ``trip``."""

    eps: torch.Tensor
    u: torch.Tensor
    T: torch.Tensor
    more: torch.Tensor
    top: torch.Tensor
    trip: torch.Tensor


def start_out(lead, device, dtype=torch.float32):
    """Zeroed :class:`StartOut` buffers for ``lead`` (``()`` or ``(T,)``)
    rungs."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return StartOut(z(lead, dtype), z(lead, dtype), z(lead, dtype),
                    z(lead, torch.int64), z((), torch.int64),
                    z((), torch.int64))


def van_der_corput(n):
    """Base-2 van der Corput value of the integer tensor ``n >= 1``: the
    32-bit bit reversal divided by 2^32, in int64 arithmetic with masks
    (``gradient.py:348-359``)."""
    n = n.to(torch.int64) & 0xFFFFFFFF
    n = ((n & 0x55555555) << 1) | ((n >> 1) & 0x55555555)
    n = ((n & 0x33333333) << 2) | ((n >> 2) & 0x33333333)
    n = ((n & 0x0F0F0F0F) << 4) | ((n >> 4) & 0x0F0F0F0F)
    n = ((n & 0x00FF00FF) << 8) | ((n >> 8) & 0x00FF00FF)
    n = ((n << 16) | (n >> 16)) & 0xFFFFFFFF
    return n.to(torch.float32) * 2.0**-32


def chees_start_plain(log_adj, log_T, n, step, max_leapfrog, out):
    """Plain PyTorch K21a into ``out`` (a :class:`StartOut`), in its
    buffers' dtype."""
    dt = out.eps.dtype
    eps = (torch.full(log_adj.shape, step, dtype=dt, device=log_adj.device)
           * torch.exp(log_adj).to(dt))
    u = van_der_corput(n).to(dt)
    T = torch.exp(log_T).to(dt)
    # Clipped in float before the int cast, as the JAX package.
    steps = torch.clamp(torch.ceil(u * T / eps), 1.0, float(max_leapfrog))
    out.eps.copy_(eps)
    out.u.copy_(u)
    out.T.copy_(T)
    out.more.copy_(steps.to(torch.int64) - 1)
    out.top.copy_(out.more.max())
    out.trip.zero_()
    return out


def chees_start(log_adj, log_T, n, step, max_leapfrog, out):
    """K21a on the carry's device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``log_adj`` and ``log_T`` float32 and
    ``n`` int32, each ``()`` or ``(T,)``; writes ``out`` (a
    :class:`StartOut` of the same lead) and returns it."""
    dev = log_adj.device
    if dev.type == "cpu":
        return chees_start_plain(log_adj, log_T, n, step, max_leapfrog, out)
    if dev.type != "cuda":
        raise ValueError(f"no K21a kernel for device {dev}")
    lead = tuple(log_adj.shape)
    if len(lead) > 1 or (lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"the carry must be () or (T,), got {lead}")
    for name, t in (("log_adj", log_adj), ("log_T", log_T),
                    ("eps", out.eps), ("u", out.u), ("T", out.T)):
        check_f32(name, t, dev, lead)
    check_i32("n", n, dev, lead)
    for name, t, shape in (("more", out.more, lead), ("top", out.top, ()),
                           ("trip", out.trip, ())):
        if (t.device != dev or t.dtype != torch.int64 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} int64 "
                             f"tensor on {dev}")
    launch("chees_start", dev, log_adj.data_ptr(), log_T.data_ptr(),
           n.data_ptr(), float(np.float32(step)),
           float(np.float32(max_leapfrog)), lead[0] if lead else 1,
           out.eps.data_ptr(), out.u.data_ptr(), out.T.data_ptr(),
           out.more.data_ptr(), out.top.data_ptr(), out.trip.data_ptr())
    count_launches(chees_start)
    return out


chees_start.launches = 0
chees_start.device_launches = None


class GradScratch(NamedTuple):
    """K21b's device buffers for a plan of more than one block a rung: the
    blocks' column sums, the means, the gradient's partials and the two
    done-counters a rung (0 between launches)."""

    part: torch.Tensor
    means: torch.Tensor
    gpart: torch.Tensor
    done: torch.Tensor


def grad_scratch(ntemps, nd, plan, device):
    """:class:`GradScratch` for ``ntemps`` rungs of ``nd`` columns under
    ``plan`` (None where the plan takes one block a rung)."""
    if plan.blocks == 1:
        return None

    def z(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return GradScratch(z(ntemps, plan.blocks, 2 * nd), z(ntemps, 2 * nd),
                       z(ntemps, plan.blocks, 2),
                       z(2 * ntemps, dt=torch.int32))


def _block_sums(v, plan):
    """``v`` ``(T, n, k)`` summed over its rows in K21b's order: each
    block's rows by thread (rows ``t, t + threads, ...`` from +0.0), the
    threads' partials by the fixed tree, then the blocks in order from
    +0.0.  Returns ``(T, k)``."""
    T, n, k = v.shape
    C, B, nb = plan.rows, plan.threads, plan.blocks
    if nb * C > n:
        v = torch.cat([v, v.new_zeros(T, nb * C - n, k)], 1)
    v = v.reshape(T, nb, C // B, B, k)
    acc = torch.zeros(T, nb, B, k, dtype=v.dtype, device=v.device)
    for i in range(C // B):
        acc = acc + v[:, :, i]
    s = B
    while s > 1:
        s //= 2
        acc = acc[:, :, :s] + acc[:, :, s:2 * s]
    total = torch.zeros(T, k, dtype=v.dtype, device=v.device)
    for b in range(nb):
        total = total + acc[:, b, 0]
    return total


def _row_sum(t):
    """``t`` ``(..., nd)`` summed over its columns in order from +0.0."""
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def _apply_L(p, d, L):
    """``L p`` of each row: ``p``, ``p d``, or ``sum_{k <= j} p_k L[j,
    k]`` from +0.0 in column order."""
    if L is not None:
        out = torch.zeros_like(p)
        for k in range(p.shape[-1]):
            out[..., k:] = out[..., k:] + p[..., k:k + 1] * L[k:, k]
        return out
    return p if d is None else p * d


def chees_gradient_plain(x, q, p, lp, lp_q, kinetic, u, T, g, d=None,
                         L=None, scratch=None, plan=None):
    """Plain PyTorch K21b: each rung's ChEES gradient with respect to
    ``log T`` written into ``g`` (``()`` or ``(T,)``, float32), its sums
    in ``plan``'s order (:func:`grad_plan` of the rows by default).
    ``x``, ``q``, ``p`` are ``(n, nd)`` or ``(T, n, nd)``, ``lp``,
    ``lp_q`` and ``kinetic`` their rows' log-probs and kinetic factors,
    ``u`` and ``T`` each rung's jitter and trajectory length; ``d`` is
    the diagonal metric or ``L`` the full metric's factor (neither for the
    identity); ``scratch`` (the kernel's) is not needed here."""
    lead = tuple(x.shape[:-2])
    if not lead:
        x, q, p = x[None], q[None], p[None]
        lp, lp_q, kinetic = lp[None], lp_q[None], kinetic[None]
        u, T = u.reshape(1), T.reshape(1)
    n = x.shape[-2]
    plan = plan or grad_plan(n)
    nf = torch.full((), float(n), dtype=x.dtype, device=x.device)
    qbar = (_block_sums(q, plan) / nf)[:, None]
    xbar = (_block_sums(x, plan) / nf)[:, None]
    dq, dx = q - qbar, x - xbar
    delta = _row_sum(dq * dq) - _row_sum(dx * dx)
    dd = (2.0 * u)[:, None] * _row_sum(dq * _apply_L(p, d, L))
    per_walker = (0.5 * delta) * dd
    lnpdiff = (lp_q - lp) + kinetic
    alpha = torch.exp(torch.clamp(lnpdiff, max=0.0))
    alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
    sums = _block_sums(torch.stack([alpha * per_walker, alpha], -1), plan)
    num, den = sums[:, 0] / nf, sums[:, 1] / nf
    out = (T * num / (den + 1e-12)).to(torch.float32)
    out = torch.where(torch.isfinite(out), out, 0.0)
    g.copy_(out.reshape(g.shape))
    return g


class _GradArgs(ctypes.Structure):
    """The arguments of the entry point (``CheesGradArgs`` in
    ``csrc/chees.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "q", "p", "lp", "lp_q", "kinetic", "u", "traj", "d", "L", "g",
        "part", "means", "gpart", "done")] + [
        (name, ctypes.c_int) for name in (
            "n", "nd", "ntemps", "rows", "blocks")]


def chees_gradient(x, q, p, lp, lp_q, kinetic, u, T, g, d=None, L=None,
                   scratch=None):
    """K21b on the rows' device: the CUDA kernel for CUDA tensors (one
    launch with one block a rung, else two), the plain version for CPU
    tensors.  Arguments as :func:`chees_gradient_plain`; ``scratch`` (a
    :class:`GradScratch` of :func:`grad_plan`'s plan) is made for the
    call where the plan needs one and none is given.  Returns ``g``."""
    if x.device.type == "cpu":
        return chees_gradient_plain(x, q, p, lp, lp_q, kinetic, u, T, g, d,
                                    L)
    return _launch(grad_plan(x.shape[-2]), x, q, p, lp, lp_q, kinetic, u, T,
                   g, d, L, scratch)


def _launch(plan, x, q, p, lp, lp_q, kinetic, u, T, g, d=None, L=None,
            scratch=None):
    """Launch K21b under ``plan`` on checked arguments."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no K21b kernel for device {dev}")
    if x.dim() not in (2, 3):
        raise ValueError("rows must be (n, ndim) or (T, n, ndim)")
    lead = tuple(x.shape[:-2])
    n, nd = (int(s) for s in x.shape[-2:])
    ntemps = lead[0] if lead else 1
    if (x.numel() >= 2**31 or not 1 <= ntemps < 65536 or n < 1
            or not 1 <= nd <= GRAD_ND_MAX):
        raise ValueError(f"bad K21b shape {tuple(x.shape)}")
    for name, t in (("x", x), ("q", q), ("p", p)):
        check_f32(name, t, dev, tuple(x.shape))
    for name, t in (("lp", lp), ("lp_q", lp_q), ("kinetic", kinetic)):
        check_f32(name, t, dev, lead + (n,))
    for name, t in (("u", u), ("T", T), ("g", g)):
        check_f32(name, t, dev, lead)
    check_f32("d", d, dev, (nd,))
    check_f32("L", L, dev, (nd, nd))
    if plan.blocks != -(-n // plan.rows) or plan.threads != GRAD_THREADS:
        raise ValueError(f"plan {plan} does not cover {n} rows")
    if plan.blocks > 1:
        scratch = scratch or grad_scratch(ntemps, nd, plan, dev)
        if (tuple(scratch.part.shape) != (ntemps, plan.blocks, 2 * nd)
                or tuple(scratch.done.shape) != (2 * ntemps,)):
            raise ValueError("the scratch is for another plan or shape")
    args = _GradArgs(
        x=x.data_ptr(), q=q.data_ptr(), p=p.data_ptr(), lp=lp.data_ptr(),
        lp_q=lp_q.data_ptr(), kinetic=kinetic.data_ptr(), u=u.data_ptr(),
        traj=T.data_ptr(), d=ptr(d), L=ptr(L), g=g.data_ptr(),
        part=None if plan.blocks == 1 else scratch.part.data_ptr(),
        means=None if plan.blocks == 1 else scratch.means.data_ptr(),
        gpart=None if plan.blocks == 1 else scratch.gpart.data_ptr(),
        done=None if plan.blocks == 1 else scratch.done.data_ptr(),
        n=n, nd=nd, ntemps=ntemps, rows=plan.rows, blocks=plan.blocks)
    launch("chees_gradient", dev, ctypes.addressof(args))
    count_launches(chees_gradient, plan.launches)
    return g


chees_gradient.launches = 0
chees_gradient.device_launches = None
